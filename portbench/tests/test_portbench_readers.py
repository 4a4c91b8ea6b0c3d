"""The metric readers' arithmetic on the CPU, on records made by hand: the
runner's steps resolved to a part of a block, and the device's idle share
over whole cycles of one client's traffic."""
from __future__ import annotations

import numpy as np
import pytest

from conftest import REPO  # noqa: F401  (puts the repo on the path)
from portbench import readers


def _samples(dispatches, block, t_end, every=0.05):
    """(time, step count, owned slots) every `every` seconds when a block of
    `block` steps is dispatched at each of `dispatches`."""
    out, t = [], 0.0
    while t <= t_end:
        out.append((t, block * sum(d <= t for d in dispatches), 4))
        t += every
    return out


@pytest.mark.parametrize("offset", [0.0, 0.3, 0.55, 0.99])
def test_steps_are_resolved_within_a_block(offset):
    """64-step blocks back to back, 1.1 s each: a window of 10 blocks' time
    counts 640 steps wherever its edges fall inside a block, to a sample's
    share of one block."""
    dispatches = [0.02 + 1.1 * k for k in range(40)]
    samples = _samples(dispatches, 64, 44.0)
    w0 = 5.0 + offset
    steps = readers.steps_at(samples, w0 + 11.0) - readers.steps_at(samples, w0)
    assert steps == pytest.approx(640, abs=64 * 0.05 / 1.1 + 1e-9)


def test_steps_before_any_dispatch_are_the_first_count():
    samples = _samples([3.0], 64, 5.0)
    assert readers.steps_at(samples, 1.0) == 0
    assert readers.steps_at(samples, 5.0) == 64


def test_step_time_sees_a_faster_step():
    """A step 2% faster moves `decode_step_ms` by about 2%, far below the
    one block in 27 that whole blocks resolve."""
    def step_ms(block_s):
        dispatches = [0.01 + block_s * k for k in range(60)]
        rec = {"window": {"start": 5.0, "end": 35.0, "seconds": 30.0},
               "runner": {"samples": _samples(dispatches, 64, 40.0)}}
        rec["runner"]["steps"] = (readers.steps_at(rec["runner"]["samples"], 35.0)
                                  - readers.steps_at(rec["runner"]["samples"], 5.0))
        return readers.decode_step_ms(rec)

    slow, fast = step_ms(1.111), step_ms(1.111 * 0.98)
    assert fast / slow == pytest.approx(0.98, abs=0.003)


def _trace_rec(busy, sent, start=0.0, end=25.0):
    return {"trace": {"host_start": start, "host_end": end, "window_s": end - start,
                      "busy_s": sum(b - a for a, b in busy),
                      "busy_spans": np.asarray(busy, np.float64).reshape(-1, 2)},
            "requests": [{"sent": s} for s in sent]}


@pytest.mark.parametrize("phase", [0.0, 2.0, 4.5, 7.0])
def test_idle_over_whole_cycles_does_not_depend_on_the_phase(phase):
    """Cycles of 8 s: busy 5 s, then idle 3 s, a section sent 1 s into the
    idle part. Whatever the phase of the traced sub-window, the idle share
    between the first and last sends inside it is 3 / 8."""
    busy, sent = [], []
    for k in range(6):
        c = -8.0 + phase + 8.0 * k
        busy.append((c, c + 5.0))
        sent.append(c + 6.0)
    rec = _trace_rec(busy, sent)
    assert readers.idle_percent_whole_cycles(rec) == pytest.approx(37.5)


def test_idle_over_whole_cycles_needs_two_sends():
    rec = _trace_rec([(0.0, 20.0)], [3.0])
    assert readers.idle_percent_whole_cycles(rec) is None
    assert readers.busy_between(rec, 1.0, 2.0) == pytest.approx(1.0)
    assert readers.busy_between(rec, -1.0, 2.0) is None
