"""The metric readers' arithmetic on the CPU, on records made by hand: the
runner's steps resolved to a part of a block, the device's idle share
over whole cycles of one client's traffic, the p95 of due latencies, and
the K2 and K3 rooflines counted over the traced sub-window."""
from __future__ import annotations

import json

import numpy as np
import pytest

from conftest import REPO
from portbench import flops, readers, run

FLAGLESS = json.loads((REPO / "portbench/configs/xttsv2-flagless.json").read_text())
LOADED_CELLS = ("ebook", "chat")


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


def _due_rec(latencies_ms, failed=()):
    """An open loop's record: request i due at 1 + i / 10 s inside a window
    of [0, 100), its first audio `latencies_ms[i]` later."""
    reqs = [{"due": 1 + i / 10, "sent": 1 + i / 10, "first": 1 + i / 10 + ms / 1e3,
             "failed": i in failed} for i, ms in enumerate(latencies_ms)]
    return {"window": {"start": 0.0, "end": 100.0, "seconds": 100.0}, "drain_end": 160.0,
            "requests": reqs}


def test_p95_is_the_nearest_rank():
    """200 requests with latencies 1..200 ms in another order: the 190th
    smallest; a failed request counts as the end of the drain."""
    lat = list(np.random.default_rng(3).permutation(np.arange(1, 201)))
    assert readers.due_latency_p95_ms(_due_rec(lat), "first") == pytest.approx(190.0)
    # one more request, failed: it lies beyond the p95 and moves it one rank
    rec = _due_rec(lat + [5.0], failed={200})
    assert readers.latencies(rec, "first")[-1] == pytest.approx(160.0 - 21.0)
    assert readers.due_latency_p95_ms(rec, "first") == pytest.approx(191.0)


def test_p95_needs_two_hundred_requests():
    assert readers.due_latency_p95_ms(_due_rec(range(1, 200)), "first") is None
    assert readers.due_latency_p95_ms(_due_rec(range(1, 201)), "first") is not None


def _kernel_rec(kernels, chunks):
    return {"config": FLAGLESS, "device": {"kind": "card", "power_limit": "700 W"},
            "trace": {"host_start": 5.0, "host_end": 10.0, "window_s": 5.0, "busy_s": 4.0,
                      "kernels": kernels},
            "requests": [{"chunks": chunks}]}


def _chunk(t_submit, t_done, n, prompt_len=100):
    return {"t_submit": t_submit, "t_done": t_done, "n": n, "prompt_len": prompt_len}


@pytest.mark.parametrize("name", ["k2_roofline.single", "k2_roofline.chat"])
def test_k2_counts_the_steps_placed_in_the_sub_window(name):
    """A chunk of 11 tokens over [0, 10) s puts token j at 10 j / 11 s: the
    sub-window [5, 10) holds tokens 6..10, 5 steps over 540 rows. A chunk
    that never ended, one of a single token and one after the sub-window
    add nothing; kernels other than `flash_decode*` are not timed."""
    chunks = [_chunk(0.0, 10.0, 11), _chunk(0.0, None, 50), _chunk(6.0, 7.0, 1),
              _chunk(10.0, 20.0, 30)]
    rec = _kernel_rec({"flash_decode_k2": 2e-4, "mrf_conv_k3": 1.0}, chunks)
    ms, by = flops.bound(flops.decode_attention_bytes(FLAGLESS, 540, 5),
                         flops.decode_attention_ops(FLAGLESS, 540), "bf16")
    assert by == "bytes"
    want = ms / 1e3 / 2e-4 * 100
    assert readers.k2_percent(rec) == pytest.approx(want)
    assert run.reader(REPO, name)(rec) == pytest.approx(want)
    assert readers.k2_percent(_kernel_rec({"mrf_conv_k3": 1.0}, chunks)) is None
    assert readers.k2_percent(_kernel_rec({"flash_decode_k2": 2e-4}, chunks[1:])) is None


def test_k3_rows_counts_the_chunks_that_ended_in_the_sub_window():
    """Each chunk is vocoded whole as its decoding ends: the frames of the
    chunks that ended inside [5, 10) count, those that ended before or
    after it or never did, none."""
    inside = [_chunk(0.0, 6.0, 300), _chunk(4.0, 9.9, 41)]
    outside = [_chunk(0.0, 4.9, 500), _chunk(6.0, 10.0, 500), _chunk(6.0, None, 500)]
    rec = _kernel_rec({"mrf_conv_a": 1e-3, "mrf_conv_b": 2e-3, "flash_decode": 1.0},
                      inside + outside)
    frames = flops.frames_of(FLAGLESS, 300) + flops.frames_of(FLAGLESS, 41)
    ms, by = flops.bound(flops.mrf_bytes(FLAGLESS, frames), flops.mrf_ops(FLAGLESS, frames),
                         "bf16")
    assert by == "operations"
    assert readers.k3_rows_percent(rec) == pytest.approx(ms / 1e3 / 3e-3 * 100)
    assert run.reader(REPO, "k3_roofline.ebook")(rec) == readers.k3_rows_percent(rec)
    assert readers.k3_rows_percent(_kernel_rec({"mrf_conv_a": 1e-3}, outside)) is None
    assert readers.k3_rows_percent(_kernel_rec({"flash_decode": 1.0}, inside)) is None


def _nothing_rec():
    """An untraced run's record in which nothing was served."""
    return {"config": FLAGLESS, "window": {"start": 0.0, "end": 30.0, "seconds": 30.0},
            "drain_end": 90.0, "requests": [], "spans": {},
            "runner": {"steps": 0, "occupied_mean": None, "num_slots": 64, "samples": []}}


@pytest.mark.parametrize("name", sorted(
    p.name[:-3] for p in (REPO / "portbench/metrics").glob("*.py")
    if p.name.split(".")[-2] in LOADED_CELLS))
def test_a_loaded_cells_reader_finds_nothing_in_an_empty_run(name):
    """The loaded cells' readers load, and return None where nothing was
    served, traced or recorded, so that the metric is left out."""
    assert run.reader(REPO, name)(_nothing_rec()) is None
