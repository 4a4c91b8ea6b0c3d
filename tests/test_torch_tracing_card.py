"""The timeline of common/tracing.py on the card, against the host's clock
and torch.profiler.

Skips without a CUDA device. On an H100 (the repository's conftest imports
JAX, which a card's machine may lack, so leave it out):

    python -m pytest --noconftest -p no:cacheprovider -q -s tests/test_torch_tracing_card.py

With the profiler on under CUDA activity alone (as the benchmark traces),
the timeline records, from any thread. A device span is on the host's
clock: at the start and at the end of a 30 s profile it lies inside the
host span that launched its kernel and synchronised on it, and ends within
50 us of that span's end. Its length agrees with its kernel's in the
profile within 10 us. Where the profile puts the kernel on the Unix-epoch
clock is printed and not held to a bound: a profile's device times stand
off that clock by up to ~0.5 ms, by another amount in each profile, and
drift from it by up to 4 ppm within one.
"""
import threading
import time

import pytest
import torch

from auralis_tpu_torch.common import tracing

TOLERANCE_NS = 50_000
LENGTH_NS = 10_000
PROFILE_S = 30.0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; none is visible")
    return torch.device("cuda", 0)


def _cuda_profiler():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])


def _kernels(prof) -> list:
    """(start_ns, end_ns, name) of the profile's device kernels, Unix-epoch
    nanoseconds (the profiler's clock)."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and "memcpy" not in e.name().lower():
            out.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
    return out


def _matching(kernels: list, start: int, offset: int) -> tuple:
    """The kernel whose start lies nearest to `start` (timeline ns)."""
    return min(kernels, key=lambda k: abs(k[0] - start - offset))


def test_timeline_records_under_cuda_only_profiling(card):
    tracing.disable()
    assert not tracing.recording()
    seen = []
    with _cuda_profiler():
        seen.append(tracing.recording())
        worker = threading.Thread(target=lambda: seen.append(tracing.recording()))
        worker.start()
        worker.join(timeout=30)
        assert not worker.is_alive()
    seen.append(tracing.recording())
    assert seen == [True, True, False], seen


def test_device_span_on_the_host_clock_over_30_s(card):
    """Two probes 30 s apart: each a matmul queued behind a 1 ms device
    sleep, so the span's start event and the kernel follow the sleep on the
    stream, inside a host span that ends after a synchronize. The anchor is
    30 s old at the second probe's first device span, which takes it anew."""
    x = torch.randn(4096, 4096, device=card)
    (x @ x).sum().item()
    torch.cuda.synchronize()
    with _cuda_profiler() as prof:
        with tracing.device_span("card.anchor", card):
            pass  # the anchor, taken before the probes
        t0 = time.perf_counter()
        for when in (0.0, PROFILE_S):
            time.sleep(max(0.0, t0 + when - time.perf_counter()))
            with tracing.device_span("card.idle", card):
                pass
            age = time.perf_counter_ns() - tracing._anchors[card.index][1]
            print(f"probe at {when:.0f} s: the anchor is {age * 1e-6:.3f} ms old")
            with tracing.span("card.host"):
                torch.cuda._sleep(2_000_000)  # ~1 ms: the stream is busy at the start event
                with tracing.device_span("card.kernel", card):
                    x @ x
                torch.cuda.synchronize()
            tracing.resolve()
        time.sleep(0.5)
        (x + 1).sum().item()  # the probes are not the profile's last work
    offset = tracing.profiler_offset_ns()
    spans = [s for s in tracing.events() if s.name == "card.kernel"][-2:]
    hosts = [s for s in tracing.events() if s.name == "card.host"][-2:]
    assert len(spans) == 2 and all(s.device for s in spans)
    kernels = [k for k in _kernels(prof) if "gemm" in k[2].lower()]
    for s, h in zip(spans, hosts):
        lead, tail = s.start_ns - h.start_ns, h.end_ns - s.end_ns
        k0, k1, name = _matching(kernels, s.start_ns, offset)
        length = (s.end_ns - s.start_ns) - (k1 - k0)
        print(f"device span {(s.end_ns - s.start_ns) * 1e-3:.1f} us, {lead * 1e-3:.1f} us into "
              f"its host span, {tail * 1e-3:.1f} us before its end; kernel {name} "
              f"{(k1 - k0) * 1e-3:.1f} us ({length * 1e-3:+.1f}), on the Unix-epoch clock "
              f"{(k0 - s.start_ns - offset) * 1e-3:+.1f} us from the span's start; "
              f"{torch.cuda.get_device_name(card)}")
        assert lead >= 0 and 0 <= tail <= TOLERANCE_NS, (lead, tail)
        assert abs(length) <= LENGTH_NS, length
