"""Tracing / profiling (SURVEY.md §5 aux subsystem).

The reference has no in-process tracer (only a torch.profiler script). Here:
- `span(name)` — lightweight timing spans aggregated into a global profile
  (count / total / max per span), dumpable via `profile_summary()`.
- `start_profiler_server(port)` — torch.profiler has no attachable server;
  raises NotImplementedError (use `trace` instead).
- `trace(dir)` — context manager around `torch.profiler.profile` for
  on-demand CPU + CUDA trace capture (chrome trace written to `dir`).
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator

from .logger import setup_logger

logger = setup_logger("tracing")

_lock = threading.Lock()
_spans: Dict[str, list] = defaultdict(lambda: [0, 0.0, 0.0])  # count, total, max


@contextlib.contextmanager
def span(name: str) -> Iterator[None]:
    """Aggregate wall-time of a named region; ~100 ns overhead when idle."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _lock:
            rec = _spans[name]
            rec[0] += 1
            rec[1] += dt
            rec[2] = max(rec[2], dt)


def record(name: str, seconds: float) -> None:
    """Add an externally-measured duration to the span aggregates (for
    regions whose start/end live in different call frames, e.g. queue waits)."""
    with _lock:
        rec = _spans[name]
        rec[0] += 1
        rec[1] += seconds
        rec[2] = max(rec[2], seconds)


def profile_summary(reset: bool = False) -> Dict[str, dict]:
    """{span: {count, total_s, mean_ms, max_ms}}."""
    with _lock:
        out = {
            k: {
                "count": c,
                "total_s": round(tot, 4),
                "mean_ms": round(tot / c * 1000, 2) if c else 0.0,
                "max_ms": round(mx * 1000, 2),
            }
            for k, (c, tot, mx) in _spans.items()
        }
        if reset:
            _spans.clear()
    return out


def log_profile_summary(reset: bool = False) -> None:
    for name, rec in sorted(profile_summary(reset).items()):
        logger.info(
            "span %-28s n=%-6d total=%8.2fs mean=%8.2fms max=%8.2fms",
            name, rec["count"], rec["total_s"], rec["mean_ms"], rec["max_ms"],
        )


def start_profiler_server(port: int = 9999) -> None:
    """torch.profiler captures in-process only; there is no server to attach."""
    raise NotImplementedError("no profiler server under torch; wrap work in trace()")


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a CPU + CUDA trace as `<log_dir>/trace.json` (chrome format)."""
    import os

    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
