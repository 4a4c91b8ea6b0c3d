"""Readers of the program's own timeline (auralis_tpu_torch.common.tracing).

While torch.profiler traces the last `trace_s` of a run's window, the
program records a timeline of spans on the benchmark's clock
(time.perf_counter): its device work as device spans (decode blocks,
inserts, vocoder batches; CUDA-event time), the runner's host turns, each
chunk's life from its submission and the instant of its first audio, each
tagged with its chunk's trace id. The functions here read it over the
traced sub-window (`rec["trace"]`) and return None where there is nothing
to read: an untraced run, or a program without the timeline.
"""
from __future__ import annotations

import statistics
import sys

import numpy as np

# the runner's host turns, by the name an idle gap is put down to
RUNNER_TURNS = {
    "decode.handoff": "hand-off", "decode.dispatch": "dispatch",
    "decode.status_wait": "status wait", "decode.harvest": "harvest",
    "decode.hooks": "hooks", "decode.snapshots": "snapshots", "decode.idle_wait": "idle wait",
}
RUNNER_DEVICE = ("decode.insert_device", "decode.block_device")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def sub_window(rec: dict) -> tuple | None:
    """(start, end) of the traced sub-window in perf_counter nanoseconds."""
    tr = rec.get("trace")
    return (int(tr["host_start"] * 1e9), int(tr["host_end"] * 1e9)) if tr else None


def program_events(rec: dict) -> list | None:
    """The timeline's spans that overlap the traced sub-window, or None."""
    win = sub_window(rec)
    if win is None:
        return None
    try:
        from auralis_tpu_torch.common import tracing
    except ImportError:
        return None
    events = getattr(tracing, "events", None)
    if events is None:
        return None
    spans = events(win[0] * 1e-9, win[1] * 1e-9)
    return spans or None


def span_total_ratio(rec: dict, num: str, den: str, scale: float) -> float | None:
    """`num`'s total over `den`'s, from the window's span totals."""
    a, b = rec["spans"].get(num), rec["spans"].get(den)
    if not a or not b or not b["total_s"]:
        return None
    return a["total_s"] / b["total_s"] * scale


def union(intervals) -> list:
    """Disjoint, sorted intervals covering the same points as `intervals`."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        elif b > a:
            out.append([a, b])
    return out


class Busy:
    """Disjoint, sorted intervals ([n, 2] nanoseconds) and how much of any
    [a, b) they cover, in O(log n)."""

    def __init__(self, intervals):
        iv = np.asarray(intervals, np.int64).reshape(-1, 2)
        self.s, self.e = iv[:, 0], iv[:, 1]
        self.cum = np.concatenate([[0], np.cumsum(self.e - self.s)])

    def covered(self, a: int, b: int) -> int:
        """Nanoseconds of [a, b) inside the intervals."""
        i = int(np.searchsorted(self.e, a, "right"))  # the first ending after a
        j = int(np.searchsorted(self.s, b, "left"))  # those starting before b
        if b <= a or j <= i:
            return 0
        return int(self.cum[j] - self.cum[i] - max(0, a - self.s[i]) - max(0, self.e[j - 1] - b))


def dispatch_gaps(rec: dict) -> float | None:
    """Mean device idle, in ms, between a decode block's end and the next
    runner pass's first device work while a slot is owned: the part of that
    interval that no device span of the program covers. Prints to stderr
    the idle split by the runner's host turn at each gap's middle and the
    program's own idle share of the sub-window beside the profiler's."""
    spans = program_events(rec)
    if spans is None:
        return None
    lo, hi = sub_window(rec)
    device = Busy(union((s.start_ns, s.end_ns) for s in spans if s.device))
    runner = sorted((s for s in spans if s.name in RUNNER_DEVICE), key=lambda s: s.start_ns)
    idle_waits = [(s.start_ns, s.end_ns) for s in spans if s.name == "decode.idle_wait"]
    turns = [s for s in spans if s.name in RUNNER_TURNS]
    gaps, split = [], {}
    for blk, nxt in zip(runner, runner[1:]):
        if (blk.name != "decode.block_device" or not (blk.attrs or {}).get("trace_ids")
                or not lo <= blk.end_ns < hi):
            continue
        a, b = blk.end_ns, max(blk.end_ns, nxt.start_ns)
        if any(s < b and t > a for s, t in idle_waits):
            continue  # the runner had no slot in between
        idle = (b - a) - device.covered(a, b)
        gaps.append(idle)
        if idle > 0:
            mid = (a + b) // 2
            under = [t for t in turns if t.start_ns <= mid < t.end_ns]
            turn = (RUNNER_TURNS[min(under, key=lambda t: t.end_ns - t.start_ns).name]
                    if under else "none")
            n, ns = split.get(turn, (0, 0))
            split[turn] = (n + 1, ns + idle)
    if not gaps:
        return None
    own_idle = 1 - device.covered(lo, hi) / max(hi - lo, 1)
    tr = rec["trace"]
    profiled = 1 - tr["busy_s"] / tr["window_s"] if tr.get("window_s") else None
    log(f"[dispatch_gap] {len(gaps)} gaps after blocks, idle {sum(gaps) * 1e-6:.3f} ms in all; "
        "by the runner's host turn at the gap's middle: "
        + ", ".join(f"{k} {ns * 1e-6:.3f} ms ({n})" for k, (n, ns) in
                    sorted(split.items(), key=lambda kv: -kv[1][1]))
        + f"; the program's idle share of the sub-window {own_idle * 100:.2f}% (the profiler's "
        f"idle_share {'n/a' if profiled is None else f'{profiled * 100:.2f}%'})")
    if tr.get("busy_spans") is not None and len(tr["busy_spans"]):
        # where the two disagree: time inside the program's device spans
        # in which the profiler saw no device operation, by span name (the
        # profile's intervals as the harness lays them, early by its
        # profiler's start, a few ms)
        busy = Busy(np.rint(np.asarray(tr["busy_spans"], np.float64) * 1e9).astype(np.int64))
        quiet = {}
        for s in spans:
            if s.device:
                a, b = max(s.start_ns, lo), min(s.end_ns, hi)
                if b > a:
                    quiet[s.name] = quiet.get(s.name, 0) + (b - a) - busy.covered(a, b)
        log("[dispatch_gap] no device operation in the profile inside the program's device "
            "spans: " + ", ".join(f"{k} {v * 1e-6:.3f} ms" for k, v in sorted(quiet.items()))
            + f" of a {(hi - lo) * 1e-6:.3f} ms sub-window")
    return statistics.fmean(gaps) * 1e-6
