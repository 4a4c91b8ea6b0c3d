"""Tracing of the port: span totals, counters, and a timeline of spans.

Totals (always on):
- `span(name)` times a region on the host; `record(name, seconds)` adds a
  duration measured elsewhere; `count(name, n)` adds to a counter. All
  three feed one table, `profile_summary()`: {count, total_s, mean_ms,
  max_ms} per name. For a counter, count is the number of events and
  total_s the sum of n.

The timeline (a bounded in-memory ring of spans) records only while it is
on: between `enable()` and `disable()`, or while torch.profiler
records. Off, a span pays one flag read for it. Each span holds its name,
start and end on the `time.perf_counter_ns()` clock (the benchmark's
clock), a span id, the id of the span around it (a context variable), the
trace id of the request chunk that caused it (`TRACE_ID`, which the engine
sets to the chunk id and which asyncio tasks and `asyncio.to_thread`
inherit), whether the interval is device time, and small attributes.
`interval(...)` puts a host interval measured elsewhere into the timeline
alone; `events()` returns the spans. A full ring drops its oldest spans and
counts them (`dropped()`).

- `device_span(name)` times device work with a pair of timing CUDA events
  on the current stream (on the CPU, where work is synchronous, host time).
  The pair is resolved by `resolve()`, which the program calls where it
  already waits for the device; the interval is mapped onto the
  perf_counter clock by an anchor: an event recorded on a stream of its
  own, which is idle, polled until it completes, then the clock read. It
  is taken at the first device span after the timeline turns on and again
  once it is a second old (the event clock drifts from the host's by a few
  ppm), and never waits for the program's work. The interval is the
  stream's: from the stream reaching the start event to its end event, so
  it also holds any wait of the device for the host to finish issuing the
  work (a CUDA graph's launch under torch.profiler's CUDA tracing takes
  tens of ms). Resolved, it goes into the timeline and into the totals,
  where total_s is device seconds. Threads issue to the stream as they
  would untraced: a short lock covers each event's record alone. A span
  during which another span on its stream was open, or began or ended, may
  enclose that span's work: it is marked `shared` (its attributes), kept
  out of the totals and counted under `tracing.device_shared`.
- `profiler_offset_ns()` lays a span on the Unix-epoch clock that
  torch.profiler stamps its events with. On the card a profile's device
  times stand off that clock by up to ~0.5 ms, by another amount in each
  profile, and drift from it by up to 4 ppm within one; device spans are
  held to the host's clock by their anchors.
- `trace(log_dir)`, the operator's tool: torch.profiler recording with the
  timeline on, written as one chrome trace with the program's spans merged
  in on the profiler's clock.
"""
from __future__ import annotations

import contextlib
import contextvars
import itertools
import json
import os
import threading
import time
from collections import defaultdict, deque
from typing import Dict, Iterator, List, NamedTuple, Optional

import torch.autograd.profiler as _torch_profiler

_lock = threading.Lock()
_spans: Dict[str, list] = defaultdict(lambda: [0, 0.0, 0.0])  # count, total, max

# the timeline
RING_SIZE = 1 << 17
_ring: deque = deque(maxlen=RING_SIZE)
_dropped = 0
_enabled = False
_ids = itertools.count(1)
# the chunk id of the work this context does (`{request_id}_{chunk index}`)
TRACE_ID: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    "auralis_trace_id", default=None)
_current: contextvars.ContextVar[Optional[int]] = contextvars.ContextVar(
    "auralis_span", default=None)

# device spans: anchors per device (event, perf_counter_ns at its
# completion), each taken on a stream of its own; per stream the number of
# span events recorded and of spans open; the event pairs not yet resolved
_device_lock = threading.Lock()
_anchors: dict = {}
_anchor_streams: dict = {}
_stream_state: dict = {}
_pending: list = []
# the event clock drifts from the host's by 6-21 us/s (two H100 hosts): an
# anchor older than this is taken again at the next device span
ANCHOR_AGE_NS = 1_000_000_000
# an anchor whose record and completion lie further apart is taken again
ANCHOR_SLACK_NS = 50_000


class Span(NamedTuple):
    name: str
    start_ns: int  # time.perf_counter_ns()
    end_ns: int
    id: int
    parent: Optional[int]
    trace_id: Optional[str]
    device: bool  # the interval is device time
    attrs: Optional[dict]


def recording() -> bool:
    """Whether the timeline records: after `enable()`, or while a
    torch.profiler records (its module flag, set for every thread)."""
    return _enabled or _torch_profiler._is_profiler_enabled


def enable() -> None:
    """Turn the timeline on (and take a fresh anchor for device spans)."""
    global _enabled
    _anchors.clear()
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def _add_total(name: str, value: float) -> None:
    with _lock:
        rec = _spans[name]
        rec[0] += 1
        rec[1] += value
        rec[2] = max(rec[2], value)


def _append(span: Span) -> None:
    global _dropped
    with _lock:
        if len(_ring) == RING_SIZE:
            _dropped += 1
        _ring.append(span)


@contextlib.contextmanager
def span(name: str, **attrs) -> Iterator[None]:
    """Aggregate wall-time of a named region; on the timeline while it is
    on, as the parent of the spans made inside it."""
    on = recording()
    if on:
        sid = next(_ids)
        parent = _current.get()
        token = _current.set(sid)
    t0 = time.perf_counter_ns()
    try:
        yield
    finally:
        t1 = time.perf_counter_ns()
        _add_total(name, (t1 - t0) * 1e-9)
        if on:
            _current.reset(token)
            _append(Span(name, t0, t1, sid, parent, TRACE_ID.get(), False, attrs or None))


def record(name: str, seconds: float, trace_id: Optional[str] = None) -> None:
    """Add an externally-measured duration to the span aggregates (for
    regions whose start/end live in different call frames, e.g. queue waits);
    on the timeline it ends now."""
    _add_total(name, seconds)
    if recording():
        end = time.perf_counter_ns()
        interval(name, (end - int(seconds * 1e9)) * 1e-9, end * 1e-9, trace_id)


def count(name: str, n: float = 1) -> None:
    """Add n to a counter (totals only)."""
    _add_total(name, n)


def interval(name: str, start: float, end: float, trace_id: Optional[str] = None) -> None:
    """A host interval measured elsewhere (`time.perf_counter()` seconds)
    into the timeline alone, while it is on; its trace id is the context's
    unless given. `start == end` marks an instant."""
    if recording():
        _append(Span(name, int(start * 1e9), int(end * 1e9), next(_ids), _current.get(),
                     trace_id if trace_id is not None else TRACE_ID.get(), False, None))


class _DevicePair(NamedTuple):
    name: str
    start: object  # torch.cuda.Event
    end: object
    anchor: tuple
    id: int
    parent: Optional[int]
    trace_id: Optional[str]
    counts: Optional[dict]
    attrs: Optional[dict]
    shared: bool


def _anchor(device) -> tuple:
    """(event, perf_counter_ns when it completed): the map from CUDA event
    time to the timeline's clock, taken anew once it is ANCHOR_AGE_NS old.
    The event is recorded on a stream of the anchor's own, which has no
    work, and polled: it completes between the clock read before its
    record and the poll that finds it done, a few microseconds apart. The
    program's streams are not touched, so it never waits for their work."""
    import torch

    key = device.index if device.index is not None else torch.cuda.current_device()
    got = _anchors.get(key)
    if got is not None and time.perf_counter_ns() - got[1] < ANCHOR_AGE_NS:
        return got
    stream = _anchor_streams.get(key)
    if stream is None:
        stream = _anchor_streams.setdefault(key, torch.cuda.Stream(device))
    for _ in range(3):
        ev = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter_ns()
        ev.record(stream)
        while not ev.query():
            pass
        t1 = time.perf_counter_ns()
        got = (ev, (t0 + t1) // 2)
        if t1 - t0 <= ANCHOR_SLACK_NS:
            break
    _anchors[key] = got
    return got


@contextlib.contextmanager
def device_span(name: str, device=None, trace_id: Optional[str] = None,
                counts: Optional[dict] = None, **attrs) -> Iterator[None]:
    """Time the device work issued inside (on `device`, a torch.device; the
    CPU's work is timed on the host). On the card a pair of timing events
    around it on the current stream, resolved by `resolve()`; `counts`
    ({counter: n}) are added when it resolves, so they cover the same work
    as its total. Off, nothing is recorded and no event is made."""
    if not recording():
        yield
        return
    sid, parent = next(_ids), _current.get()
    trace_id = trace_id if trace_id is not None else TRACE_ID.get()
    cuda = device is not None and device.type == "cuda"
    if cuda:
        import torch

        stream = torch.cuda.current_stream(device)
        anchor = _anchor(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
    with _device_lock:
        # [span events recorded, spans open] on this stream (on the CPU, one)
        state = _stream_state.setdefault(stream.cuda_stream if cuda else None, [0, 0])
        alone = state[1] == 0
        state[0] += 1
        state[1] += 1
        first = state[0]
        if cuda:
            start.record(stream)
        t0 = time.perf_counter_ns()
    try:
        yield
    finally:
        with _device_lock:
            t1 = time.perf_counter_ns()
            state[0] += 1
            state[1] -= 1
            shared = not alone or state[0] != first + 1
            if cuda:
                end.record(stream)
    if cuda:
        with _lock:
            _pending.append(_DevicePair(name, start, end, anchor, sid, parent, trace_id, counts,
                                        attrs or None, shared))
    else:
        _device_done(Span(name, t0, t1, sid, parent, trace_id, True, attrs or None), counts,
                     shared)


def _finish(s: Span, counts: Optional[dict]) -> None:
    _add_total(s.name, (s.end_ns - s.start_ns) * 1e-9)
    for counter, n in (counts or {}).items():
        _add_total(counter, n)
    _append(s)


def resolve() -> None:
    """Resolve every device span whose work has finished (a non-blocking
    query per pair). The program calls it where it already waits for the
    device."""
    if not _pending:
        return
    with _lock:
        ready = [p for p in _pending if p.end.query()]
        if not ready:
            return
        done = {id(p) for p in ready}
        _pending[:] = [p for p in _pending if id(p) not in done]
    for p in ready:
        ev, t_ns = p.anchor
        s = t_ns + int(ev.elapsed_time(p.start) * 1e6)
        e = t_ns + int(ev.elapsed_time(p.end) * 1e6)
        _device_done(Span(p.name, s, e, p.id, p.parent, p.trace_id, True, p.attrs), p.counts,
                     p.shared)


def _device_done(s: Span, counts: Optional[dict], shared: bool) -> None:
    if shared:
        # it may hold another span's work: on the timeline alone
        _add_total("tracing.device_shared", 1)
        _append(s._replace(attrs={**(s.attrs or {}), "shared": True}))
    else:
        _finish(s, counts)


def events(t0: Optional[float] = None, t1: Optional[float] = None) -> List[Span]:
    """The timeline's spans that overlap [t0, t1) (`time.perf_counter()`
    seconds; None: unbounded), in the order they ended, device spans once
    resolved. The benchmark's per-layer readers call this: the timeline
    covers its traced sub-window, in which torch.profiler runs."""
    resolve()
    lo = -1 if t0 is None else int(t0 * 1e9)
    hi = None if t1 is None else int(t1 * 1e9)
    with _lock:
        spans = list(_ring)
    return [s for s in spans if s.end_ns >= lo and (hi is None or s.start_ns < hi)]


def dropped() -> int:
    """Spans dropped by the full ring since the start."""
    return _dropped


def clear() -> None:
    """Empty the timeline (its drop count too)."""
    global _dropped
    with _lock:
        _ring.clear()
        _dropped = 0


def profiler_offset_ns(reads: int = 5) -> int:
    """time.time_ns() - time.perf_counter_ns(), the least of a few paired
    reads: a timeline time plus this is on torch.profiler's clock."""
    best = None
    for _ in range(reads):
        a = time.perf_counter_ns()
        w = time.time_ns()
        b = time.perf_counter_ns()
        off = w - (a + b) // 2
        if best is None or b - a < best[0]:
            best = (b - a, off)
    return best[1]


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


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Profile the enclosed work with torch.profiler (CPU, and CUDA where a
    card is visible) with the timeline on, then write `<log_dir>/trace.json`
    (chrome format): the profiler's events, and the program's spans of the
    same period on the profiler's clock (`profiler_offset_ns`; on the card
    a profile's kernels may stand up to ~0.5 ms off it; process "auralis",
    one row for host spans and one for device spans; attributes and trace
    ids under `args`)."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    was_enabled = _enabled
    enable()
    t0 = time.perf_counter()
    try:
        with torch.profiler.profile(activities=acts) as prof:
            yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    finally:
        if not was_enabled:
            disable()
    t1 = time.perf_counter()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    offset = profiler_offset_ns()
    with open(path) as f:
        data = json.load(f)
    # the profiler's `ts` are microseconds after baseTimeNanoseconds (Unix
    # epoch; absent in older versions, where they are absolute)
    base = int(data.get("baseTimeNanoseconds", 0))
    pid = "auralis"
    out = data.setdefault("traceEvents", [])
    out += [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
             "args": {"name": f"auralis {tid}"}} for tid in ("host", "device")]
    for s in events(t0, t1):
        out.append({"ph": "X", "cat": "auralis", "name": s.name, "pid": pid,
                    "tid": "device" if s.device else "host",
                    "ts": (s.start_ns + offset - base) / 1e3,
                    "dur": (s.end_ns - s.start_ns) / 1e3,
                    "args": {"id": s.id, "parent": s.parent, "trace_id": s.trace_id,
                             **(s.attrs or {})}})
    with open(path, "w") as f:
        json.dump(data, f)
