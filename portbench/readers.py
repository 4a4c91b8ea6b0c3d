"""Helpers that the metric readers (`portbench/metrics/<name>.py`) share.

A reader is `read(rec) -> float | None`, where `rec` is the run's record
(built by `run.run_cell`):
- `window`: {start, end, seconds} on the host clock (time.perf_counter);
- `setup_s`: process start to the start of the ramp;
- `requests`: per request `due` (open loop), `sent`, `first` (first audio),
  `done` (last audio; None if it never ended), `outputs` ((arrival time,
  samples) of each piece of audio received), `audio_s`, `failed`,
  `stream`, `greedy` and
  `chunks`, each {t_submit, t_done, n (tokens decoded), prompt_len (the
  benchmark's own count)};
- `spans`: the program's span aggregates over the window, per name
  {count, total_s};
- `runner`: the decode runner's counters over the window (`blocks`,
  `occupancy_sum`), `steps` (`steps_at` the window's end less at its
  start), `num_slots`, `samples`, (time, step count, owned slots) every
  50 ms from the ramp's start to past the window's end, and
  `occupied_mean`, the mean owned slots of the samples in the window;
- `trace` (traced runs only): the profiled sub-window, from its first
  device operation to the window's end, {host_start, host_end, window_s,
  busy_s, busy_spans ([n, 2] host-clock seconds in which the device ran an
  operation), kernels: {name: device seconds}};
- `config`: the configuration file.
A reader that finds nothing to read returns None, and the metric is left
out of the result.
"""
from __future__ import annotations

import math
import statistics
import sys

import numpy as np

from . import flops


def in_window(rec: dict, t) -> bool:
    w = rec["window"]
    return t is not None and w["start"] <= t < w["end"]


def latencies(rec: dict, key: str) -> list:
    """Over the requests due in the window (an open loop's due time, a
    closed loop's send time), `key` time - due time in seconds; a failed or
    unfinished request counts as the end of the drain."""
    lat = []
    for r in rec["requests"]:
        due = r["due"] if r["due"] is not None else r["sent"]
        if not in_window(rec, due):
            continue
        t = r[key] if not r["failed"] else None
        lat.append((t if t is not None else rec["drain_end"]) - due)
    return lat


def due_latency_p50_ms(rec: dict, key: str) -> float | None:
    lat = sorted(latencies(rec, key))
    return lat[(len(lat) - 1) // 2] * 1e3 if lat else None


def due_latency_p95_ms(rec: dict, key: str) -> float | None:
    """The 95th percentile (nearest rank) of `latencies`, in ms; None with
    fewer than 200 requests, which leave under ten beyond it."""
    lat = sorted(latencies(rec, key))
    if len(lat) < 200:
        return None
    return lat[math.ceil(0.95 * len(lat)) - 1] * 1e3


def window_share(rec: dict, r: dict) -> float:
    """The share of a finished request's life (sent to last audio) that lies
    inside the window: the part of its work counted as the window's."""
    if r["failed"] or r["done"] is None:
        return 0.0
    w = rec["window"]
    inside = min(r["done"], w["end"]) - max(r["sent"], w["start"])
    return max(0.0, inside) / max(r["done"] - r["sent"], 1e-9)


def span_mean_ms(rec: dict, name: str) -> float | None:
    s = rec["spans"].get(name)
    if not s or not s["count"]:
        return None
    return s["total_s"] / s["count"] * 1e3


def steps_at(samples: list, t: float) -> float:
    """The runner's decode steps by time `t`, from (time, step count, ...)
    samples. The count grows by a whole block when a block is dispatched;
    the last block dispatched by `t` counts pro rata to the share of a
    typical block's time (the median time between dispatches) elapsed by
    then, each dispatch placed midway between the samples around it. So a
    window's steps are resolved to a part of a block, not to whole ones."""
    jumps, prev = [], None
    for now, steps, *_ in samples:
        if prev is not None and steps > prev[1]:
            jumps.append(((prev[0] + now) / 2, steps - prev[1], steps))
        prev = (now, steps)
    before = [j for j in jumps if j[0] <= t]
    if not before:
        # no dispatch by t: the count before the first one
        return float(samples[0][1]) if samples else 0.0
    t_j, n_j, total = before[-1]
    gaps = [b[0] - a[0] for a, b in zip(jumps, jumps[1:])]
    typical = statistics.median(gaps) if gaps else 0.0
    done = min(1.0, (t - t_j) / typical) if typical > 0 else 1.0
    return total - n_j + n_j * done


def busy_between(rec: dict, a: float, b: float) -> float | None:
    """Seconds of [a, b) (host clock) in which the traced device ran an
    operation; None outside the traced sub-window."""
    tr = rec.get("trace")
    if not tr or not (tr["host_start"] <= a < b <= tr["host_end"]):
        return None
    spans = tr["busy_spans"]
    return float(np.clip(np.minimum(spans[:, 1], b) - np.maximum(spans[:, 0], a), 0, None).sum())


def idle_percent_whole_cycles(rec: dict) -> float | None:
    """The device's idle share between the first and the last request sent
    inside the traced sub-window, in %: in a closed loop of one client that
    spans whole cycles of the client's traffic, so the reading does not
    depend on where in a cycle the sub-window falls."""
    tr = rec.get("trace")
    if not tr:
        return None
    sent = sorted(r["sent"] for r in rec["requests"]
                  if tr["host_start"] <= r["sent"] < tr["host_end"])
    if len(sent) < 2:
        return None
    busy = busy_between(rec, sent[0], sent[-1])
    return None if busy is None else (1 - busy / (sent[-1] - sent[0])) * 100


def decode_step_ms(rec: dict) -> float | None:
    steps = rec["runner"]["steps"]
    return rec["window"]["seconds"] / steps * 1e3 if steps else None


def audio_s_per_s(rec: dict) -> float | None:
    """Seconds of audio served per second of the window: each finished
    request's audio times its `window_share`."""
    audio = sum(r["audio_s"] * window_share(rec, r) for r in rec["requests"])
    return audio / rec["window"]["seconds"] if audio else None


def mfu_percent(rec: dict) -> float | None:
    """The operations of the window's work (each finished request's chunks:
    prompt, decoded tokens and the vocoder over their frames, times its
    `window_share`) over the window's seconds at the bf16 peak, in %."""
    cfg, ops = rec["config"], 0.0
    for r in rec["requests"]:
        share = window_share(rec, r)
        for c in r["chunks"] if share else ():
            ops += share * flops.chunk_gpt_ops(cfg, c["prompt_len"], c["n"])
            ops += share * flops.vocoder_ops(cfg, flops.frames_of(cfg, c["n"]))
    if not ops:
        return None
    return ops / (rec["window"]["seconds"] * flops.PEAK_OPS_PER_S["bf16"]) * 100


def kernel_seconds(rec: dict, pattern: str) -> float:
    tr = rec.get("trace")
    return sum(s for name, s in tr["kernels"].items() if pattern in name) if tr else 0.0


def idle_percent(rec: dict) -> float | None:
    tr = rec.get("trace")
    if not tr or not tr["window_s"]:
        return None
    return (1 - tr["busy_s"] / tr["window_s"]) * 100


def k2_percent(rec: dict) -> float | None:
    """Kernel K2's share of its roofline in the traced sub-window, in %: the
    least time to read the K and V rows that the decode steps in the
    sub-window needed (each active slot's rows at each step; the rows of
    idle slots that K2 reads anyway are not counted), over the device time
    of the K2 kernels (`flash_decode*`) in it. A chunk's tokens are placed
    evenly between its submission and its end. Bound by bytes."""
    tr, cfg = rec.get("trace"), rec["config"]
    seconds = kernel_seconds(rec, "flash_decode")
    if not tr or not seconds:
        return None
    rows = steps = 0
    for r in rec["requests"]:
        for c in r["chunks"]:
            if c["t_done"] is None or c["n"] < 2:
                continue
            t0, span = c["t_submit"], c["t_done"] - c["t_submit"]
            for j in range(1, c["n"]):
                if tr["host_start"] <= t0 + span * j / c["n"] < tr["host_end"]:
                    rows += c["prompt_len"] + j
                    steps += 1
    if not steps:
        return None
    ms, by = flops.bound(flops.decode_attention_bytes(cfg, rows, steps),
                         flops.decode_attention_ops(cfg, rows), "bf16")
    print(f"[k2_roofline] bound by {by}, {steps} slot-steps over {rows} rows, K2 "
          f"{seconds:.6f} s on the device; card {rec['device']['kind']}, power limit "
          f"{rec['device']['power_limit']}", file=sys.stderr)
    return ms / 1e3 / seconds * 100


def k3_rows_percent(rec: dict) -> float | None:
    """Kernel K3's share of its roofline in the traced sub-window for the
    row vocoder, in %: the least time the MRF stages need for the frames of
    the chunks whose decoding ended in the sub-window (each is vocoded whole
    as it ends; a bucket's padding is not counted as needed), over the
    device time of the `mrf_conv*` kernels in it."""
    tr, cfg = rec.get("trace"), rec["config"]
    seconds = kernel_seconds(rec, "mrf_conv")
    if not tr or not seconds:
        return None
    frames = sum(flops.frames_of(cfg, c["n"]) for r in rec["requests"] for c in r["chunks"]
                 if c["t_done"] is not None and tr["host_start"] <= c["t_done"] < tr["host_end"])
    if not frames:
        return None
    ms, by = flops.bound(flops.mrf_bytes(cfg, frames), flops.mrf_ops(cfg, frames), "bf16")
    print(f"[k3_roofline] bound by {by}, {frames} frames of row chunks, K3 {seconds:.6f} s on "
          f"the device; card {rec['device']['kind']}, power limit "
          f"{rec['device']['power_limit']}", file=sys.stderr)
    return ms / 1e3 / seconds * 100


def k3_percent(rec: dict) -> float | None:
    """Kernel K3's share of its roofline in the traced sub-window, in %:
    the least time the MRF stages need for the frames of the audio that
    arrived in the sub-window (each piece vocoded just before it arrived;
    a vocoder window's context frames and a bucket's padding not counted
    as needed), over the device time of the `mrf_conv*` kernels in it."""
    tr, cfg = rec.get("trace"), rec["config"]
    seconds = kernel_seconds(rec, "mrf_conv")
    if not tr or not seconds:
        return None
    frames = sum(n // 256 for r in rec["requests"] for t, n in r["outputs"]
                 if tr["host_start"] <= t < tr["host_end"])
    if not frames:
        return None
    ms, by = flops.bound(flops.mrf_bytes(cfg, frames), flops.mrf_ops(cfg, frames), "bf16")
    print(f"[k3_roofline] bound by {by}, {frames} frames, K3 {seconds:.6f} s on the device; "
          f"card {rec['device']['kind']}, power limit {rec['device']['power_limit']}",
          file=sys.stderr)
    return ms / 1e3 / seconds * 100
