"""The port's tracing (common/tracing.py) on the CPU: the totals against
the JAX original, the timeline (parents, trace ids from the engine through
the runner and the vocoder, off means nothing recorded, ring drops, device
spans resolved through an anchor), the runner's counters against a
brute-force count, the benchmark's timeline readers on a hand-built
record, and the merged chrome trace."""
import asyncio
import contextlib
import dataclasses
import importlib.util
import json
import sys
import threading
import time
from collections import deque
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))
from helpers import build_tiny_tokenizer, sine_wav

from auralis_tpu.common import tracing as jax_tracing
from auralis_tpu_torch import TTS, TTSRequest
from auralis_tpu_torch.common import tracing
from auralis_tpu_torch.common.tracing import Span
from auralis_tpu_torch.frontend.tokenizer import TTSTokenizer
from auralis_tpu_torch.models.xttsv2 import weights as tw
from auralis_tpu_torch.models.xttsv2.config import tiny_test_config
from auralis_tpu_torch.models.xttsv2.engine import XTTSv2Engine
from auralis_tpu_torch.runtime import engine_core as tcore

RUNNER_TURNS = ("decode.handoff", "decode.dispatch", "decode.status_wait", "decode.hooks",
                "decode.snapshots", "decode.harvest", "decode.idle_wait")


@pytest.fixture
def timeline():
    """The timeline on and empty for the test, off and empty after it."""
    tracing.clear()
    tracing.enable()
    yield
    tracing.disable()
    tracing.clear()


def _total(summary: dict, name: str) -> float:
    return summary.get(name, {"total_s": 0.0})["total_s"]


# ------------------------------------------------------------ the totals
@pytest.mark.parametrize("on", [False, True])
def test_totals_match_the_jax_original(on):
    """span, record and profile_summary give the JAX original's summary for
    the same calls, timeline off or on: the recorded entries equal, the
    spans' counts and keys equal."""
    names = {k: f"cmp{int(on)}.{k}" for k in "abc"}
    calls = [("a", 0.25), ("a", 0.5), ("b", 1e-3), ("c", None), ("c", None), ("b", 2.0)]
    if on:
        tracing.enable()
    try:
        for key, seconds in calls:
            for mod in (jax_tracing, tracing):
                if seconds is None:
                    with mod.span(names[key]):
                        pass
                else:
                    mod.record(names[key], seconds)
    finally:
        tracing.disable()
    got = {k: v for k, v in tracing.profile_summary().items() if k in names.values()}
    want = {k: v for k, v in jax_tracing.profile_summary().items() if k in names.values()}
    assert got.keys() == want.keys() == set(names.values())
    for k in "ab":
        assert got[names[k]] == want[names[k]]
    assert got[names["c"]]["count"] == want[names["c"]]["count"] == 2
    assert got[names["c"]].keys() == want[names["c"]].keys()


def test_count_aggregates():
    """A counter's count is its number of events and its total the sum of n;
    it puts nothing on the timeline."""
    tracing.clear()
    tracing.enable()
    try:
        tracing.count("cnt.rows", 3)
        tracing.count("cnt.rows", 40)
        tracing.count("cnt.rows")
        tracing.count("cnt.rows", -2)
    finally:
        tracing.disable()
    s = tracing.profile_summary()["cnt.rows"]
    assert s["count"] == 4 and s["total_s"] == 42
    assert tracing.events() == []


# ------------------------------------------------------------ the timeline
def test_spans_nest_with_parents(timeline):
    """A span is the parent of the spans and intervals made inside it, in
    its thread, in an asyncio task started there and in its to_thread
    worker; attributes and the trace id are kept."""
    tok = tracing.TRACE_ID.set("req_0")
    try:
        with tracing.span("outer"):
            with tracing.span("inner", k=1):
                now = time.perf_counter()
                tracing.interval("mark", now, now)

            async def task():
                with tracing.span("in_task"):
                    await asyncio.to_thread(
                        lambda: tracing.interval("in_thread", time.perf_counter() - 1e-3,
                                                 time.perf_counter(), trace_id="other_1"))

            asyncio.run(task())
    finally:
        tracing.TRACE_ID.reset(tok)
    ev = {e.name: e for e in tracing.events()}
    assert ev["outer"].parent is None
    assert ev["inner"].parent == ev["outer"].id and ev["inner"].attrs == {"k": 1}
    assert ev["mark"].parent == ev["inner"].id and ev["mark"].start_ns == ev["mark"].end_ns
    assert ev["in_task"].parent == ev["outer"].id
    assert ev["in_thread"].parent == ev["in_task"].id
    assert ev["outer"].start_ns <= ev["inner"].start_ns <= ev["inner"].end_ns <= ev["outer"].end_ns
    assert {e.trace_id for n, e in ev.items() if n != "in_thread"} == {"req_0"}
    assert ev["in_thread"].trace_id == "other_1"
    assert not any(e.device for e in ev.values())
    assert len({e.id for e in ev.values()}) == len(ev)


def test_ring_drops_its_oldest_and_counts_them(timeline, monkeypatch):
    monkeypatch.setattr(tracing, "RING_SIZE", 4)
    monkeypatch.setattr(tracing, "_ring", deque(maxlen=4))
    for i in range(6):
        tracing.interval(f"ring.{i}", i, i + 0.5)
    assert tracing.dropped() == 2
    assert [e.name for e in tracing.events()] == [f"ring.{i}" for i in range(2, 6)]
    assert [e.name for e in tracing.events(3.0, 4.2)] == ["ring.3", "ring.4"]


class _FakeEvent:
    """A timing CUDA event on the CPU: records the host clock; the device
    has reached it unless it was recorded on the program's stream after
    `hold_after` (an anchor's own stream has no work)."""
    made = 0
    hold_after = None

    def __init__(self, enable_timing=False):
        assert enable_timing
        _FakeEvent.made += 1
        self.t = self.stream = None

    def record(self, stream=None):
        self.t, self.stream = time.perf_counter_ns(), stream

    def query(self):
        return self.t is not None and (not self.stream.program or self.hold_after is None
                                       or self.t < self.hold_after)

    def elapsed_time(self, other):
        return (other.t - self.t) / 1e6


class _FakeStream:
    def __init__(self, device=None, program=False):
        self.program = program
        self.cuda_stream = 1 if program else 2


PROGRAM_STREAM = _FakeStream(program=True)


@pytest.fixture
def fake_card(monkeypatch):
    """torch.cuda's events and streams stood in for on the CPU; cuda:0."""
    monkeypatch.setattr(_FakeEvent, "hold_after", None)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "Stream", _FakeStream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: PROGRAM_STREAM)
    monkeypatch.setattr(tracing, "_anchor_streams", {})
    monkeypatch.setattr(tracing, "_stream_state", {})
    return torch.device("cuda", 0)


def test_device_span_resolves_through_its_anchor(timeline, fake_card):
    """The card's path with stand-in events: a device span is a pending
    event pair until `resolve()` finds its end reached; then its interval
    (mapped by the anchor), its device total and its counts appear."""
    t0 = time.perf_counter_ns()
    with tracing.device_span("fake.block", fake_card, counts={"fake.steps": 16}, steps=16):
        time.sleep(0.002)
        _FakeEvent.hold_after = time.perf_counter_ns()  # the end is not reached yet
    t1 = time.perf_counter_ns()
    tracing.resolve()
    assert tracing.events() == [] and "fake.block" not in tracing.profile_summary()
    _FakeEvent.hold_after = None
    (s,) = tracing.events()
    assert s.name == "fake.block" and s.device and s.attrs == {"steps": 16}
    assert t0 <= s.start_ns and s.end_ns <= t1 and s.end_ns - s.start_ns >= 2_000_000
    summary = tracing.profile_summary()
    assert summary["fake.steps"]["total_s"] == 16
    assert summary["fake.block"]["count"] == 1
    assert abs(summary["fake.block"]["total_s"] - (s.end_ns - s.start_ns) * 1e-9) < 1e-4


def test_anchor_is_taken_on_its_own_stream_by_age(timeline, fake_card, monkeypatch):
    """An anchor is recorded on a stream of its own, so it never waits for
    the program's work: one is kept until it is ANCHOR_AGE_NS old and then
    taken anew at the next device span, while the program's stream is busy
    too."""
    with tracing.device_span("fake.a", fake_card):
        pass
    first = tracing._anchors[0]
    assert first[0].stream is not PROGRAM_STREAM
    _FakeEvent.hold_after = time.perf_counter_ns()  # the program's stream is busy from here
    with tracing.device_span("fake.b", fake_card):
        pass
    assert tracing._anchors[0] is first
    monkeypatch.setattr(tracing, "ANCHOR_AGE_NS", 0)
    with tracing.device_span("fake.c", fake_card):
        pass
    assert tracing._anchors[0] is not first
    _FakeEvent.hold_after = None
    assert [s.name for s in tracing.events()] == ["fake.a", "fake.b", "fake.c"]


@pytest.mark.parametrize("card", [False, True])
def test_spans_that_share_the_stream_are_marked(timeline, fake_card, card):
    """A device span during which another span on its stream was open, or
    began or ended, is marked shared: kept on the timeline, out of the
    totals and its counts, and counted under tracing.device_shared. Spans
    one after another, in one thread or two, are not."""
    dev = fake_card if card else None
    def totals():
        summary = tracing.profile_summary()
        return [summary.get(k, {"total_s": 0})["total_s"]
                for k in ("tracing.device_shared", "share.n")]

    before = totals()
    with tracing.device_span("share.outer", dev, counts={"share.n": 1}):
        with tracing.device_span("share.inner", dev):
            pass
    inside = threading.Event()
    leave = threading.Event()

    def other():
        with tracing.device_span("share.thread", dev):
            inside.set()
            leave.wait(10)

    worker = threading.Thread(target=other)
    worker.start()
    inside.wait(10)
    with tracing.device_span("share.main", dev):
        pass
    leave.set()
    worker.join(10)
    for name in ("share.after", "share.after2"):
        with tracing.device_span(name, dev, counts={"share.n": 1}):
            pass
    tracing.resolve()
    shared = {s.name: bool((s.attrs or {}).get("shared")) for s in tracing.events()}
    assert shared == {"share.outer": True, "share.inner": True, "share.thread": True,
                      "share.main": True, "share.after": False, "share.after2": False}
    assert [a - b for a, b in zip(totals(), before)] == [4, 2]
    assert not ({"share.outer", "share.inner", "share.thread", "share.main"}
                & tracing.profile_summary().keys())


def test_off_records_nothing_and_makes_no_event(monkeypatch):
    """With the timeline off (no enable(), no profiler), spans, intervals,
    records and device spans put nothing on the timeline and a device span
    on the card makes no CUDA event; a runner serving a chunk records none
    either."""
    tracing.disable()
    tracing.clear()
    monkeypatch.setattr(_FakeEvent, "made", 0)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "Stream", _FakeStream)
    with tracing.span("off.span"):
        tracing.interval("off.interval", 0.0, 1.0)
        tracing.record("off.record", 0.1)
    with tracing.device_span("off.device", torch.device("cuda", 0), counts={"off.n": 1}):
        pass
    engine, prompts = _runner(4, {}, False, seed=2)
    opts = tcore.SamplingOptions(do_sample=False, max_new_tokens=6)
    asyncio.run(_serve(engine, prompts[:2], [opts] * 2))
    assert tracing.events() == [] and not tracing._pending and _FakeEvent.made == 0
    assert "off.device" not in tracing.profile_summary()


# ------------------------------------------------------------ the engine
@pytest.fixture(scope="module")
def tiny_tts(tmp_path_factory):
    cfg = tiny_test_config()
    gpt_np, core_np = tw.random_init(cfg, 0)
    params, core = tw.params_from_numpy(gpt_np, core_np, device="cpu")
    engine = XTTSv2Engine(cfg, cfg.gpt, params=params, core=core, device="cpu",
                          max_concurrency=2, cache_dtype=torch.float32,
                          tokenizer=TTSTokenizer(build_tiny_tokenizer().tokenizer))
    tts = TTS(scheduler_max_concurrency=2).with_engine(engine)
    yield tts, sine_wav(tmp_path_factory.mktemp("voice") / "speaker.wav")
    tts.loop.run_until_complete(tts.shutdown())


def test_trace_id_reaches_runner_and_vocoder_spans(tiny_tts, timeline):
    """Each chunk's id (`{request_id}_{idx}`), set by get_generation_context
    before its decode task starts, tags its generate() interval, its queue
    wait, the insert and every decode block that holds it (the runner's own
    task and its worker thread), the speculative first segment (a young
    block's hook) and the other vocoder batches (the batcher's task and
    threads), and its first audio; the runner's host turns carry none."""
    tts, wav = tiny_tts
    text = "one two three four five six seven hello world. the quick brown fox jumps."
    stream = TTSRequest(text=text, speaker_files=[wav], language="en", stream=True,
                        do_sample=False, temperature=1.0)
    assert list(tts.generate_speech(stream))
    plain = TTSRequest(text="one two three four five", speaker_files=[wav], language="en",
                       do_sample=False, temperature=1.0)
    tts.generate_speech(plain)
    ev = tracing.events()
    chunks = {e.trace_id: e for e in ev if e.name == "decode.chunk"}
    ids = sorted(chunks)
    assert f"{stream.request_id}_0" in ids and f"{plain.request_id}_0" in ids

    def tagged(name, tid):
        return [e for e in ev if e.name == name
                and (e.trace_id == tid or tid in (e.attrs or {}).get("trace_ids", ()))]

    for tid in ids:
        for name in ("decode.queue_wait", "decode.insert_device", "decode.block_device",
                     "phase2.first_audio"):
            assert tagged(name, tid), (name, tid)
        assert any(tagged(f"vocode.device.{k}", tid) for k in ("seg_first", "seg", "row")), tid
        c, (first,) = chunks[tid], tagged("phase2.first_audio", tid)
        assert c.start_ns <= tagged("decode.insert_device", tid)[0].start_ns < first.start_ns
    assert tagged("vocode.device.seg_first", f"{stream.request_id}_0")
    assert tagged("vocode.device.row", f"{plain.request_id}_0")
    assert all(e.device for e in ev if ".device" in e.name or e.name.endswith("_device"))
    turns = [e for e in ev if e.name in RUNNER_TURNS]
    assert {e.name for e in turns} >= {"decode.handoff", "decode.dispatch", "decode.status_wait",
                                       "decode.hooks", "decode.snapshots", "decode.harvest"}
    assert all(e.trace_id is None for e in turns)


# ------------------------------------------------------------ the runner
def _runner(num_slots, flags, bucketing, seed=3):
    """A CPU runner on tiny weights whose stop token never wins, so chunks
    run to their caps, and prompts for it."""
    cfg = dataclasses.replace(tiny_test_config().gpt, **flags)
    p = tw.init_gpt_params(cfg, seed)
    p["mel_head_b"][cfg.stop_audio_token] = -1e4
    engine = tcore.DecodeEngine(tw.tree_to_torch(p, "cpu"), cfg, num_slots=num_slots,
                                cache_dtype=torch.float32, steps_per_sync=4,
                                slot_bucketing=bucketing, device="cpu")
    rng = np.random.default_rng(seed)
    prompts = [tcore.TokenPrompt(
        cond=torch.from_numpy((0.5 * rng.standard_normal(
            (cfg.num_cond_latents, cfg.hidden_size))).astype(np.float32)),
        ids=rng.integers(5, 300, int(rng.integers(3, 30))).astype(np.int64)) for _ in range(8)]
    return engine, prompts


async def _serve(engine, prompts, options):
    tasks = [asyncio.ensure_future(engine.generate(p, o)) for p, o in zip(prompts, options)]
    out = await asyncio.wait_for(asyncio.gather(*tasks), 300)
    await engine.shutdown()
    return out


@pytest.mark.parametrize("body,bucketing", [("dense", False), ("dense", True), ("k2", False),
                                            ("k2", True)])
def test_rows_counters_equal_a_brute_force_count(body, bucketing, monkeypatch):
    """Over a run of 7 chunks on 4 slots (caps inside blocks, refilled
    slots with leftover lengths, and with bucketing slot-bounded blocks
    and migrations), `decode.rows_read` and `decode.rows_live` equal a count
    taken step by step from `state.seq_lens` and `state.active` before each
    step: every stepped slot's rows up to the length bound (dense) or up to
    its length plus the row it appends (K2), and those of active slots.
    The pass counters agree: `blocks` is the number of passes,
    `occupancy_sum` their owned slots, `steps_total` their steps."""
    engine, prompts = _runner(4, {"flash_decode": body == "k2"}, bucketing)
    tally = {"read": 0, "live": 0}
    stepwise_of = tcore.decode_steps_status

    def stepwise(params, cfg, state, n_steps=1, len_bound=None, slot_bound=None, gumbel=None):
        s, t = slot_bound or state.seq_lens.shape[0], state.cache.max_len
        for _ in range(n_steps):
            lens = state.seq_lens[:s].long()
            rows = lens + 1 if body == "k2" else torch.full_like(lens, min(len_bound or t, t))
            tally["read"] += int(rows.sum())
            tally["live"] += int(rows[state.active[:s]].sum())
            out = stepwise_of(params, cfg, state, 1, len_bound, slot_bound)
        return out

    monkeypatch.setattr(tcore, "decode_steps_status", stepwise)
    passes, inner = [], engine._device_pass

    def counted(chunks, n_steps):
        status = inner(chunks, n_steps)
        passes.append((len(engine._slot_owner), n_steps))
        return status

    engine._device_pass = counted
    before = tracing.profile_summary()
    caps = [5, 9, 13, 6, 11, 3, 7]
    out = asyncio.run(_serve(engine, prompts[:7], [
        tcore.SamplingOptions(do_sample=False, max_new_tokens=c) for c in caps]))
    after = tracing.profile_summary()
    assert [n for _, _, n in out] == caps
    assert engine.stats["migrations"] > 0 or not bucketing
    for name, key in (("decode.rows_read", "read"), ("decode.rows_live", "live")):
        assert _total(after, name) - _total(before, name) == tally[key], name
    assert 0 < tally["live"] < tally["read"]
    assert engine.stats["blocks"] == len(passes)
    assert engine.stats["occupancy_sum"] == sum(o for o, _ in passes)
    assert engine.steps_total == engine._steps_total == sum(n for _, n in passes)


def test_cancelling_a_queued_chunk_behind_another():
    """A chunk cancelled while it waits in the queue behind another leaves
    the queue (chunks compare by identity, not by their tensors) and the
    others finish."""
    engine, prompts = _runner(1, {}, False, seed=4)
    opts = tcore.SamplingOptions(do_sample=False, max_new_tokens=5)

    async def go():
        tasks = [asyncio.ensure_future(engine.generate(p, opts)) for p in prompts[:3]]
        while not engine.num_active:  # the runner took the first chunk
            await asyncio.sleep(0)
        assert len(engine._queue) == 2
        tasks[2].cancel()
        res = await asyncio.gather(*tasks, return_exceptions=True)
        await engine.shutdown()
        return res

    res = asyncio.run(go())
    assert isinstance(res[2], asyncio.CancelledError), res[2]
    assert [r[2] for r in res[:2]] == [5, 5]


# ------------------------------------------------------------ the readers
def _reader(name):
    spec = importlib.util.spec_from_file_location(
        f"metric_{name}", ROOT / "portbench" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _s(name, a_ms, b_ms, tid=None, device=False, **attrs):
    """A span from `a_ms` to `b_ms` after 10 s on the timeline's clock."""
    return Span(name, 10_000_000_000 + int(a_ms * 1e6), 10_000_000_000 + int(b_ms * 1e6), 0,
                None, tid, device, attrs or None)


# one streamed chunk, r1_0: its insert, two 16-step blocks with a gap the
# first segment partly fills, the runner's turns around the gap, its first
# audio at 40 ms; a chunk that started before the sub-window; later segments
# of another chunk
TIMELINE = [
    _s("decode.chunk", 0, 200, "r1_0"),
    _s("decode.chunk", -50, 100, "r0_0"),
    _s("phase2.first_audio", -10, -10, "r0_0"),
    _s("decode.insert_device", 1, 3, device=True, trace_ids=["r1_0"]),
    _s("decode.block_device", 3, 30, device=True, steps=16, trace_ids=["r1_0"]),
    _s("decode.status_wait", 10, 32),
    _s("decode.handoff", 32, 36),
    _s("decode.dispatch", 34, 35.5),
    _s("vocode.device.seg_first", 30, 34, device=True, trace_ids=["r1_0"], batch=1),
    _s("decode.block_device", 35, 62, device=True, steps=16, trace_ids=["r1_0"]),
    _s("decode.idle_wait", 70, 90),
    _s("decode.insert_device", 95, 97, device=True, trace_ids=["r2_0"]),
    _s("phase2.first_audio", 40, 40, "r1_0"),
    *[_s("vocode.device.seg", t, t + 2, device=True, trace_ids=["r2_0"], batch=1)
      for t in (110, 120, 130, 140)],
]
# the profile's busy intervals (ms on the timeline's clock): the blocks'
# kernels start 2 ms into their spans (the launch), the first segment's end
# 0.5 ms before its span's end
BUSY_MS = [(1, 3), (5, 30), (30, 33.5), (37, 62), (95, 97), (110, 112), (120, 122),
           (130, 132), (140, 142)]
SPANS = {"decode.block_device": {"count": 2, "total_s": 0.054},
         "decode.block_steps": {"count": 2, "total_s": 32.0},
         "decode.rows_read": {"count": 3, "total_s": 1200.0},
         "decode.rows_live": {"count": 4, "total_s": 300.0},
         "vocode.device.seg_first": {"count": 2, "total_s": 0.009}}


def _rec(spans=SPANS, traced=True):
    rec = {"spans": dict(spans), "window": {"start": 5.0, "end": 11.0, "seconds": 6.0},
           "device": {"kind": "cpu", "power_limit": None}}
    busy = np.asarray(BUSY_MS, np.float64) * 1e-3 + 10.0
    rec["trace"] = ({"host_start": 10.0, "host_end": 11.0, "window_s": 1.0, "busy_s": 0.06,
                     "busy_spans": busy} if traced else None)
    return rec


def test_readers_on_a_hand_built_record(monkeypatch, capsys):
    seen = []

    def events(t0=None, t1=None):
        seen.append((t0, t1))
        return list(TIMELINE)

    monkeypatch.setattr(tracing, "events", events)
    want = {"decode_device_ms.narrator": 54 / 32, "useful_rows.narrator": 25.0,
            "first_seg_device_ms.single": 4.5,
            # one gap, 30 -> 35 ms, 4 ms of it under the first segment
            "dispatch_gap_ms.single": 1.0}
    for name, value in want.items():
        assert _reader(name)(_rec()) == pytest.approx(value, rel=1e-9), name
    assert set(seen) == {(10.0, 11.0)}
    err = capsys.readouterr().err
    assert "hand-off 1.000 ms (1)" in err and "idle share of the sub-window 93.00%" in err
    assert "inside the program's device spans: decode.block_device 4.000 ms" in err
    # nothing to read: no spans, an untraced run, a program without the timeline
    for name in want:
        assert _reader(name)(_rec(spans={}, traced=False)) is None, name
    monkeypatch.delattr(tracing, "events")
    assert _reader("dispatch_gap_ms.single")(_rec()) is None


def test_busy_covers_an_interval():
    """Busy.covered against a brute-force sum over its intervals."""
    from portbench.timeline import Busy

    rng = np.random.default_rng(3)
    edges = np.sort(rng.choice(10_000, 40, replace=False))
    busy = Busy(edges.reshape(-1, 2))
    for a, b in rng.integers(-100, 10_100, (200, 2)):
        want = sum(max(0, min(t, b) - max(s, a)) for s, t in edges.reshape(-1, 2))
        assert busy.covered(int(a), int(b)) == want


# ------------------------------------------------------------ trace()
def test_trace_file_merges_program_spans_on_the_profiler_clock(tmp_path):
    """trace() writes one chrome trace with the profiler's events and the
    program's spans; a span around an aten op encloses the op's interval
    there, and the timeline is off again after it."""
    x = torch.randn(256, 256)
    torch.mm(x, x)
    tracing.disable()
    with tracing.trace(str(tmp_path)):
        assert tracing.recording()
        with tracing.span("probe"):
            torch.mm(x, x)
    assert not tracing.recording()
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    (probe,) = [e for e in events if e.get("cat") == "auralis" and e["name"] == "probe"]
    mm = [e for e in events if e.get("name") == "aten::mm"]
    assert len(mm) == 1 and probe["tid"] == "host"
    assert probe["ts"] <= mm[0]["ts"] and mm[0]["ts"] + mm[0]["dur"] <= probe["ts"] + probe["dur"]
