"""Streaming synthesis on the tiny config: the port's segment and
first-segment vocoders, its vocode batcher, the speculative first segment,
the runner's young blocks and snapshots, and TTS.warmup().

The JAX engine (its CPU path, vocoder in f32) and the port's engine are
built from the same parameters; both vocoders run in f32 and ship 16-bit
PCM. Within the port, the segments and the batched rows must reproduce the
full-row vocoder exactly, as the JAX package guarantees for its own
(tests/unit/test_streaming_vocoder.py)."""
import asyncio
import dataclasses
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from helpers import build_tiny_engine, sine_wav

from auralis_tpu import TTS as JaxTTS
from auralis_tpu import TTSRequest as JaxRequest
import auralis_tpu_torch.models.xttsv2.engine as em
from auralis_tpu_torch import TTS, TTSRequest
from auralis_tpu_torch.frontend.tokenizer import TTSTokenizer
from auralis_tpu_torch.models.xttsv2.engine import (
    FIRST_SEG_PF,
    PAD_PF,
    SEG_PF,
    XTTSv2Engine,
    _VocodeBatcher,
)
from auralis_tpu_torch.models.xttsv2.weights import params_from_numpy
from auralis_tpu_torch.runtime.engine_core import SamplingOptions

# Across the two packages the f32 waveforms agree to ~1e-7, but rounding to
# 16-bit PCM can land a sample one step apart (as in test_torch_slice.py:
# here on up to 0.009% of the samples); within the port the comparisons are
# exact.
TEXT = "one two three four five six seven hello world"


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    jax_engine = build_tiny_engine(max_concurrency=2, vocoder_dtype=None)
    params, core = params_from_numpy(jax.device_get(jax_engine.params),
                                     jax.device_get(jax_engine.core), device="cpu")
    gpt_cfg = dataclasses.replace(jax_engine.gpt_config, flash_decode=True, prefill_flash=True)
    torch_engine = XTTSv2Engine(
        jax_engine.hifi_config, gpt_cfg, params=params, core=core,
        tokenizer=TTSTokenizer(jax_engine.tokenizer.tokenizer), max_concurrency=2,
        cache_dtype=torch.float32, vocoder_dtype=torch.float32, device="cpu",
    )
    jax_tts = JaxTTS(scheduler_max_concurrency=2).with_engine(jax_engine)
    torch_tts = TTS(scheduler_max_concurrency=2).with_engine(torch_engine)
    wav = sine_wav(tmp_path_factory.mktemp("voice") / "speaker.wav")
    yield jax_tts, torch_tts, wav
    jax_tts.loop.run_until_complete(jax_tts.shutdown())
    torch_tts.loop.run_until_complete(torch_tts.shutdown())


def _rows(engine, b, seed):
    rng = np.random.default_rng(seed)
    g = engine.gpt_config
    rows = rng.standard_normal((b, g.max_audio_tokens, g.hidden_size)).astype(np.float32)
    gs = [rng.standard_normal((1, 512)).astype(np.float32) * 0.1 for _ in range(b)]
    return rows, gs


def _pcm_close(got, want, what):
    """int16 PCM of the port against the JAX package: at most one step
    apart, on at most 1% of the samples."""
    got, want = np.asarray(got, np.int32), np.asarray(want, np.int32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    diff = np.abs(got - want)
    assert diff.max() <= 1, (what, diff.max())
    assert (diff > 0).mean() <= 0.01, (what, (diff > 0).mean())


# --------------------------------------------------------------- vocoders
def test_segment_vocoders_match_jax(engines):
    """_vocode_seg (segment windows, one start clamped at _bucket_pf -
    window) and _vocode_seg_first against the JAX engine's jitted programs
    on the same rows, n and d-vectors."""
    jax_tts, torch_tts, _ = engines
    je, te = jax_tts.tts_engine, torch_tts.tts_engine
    rows, gs = _rows(te, 3, seed=1)
    t_max = te.gpt_config.max_audio_tokens
    ns = [t_max - 5, 17, t_max]
    slice_len = PAD_PF + SEG_PF + PAD_PF
    starts = [0, 40, te._bucket_pf - slice_len]
    assert te._bucket_pf == je._bucket_pf
    assert te._seg_slice_start(10_000) == je._seg_slice_start(10_000) == starts[2]
    g_j = jnp.asarray(np.concatenate(gs))
    want = np.asarray(je._vocode_seg_fn()(
        je.core["hifigan"], jnp.asarray(rows), jnp.asarray(ns, jnp.int32),
        jnp.asarray(starts, jnp.int32), g_j))
    got = te._vocode_seg(torch.from_numpy(rows), ns, starts, gs).numpy()
    _pcm_close(got, want, "seg")
    want = np.asarray(je._vocode_seg_first_fn()(
        je.core["hifigan"], jnp.asarray(rows), jnp.asarray(ns, jnp.int32), g_j))
    got = te._vocode_seg_first(torch.from_numpy(rows), ns, gs).numpy()
    assert got.shape[1] == (FIRST_SEG_PF + PAD_PF) * 256
    _pcm_close(got, want, "seg_first")


def test_segment_assembly_matches_full_row(engines):
    """FIRST_SEG_PF, SEG_PF, ... segments concatenated equal the port's
    full-row vocoder (the first through the first-segment vocoder, as the
    speculative path emits it)."""
    _, torch_tts, _ = engines
    te = torch_tts.tts_engine
    rows, gs = _rows(te, 1, seed=3)
    row = torch.from_numpy(rows[0])
    n = te.gpt_config.max_audio_tokens - 5
    full = te.vocode_device_row(row, n, gs[0])
    total_pf = te._total_pf(n)
    assert total_pf * 256 == len(full)
    first = te._vocode_seg_first(row[None], [n], gs).numpy()[0, : FIRST_SEG_PF * 256] / 32767.0
    pieces, start = [first], FIRST_SEG_PF
    while start < total_pf:
        emit = min(SEG_PF, total_pf - start)
        pieces.append(te._vocode_segment(row, n, start, emit, gs[0]))
        start += emit
    assert len(pieces) >= 2
    np.testing.assert_allclose(np.concatenate(pieces), full, rtol=1e-5, atol=1e-5)
    # the first segment through the generic segment vocoder is the same
    np.testing.assert_array_equal(te._vocode_segment(row, n, 0, FIRST_SEG_PF, gs[0]),
                                  pieces[0].astype(np.float32))


def test_batched_row_vocoder_equals_rows_alone_and_jax(engines):
    """Three rows of different n in one batch (padded to the bucket of the
    largest n) against each row alone: equal; and against the JAX engine's
    batched row program: within one PCM step."""
    jax_tts, torch_tts, _ = engines
    je, te = jax_tts.tts_engine, torch_tts.tts_engine
    rows, gs = _rows(te, 3, seed=5)
    t_max = te.gpt_config.max_audio_tokens
    ns = [t_max, 9, 20]
    batch = te._vocode_rows(torch.from_numpy(rows), ns, gs)
    for i, n in enumerate(ns):
        alone = te.vocode_device_row(torch.from_numpy(rows[i]), n, gs[i])
        assert batch[i].shape == (te._true_wav_len(n),)
        np.testing.assert_array_equal(batch[i], alone)
    want = np.asarray(je._vocode_row_fn(je.row_bucket(max(ns)))(
        je.core["hifigan"], jnp.asarray(rows), jnp.asarray(ns, jnp.int32),
        jnp.asarray(np.concatenate(gs))))
    for i, n in enumerate(ns):
        _pcm_close(np.round(batch[i] * 32767), want[i, : te._true_wav_len(n)], f"row {i}")


def test_seg_first_burst_of_six_flies_as_one_batch(engines, monkeypatch):
    """Six first segments submitted together go out as one batch (cap 8),
    and each lane equals its solo submit."""
    _, torch_tts, _ = engines
    te = torch_tts.tts_engine
    rows, gs = _rows(te, 6, seed=7)
    items = [(torch.from_numpy(rows[i]), min(8 + i, te.gpt_config.max_audio_tokens), gs[i])
             for i in range(6)]
    flights = []
    orig = _VocodeBatcher._run_batch

    def recording(self, kind, batch_items, *rest):
        flights.append(len(batch_items))
        return orig(self, kind, batch_items, *rest)

    monkeypatch.setattr(_VocodeBatcher, "_run_batch", recording)
    batcher = te._vocode_batcher

    async def burst():
        return await asyncio.gather(*(batcher.submit("seg_first", it) for it in items))

    wavs = asyncio.run(burst())
    assert flights == [6], flights
    for it, got in zip(items, wavs):
        ref = asyncio.run(batcher.submit("seg_first", it))
        assert got.shape == ref.shape == (FIRST_SEG_PF * 256,)
        np.testing.assert_array_equal(got, ref)


def test_batcher_failure_reaches_every_waiter(engines, monkeypatch):
    _, torch_tts, _ = engines
    te = torch_tts.tts_engine
    rows, gs = _rows(te, 2, seed=9)

    def boom(self, kind, items, *rest):
        raise RuntimeError("synthetic vocoder failure")

    monkeypatch.setattr(_VocodeBatcher, "_run_batch", boom)

    async def go():
        return await asyncio.gather(
            *(te._vocode_batcher.submit("row", (torch.from_numpy(rows[i]), 5, gs[i]))
              for i in range(2)), return_exceptions=True)

    out = asyncio.run(go())
    assert all(isinstance(e, RuntimeError) for e in out), out


# ----------------------------------------------------------- young blocks
YOUNG_TABLES = [  # (slot -> (streaming?, steps_at_insert)), steps_total
    ({0: (True, 0)}, 0),
    ({0: (True, 0)}, 63),
    ({0: (True, 0)}, 64),
    ({0: (False, 0), 1: (True, 40)}, 90),
    ({0: (False, 0), 1: (True, 10)}, 90),
    ({0: (False, 0), 2: (False, 5)}, 3),
]


@pytest.mark.parametrize("table", YOUNG_TABLES)
def test_young_block_decision_matches_jax(engines, table):
    """stream_block_steps equals the JAX engine's, and _block_steps() picks
    the young or the steady block as the JAX runner does for the same
    owners and step counts."""
    jax_tts, torch_tts, _ = engines
    jd, td = jax_tts.tts_engine.decode_engine, torch_tts.tts_engine.decode_engine
    assert td.stream_block_steps == jd.stream_block_steps
    assert (td.STREAM_BLOCK_STEPS, td.STREAM_YOUNG_STEPS) == (
        jd.STREAM_BLOCK_STEPS, jd.STREAM_YOUNG_STEPS)
    owners, steps_total = table
    got = []
    for de in (jd, td):
        saved = (de._slot_owner, de._slot_meta, de._steps_total)
        de._slot_owner = {s: dataclasses.make_dataclass("P", ["stream_queue"])(
            asyncio.Queue() if streaming else None) for s, (streaming, _) in owners.items()}
        de._slot_meta = {s: {"prompt_len": 20, "steps_at_insert": at}
                         for s, (_, at) in owners.items()}
        de._steps_total = steps_total
        try:
            got.append(de._block_steps())
        finally:
            de._slot_owner, de._slot_meta, de._steps_total = saved
    assert got[0] == got[1], got


# --------------------------------------------------------------- streaming
def _req(cls, wav, text=TEXT, **kw):
    return cls(text=text, speaker_files=[wav], language="en", do_sample=False,
               temperature=1.0, **kw)


def test_greedy_stream_matches_nonstreaming_and_jax(engines):
    """Greedy: the port's streamed segments concatenate to its non-streaming
    waveform exactly, in at least two segments, and to the JAX package's
    streamed concatenation within one PCM step."""
    jax_tts, torch_tts, wav = engines
    full = torch_tts.generate_speech(_req(TTSRequest, wav))
    chunks = list(torch_tts.generate_speech(_req(TTSRequest, wav, stream=True)))
    assert len(chunks) >= 2
    streamed = np.concatenate([c.array for c in chunks])
    np.testing.assert_array_equal(streamed, full.array)
    want = np.concatenate([c.array for c in jax_tts.generate_speech(
        _req(JaxRequest, wav, stream=True))])
    _pcm_close(np.round(streamed * 32767), np.round(want * 32767), "stream vs JAX")


def _stream(tts, wav, text=TEXT):
    chunks = list(tts.generate_speech(_req(TTSRequest, wav, text=text, stream=True)))
    return np.concatenate([c.array for c in chunks]), chunks


def test_spec_first_segment_fires_and_matches_normal_path(engines, monkeypatch):
    _, torch_tts, wav = engines
    fired = {"launched": 0}
    orig_hook = em._SpecFirstSeg.hook

    def counting_hook(self, row, n):
        r = orig_hook(self, row, n)
        fired["launched"] += int(r)
        return r

    monkeypatch.setattr(em._SpecFirstSeg, "hook", counting_hook)
    spec_wave, spec_chunks = _stream(torch_tts, wav)
    assert fired["launched"] >= 1, "the speculative first segment never launched"
    # the hook claims done without launching: the normal path only
    monkeypatch.setattr(em._SpecFirstSeg, "hook", lambda self, row, n: True)
    normal_wave, normal_chunks = _stream(torch_tts, wav)
    np.testing.assert_array_equal(spec_wave, normal_wave)
    assert len(spec_chunks[0].array) == FIRST_SEG_PF * 256
    assert len(spec_chunks[0].array) <= len(normal_chunks[0].array)


def test_spec_claim_past_the_stop_is_discarded(engines, monkeypatch):
    """A claim no snapshot can confirm is discarded at the final snapshot
    and the stream still equals the normal path."""
    _, torch_tts, wav = engines
    orig_hook = em._SpecFirstSeg.hook
    monkeypatch.setattr(em._SpecFirstSeg, "hook",
                        lambda self, row, n: orig_hook(self, row, n + 10_000))
    inflated, _ = _stream(torch_tts, wav)
    monkeypatch.setattr(em._SpecFirstSeg, "hook", lambda self, row, n: True)
    normal, _ = _stream(torch_tts, wav)
    np.testing.assert_array_equal(inflated, normal)


async def _wait_until(pred, timeout=30.0):
    t0 = time.monotonic()
    while not pred():
        assert time.monotonic() - t0 < timeout, "timed out"
        await asyncio.sleep(0.01)


def test_abandoned_stream_releases_its_slot(engines):
    """Closing a stream after its first segment stops the decode (the slot
    is released) and the engine serves the next request."""
    _, torch_tts, wav = engines
    de = torch_tts.tts_engine.decode_engine
    text = "hello world this is a test of speech. the quick brown fox jumps over the dog. " * 3
    stream = torch_tts.generate_speech(TTSRequest(text=text, speaker_files=[wav],
                                                  language="en", stream=True))
    first = next(stream)
    assert len(first.array) > 0
    stream.close()
    torch_tts.loop.run_until_complete(
        _wait_until(lambda: de.num_active == 0 and not de._queue))
    assert not de.state.active.any()
    out = torch_tts.generate_speech(TTSRequest(text="hello world.", speaker_files=[wav],
                                               language="en"))
    assert len(out.array) > 0


def test_streaming_decode_failure_propagates(engines, monkeypatch):
    """A decode failure before the runner owns the chunk reaches the stream's
    consumer instead of hanging it."""
    _, torch_tts, wav = engines

    async def boom(*a, **kw):
        raise RuntimeError("synthetic decode failure")

    monkeypatch.setattr(torch_tts.tts_engine.decode_engine, "generate", boom)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="synthetic decode failure"):
        list(torch_tts.generate_speech(_req(TTSRequest, wav, stream=True)))
    assert time.monotonic() - t0 < 60


def test_runner_crash_poisons_the_stream(engines, monkeypatch):
    """A runner crash mid-stream sends the poison sentinel: the consumer
    raises the runner's error."""
    _, torch_tts, wav = engines
    de = torch_tts.tts_engine.decode_engine
    calls = {"n": 0}
    orig = type(de)._device_pass

    def crash_on_second(self, *a, **kw):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("synthetic runner failure")
        return orig(self, *a, **kw)

    monkeypatch.setattr(type(de), "_device_pass", crash_on_second)
    with pytest.raises(RuntimeError, match="synthetic runner failure"):
        list(torch_tts.generate_speech(_req(TTSRequest, wav, stream=True)))
    assert de.num_active == 0


def test_snapshot_rows_are_independent_copies(engines):
    """A snapshot's latent row stays unchanged after its slot is released
    and refilled by another request, which writes that slot's latents."""
    _, torch_tts, _ = engines
    te = torch_tts.tts_engine
    de = te.decode_engine
    rng = np.random.default_rng(11)
    cond = te._cond_device(rng.standard_normal((1, 8, 64)).astype(np.float32))
    prompt_a = te._build_prompt(cond, rng.integers(5, 300, 12).tolist())
    prompt_b = te._build_prompt(cond, rng.integers(5, 300, 20).tolist())
    greedy = SamplingOptions(do_sample=False)

    async def go():
        queue = asyncio.Queue()
        task = asyncio.ensure_future(de.generate(prompt_a, greedy, stream_queue=queue))
        row, n, final = await asyncio.wait_for(queue.get(), 60)
        assert not final and n > 0
        slot = next(s for s, p in de._slot_owner.items() if p.stream_queue is queue)
        kept = row.clone()
        task.cancel()
        await _wait_until(lambda: de.num_active == 0)
        # the freed slot is the lowest free one: the next request takes it
        refill = asyncio.ensure_future(de.generate(prompt_b, greedy))
        await _wait_until(lambda: de._slot_owner.get(slot) is not None or refill.done())
        _, row_b, n_b = await refill
        return row, kept, row_b, n_b, slot

    row, kept, row_b, n_b, slot = torch_tts.loop.run_until_complete(go())
    assert n_b > 0 and not torch.equal(row_b[:n_b], kept[:n_b])  # the slot was rewritten
    assert torch.equal(row, kept)


def test_cancel_generation_handle_takes_stream_tuples(engines):
    _, torch_tts, wav = engines
    te = torch_tts.tts_engine

    async def go():
        handles, *_ = await te.get_generation_context(_req(TTSRequest, wav, stream=True))
        assert all(isinstance(h, tuple) and len(h) == 3 for h in handles)
        for h in handles:
            te.cancel_generation_handle(h)
        await asyncio.sleep(0)
        await _wait_until(lambda: te.decode_engine.num_active == 0)
        return handles

    handles = torch_tts.loop.run_until_complete(go())
    assert all(h[0].cancelled() for h in handles)


def test_warmup_completes(engines):
    """TTS.warmup() ends with a streaming request, which the port serves."""
    _, torch_tts, _ = engines
    torch_tts.warmup(text="Hello world.")
    assert torch_tts.tts_engine.decode_engine.num_active == 0


# ---------------------------------------------------- generator GEMM convs
@pytest.mark.parametrize("kind,k,stride", [("conv", 7, 1), ("up", 16, 8), ("up", 4, 2)])
def test_generator_gemm_convs_equal_torch_convs(kind, k, stride):
    """conv_pre/conv_post and the transposed upsamples as fixed-row GEMMs
    against F.conv1d / F.conv_transpose1d, in f64 (the JAX layouts: [K, I, O],
    transposed kernels stored flipped)."""
    from auralis_tpu_torch.models.xttsv2 import hifigan as H

    gen = torch.Generator().manual_seed(k)
    x = torch.randn((2, 37, 16), generator=gen, dtype=torch.float64)
    w = torch.randn((k, 16, 8), generator=gen, dtype=torch.float64)
    b = torch.randn((8,), generator=gen, dtype=torch.float64)
    if kind == "conv":
        got = H._conv1d(x, w, b, padding=3)
        want = torch.nn.functional.conv1d(x.transpose(1, 2), w.permute(2, 1, 0), b, padding=3)
    else:
        pad = (k - stride) // 2
        got = H._conv_transpose1d(x, w, b, stride=stride, padding=pad)
        want = torch.nn.functional.conv_transpose1d(
            x.transpose(1, 2), w.permute(1, 2, 0).flip(-1), b, stride=stride, padding=pad)
    np.testing.assert_allclose(got.numpy(), want.transpose(1, 2).numpy(), rtol=1e-12, atol=1e-12)


def test_generator_gemm_shapes_fixed_per_layer(engines, monkeypatch):
    """Every GEMM the generator issues has a shape set by its layer alone,
    whatever the window length and the batch: the property that keeps the
    card's streamed segments and batched rows equal to the full row (the
    CPU's own convs would not show a difference)."""
    _, torch_tts, _ = engines
    te = torch_tts.tts_engine
    shapes, mm = [], torch.mm

    def recording(a, b):
        shapes.append((tuple(a.shape), tuple(b.shape)))
        return mm(a, b)

    monkeypatch.setattr(torch, "mm", recording)
    seen = []
    for b, frames in ((1, FIRST_SEG_PF + PAD_PF), (3, PAD_PF + SEG_PF + PAD_PF), (2, 139)):
        del shapes[:]
        z = torch.randn((b, te.gpt_config.hidden_size, frames))
        te._generate(z, torch.zeros((b, 512)))
        seen.append(set(shapes))
    assert seen[0] == seen[1] == seen[2] and len(seen[0]) == 6, seen
