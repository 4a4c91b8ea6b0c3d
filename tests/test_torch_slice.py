"""The whole slice on the tiny config: the JAX engine (its dense CPU path)
and the torch engine built from the same parameters answer the same greedy
requests — through the engines' phase-1/phase-2 API and through both TTS
facades, one request sync and two concurrently. Tokens must match exactly;
waveforms match to the 16-bit PCM both engines emit.

The torch engine runs the slice's configuration (prefill_flash and
flash_decode on), so every kernel wrapper is on the path (plain versions on
CPU). Both vocoders run in f32."""
import asyncio
import dataclasses
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from helpers import build_tiny_engine, sine_wav

from auralis_tpu import TTS as JaxTTS
from auralis_tpu import TTSRequest as JaxRequest
from auralis_tpu_torch import TTS, TTSRequest
from auralis_tpu_torch.frontend.tokenizer import TTSTokenizer
from auralis_tpu_torch.models.xttsv2.engine import XTTSv2Engine
from auralis_tpu_torch.models.xttsv2.weights import params_from_numpy

TEXTS = ("Hello world. This is a test.", "one two three four", "the quick brown fox")
# both engines ship 16-bit PCM: latents agree to f32 noise, so a sample may
# land one or two PCM steps apart after rounding
PCM_TOL = 2.5 / 32767


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


def _req(cls, wav, text, **kw):
    return cls(text=text, speaker_files=[wav], language="en", do_sample=False, **kw)


async def _tokens(engine, req):
    """Phase 1 + the decode futures: per-chunk (tokens, n)."""
    handles, _, spk, cond = await engine.get_generation_context(req)
    out = []
    for h in handles:
        tokens, _row, n = await (h[0] if isinstance(h, tuple) else h)
        out.append((np.asarray(tokens), n))
    return out, np.asarray(spk), np.asarray(cond)


def test_conditioning_and_tokens_match(engines):
    jax_tts, torch_tts, wav = engines

    async def two(tts, cls):
        return await asyncio.gather(*(_tokens(tts.tts_engine, _req(cls, wav, t))
                                      for t in TEXTS[:2]))

    want = jax_tts.loop.run_until_complete(two(jax_tts, JaxRequest))
    got = torch_tts.loop.run_until_complete(two(torch_tts, TTSRequest))
    for (wt, ws, wc), (gt, gs, gc) in zip(want, got):
        np.testing.assert_allclose(gs, ws, atol=1e-5)  # L2-normalized d-vector
        np.testing.assert_allclose(gc, wc, atol=1e-4)  # perceiver latents, O(1)
        assert len(wt) == len(gt)
        for (ta, na), (tb, nb) in zip(wt, gt):
            assert na == nb
            np.testing.assert_array_equal(tb, ta)


def test_facade_sync_request_matches(engines):
    jax_tts, torch_tts, wav = engines
    want = jax_tts.generate_speech(_req(JaxRequest, wav, TEXTS[0]))
    got = torch_tts.generate_speech(_req(TTSRequest, wav, TEXTS[0]))
    assert got.sample_rate == want.sample_rate == 24000
    assert got.array.shape == want.array.shape and got.array.size > 0
    assert np.isfinite(got.array).all()
    np.testing.assert_allclose(got.array, want.array, rtol=0, atol=PCM_TOL)


def test_facade_concurrent_requests_match(engines):
    jax_tts, torch_tts, wav = engines

    async def two(tts, cls):
        return await asyncio.gather(*(tts.generate_speech_async(_req(cls, wav, t))
                                      for t in TEXTS[1:]))

    want = jax_tts.loop.run_until_complete(two(jax_tts, JaxRequest))
    got = torch_tts.loop.run_until_complete(two(torch_tts, TTSRequest))
    for w, g in zip(want, got):
        assert g.array.shape == w.array.shape and g.array.size > 0
        np.testing.assert_allclose(g.array, w.array, rtol=0, atol=PCM_TOL)


def test_vocode_matches(engines):
    """The host-latents vocoder entry point (no PCM rounding) in f32."""
    jax_tts, torch_tts, _ = engines
    rng = np.random.default_rng(3)
    lat = rng.standard_normal((13, 64)).astype(np.float32)
    g = rng.standard_normal((1, 512)).astype(np.float32)
    want = jax_tts.tts_engine.vocode(lat, g)
    got = torch_tts.tts_engine.vocode(lat, g)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)  # tanh output, f32 convs


def test_cancelled_request_releases_its_slot(engines):
    _, torch_tts, wav = engines
    engine = torch_tts.tts_engine

    async def go():
        handles, *_ = await engine.get_generation_context(_req(TTSRequest, wav, TEXTS[0]))
        for _ in range(500):  # until the runner has inserted the chunk into a slot
            if engine.decode_engine.num_active:
                break
            await asyncio.sleep(0.002)
        assert engine.decode_engine.num_active == 1 and not handles[0].done()
        for h in handles:
            engine.cancel_generation_handle(h)
        await asyncio.gather(*handles, return_exceptions=True)
        for _ in range(200):  # the runner releases cancelled slots on its next pass
            if engine.decode_engine.num_active == 0:
                break
            await asyncio.sleep(0.01)
        return handles

    steps = engine.decode_engine.steps_per_sync
    engine.decode_engine.steps_per_sync = 1  # one step per block: the chunk stays live
    try:
        handles = torch_tts.loop.run_until_complete(go())
    finally:
        engine.decode_engine.steps_per_sync = steps
    assert all(h.cancelled() for h in handles)
    assert engine.decode_engine.num_active == 0
    assert not engine.decode_engine.state.active.any()


def test_unported_paths_raise(engines):
    """Tensor parallelism (ROADMAP.md, queue 1 item 10) is the engine's
    unported path: it raises. Checkpoint loading is ported: the registry's
    "xtts" factory reaches from_pretrained, which looks for the root's
    config.json (tests/test_torch_checkpoint.py loads real artifacts)."""
    _, torch_tts, _ = engines
    eng = torch_tts.tts_engine
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        XTTSv2Engine(eng.hifi_config, eng.gpt_config, params=eng.params, core=eng.core,
                     max_concurrency=1, device="cpu", tensor_parallel_size=2)
    from auralis_tpu_torch.models.registry import get_model_factory

    with pytest.raises(FileNotFoundError, match="config.json"):
        get_model_factory("xtts")("/nonexistent")


def test_runner_stress_concurrent_submits_and_cancels(engines):
    """More chunks than slots, a third of them cancelled mid-flight, with a
    short thread switch interval: the runner's worker thread and the event
    loop share the decode state. Every surviving chunk must resolve, and no
    slot may leak."""
    _, torch_tts, _ = engines
    engine = torch_tts.tts_engine
    de = engine.decode_engine
    rng = np.random.default_rng(0)
    cond = engine._cond_device(rng.standard_normal((1, 8, 64)).astype(np.float32))
    prompts = [engine._build_prompt(cond, rng.integers(5, 300, int(rng.integers(1, 30))).tolist())
               for _ in range(12)]

    async def go():
        tasks = [asyncio.ensure_future(de.generate(p)) for p in prompts]
        for i, t in enumerate(tasks):
            if i % 3 == 0:
                await asyncio.sleep(0.001 * i)
                t.cancel()
        results = await asyncio.wait_for(asyncio.gather(*tasks, return_exceptions=True), 120)
        for _ in range(200):
            if de.num_active == 0:
                break
            await asyncio.sleep(0.01)
        return tasks, results

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        tasks, results = torch_tts.loop.run_until_complete(go())
    finally:
        sys.setswitchinterval(interval)
    for i, (t, r) in enumerate(zip(tasks, results)):
        if i % 3:
            tokens, row, n = r
            assert 1 <= n <= engine.gpt_config.max_audio_tokens and len(tokens) <= n
        else:
            assert t.cancelled() or isinstance(r, tuple)  # may finish before the cancel
    assert de.num_active == 0 and not de._queue
    assert not de.state.active.any()
