"""Data-parallel replica serving (auralis_tpu_torch/parallel/replica.py) on
the CPU: two replicas of the tiny engine on one device, as chip_smoke.py's
phase 7a runs two on one card, against one engine alone and against the JAX
package's replicated engine on its virtual CPU mesh (same numpy weights,
greedy requests). Routing, truncation, forwarding and the facade's
`data_parallel_replicas` are held directly. Each tolerance is stated where
it is asserted."""
import asyncio
import dataclasses
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from helpers import build_tiny_engine, sine_wav
from test_torch_checkpoint import convert_tiny

from auralis_tpu import TTS as JaxTTS
from auralis_tpu import TTSRequest as JaxRequest
from auralis_tpu.parallel.replica import ReplicatedTTSEngine as JaxReplicated
from auralis_tpu_torch import TTS, TTSRequest
from auralis_tpu_torch.frontend.tokenizer import TTSTokenizer
from auralis_tpu_torch.models.xttsv2.engine import XTTSv2Engine
from auralis_tpu_torch.models.xttsv2.weights import params_from_numpy
from auralis_tpu_torch.parallel import replica as treplica
from auralis_tpu_torch.parallel.replica import ReplicatedTTSEngine

CPU = torch.device("cpu")
# both engines ship 16-bit PCM from latents that agree to f32 noise: a
# sample may land one or two PCM steps apart (tests/test_torch_slice.py)
PCM_TOL = 2.5 / 32767


@pytest.fixture(scope="module")
def replicated(tmp_path_factory):
    jax_donor = build_tiny_engine(max_concurrency=2, vocoder_dtype=None)
    params, core = params_from_numpy(jax.device_get(jax_donor.params),
                                     jax.device_get(jax_donor.core), device="cpu")
    gpt_cfg = dataclasses.replace(jax_donor.gpt_config, flash_decode=True, prefill_flash=True)
    donor = XTTSv2Engine(
        jax_donor.hifi_config, gpt_cfg, params=params, core=core,
        tokenizer=TTSTokenizer(jax_donor.tokenizer.tokenizer), max_concurrency=2,
        cache_dtype=torch.float32, vocoder_dtype=torch.float32, device="cpu")
    engine = ReplicatedTTSEngine.from_engine(donor, devices=[CPU, CPU])
    tts = TTS(scheduler_max_concurrency=4).with_engine(engine)
    jax_engine = JaxReplicated.from_engine(jax_donor, devices=jax.devices()[:2])
    jax_tts = JaxTTS(scheduler_max_concurrency=4).with_engine(jax_engine)
    wav = sine_wav(tmp_path_factory.mktemp("voice") / "spk.wav")
    yield tts, engine, jax_tts, wav
    tts.loop.run_until_complete(tts.shutdown())
    jax_tts.loop.run_until_complete(jax_tts.shutdown())


def _req(wav_path, cls=TTSRequest, **kw):
    return cls(text="hello world this is a test", speaker_files=[wav_path], language="en",
               **kw)


def test_replicas_share_weights_on_one_device(replicated):
    """The JAX test's distinct devices become one CPU here: replica 1
    shares the donor's weight tensors (a device_put to the same device
    copies nothing) and owns its decode state, its runner and its program
    caches."""
    _, engine, _, _ = replicated
    donor, rep = engine.engines
    assert len(engine.engines) == 2 and rep.device == donor.device == CPU
    assert rep.params["wte"] is donor.params["wte"]
    assert rep.core["hifigan"]["conv_pre_w"] is donor.core["hifigan"]["conv_pre_w"]
    assert rep.decode_engine is not donor.decode_engine
    assert rep.decode_engine.state.cache.k.data_ptr() != donor.decode_engine.state.cache.k.data_ptr()
    assert rep._vocoder_programs is not donor._vocoder_programs
    assert rep.decode_slots == donor.decode_slots and rep.cache_dtype == donor.cache_dtype
    assert rep.gpt_config == donor.gpt_config


def test_concurrent_requests_spread_and_complete(replicated, tmp_path):
    tts, engine, _, _ = replicated
    wav_path = sine_wav(tmp_path / "spk.wav")
    served = []
    orig_route = engine._route

    def spy(request):
        idx = orig_route(request)
        served.append(idx)
        return idx

    engine._route = spy
    try:
        async def run():
            return await asyncio.gather(
                *(tts.generate_speech_async(_req(wav_path)) for _ in range(4)))

        outs = tts.loop.run_until_complete(run())
        # the same burst again: every voice is now a conditioning cache
        # hit, so phase 1 awaits nothing, and the load must still show
        outs += tts.loop.run_until_complete(run())
    finally:
        engine._route = orig_route
    assert all(len(o.array) > 0 and np.isfinite(o.array).all() for o in outs)
    assert len(served) == 8
    # least-loaded routing over concurrent requests must touch both replicas
    for burst in (served[:4], served[4:]):
        assert len(set(burst)) == 2, f"all requests went to replica(s) {set(burst)}"


def test_streaming_through_replicas(replicated, tmp_path):
    tts, _, _, _ = replicated
    wav_path = sine_wav(tmp_path / "spk2.wav")
    chunks = list(tts.generate_speech(_req(wav_path, stream=True)))
    assert chunks and all(np.isfinite(c.array).all() for c in chunks)


def test_stream_abandon_through_replicas_stops_decode(replicated, tmp_path):
    """cancel_generation_handle must delegate through the replica tag: an
    abandoned stream drains the owning replica's decode engine."""
    tts, engine, _, _ = replicated
    wav_path = sine_wav(tmp_path / "spk3.wav")
    long_text = ("hello world this is a test of speech. the quick brown fox jumps "
                 "over the dog. one two three four five six seven. " * 3)
    stream = tts.generate_speech(
        TTSRequest(text=long_text, speaker_files=[wav_path], language="en", stream=True))
    first = next(stream)
    assert np.isfinite(first.array).all()
    stream.close()

    async def drained():
        t0 = time.monotonic()
        while any(e.decode_engine.num_active or e.decode_engine._queue for e in engine.engines):
            if time.monotonic() - t0 > 60:
                raise AssertionError("replica decode did not drain after abandon")
            await asyncio.sleep(0.05)

    tts.loop.run_until_complete(drained())
    out = tts.generate_speech(_req(wav_path))
    assert len(out.array) > 0


@pytest.mark.parametrize("replica", [0, 1])
def test_greedy_on_each_replica_equals_donor_and_jax(replicated, replica):
    """A greedy request routed to either replica gives the donor's tokens
    and waveform alone (exactly: the same weights on one device), and the
    JAX replicated engine's request routed to the same replica gives the
    same waveform within PCM_TOL."""
    tts, engine, jax_tts, wav = replicated
    donor = engine.engines[0]

    def routed(eng, tts_, cls):
        orig = eng._route
        eng._route = lambda request: replica
        try:
            return tts_.generate_speech(_req(wav, cls, do_sample=False))
        finally:
            eng._route = orig

    got = routed(engine, tts, TTSRequest)
    alone = TTS(scheduler_max_concurrency=1).with_engine(donor)
    try:
        want = alone.generate_speech(_req(wav, do_sample=False))
    finally:
        alone.loop.run_until_complete(donor.shutdown())  # its runner rebinds on next use
        alone.loop.close()
    np.testing.assert_array_equal(got.array, want.array)
    jax_out = routed(jax_tts.tts_engine, jax_tts, JaxRequest)
    assert got.array.shape == np.asarray(jax_out.array).shape
    np.testing.assert_allclose(got.array, jax_out.array, rtol=0, atol=PCM_TOL)


# ------------------------------------------------------ routing with doubles
class _Runner:
    def __init__(self, active=0, queued=0):
        self.num_active = active
        self._queue = [None] * queued


class _FakeEngine:
    """Just the surface the router reads and forwards to."""

    def __init__(self, active=0, queued=0):
        self.decode_engine = _Runner(active, queued)
        self.calls = []
        self.gate = None

    async def get_generation_context(self, request, **kw):
        self.calls.append(("context", request))
        if self.gate is not None:
            await self.gate.wait()
        return ["h0", "h1"], ["r0", "r1"], "spk", "cond"

    def cancel_generation_handle(self, handle):
        self.calls.append(("cancel", handle))

    async def process_tokens_to_speech(self, handle, spk=None, mm=None, request=None):
        self.calls.append(("speech", handle))
        yield handle

    async def shutdown(self):
        self.calls.append(("shutdown",))

    def get_memory_usage_curve(self):
        return 1.5

    def precompile_decode_programs(self):
        self.calls.append(("precompile_decode",))

    def precompile_vocoder_buckets(self):
        self.calls.append(("precompile_vocoder",))


def test_routing_least_loaded_tiebreak_and_inflight():
    """Least loaded by active + queued chunks + requests still in phase 1;
    a tie goes to hash(speaker files) over the tied replicas, so a voice
    repeats on one replica; a request in flight counts until its chunks
    are queued."""
    engines = [_FakeEngine(active=2), _FakeEngine(active=1, queued=1), _FakeEngine(active=0)]
    rep = ReplicatedTTSEngine(engines)
    req = TTSRequest(text="x", speaker_files=["a.wav"], language="en")
    assert [rep._load(i) for i in range(3)] == [2, 2, 0]
    assert rep._route(req) == 2
    engines[2].decode_engine.num_active = 2
    want = [0, 1, 2][hash(("a.wav",)) % 3]
    assert rep._route(req) == want == rep._route(req)

    async def inflight():
        gate = asyncio.Event()
        engines[want].gate = gate
        task = asyncio.ensure_future(rep.get_generation_context(req))
        await asyncio.sleep(0)
        assert rep._inflight[want] == 1 and rep._load(want) == 3
        assert rep._route(req) != want  # the request in phase 1 weighs
        gate.set()
        tagged, ids, spk, cond = await task
        assert rep._inflight[want] == 0
        assert tagged == [(want, "h0"), (want, "h1")] and ids == ["r0", "r1"]

    asyncio.run(inflight())


def test_cancel_process_and_shutdown_forward_to_the_owner():
    engines = [_FakeEngine(), _FakeEngine()]
    rep = ReplicatedTTSEngine(engines)
    rep.cancel_generation_handle((1, "h"))
    assert engines[1].calls == [("cancel", "h")] and not engines[0].calls

    async def speech():
        return [x async for x in rep.process_tokens_to_speech((0, "h0"), "spk")]

    assert asyncio.run(speech()) == ["h0"] and engines[0].calls == [("speech", "h0")]
    rep.precompile_decode_programs()
    rep.precompile_vocoder_buckets()
    assert rep.get_memory_usage_curve() == 3.0
    asyncio.run(rep.shutdown())
    for e in engines:
        assert e.calls[-3:] == [("precompile_decode",), ("precompile_vocoder",), ("shutdown",)]
    with pytest.raises(ValueError, match="at least one"):
        ReplicatedTTSEngine([])


def test_more_replicas_than_devices_truncates_and_logs(replicated, monkeypatch):
    """JAX takes devices[:n_replicas] without a word; the port keeps the
    behaviour and logs it. A CPU engine's default devices are its own."""
    _, engine, _, _ = replicated
    warned = []
    monkeypatch.setattr(treplica.logger, "warning", lambda msg, *a: warned.append(msg % a))
    one = ReplicatedTTSEngine.from_engine(engine.engines[0], n_replicas=2)
    assert one.engines == [engine.engines[0]]
    assert warned and "data_parallel_replicas=2" in warned[0] and "1 replica" in warned[0]
    three = ReplicatedTTSEngine.from_engine(engine.engines[0], devices=[CPU] * 3, n_replicas=2)
    assert len(three.engines) == 2 and len(warned) == 1


def test_facade_data_parallel_replicas(tmp_path, monkeypatch):
    """TTS.from_pretrained(..., data_parallel_replicas=2) builds the
    replicated engine from a converted checkpoint (the facade is a copy of
    the JAX package's): on a CPU drive, one device, so one replica, logged;
    it serves a request."""
    ck = convert_tiny(tmp_path)
    warned = []
    monkeypatch.setattr(treplica.logger, "warning", lambda msg, *a: warned.append(msg % a))
    tts = TTS(scheduler_max_concurrency=2).from_pretrained(
        ck.port_dirs["core"], gpt_model=ck.port_dirs["gpt"], device="cpu",
        data_parallel_replicas=2)
    try:
        assert isinstance(tts.tts_engine, ReplicatedTTSEngine)
        assert len(tts.tts_engine.engines) == 1 and warned
        out = tts.generate_speech(TTSRequest(text="one two three", language="en",
                                             speaker_files=[sine_wav(tmp_path / "v.wav")],
                                             max_new_tokens=16))
        assert np.isfinite(out.array).all() and out.array.size > 0
    finally:
        tts.loop.run_until_complete(tts.shutdown())
