"""The port's OpenAI-compatible server (auralis_tpu_torch/server/) on a CPU
engine loaded from a converted checkpoint.

tests/unit/test_server.py's cases, run against the port's `build_app`; the
same greedy request through the JAX package's app and the port's, both on
one converted checkpoint; the CLI's options, its refusal of parallel
serving, and a CLI boot in a subprocess that answers and exits on SIGINT."""
import argparse
import asyncio
import base64
import json
import os
import signal
import socket
import struct
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp import web
from aiohttp.test_utils import TestClient, TestServer

sys.path.insert(0, str(Path(__file__).resolve().parent))
from helpers import sine_wav
from test_torch_checkpoint import PCM_TOL, convert_tiny

from auralis_tpu import TTS as JaxTTS
from auralis_tpu.server import oai_server as jax_server
from auralis_tpu_torch import TTS, TTSRequest
from auralis_tpu_torch.common import audio_io, native_audio
from auralis_tpu_torch.server import oai_server
from auralis_tpu_torch.server.oai_server import build_app, build_parser, scan_voices_dir

ROOT = Path(__file__).resolve().parent.parent
F32 = dict(dtype=torch.float32, device="cpu", cache_dtype=torch.float32,
           vocoder_dtype=torch.float32)


@pytest.fixture(scope="module")
def ck(tmp_path_factory):
    return convert_tiny(tmp_path_factory.mktemp("ckpt"))


@pytest.fixture(scope="module")
def voice_b64(tmp_path_factory):
    path = sine_wav(tmp_path_factory.mktemp("srv") / "voice.wav")
    return base64.b64encode(Path(path).read_bytes()).decode()


@pytest.fixture(scope="module")
def shared_tts(ck):
    tts = TTS(scheduler_max_concurrency=2).from_pretrained(
        ck.port_dirs["core"], gpt_model=ck.port_dirs["gpt"], **F32)
    yield tts
    if tts.loop is not None and not tts.loop.is_closed():
        tts.loop.run_until_complete(tts.shutdown())


@pytest.fixture()
def app(shared_tts):
    # an aiohttp Application freezes on first startup; build one per test
    return build_app(shared_tts)


async def _request(app, method, path, **kw):
    async with TestClient(TestServer(app)) as client:
        resp = await getattr(client, method)(path, **kw)
        body = await resp.read()
        return resp, body


def _speech(voice_b64, **kw):
    return {"input": "Hello world from the server.", "model": "xttsv2", "voice": [voice_b64],
            "response_format": "wav", "language": "en", **kw}


# ------------------------------------------- tests/unit/test_server.py's cases
def test_health(app):
    resp, body = asyncio.run(_request(app, "get", "/health"))
    assert resp.status == 200
    assert json.loads(body) == {"status": "ok", "engine_loaded": True}


def test_audio_speech_wav(app, voice_b64):
    resp, body = asyncio.run(_request(app, "post", "/v1/audio/speech", json=_speech(voice_b64)))
    assert resp.status == 200, body
    audio, sr = audio_io.read_wav(body)
    assert sr == 24000
    assert audio.shape[-1] > 1000 and np.isfinite(audio).all()


def test_audio_speech_speed_change(app, voice_b64):
    resp, body = asyncio.run(_request(app, "post", "/v1/audio/speech",
                                      json=_speech(voice_b64, speed=1.5)))
    assert resp.status == 200, body
    audio, sr = audio_io.read_wav(body)
    assert sr == 24000 and audio.shape[-1] > 0


def test_audio_speech_flac(app, voice_b64):
    if not native_audio.available():
        pytest.skip("native FLAC codec not built")
    resp, body = asyncio.run(_request(app, "post", "/v1/audio/speech",
                                      json=_speech(voice_b64, response_format="flac")))
    assert resp.status == 200, body
    assert resp.content_type == "audio/flac"
    assert body[:4] == b"fLaC"
    audio, sr = native_audio.flac_decode(bytes(body))
    assert sr == 24000 and audio.shape[-1] > 1000


def test_audio_speech_invalid_base64(app):
    payload = {"input": "x", "model": "m", "voice": ["@@not-base64@@"]}
    resp, body = asyncio.run(_request(app, "post", "/v1/audio/speech", json=payload))
    assert resp.status == 400
    assert b"base64" in body


def test_audio_speech_unregistered_voice_name(app):
    """An OpenAI-style voice name ('echo') is valid base64 of a few bytes:
    the 400 names the registry instead of failing deep in audio loading."""
    payload = {"input": "x", "model": "m", "voice": ["echo"]}
    resp, body = asyncio.run(_request(app, "post", "/v1/audio/speech", json=payload))
    assert resp.status == 400
    assert b"registered voice" in body


def test_audio_speech_unsupported_format(app, voice_b64):
    payload = {"input": "hello there", "model": "m", "voice": [voice_b64],
               "response_format": "mp3", "language": "en"}
    resp, body = asyncio.run(_request(app, "post", "/v1/audio/speech", json=payload))
    assert resp.status == 400
    assert b"encoder" in body


def _sse_events(body: bytes) -> list:
    return [json.loads(line[len("data:"):].strip()) for line in body.decode().splitlines()
            if line.startswith("data:")]


def test_audio_speech_stream_sse(shared_tts, voice_b64):
    """speech.audio.delta events (base64 PCM) then speech.audio.done; the
    concatenated deltas match the buffered synthesis of the same greedy
    request within the tolerance tests/unit/test_server.py pins."""
    payload = {"input": "The first sentence streams early. The second sentence follows it.",
               "model": "xttsv2", "voice": [voice_b64], "language": "en", "do_sample": False,
               "stream_format": "sse"}
    buf_payload = {**payload, "response_format": "pcm"}
    del buf_payload["stream_format"]

    async def run():
        # a fresh app per request: an aiohttp Application binds to the
        # first loop it starts on
        r1 = await _request(build_app(shared_tts), "post", "/v1/audio/speech", json=payload)
        r2 = await _request(build_app(shared_tts), "post", "/v1/audio/speech", json=buf_payload)
        return r1, r2

    (resp, body), (resp2, body2) = asyncio.run(run())
    assert resp.status == 200, body
    assert resp.headers["Content-Type"].startswith("text/event-stream")
    events = _sse_events(body)
    deltas = [e for e in events if e.get("type") == "speech.audio.delta"]
    assert deltas, events
    assert events[-1]["type"] == "speech.audio.done"
    assert all(e["sample_rate"] == 24000 for e in deltas)
    pcm = np.frombuffer(b"".join(base64.b64decode(e["audio"]) for e in deltas), dtype="<i2")
    assert pcm.size > 1000
    assert resp2.status == 200
    buffered = np.frombuffer(body2, dtype="<i2")
    assert pcm.shape == buffered.shape
    assert np.abs(pcm.astype(np.int32) - buffered.astype(np.int32)).max() <= 4


def test_audio_speech_stream_raw_wav(app, voice_b64):
    """stream_format "audio" + wav: a streaming RIFF header (0xFFFFFFFF
    sizes), then raw PCM frames."""
    payload = {"input": "Raw chunked audio bytes flow here.", "model": "xttsv2",
               "voice": [voice_b64], "language": "en", "do_sample": False,
               "response_format": "wav", "stream_format": "audio"}
    resp, body = asyncio.run(_request(app, "post", "/v1/audio/speech", json=payload))
    assert resp.status == 200, body
    assert resp.content_type == "audio/wav"
    assert body[:4] == b"RIFF" and body[8:12] == b"WAVE" and body[36:40] == b"data"
    assert struct.unpack("<I", body[4:8])[0] == 0xFFFFFFFF
    assert struct.unpack("<I", body[40:44])[0] == 0xFFFFFFFF
    fmt = struct.unpack("<IHHIIHH", body[16:36])
    assert fmt[1] == 1 and fmt[2] == 1 and fmt[3] == 24000 and fmt[6] == 16
    assert np.frombuffer(body[44:], dtype="<i2").size > 1000


def test_audio_speech_stream_rejections(shared_tts, voice_b64):
    """Compressed formats and speed changes cannot stream: clean 400s."""
    base = {"input": "hello there", "model": "m", "voice": [voice_b64], "language": "en",
            "stream_format": "audio"}

    async def run():
        r1 = await _request(build_app(shared_tts), "post", "/v1/audio/speech",
                            json={**base, "response_format": "mp3"})
        r2 = await _request(build_app(shared_tts), "post", "/v1/audio/speech",
                            json={**base, "speed": 1.5})
        return r1, r2

    (resp, body), (resp2, body2) = asyncio.run(run())
    assert resp.status == 400 and b"stream" in body
    assert resp2.status == 400 and b"speed" in body2


def test_named_voices_and_metrics(shared_tts, tmp_path):
    """A --voices_dir stem works as `voice`, /v1/voices lists it, unknown
    names get a 400 that lists the registry, and /metrics' counters grow
    with traffic."""
    sine_wav(tmp_path / "alloy.wav")
    (tmp_path / "readme.txt").write_text("not audio")
    voices = scan_voices_dir(tmp_path)
    assert list(voices) == ["alloy"]
    payload = {"input": "A named voice speaks.", "model": "xttsv2", "voice": "alloy",
               "language": "en", "do_sample": False}

    async def run():
        async with TestClient(TestServer(build_app(shared_tts, voices=voices))) as client:
            r_voices = await client.get("/v1/voices")
            listing = await r_voices.json()
            r_speech = await client.post("/v1/audio/speech", json=payload)
            speech = await r_speech.read()
            r_metrics = await client.get("/metrics")
            metrics_text = await r_metrics.text()
            r_unknown = await client.post("/v1/audio/speech",
                                          json={**payload, "voice": "##ghost##"})
            unknown = await r_unknown.read()
        return ((r_voices.status, listing), (r_speech.status, speech),
                (r_metrics.status, metrics_text), (r_unknown.status, unknown))

    (vs, listing), (ss, speech), (ms, mtext), (us, unknown) = asyncio.run(run())
    assert vs == 200 and listing == {"voices": ["alloy"]}
    assert ss == 200, speech
    audio, sr = audio_io.read_wav(speech)
    assert sr == 24000 and audio.shape[-1] > 1000
    assert ms == 200
    counters = {line.split()[0]: float(line.split()[1])
                for line in mtext.splitlines() if line and not line.startswith("#")}
    assert counters["auralis_audio_chunks_total"] >= 1
    assert counters["auralis_audio_seconds_total"] > 0
    assert counters["auralis_mel_tokens_total"] > 0
    # the port's runner exposes the decode telemetry too
    assert counters["auralis_decode_inserts_total"] >= 1
    assert counters["auralis_decode_slots"] == shared_tts.tts_engine.decode_slots
    assert us == 400
    assert b"alloy" in unknown


def test_chat_completions_requires_url(app, voice_b64):
    payload = {"model": "llm", "messages": [{"role": "user", "content": "hi"}],
               "speaker_files": [voice_b64]}
    resp, body = asyncio.run(_request(app, "post", "/v1/chat/completions", json=payload))
    assert resp.status == 400
    assert b"url" in body


def test_chat_completions_upstream_error(app, voice_b64):
    payload = {"model": "llm", "messages": [{"role": "user", "content": "hi"}],
               "speaker_files": [voice_b64],
               "openai_api_url": "http://127.0.0.1:1/v1"}  # nothing listens there
    resp, body = asyncio.run(_request(app, "post", "/v1/chat/completions", json=payload))
    assert resp.status == 200  # an SSE stream with an error event
    assert b"error" in body and b"[DONE]" in body


def test_chat_completions_happy_path_interleaves_audio(app, voice_b64):
    """A stub upstream LLM on 127.0.0.1: text deltas are relayed as chat
    chunks, every 2 words an `audio.chunk` is spoken (a word split across
    deltas is held back), the tail is spoken, and the stream ends with
    [DONE]."""
    deltas = ["Hello ", "there ", "unbe", "lievable ", "of ", "mine ", "tail"]

    async def stub_chat(request):
        body = await request.json()
        assert body.get("stream") is True
        assert "modalities" not in body and "speaker_files" not in body
        resp = web.StreamResponse(status=200, headers={"Content-Type": "text/event-stream"})
        await resp.prepare(request)
        frame = lambda d: f"data: {json.dumps(d)}\n\n".encode()
        await resp.write(frame({"id": "c", "object": "chat.completion.chunk", "choices": []}))
        for d in deltas:
            await resp.write(frame({"id": "c", "object": "chat.completion.chunk",
                                    "choices": [{"index": 0, "delta": {"content": d},
                                                 "finish_reason": None}]}))
        await resp.write(frame({"id": "c", "object": "chat.completion.chunk", "choices": [],
                                "usage": {"total_tokens": 7}}))
        await resp.write(b"data: [DONE]\n\n")
        return resp

    async def run():
        stub_app = web.Application()
        stub_app.router.add_post("/v1/chat/completions", stub_chat)
        async with TestClient(TestServer(stub_app)) as stub_client:
            payload = {"model": "llm", "messages": [{"role": "user", "content": "hi"}],
                       "speaker_files": [voice_b64],
                       "openai_api_url": str(stub_client.make_url("/v1")),
                       "vocalize_at_every_n_words": 2, "language": "en"}
            async with TestClient(TestServer(app)) as client:
                resp = await client.post("/v1/chat/completions", json=payload)
                assert resp.status == 200
                assert resp.headers["Content-Type"].startswith("text/event-stream")
                return (await resp.read()).decode()

    raw = asyncio.run(run())
    assert raw.rstrip().endswith("data: [DONE]")
    events = [json.loads(line[len("data:"):].strip()) for line in raw.splitlines()
              if line.startswith("data:") and line[len("data:"):].strip() != "[DONE]"]
    chat = [e for e in events if e.get("object") == "chat.completion.chunk"]
    audio = [e for e in events if e.get("object") == "audio.chunk"]
    assert [c["choices"][0]["delta"]["content"] for c in chat if c.get("choices")] == deltas
    assert sum(1 for c in chat if not c.get("choices")) == 2
    assert len(audio) >= 2
    for a in audio:
        wav, sr = audio_io.read_wav(base64.b64decode(a["data"]))
        assert sr == 24000 and wav.shape[-1] > 0
    order = [e.get("object") for e in events]
    assert order.index("audio.chunk") < len(order) - 1 - order[::-1].index(
        "chat.completion.chunk")


def test_audio_speech_malformed_bodies(app):
    """Malformed bodies come back as 4xx (or a clean 5xx), never 200."""
    cases = [
        ("not json at all", {"data": b"\x00\x01binary"}),
        ("empty object", {"json": {}}),
        ("wrong types", {"json": {"model": 3, "input": [1, 2], "voice": 7}}),
        ("empty input text", {"json": {"model": "x", "input": "", "voice": ["AAAA"]}}),
        ("absurd speed", {"json": {"model": "x", "input": "hi", "voice": ["AAAA"], "speed": -5}}),
        ("null voice", {"json": {"model": "x", "input": "hi", "voice": None}}),
    ]

    async def go():
        out = []
        async with TestClient(TestServer(app)) as client:
            for name, kw in cases:
                resp = await client.post("/v1/audio/speech", **kw)
                await resp.read()
                out.append((name, resp.status))
        return out

    for name, status in asyncio.run(go()):
        assert 400 <= status < 600, f"{name}: unexpected status {status}"


# -------------------------------------------------- against the JAX server
def test_speech_matches_the_jax_server(ck, shared_tts, voice_b64):
    """One greedy /v1/audio/speech body through the JAX package's app
    (its engine from the JAX converter's artifacts, f32) and the port's
    app: the decoded waveforms agree within PCM_TOL."""
    body = _speech(voice_b64, do_sample=False, input="Hello world. This is a test.")
    jax_tts = JaxTTS(scheduler_max_concurrency=2).from_pretrained(
        ck.jax_dirs["core"], gpt_model=ck.jax_dirs["gpt"], dtype=jnp.float32,
        cache_dtype=jnp.float32, vocoder_dtype=None)
    try:
        resp, want = asyncio.run(_request(jax_server.build_app(jax_tts), "post",
                                          "/v1/audio/speech", json=body))
        assert resp.status == 200, want
    finally:
        jax_tts.loop.run_until_complete(jax_tts.shutdown())
    resp, got = asyncio.run(_request(build_app(shared_tts), "post", "/v1/audio/speech",
                                     json=body))
    assert resp.status == 200, got
    want_audio, want_sr = audio_io.read_wav(want)
    got_audio, got_sr = audio_io.read_wav(got)
    assert got_sr == want_sr == 24000
    assert got_audio.shape == want_audio.shape and got_audio.size > 1000
    np.testing.assert_allclose(got_audio, want_audio, rtol=0, atol=PCM_TOL)


# ------------------------------------------------------------------- the CLI
def _actions(parser) -> dict:
    return {opt: (a.dest, a.default, getattr(a.type, "__name__", a.type))
            for a in parser._actions for opt in a.option_strings}


def test_cli_options_are_the_jax_servers(monkeypatch):
    """The port's CLI takes every option of the JAX package's, with its
    defaults, plus --kv_int8 (the card arms no int8 default) and --device."""
    class Parsed(Exception):
        pass

    def grab(self, *args, **kwargs):
        raise Parsed(self)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(Parsed) as caught:
            jax_server.main([])
    want = _actions(caught.value.args[0])
    got = _actions(build_parser())
    assert set(got) == set(want) | {"--kv_int8", "--no-kv_int8", "--device"}
    assert {k: got[k] for k in want} == want
    args = build_parser().parse_args(["--model", "m"])
    assert args.kv_int8 is None and args.device is None and args.decode_slots is None


@pytest.mark.parametrize("flag", ["--tensor_parallel_size", "--data_parallel_replicas"])
def test_cli_refuses_parallel_serving(ck, flag, monkeypatch, tmp_path):
    """Parallel serving is ported (auralis_tpu_torch/parallel/): the CLI's
    two flags build. --data_parallel_replicas 2 on a CPU drive, which has
    one device, serves one replica and logs that it gave fewer;
    --tensor_parallel_size 2 with --device cpu shards the GPT over a mesh
    of two CPU shards. Each answers a short request."""
    from auralis_tpu_torch.parallel import replica as treplica

    import shutil

    warned = []
    monkeypatch.setattr(treplica.logger, "warning", lambda msg, *a: warned.append(msg % a))
    core = ck.port_dirs["core"]
    if flag == "--tensor_parallel_size":
        # the converted tiny checkpoint infers one head at width 64 (D / 64);
        # read the same weights as two heads of 32 so that tp = 2 divides
        core = shutil.copytree(core, tmp_path / "core2")
        config = json.loads((core / "config.json").read_text())
        config["gpt_config"]["num_attention_heads"] = 2
        (core / "config.json").write_text(json.dumps(config))
    args = build_parser().parse_args([
        "--model", str(core), "--gpt_model", ck.port_dirs["gpt"], "--device", "cpu",
        "--max_concurrency", "2", flag, "2"])
    tts = oai_server.start_tts_engine(args)
    eng = tts.tts_engine
    try:
        if flag == "--data_parallel_replicas":
            assert type(eng).__name__ == "ReplicatedTTSEngine" and len(eng.engines) == 1
            assert any("data_parallel_replicas=2" in m and "1 replica" in m for m in warned)
        else:
            assert eng.mesh is not None and eng.mesh.shape["model"] == 2
            assert len(eng.decode_engine.params.shards) == 2
        out = tts.generate_speech(TTSRequest(text="one two three",
                                             speaker_files=[sine_wav(tmp_path / "v.wav")],
                                             language="en", max_new_tokens=16))
        assert np.isfinite(out.array).all() and out.array.size > 0
    finally:
        tts.loop.run_until_complete(tts.shutdown())


def test_start_tts_engine_forwards_options(ck):
    args = build_parser().parse_args([
        "--model", ck.port_dirs["core"], "--gpt_model", ck.port_dirs["gpt"], "--device", "cpu",
        "--max_concurrency", "2", "--decode_slots", "3", "--slot_bucketing", "--kv_int8",
        "--conditioning_cache_size", "5", "--ref_length_quantum_s", "0.5"])
    tts = oai_server.start_tts_engine(args)
    eng = tts.tts_engine
    try:
        assert eng.device.type == "cpu" and eng.max_concurrency == 2 and eng.decode_slots == 3
        assert eng.decode_engine.slot_bucketing and eng.gpt_config.kv_int8
        assert eng.decode_engine.state.cache.quantized
        assert eng.conditioning_cache_size == 5 and eng.ref_length_quantum_s == 0.5
    finally:
        tts.loop.run_until_complete(tts.shutdown())


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_boots_answers_and_exits_on_sigint(ck, voice_b64, tmp_path):
    """`python -m auralis_tpu_torch.entrypoints.oai_server --device cpu` in
    a subprocess: /health answers, one short request returns audio, and
    SIGINT ends the process with exit code 0."""
    port = _free_port()
    url = f"http://127.0.0.1:{port}"
    log = open(tmp_path / "server.log", "wb")
    proc = subprocess.Popen(
        [sys.executable, "-m", "auralis_tpu_torch.entrypoints.oai_server",
         "--model", ck.port_dirs["core"], "--gpt_model", ck.port_dirs["gpt"], "--device", "cpu",
         "--host", "127.0.0.1", "--port", str(port), "--max_concurrency", "2"],
        cwd=ROOT, stdout=log, stderr=subprocess.STDOUT,
        env={k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))})
    try:
        deadline = time.monotonic() + 120
        while True:
            assert proc.poll() is None, (tmp_path / "server.log").read_text()[-3000:]
            assert time.monotonic() < deadline, "no /health within 120 s"
            try:
                with urllib.request.urlopen(f"{url}/health", timeout=5) as r:
                    assert json.loads(r.read())["engine_loaded"]
                break
            except OSError:
                time.sleep(0.2)
        req = urllib.request.Request(
            f"{url}/v1/audio/speech", headers={"Content-Type": "application/json"},
            data=json.dumps(_speech(voice_b64, max_new_tokens=20)).encode())
        with urllib.request.urlopen(req, timeout=120) as r:
            audio, sr = audio_io.read_wav(r.read())
        assert sr == 24000 and audio.size > 0 and np.isfinite(audio).all()
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 0, (tmp_path / "server.log").read_text()[-3000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
