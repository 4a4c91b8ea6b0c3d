"""OpenAI-compatible HTTP server (capability parity with reference
entrypoints/oai_server.py, built on aiohttp — FastAPI isn't in this image).

Endpoints:
- POST /v1/audio/speech      — text -> audio bytes (wav/pcm; compressed
  formats require an external encoder and return 400). With
  `stream_format` ("sse" | "audio") the response streams chunk-by-chunk
  as the engine synthesizes (the reference buffers the whole request)
- POST /v1/chat/completions  — proxies a streaming chat completion to an
  upstream LLM and interleaves base64 `audio.chunk` SSE events, vocalizing
  every N accumulated words
- GET  /v1/voices            — named voices registered via --voices_dir
  (clients pass a name as `voice` instead of base64 reference audio)
- GET  /metrics              — Prometheus text exposition (cumulative
  synthesis counters + decode-runner telemetry)
- GET  /health               — liveness probe
"""
from __future__ import annotations

import argparse
import asyncio
import base64
import json
import logging
import time
import uuid
from typing import Optional

from aiohttp import ClientSession, ClientTimeout, web

from ..common import audio_io
from ..common.logger import setup_logger
from ..common.tracing import record as trace_record
from ..core.tts import TTS
from .openai_schemas import AudioSpeechGenerationRequest, VoiceChatCompletionRequest

logger = setup_logger("oai_server")

TTS_ENGINE_KEY = web.AppKey("tts_engine", TTS)
VOICES_KEY = web.AppKey("voices", dict)


def _error(status: int, message: str) -> web.Response:
    return web.json_response({"error": {"message": message}}, status=status)


# smaller than any real audio payload: an unregistered voice NAME that
# happens to be valid base64 ('echo', 'nova' — any 4-char string decodes)
# must get the helpful 400, not an opaque decode failure deep in audio IO
_MIN_B64_AUDIO_BYTES = 512


def _resolve_voices(items: list, registry: dict) -> list:
    """Map each voice item to a speaker reference: a name registered via
    --voices_dir resolves to its audio file path, anything else must be
    base64 audio (decoded to bytes). Lookup is by exact registered name —
    user input is never joined with the directory, so no path traversal.

    CPU-bound for large payloads (up to ~48 MB of base64 per item under the
    64 MB client_max_size): callers run it via asyncio.to_thread."""
    out = []
    for item in items:
        if item in registry:
            out.append(str(registry[item]))
            continue
        try:
            decoded = base64.b64decode(item, validate=True)
            if len(decoded) < _MIN_B64_AUDIO_BYTES:
                raise ValueError("too small to be audio")
        except Exception:
            known = ", ".join(sorted(registry)) or "none registered"
            raise ValueError(
                f"voice '{item[:48]}' is neither a registered voice name "
                f"nor valid base64 audio (registered voices: {known})"
            )
        out.append(decoded)
    return out


def scan_voices_dir(path) -> dict:
    """Build the named-voice registry from a directory: every .wav/.flac
    file registers its stem as a voice name (OpenAI-style 'voice': 'alloy'
    without shipping reference audio per request). Conditioning latents are
    cached per voice by the engine's LRU after first use."""
    from pathlib import Path

    registry = {}
    root = Path(path)
    if not root.is_dir():
        raise ValueError(f"--voices_dir {path} is not a directory")
    for f in sorted(root.iterdir()):
        if f.suffix.lower() in (".wav", ".flac") and f.is_file():
            if f.stem in registry:
                logger.warning(
                    "--voices_dir: voice '%s' defined by both %s and %s; "
                    "using %s", f.stem, registry[f.stem].name, f.name, f.name,
                )
            registry[f.stem] = f.resolve()
    if not registry:
        logger.warning("--voices_dir %s contains no .wav/.flac files", path)
    return registry


async def handle_audio_speech(request: web.Request) -> web.Response:
    """OpenAI `audio.speech`-compatible synthesis."""
    tts: TTS = request.app[TTS_ENGINE_KEY]
    try:
        body = AudioSpeechGenerationRequest.model_validate(await request.json())
    except Exception as e:
        return _error(400, str(e))
    try:
        speaker_files = await asyncio.to_thread(
            _resolve_voices, body.voice, request.app[VOICES_KEY]
        )
    except ValueError as e:
        return _error(400, str(e))
    if body.stream_format is not None:
        return await _stream_audio_speech(request, tts, body, speaker_files)
    try:
        # __post_init__ may run reference enhancement (decode + numpy DSP):
        # keep it off the serving loop
        t0 = time.perf_counter()
        tts_request = await asyncio.to_thread(body.to_tts_request, speaker_files)
        trace_record("server.build_request", time.perf_counter() - t0)
        output = await tts.generate_speech_async(tts_request)
        if body.speed != 1.0:
            output = output.change_speed(body.speed)
        payload = output.to_bytes(format=body.response_format)
    except ValueError as e:
        return _error(400, str(e))
    except Exception as e:
        logger.error("Speech generation failed: %s", e)
        return _error(500, str(e))
    content_type = {
        "wav": "audio/wav",
        "pcm": "audio/pcm",
        "flac": "audio/flac",
        "mp3": "audio/mpeg",
        "opus": "audio/ogg",
        "aac": "audio/aac",
    }.get(body.response_format, "application/octet-stream")
    return web.Response(body=payload, content_type=content_type)


async def _stream_audio_speech(
    request: web.Request, tts: TTS, body: AudioSpeechGenerationRequest,
    speaker_files: list,
) -> web.StreamResponse:
    """Streaming synthesis: audio flows at the first synthesized chunk
    (the engine's time to first audio) instead of after the whole request.

    `stream_format="sse"` emits OpenAI-style `speech.audio.delta` events
    (base64 s16le PCM at the engine sample rate) terminated by
    `speech.audio.done`; `stream_format="audio"` emits chunked raw bytes —
    for "wav" a RIFF header with streaming (0xFFFFFFFF) sizes followed by
    PCM frames, for "pcm" the frames alone. The reference server has no
    streaming speech path (entrypoints/oai_server.py:65-93 buffers); this
    rides the engine's chunk-granular streaming generator."""
    if body.response_format not in ("wav", "pcm"):
        return _error(
            400,
            "streaming synthesis supports response_format 'wav' or 'pcm' "
            f"(got '{body.response_format}': compressed formats need a "
            "whole-signal encode — drop stream_format for those)",
        )
    if body.speed != 1.0:
        return _error(
            400,
            "speed adjustment needs the whole signal (phase vocoder) and "
            "cannot stream; drop stream_format or use speed=1.0",
        )
    try:
        tts_request = await asyncio.to_thread(body.to_tts_request, speaker_files)
        agen = await tts.generate_speech_async(tts_request)
    except ValueError as e:
        return _error(400, str(e))
    except Exception as e:
        logger.error("Streaming speech setup failed: %s", e)
        return _error(500, str(e))

    # pull the FIRST chunk before committing to a 200: phase-1 failures
    # (bad language, unspeakable text) become clean HTTP errors, not a
    # 200 that dies mid-body
    try:
        first = await anext(agen)
    except StopAsyncIteration:
        first = None
    except ValueError as e:
        await agen.aclose()
        return _error(400, str(e))
    except Exception as e:
        logger.error("Streaming speech failed before first chunk: %s", e)
        await agen.aclose()
        return _error(500, str(e))

    sse = body.stream_format == "sse"
    resp = web.StreamResponse(
        status=200,
        headers={
            "Content-Type": "text/event-stream" if sse
            else ("audio/wav" if body.response_format == "wav" else "audio/pcm"),
            "Cache-Control": "no-cache",
        },
    )
    await resp.prepare(request)

    async def send_event(payload: dict) -> None:
        await resp.write(f"data: {json.dumps(payload)}\n\n".encode())

    try:
        if not sse and body.response_format == "wav":
            sr = first.sample_rate if first is not None else 24000
            await resp.write(audio_io.wav_stream_header(sr))
        chunk = first
        while chunk is not None:
            pcm = chunk.to_bytes("pcm")
            if sse:
                await send_event(
                    {
                        "type": "speech.audio.delta",
                        "audio": base64.b64encode(pcm).decode(),
                        "sample_rate": chunk.sample_rate,
                    }
                )
            else:
                await resp.write(pcm)
            try:
                chunk = await anext(agen)
            except StopAsyncIteration:
                chunk = None
        if sse:
            await send_event({"type": "speech.audio.done"})
    except ConnectionResetError:
        # client went away: the finally acloses the generator, which cancels
        # the in-flight decode work through the scheduler's cleanup
        pass
    except asyncio.CancelledError:
        # aiohttp cancelled us (disconnect): re-raise so structured
        # cancellation bookkeeping (uncancel on 3.11+) stays intact — the
        # finally still acloses the generator on the way out
        raise
    except Exception as e:
        logger.error("Streaming speech failed mid-stream: %s", e)
        if sse:
            try:
                await send_event({"type": "error", "message": str(e)})
            except ConnectionResetError:
                pass
        # raw-audio mode has no in-band error channel; closing the
        # connection early is the signal
    finally:
        await agen.aclose()
    return resp


async def handle_chat_completions(request: web.Request) -> web.StreamResponse:
    """Streaming chat proxy with interleaved vocalization."""
    tts: TTS = request.app[TTS_ENGINE_KEY]
    try:
        body = VoiceChatCompletionRequest.model_validate(await request.json())
    except Exception as e:
        return _error(400, str(e))
    try:
        speaker_files = await asyncio.to_thread(
            _resolve_voices, body.speaker_files, request.app[VOICES_KEY]
        )
    except ValueError as e:
        return _error(400, str(e))

    resp = web.StreamResponse(
        status=200,
        headers={"Content-Type": "text/event-stream", "Cache-Control": "no-cache"},
    )
    await resp.prepare(request)

    async def send_event(payload: dict) -> None:
        await resp.write(f"data: {json.dumps(payload)}\n\n".encode())

    async def vocalize(text: str) -> None:
        if not text.strip():
            return
        # to_tts_request runs TTSRequest.__post_init__ (language inference
        # + optional reference enhancement: file decode + numpy DSP) —
        # off-loop so a slow reference can't stall every concurrent stream
        tts_request = await asyncio.to_thread(
            body.to_tts_request, text, speaker_files
        )
        output = await tts.generate_speech_async(tts_request)
        await send_event(
            {
                "object": "audio.chunk",
                "id": f"audio-{uuid.uuid4().hex}",
                "data": base64.b64encode(output.to_bytes("wav")).decode(),
                "created": int(time.time()),
            }
        )

    try:
        accumulated: list[str] = []
        headers = {}
        if body.openai_api_key:
            headers["Authorization"] = f"Bearer {body.openai_api_key}"
        # aiohttp's default ClientTimeout(total=300) would abort any chat
        # stream longer than 5 minutes (the inline vocalize awaits make long
        # conversations slower still); unbounded total, bounded connect
        timeout = ClientTimeout(total=None, connect=30, sock_connect=30)
        async with ClientSession(timeout=timeout) as session:
            async with session.post(
                f"{body.openai_api_url.rstrip('/')}/chat/completions",
                json=body.to_openai_request(),
                headers=headers,
            ) as upstream:
                if upstream.status != 200:
                    detail = (await upstream.text())[:500]
                    await send_event({"object": "error", "message": detail})
                    await resp.write(b"data: [DONE]\n\n")
                    return resp
                async for raw in upstream.content:
                    line = raw.decode().strip()
                    if not line.startswith("data:"):
                        continue
                    data = line[len("data:"):].strip()
                    if data == "[DONE]":
                        break
                    try:
                        chunk = json.loads(data)
                    except json.JSONDecodeError:
                        continue
                    if "text" in body.modalities:
                        await send_event(chunk)
                    choices = chunk.get("choices") or [{}]
                    # Azure's prompt_filter chunk and usage-only chunks ship
                    # "choices": [] — indexing [0] on it killed the stream
                    delta = choices[0].get("delta", {}).get("content") or ""
                    if delta and "audio" in body.modalities:
                        accumulated.append(delta)
                        text_so_far = "".join(accumulated)
                        words = text_so_far.split()
                        if len(words) >= body.vocalize_at_every_n_words:
                            # hold back a trailing PARTIAL word (BPE deltas
                            # split mid-word): vocalizing "unbeliev" now and
                            # "able" next chunk pronounces it as fragments
                            if text_so_far[-1].isspace():
                                speak, accumulated = text_so_far, []
                            else:
                                head, _, tail = text_so_far.rpartition(" ")
                                speak, accumulated = head, [tail]
                            if speak:
                                await vocalize(speak)
        if accumulated and "audio" in body.modalities:
            await vocalize("".join(accumulated))
        await resp.write(b"data: [DONE]\n\n")
    except Exception as e:
        logger.error("chat completion proxy failed: %s", e)
        try:
            await send_event({"object": "error", "message": str(e)})
            await resp.write(b"data: [DONE]\n\n")
        except ConnectionResetError:
            pass
    return resp


async def handle_health(request: web.Request) -> web.Response:
    tts: TTS = request.app[TTS_ENGINE_KEY]
    return web.json_response({"status": "ok", "engine_loaded": tts.tts_engine is not None})


async def handle_voices(request: web.Request) -> web.Response:
    """Named voices registered via --voices_dir (usable as `voice` items)."""
    return web.json_response({"voices": sorted(request.app[VOICES_KEY])})


async def handle_metrics(request: web.Request) -> web.Response:
    """Prometheus text exposition of the serving counters. The reference
    only sketches Prometheus in its deployment docs; these are first-party:
    cumulative totals from the generation tracker (scrapers derive their
    own rates) plus decode-runner telemetry where the engine exposes it."""
    from ..common.metrics import metrics as m

    lines = [
        "# HELP auralis_audio_chunks_total Audio chunks yielded by phase-2 generators",
        "# TYPE auralis_audio_chunks_total counter",
        f"auralis_audio_chunks_total {m.total_requests}",
        "# HELP auralis_mel_tokens_total Mel-codec tokens decoded",
        "# TYPE auralis_mel_tokens_total counter",
        f"auralis_mel_tokens_total {m.total_tokens}",
        "# HELP auralis_audio_seconds_total Seconds of audio synthesized",
        "# TYPE auralis_audio_seconds_total counter",
        f"auralis_audio_seconds_total {m.total_audio_seconds:.3f}",
        "# HELP auralis_chunk_latency_seconds_sum Request-start-to-chunk latency, summed",
        "# TYPE auralis_chunk_latency_seconds_sum counter",
        f"auralis_chunk_latency_seconds_sum {m.total_latency_sum:.3f}",
        "# HELP auralis_uptime_seconds Seconds since the metrics tracker started",
        "# TYPE auralis_uptime_seconds gauge",
        f"auralis_uptime_seconds {time.time() - m.started_at:.1f}",
    ]
    tts: TTS = request.app[TTS_ENGINE_KEY]
    de = getattr(tts.tts_engine, "decode_engine", None)
    if de is not None and getattr(de, "stats", None) is not None:
        st = de.stats
        blocks = st.get("blocks", 0)
        lines += [
            "# HELP auralis_decode_blocks_total Decode blocks dispatched",
            "# TYPE auralis_decode_blocks_total counter",
            f"auralis_decode_blocks_total {blocks}",
            "# HELP auralis_decode_inserts_total Sequences inserted into decode slots",
            "# TYPE auralis_decode_inserts_total counter",
            f"auralis_decode_inserts_total {st.get('inserts', 0)}",
            "# HELP auralis_decode_slots Configured decode slots",
            "# TYPE auralis_decode_slots gauge",
            f"auralis_decode_slots {de.num_slots}",
            "# HELP auralis_decode_slot_occupancy_avg Mean live slots per decode block",
            "# TYPE auralis_decode_slot_occupancy_avg gauge",
            f"auralis_decode_slot_occupancy_avg "
            f"{(st.get('occupancy_sum', 0) / blocks) if blocks else 0.0:.2f}",
        ]
    return web.Response(
        text="\n".join(lines) + "\n",
        content_type="text/plain",
        charset="utf-8",
    )


def build_app(tts: TTS, voices: Optional[dict] = None) -> web.Application:
    app = web.Application(client_max_size=64 * 1024 * 1024)
    app[TTS_ENGINE_KEY] = tts
    app[VOICES_KEY] = dict(voices or {})
    app.router.add_post("/v1/audio/speech", handle_audio_speech)
    app.router.add_post("/v1/chat/completions", handle_chat_completions)
    app.router.add_get("/v1/voices", handle_voices)
    app.router.add_get("/metrics", handle_metrics)
    app.router.add_get("/health", handle_health)

    async def _shutdown_engine(app: web.Application) -> None:
        # drain the scheduler + decode runner on server exit (reference
        # awaits tts_engine.shutdown() in its lifespan, oai_server.py:35);
        # the engine quiesces rather than closes, so embedding callers can
        # still reuse it after the app stops
        await app[TTS_ENGINE_KEY].shutdown()

    app.on_cleanup.append(_shutdown_engine)
    return app


def start_tts_engine(args) -> TTS:
    tts = TTS(
        scheduler_max_concurrency=args.max_concurrency,
        vllm_logging_level=args.vllm_logging_level,
    )
    kwargs = {}
    if getattr(args, "decode_slots", None) is not None:
        kwargs["decode_slots"] = args.decode_slots
    if getattr(args, "tensor_parallel_size", 1) != 1:
        kwargs["tensor_parallel_size"] = args.tensor_parallel_size
    if getattr(args, "data_parallel_replicas", 1) != 1:
        kwargs["data_parallel_replicas"] = args.data_parallel_replicas
    if getattr(args, "slot_bucketing", None) is not None:
        kwargs["slot_bucketing"] = args.slot_bucketing
    if getattr(args, "conditioning_cache_size", None) is not None:
        kwargs["conditioning_cache_size"] = args.conditioning_cache_size
    if getattr(args, "ref_length_quantum_s", None) is not None:
        kwargs["ref_length_quantum_s"] = args.ref_length_quantum_s
    if getattr(args, "kv_int8", None) is not None:
        kwargs["kv_int8"] = args.kv_int8
    if getattr(args, "device", None) is not None:
        kwargs["device"] = args.device
    return tts.from_pretrained(args.model, gpt_model=args.gpt_model, **kwargs)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="auralis-tpu OpenAI-compatible server")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--model", required=True, help="model directory")
    parser.add_argument("--gpt_model", default=None, help="GPT weights directory")
    parser.add_argument("--max_concurrency", type=int, default=10)
    parser.add_argument(
        "--vllm_logging_level", type=lambda s: getattr(logging, s.upper()),
        default=logging.WARNING, help="backend logging level",
    )
    parser.add_argument(
        "--warmup", action="store_true",
        help="capture every serving program (decode blocks, vocoder programs) "
             "on the card and run a traffic pass (requests and a stream) through "
             "the engine before accepting traffic (one-time boot cost)",
    )
    parser.add_argument(
        "--no_precompile", action="store_true",
        help="with --warmup: skip the up-front captures and run only the "
             "traffic pass; programs it does not reach are captured at first use",
    )
    parser.add_argument(
        "--decode_slots", type=int, default=None,
        help="concurrent decode sequences on the card (default 2x concurrency; "
             "clamped to the card's free memory after the weights at boot)",
    )
    parser.add_argument(
        "--tensor_parallel_size", type=int, default=1,
        help="shard attention heads/MLP over N GPUs (latency knob)",
    )
    parser.add_argument(
        "--data_parallel_replicas", type=int, default=1,
        help="independent engine replicas across local GPUs (throughput knob)",
    )
    parser.add_argument(
        "--slot_bucketing", action=argparse.BooleanOptionalAction, default=None,
        help="step only the lowest quarter/half of the decode slots at low "
             "occupancy, with automatic slot compaction (default off: on the H100 "
             "it cost e-book RTF). --slot_bucketing opts in",
    )
    parser.add_argument(
        "--kv_int8", action=argparse.BooleanOptionalAction, default=None,
        help="int8 KV cache (default off: on the H100 the dense int8 body lost "
             "to bf16 KV; a config.json's kv_int8 takes effect only with this "
             "flag). With ragged_decode in the GPT config, decode attention runs "
             "over the ragged int8 rows",
    )
    parser.add_argument(
        "--device", default=None,
        help="torch device the engine runs on (default cuda; cpu for tests)",
    )
    parser.add_argument(
        "--conditioning_cache_size", type=int, default=None,
        help="voices held in the conditioning LRU (default 32; ~0.2 MB "
             "per entry — raise for many-voice fleets)",
    )
    parser.add_argument(
        "--voices_dir", default=None,
        help="directory of .wav/.flac files registering named voices: a "
             "file stem becomes a `voice` value clients can use instead of "
             "shipping base64 reference audio per request (GET /v1/voices "
             "lists them)",
    )
    parser.add_argument(
        "--ref_length_quantum_s", type=float, default=None,
        help="reference-audio lengths truncate DOWN to this grid in seconds "
             "(default 1.0), as the JAX package does; 0 disables (exact lengths)",
    )
    return parser


def main(argv: Optional[list] = None) -> None:
    args = build_parser().parse_args(argv)

    voices = scan_voices_dir(args.voices_dir) if args.voices_dir else {}
    if voices:
        logger.info("Registered %d named voices: %s", len(voices), ", ".join(sorted(voices)))
    tts = start_tts_engine(args)
    if args.warmup:
        t0 = time.perf_counter()
        logger.info("Warming up (traffic pass)…")
        tts.warmup(precompile=not args.no_precompile)
        logger.info("Warmup complete in %.1f s", time.perf_counter() - t0)
    else:
        logger.warning(
            "Serving WITHOUT --warmup: the first requests pay the engine's "
            "one-time costs (kernel build or load, graph captures, allocator "
            "growth). "
            "Pass --warmup for production."
        )
    app = build_app(tts, voices=voices)
    logger.info("Serving on http://%s:%d", args.host, args.port)
    web.run_app(app, host=args.host, port=args.port, print=None)


if __name__ == "__main__":
    main()
