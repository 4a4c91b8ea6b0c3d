"""The TTS facade — the main public entry point.

API parity with the reference core/tts.py: `from_pretrained`,
`generate_speech` (sync), `generate_speech_async`, streaming,
`prepare_for_streaming_generation`, 100k-char request splitting, shutdown.
Orchestrates the two-phase scheduler over the engine registry.
"""
from __future__ import annotations

import asyncio
import json
import logging
import os
import time
import uuid
from functools import partial
from pathlib import Path
from typing import AsyncGenerator, Dict, Generator, List, Optional, Union

from ..common.logger import set_backend_logging_level, setup_logger
from ..common.metrics import track_generation
from ..common.output import TTSOutput
from ..common.requests import TTSRequest
from ..common.scheduler import TwoPhaseScheduler
from ..common.tracing import span
from ..models.base import BaseAsyncTTSEngine
from ..models.registry import get_model_factory

logger = setup_logger("tts")


class TTS:
    """High-performance TTS engine facade (sync + async + streaming)."""

    def __init__(self, scheduler_max_concurrency: int = 10, vllm_logging_level=logging.WARNING):
        # `vllm_logging_level` kept for API compatibility; maps to backend logs
        set_backend_logging_level(vllm_logging_level)
        self.concurrency = scheduler_max_concurrency
        self.scheduler: Optional[TwoPhaseScheduler] = TwoPhaseScheduler(
            second_phase_concurrency=scheduler_max_concurrency
        )
        self.tts_engine: Optional[BaseAsyncTTSEngine] = None
        self.loop: Optional[asyncio.AbstractEventLoop] = None

    # ------------------------------------------------------------- loading
    def _ensure_event_loop(self) -> None:
        if self.loop is None or self.loop.is_closed():
            try:
                self.loop = asyncio.get_running_loop()
            except RuntimeError:
                self.loop = asyncio.new_event_loop()
                asyncio.set_event_loop(self.loop)

    @staticmethod
    def _resolve_model_source(name_or_path: str) -> str:
        """Local directory passthrough, else a Hugging Face Hub id resolved
        via snapshot_download (reference: hf_hub_download fallback,
        core/tts.py:72-81). huggingface_hub is an optional dependency; in an
        offline build a hub id degrades to a clear ValueError."""
        if os.path.isdir(name_or_path):
            return name_or_path
        try:
            from huggingface_hub import snapshot_download
        except ImportError as e:
            raise ValueError(
                f"Could not load model from {name_or_path}: not a local "
                "directory, and huggingface_hub is not installed to treat it "
                "as a Hub id"
            ) from e
        try:
            return snapshot_download(repo_id=name_or_path)
        except Exception as e:
            raise ValueError(
                f"Could not load model from {name_or_path} neither locally "
                f"nor from the Hub: {e}"
            ) from e

    def from_pretrained(self, model_name_or_path: str, **kwargs) -> "TTS":
        """Load a local model directory or Hub id (synchronous)."""
        self._ensure_event_loop()
        model_name_or_path = self._resolve_model_source(model_name_or_path)
        if kwargs.get("gpt_model"):
            kwargs["gpt_model"] = self._resolve_model_source(kwargs["gpt_model"])
        config_path = os.path.join(model_name_or_path, "config.json")
        try:
            with open(config_path) as f:
                config = json.load(f)
        except FileNotFoundError as e:
            raise ValueError(
                f"Could not load model from {model_name_or_path}: no config.json"
            ) from e
        factory = get_model_factory(config.get("model_type", "xtts"))
        n_replicas = kwargs.pop("data_parallel_replicas", 1)

        async def _load():
            engine = factory(model_name_or_path, max_concurrency=self.concurrency, **kwargs)
            if n_replicas and n_replicas > 1:
                from ..parallel.replica import ReplicatedTTSEngine

                engine = ReplicatedTTSEngine.from_engine(engine, n_replicas=n_replicas)
            return engine

        self.tts_engine = self.loop.run_until_complete(_load())
        return self

    def with_engine(self, engine: BaseAsyncTTSEngine) -> "TTS":
        """Attach an already-constructed engine (tests, custom builds)."""
        self._ensure_event_loop()
        self.tts_engine = engine
        return self

    # -------------------------------------------------------------- phases
    async def prepare_for_streaming_generation(self, request: TTSRequest):
        """Precompute voice conditioning; returns a partial usable as the
        request's `context_partial_function` (voice caching)."""
        conditioning = self.tts_engine.conditioning_config
        if conditioning.speaker_embeddings or conditioning.gpt_like_decoder_conditioning:
            # pass the request's conditioning params so the prepared voice
            # matches (and shares the cache entry with) the normal path —
            # the reference's prepare path silently uses different engine
            # defaults (30/6/6 vs the request's 60/30/4), producing a
            # different clone depending on which path ran
            gpt_cond_latent, speaker_embeddings = await self.tts_engine.get_audio_conditioning(
                request.speaker_files,
                request.max_ref_length,
                request.gpt_cond_len,
                request.gpt_cond_chunk_len,
                sound_norm_refs=request.sound_norm_refs,
                load_sr=request.load_sample_rate,
            )
            return partial(
                self.tts_engine.get_generation_context,
                gpt_cond_latent=gpt_cond_latent,
                speaker_embeddings=speaker_embeddings,
            )
        return None

    async def _prepare_generation_context(self, input_request: TTSRequest) -> Dict:
        """Phase 1: build conditioning + one generation handle per chunk."""
        input_request.start_time = time.time()
        context_fn = input_request.context_partial_function or partial(
            self.tts_engine.get_generation_context
        )
        with span("phase1.context"):
            handles, request_ids, speaker_embeddings, conditioning = await context_fn(
                input_request
            )
        parallel_inputs = [
            {
                "generator": handle,
                "speaker_embedding": speaker_embeddings,
                "multimodal_data": conditioning,
                "request": input_request,
                # invoked by the scheduler when the request is abandoned
                # before this chunk's phase-2 generator ever started (a
                # started generator aborts its own handle); stops the
                # engine from decoding tokens nobody will consume
                "cancel": partial(self.tts_engine.cancel_generation_handle, handle),
            }
            for handle in handles
        ]
        return {"parallel_inputs": parallel_inputs, "request": input_request}

    @track_generation
    async def _second_phase_fn(self, gen_input: Dict) -> AsyncGenerator[TTSOutput, None]:
        """Phase 2: decode handle -> audio chunks."""
        async for chunk in self.tts_engine.process_tokens_to_speech(
            generator=gen_input["generator"],
            speaker_embeddings=gen_input["speaker_embedding"],
            multimodal_data=gen_input["multimodal_data"],
            request=gen_input["request"],
        ):
            yield chunk

    # --------------------------------------------------------------- public
    @staticmethod
    async def _materialize_text_async(request: TTSRequest) -> None:
        """Resolve flexible `text` inputs (reference requests.py:165 —
        str | List[str] | AsyncGenerator[str, None]) to a concrete form the
        frontend consumes: async generators and sync iterables drain to a
        list; strings and lists pass through."""
        text = request.text
        if isinstance(text, str) or (
            isinstance(text, list) and all(isinstance(t, str) for t in text)
        ):
            return
        if hasattr(text, "__anext__"):
            request.text = [t async for t in text]
        elif hasattr(text, "__iter__"):
            request.text = [str(t) for t in text]
        else:
            raise TypeError(
                f"TTSRequest.text must be str, list[str], an iterable, or an "
                f"async generator; got {type(text).__name__}"
            )
        request.infer_language()

    async def generate_speech_async(
        self, request: TTSRequest
    ) -> Union[AsyncGenerator[TTSOutput, None], TTSOutput]:
        self._ensure_event_loop()
        await self._materialize_text_async(request)
        # >100k-char splitting applies on the async path too (it previously
        # ran only in sync generate_speech, so the HTTP serving path
        # submitted oversized requests whole — one failure domain and one
        # scheduler deadline for a whole book)
        requests = self.split_requests(request)
        if not request.stream and len(requests) > 1:
            return await self._process_multiple_requests(requests)

        async def process_chunks():
            chunks = []
            for sub in requests:
                agen = self.scheduler.run(
                    inputs=sub,
                    request_id=sub.request_id,
                    first_phase_fn=self._prepare_generation_context,
                    second_phase_fn=self._second_phase_fn,
                )
                try:
                    async for chunk in agen:
                        if request.stream:
                            yield chunk
                        else:
                            # only the combining path needs the chunks; a
                            # stream must not retain the whole waveform
                            chunks.append(chunk)
                finally:
                    # deterministic cleanup when the caller abandons the
                    # stream: async-for never acloses its source, so without
                    # this the scheduler's finally (which cancels in-flight
                    # decode work) would wait for GC/asyncgen-shutdown hooks
                    await agen.aclose()
            if not request.stream:
                yield TTSOutput.combine_outputs(chunks)

        if request.stream:
            return process_chunks()
        async for result in process_chunks():
            return result

    @staticmethod
    def split_requests(request: TTSRequest, max_length: int = 100_000) -> List[TTSRequest]:
        """Split >100k-char requests into independent sub-requests. List
        texts split per-element (each element is already an independent
        frontend unit); only oversized str elements are cut."""
        if not isinstance(request.text, str):
            out = []
            for element in request.text:
                sub = request.copy()
                sub.text = element
                sub.request_id = uuid.uuid4().hex
                out.extend(TTS.split_requests(sub, max_length))
            return out or [request]
        if len(request.text) <= max_length:
            return [request]
        out = []
        for i in range(0, len(request.text), max_length):
            sub = request.copy()
            sub.text = request.text[i : i + max_length]
            sub.request_id = uuid.uuid4().hex
            out.append(sub)
        return out

    async def _process_multiple_requests(self, requests: List[TTSRequest]) -> TTSOutput:
        async def one(sub: TTSRequest) -> List[TTSOutput]:
            chunks = []
            async for chunk in self.scheduler.run(
                inputs=sub,
                request_id=sub.request_id,
                first_phase_fn=self._prepare_generation_context,
                second_phase_fn=self._second_phase_fn,
            ):
                chunks.append(chunk)
            return chunks

        tasks = [asyncio.create_task(one(r)) for r in requests]
        try:
            all_chunks = await asyncio.gather(*tasks)
        except BaseException:
            # one sub-request failed: cancel the siblings (their scheduler
            # cleanup stops the in-flight decode work) instead of leaving
            # them to decode unconsumed into a stopped loop
            for t in tasks:
                if not t.done():
                    t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
            raise
        flat = [c for chunks in all_chunks for c in chunks]
        return TTSOutput.combine_outputs(flat)

    def generate_speech(
        self, request: TTSRequest
    ) -> Union[Generator[TTSOutput, None, None], TTSOutput]:
        """Synchronous entry point; returns a generator when streaming."""
        self._ensure_event_loop()
        self.loop.run_until_complete(self._materialize_text_async(request))
        requests = self.split_requests(request)

        if request.stream:

            def streaming_wrapper():
                for sub in requests:
                    agen = self.scheduler.run(
                        inputs=sub,
                        request_id=sub.request_id,
                        first_phase_fn=self._prepare_generation_context,
                        second_phase_fn=self._second_phase_fn,
                    )
                    try:
                        while True:
                            try:
                                yield self.loop.run_until_complete(anext(agen))
                            except StopAsyncIteration:
                                break
                    finally:
                        # caller closed the sync generator mid-stream: run
                        # the scheduler's cleanup (cancels in-flight decode)
                        # now, not at GC time
                        if not self.loop.is_closed():
                            self.loop.run_until_complete(agen.aclose())

            return streaming_wrapper()
        return self.loop.run_until_complete(self._process_multiple_requests(requests))

    def warmup(self, text: Optional[str] = None, precompile: bool = True) -> None:
        """Compile every serving program with synthetic inputs.

        All device programs have bounded shape sets (prefill buckets, decode
        block sizes x length buckets, fixed vocoder batches, 1s-quantized
        conditioning), so one warmup pass makes serving fully hot; without
        it the first requests pay multi-second XLA compiles. The reference
        needs no analogue (eager torch), which is why it has no such API.

        `precompile=False` (development boots / --no_precompile) skips the
        AOT program sets (decode slot/length matrix, insert matrix, vocoder
        buckets) and runs only the traffic pass: boot gets much cheaper, but
        the first production traffic that forms an unwarmed shape pays a
        lazy compile mid-serving (~90 s on remote-compile rigs). Cold/warm
        wall times are published in docs/advanced/performance.md."""
        import tempfile

        import numpy as np

        from ..common import audio_io

        self._ensure_event_loop()
        sr = 22050
        t = np.arange(sr * 6) / sr
        voice = (0.4 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
        with tempfile.NamedTemporaryFile(suffix=".wav", delete=False) as f:
            audio_io.write_wav(f.name, voice, sr)
            voice_path = f.name
        # a long text exercises max-length chunks (all KV length buckets);
        # concurrent copies fill a vocoder batch; one streaming request
        # compiles the segment vocoder + short-block decode variants
        text = text or (
            "the quick brown fox jumps over the lazy dog while speech "
            "synthesis warms every compiled program on this chip. " * 12
        )

        async def _run():
            # a burst (not a pair) of concurrent requests: the runner's
            # batched prefill compiles one program per (K bucket, prompt
            # bucket), so warmup must hit the K buckets {2,4,8} a production
            # burst will use — 8 concurrent long-text requests cover them
            reqs = [
                TTSRequest(text=text, speaker_files=[voice_path], language="en")
                for _ in range(8)
            ]
            await asyncio.gather(*(self.generate_speech_async(r) for r in reqs))
            stream_req = TTSRequest(
                text=text[:200], speaker_files=[voice_path], language="en",
                stream=True,
            )
            agen = await self.generate_speech_async(stream_req)
            async for _ in agen:
                pass

        if precompile:
            # vocoder buckets FIRST: the warmup requests only hit the buckets
            # their chunk lengths land in, and compiles dispatched AFTER the
            # requests would leave queued device work that bleeds into the
            # first production traffic (precompile_vocoder_buckets drains
            # itself before returning)
            precompile_vocoder = getattr(
                self.tts_engine, "precompile_vocoder_buckets", None
            )
            if precompile_vocoder is not None:
                precompile_vocoder()
            # decode-block executables likewise: with slot bucketing on, the
            # narrow slot-bound programs (and migrate_slot) would otherwise
            # compile lazily at the first drain — mid-serving. Engine-level
            # method so ReplicatedTTSEngine forwards it to every replica.
            precompile_decode = getattr(
                self.tts_engine, "precompile_decode_programs", None
            )
            if precompile_decode is not None:
                precompile_decode()
        try:
            self.loop.run_until_complete(_run())
        finally:
            Path(voice_path).unlink(missing_ok=True)

    async def shutdown(self) -> None:
        if self.scheduler:
            await self.scheduler.shutdown()
        if self.tts_engine is not None:
            await self.tts_engine.shutdown()
