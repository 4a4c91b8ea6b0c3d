"""Benchmark of the PyTorch/CUDA port (auralis_tpu_torch) on one NVIDIA GPU:
bench.py's four sections, with bench.py's traffic, on the port.

    python3 bench_torch.py [--config default|bf16|int8]

Runs the complete public path (TTS facade -> scheduler -> conditioning ->
continuous-batched decode -> vocoder, then the OpenAI-compatible server) at
the full XTTSv2 width (GPT 30 x 1024, 16 heads, full HiFi-GAN) with seeded
random weights and a tokenizer trained here (no checkpoint is in the
repository; compute cost does not depend on the weights' values). Random
weights never sample the stop token, so every chunk runs to the 605-token
cap.

Configurations (`--config`):
- default: `XTTSConfig()` with no kernel flag and every engine flag left to
  the engine's own serving defaults (`serving_defaults`: on one card the
  values an H100 A/B set for int8 KV, the per-program W8A8 policy, int8
  prefill and slot bucketing), as bench.py builds its engine; the dense
  decode bodies and the prompt's attention in plain PyTorch, kernel K3
  (MRF) in the vocoder.
- bf16: `prefill_flash` + `flash_decode`, bf16 weights and KV cache;
  kernels K1 (prefill attention), K2 (flash-decode append), K3.
- int8: `prefill_flash` + `ragged_decode`, with `kv_int8`, `decode_w8a8`
  (on every decode program) and `prefill_w8a8`; kernels K1, K4 (ragged int8
  decode), K3. Neither is the JAX package's TPU serving configuration: that
  is bench.py's flagless engine (`default` here), which on a TPU ran the
  dense int8 body, the W8A8 policy, int8 prefill and bucketing.
bf16 and int8 pin every engine flag to what they ran when they were
introduced: int8 prefill and the W8A8 policy off on bf16, slot bucketing
off on both unless BENCH_SLOT_BUCKETING sets it.

Sections, in bench.py's order and with its traffic:
1. RTF: N_REQUESTS requests of SENTENCE * 2 * CHUNKS_PER_REQUEST at
   CONCURRENCY, sampled; the best of up to three timed runs (`value`), every
   run in `runs`.
2. TTFA: SENTENCE * 4 streaming requests; one solo and one batch of
   CONCURRENCY as warmup, one batch measured (p50, p95 = the max of 8).
3. Short phrase: a 60-character phrase at concurrency 1; one warm call, 10
   timed calls capped at 140 tokens, one uncapped call.
4. Server load: the port's build_app in-process under aiohttp's TestServer
   on a second facade at SERVER_CONCURRENCY sharing the warm engine and its
   loop; SERVER_REQUESTS multilingual POSTs with base64 voices and
   enhancement, run uncapped and capped at 140 tokens.
5. Sustained load (last, when the budget allows): waves of CONCURRENCY
   requests on the warm engine; device memory allocated and reserved, graph
   captures and host RSS after each wave must hold steady.

Cold and warm costs are measured apart, before any timed section: the
kernels' build, the native audio library's build (`make -C native`), the
engine's boot, one request on the unwarmed engine, then the warmup
(`precompile_decode_programs()`, a batch of 2 RTF requests,
`precompile_vocoder_buckets()`), each timed. Every timed section reports
the CUDA-graph captures made inside it (`captures_in_timed`, with their
keys): no program should be captured mid-measurement.

Output (bench.py's emission contract): a stub JSON line at start, then one
complete JSON line after each section, each with every key of bench.py's
result (null until measured) plus `backend`, `config`, `device`, versions,
the settings, the cold costs, per-section request counts and captures and
`peak_reserved_gib`. A budget (BENCH_BUDGET_S, default 1500 s) is checked
between sections; a section that does not fit is named in
`skipped_sections`. Runner telemetry and the tracing phase split go to
stderr. `vs_baseline` is BASELINE_RTF / RTF, where BASELINE_RTF = 0.02 is
the upstream README's claim on an RTX 3090, not a TPU figure.

Environment, as bench.py reads it: BENCH_DECODE_SLOTS (64),
BENCH_STEPS_PER_SYNC (64), BENCH_SLOT_BUCKETING (1/0; unset: the engine's
default, or off for bf16 and int8), BENCH_SERVER_CONCURRENCY (32),
BENCH_SERVER_REQUESTS (32), BENCH_SKIP_SERVER=1, BENCH_BUDGET_S. The port
adds BENCH_KV_INT8, BENCH_DECODE_W8A8 and BENCH_PREFILL_W8A8 (1/0; unset:
the configuration's value, else the engine's default) for the defaults'
A/Bs; BENCH_DECODE_W8A8=0 also disarms the W8A8 policy. The engine's
resolved flags are in the result's `config.resolved`. bench.py's BENCH_PREFILL_FLASH and
BENCH_SEG_FIRST_BATCH1 are not read: `--config` sets the kernel flags, and
the port's engine ignores seg_first_batch1 (it pads no batch).

There is no CPU path: the script exits non-zero, printing no result, when
no CUDA device is visible. A failed request is counted in `failed` and
makes the script exit non-zero. The section functions take the facade and
their depth as arguments, so tests drive them on a small CPU engine.
"""
from __future__ import annotations

import argparse
import asyncio
import base64
import contextlib
import dataclasses
import gc
import io
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch
from aiohttp.test_utils import TestClient, TestServer

from auralis_tpu_torch import TTS, TTSRequest
from auralis_tpu_torch.common import audio_io, native_audio
from auralis_tpu_torch.common.tracing import profile_summary
from auralis_tpu_torch.models.xttsv2.config import XTTSConfig
from auralis_tpu_torch.models.xttsv2.engine import XTTSv2Engine
from auralis_tpu_torch.ops import _build
from auralis_tpu_torch.runtime import graphs
from auralis_tpu_torch.server.oai_server import build_app

# ------------------------------------------------ bench.py's constants
BASELINE_RTF = 0.02
BASELINE_NOTE = ("vs_baseline = BASELINE_RTF / value; BASELINE_RTF 0.02 is the upstream "
                 "README's claim on an RTX 3090, not a TPU figure")
BENCH_START = time.time()
BUDGET_S = float(os.environ.get("BENCH_BUDGET_S", "1500"))
CONCURRENCY = 8
CHUNKS_PER_REQUEST = 16
N_REQUESTS = 8
SERVER_CONCURRENCY = int(os.environ.get("BENCH_SERVER_CONCURRENCY", "32"))
SERVER_REQUESTS = int(os.environ.get("BENCH_SERVER_REQUESTS", "32"))
SENTENCE = (
    "the quick brown fox jumps over the lazy dog while voice cloning "
    "speech synthesis runs on tensor processing hardware. "
)
SAMPLING = {"temperature": 0.75, "top_p": 0.85, "top_k": 50, "repetition_penalty": 5.0}
SHORT_PHRASE = "The quick brown fox jumps over the lazy dog near the river."
SHORT_CAP = 140  # tokens: a real checkpoint's stop token for a 60-char phrase (~6.5 s)
SERVER_TEXTS = {
    "en": "The quick brown fox jumps over the lazy dog near the river.",
    "es": "El rápido zorro marrón salta sobre el perro perezoso.",
    "de": "Der schnelle braune Fuchs springt über den faulen Hund.",
    "fr": "Le renard brun rapide saute par-dessus le chien paresseux.",
}
RTF_REPS = 3
SHORT_REPS = 10
SUSTAINED_WAVES = 10
SUSTAINED_TEXT = "the quick brown fox jumps over the lazy dog. " * 4
SUSTAINED_GROWTH_BYTES = 32 * 2**20

# the keys of bench.py's result line (BENCH_r05.json's "parsed")
RESULT_KEYS = (
    "metric", "value", "unit", "vs_baseline", "runs", "ttfa_p50_ms", "ttfa_p95_ms",
    "short_phrase_p50_ms", "short_phrase_p95_ms", "short_phrase_audio_s",
    "short_phrase_uncapped_ms", "server_req_s", "server_p50_ms", "server_p95_ms",
    "server_audio_s_per_s", "server_rtf", "server_capped_req_s", "server_capped_p50_ms",
    "server_capped_p95_ms", "server_capped_audio_s_per_s", "skipped_sections",
)

# --config: (GPT config flags, engine flags); an engine flag left out takes
# the engine's default
CONFIGS = {
    "default": ({}, {}),
    "bf16": ({"prefill_flash": True, "flash_decode": True},
             {"kv_int8": False, "decode_w8a8": False, "prefill_w8a8": False,
              "slot_bucketing": False}),
    "int8": ({"prefill_flash": True, "ragged_decode": True},
             {"kv_int8": True, "decode_w8a8": True, "prefill_w8a8": True,
              "slot_bucketing": False}),
}
# the kernels (chip_smoke's wrapper names) each configuration's path runs
CONFIG_KERNELS = {
    "default": ("mrf_stage",),
    "bf16": ("prefill_attention", "flash_decode_append", "mrf_stage"),
    "int8": ("prefill_attention", "ragged_decode", "mrf_stage"),
}
# the port's engine-flag overrides: environment variable -> engine flag
FLAG_ENV = {"BENCH_KV_INT8": "kv_int8", "BENCH_DECODE_W8A8": "decode_w8a8",
            "BENCH_PREFILL_W8A8": "prefill_w8a8"}
SAMPLE_RATE = 24000


def _emit(payload: dict) -> None:
    """Print the result so far as one complete JSON line and flush."""
    print(json.dumps(payload), flush=True)


def _budget_left() -> float:
    return BUDGET_S - (time.time() - BENCH_START)


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def engine_settings() -> dict:
    """bench.py's engine settings with its environment overrides."""
    sb = os.environ.get("BENCH_SLOT_BUCKETING")
    return {
        "decode_slots": int(os.environ.get("BENCH_DECODE_SLOTS", "64")),
        "steps_per_sync": int(os.environ.get("BENCH_STEPS_PER_SYNC", "64")),
        "slot_bucketing": None if sb is None else sb == "1",
    }


# ------------------------------------------------------------ bookkeeping
@dataclasses.dataclass
class Section:
    """A section's result: its metrics (keys of the result line) and its
    bookkeeping: requests attempted and failed, and of its timed regions
    the idle rows at the first one's start (DecodeEngine.idle_rows) and the
    captures inside all, with their keys."""
    engine: object
    metrics: dict = dataclasses.field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    captures_in_timed: int = 0
    captured_keys: list = dataclasses.field(default_factory=list)
    idle_rows: int | None = None

    def count(self, attempted: int, failed: int) -> None:
        self.attempted += attempted
        self.failed += failed

    @contextlib.contextmanager
    def timed(self):
        if self.idle_rows is None:
            self.idle_rows = self.engine.decode_engine.idle_rows()
        n0 = len(graphs.captured_keys)
        try:
            yield
        finally:
            new = graphs.captured_keys[n0:]
            self.captures_in_timed += len(new)
            self.captured_keys += [str(k) for k in new]

    def book(self) -> dict:
        return {"attempted": self.attempted, "failed": self.failed,
                "captures_in_timed": self.captures_in_timed,
                "captured_keys": self.captured_keys, "idle_rows": self.idle_rows}


async def _gather(coros) -> tuple[list, int]:
    """Run the requests concurrently: (results of those that succeeded,
    number that failed). Each failure's traceback goes to stderr."""
    results = await asyncio.gather(*coros, return_exceptions=True)
    ok = []
    for r in results:
        if isinstance(r, BaseException):
            traceback.print_exception(r, file=sys.stderr)
        else:
            ok.append(r)
    return ok, len(results) - len(ok)


def _run(tts: TTS, coros) -> tuple[list, int]:
    return tts.loop.run_until_complete(_gather(coros))


def _audio_s(out) -> float:
    return len(out.array) / SAMPLE_RATE


# ------------------------------------------------------------ the engine
def build_tokenizer():
    """bench.py's BPE tokenizer, trained here."""
    from tokenizers import Tokenizer, models, trainers

    from auralis_tpu_torch.frontend.tokenizer import TTSTokenizer

    tok = Tokenizer(models.BPE(unk_token="[UNK]"))
    trainer = trainers.BpeTrainer(
        vocab_size=3000,
        special_tokens=["[PAD]", "[UNK]", "[START]", "[STOP]", "[SPACE]", "[en]"],
    )
    words = ["the", "quick", "brown", "fox", "jumps", "over", "lazy", "dog",
             "voice", "cloning", "speech", "synthesis", "tensor", "processing"]
    corpus = ["[SPACE]".join(words), "abcdefghijklmnopqrstuvwxyz.,!?'0123456789"]
    tok.train_from_iterator(corpus, trainer)
    return TTSTokenizer(tok)


def engine_kwargs(config: str, settings: dict) -> dict:
    """The engine flags of `config`, under the environment's overrides
    (FLAG_ENV, then `settings`' slot_bucketing when set), and `settings`'
    slot and step counts. A flag none of them sets is left to the engine."""
    kw = dict(CONFIGS[config][1])
    for var, flag in FLAG_ENV.items():
        if os.environ.get(var) is not None:
            kw[flag] = os.environ[var] == "1"
    kw.update({k: v for k, v in settings.items() if v is not None})
    return kw


def resolved_flags(engine: XTTSv2Engine) -> dict:
    """What the engine runs after its defaults: the GPT config's flags, the
    W8A8 policy and its crossover, slot bucketing and the attn_fp region."""
    g, de = engine.gpt_config, engine.decode_engine
    return {**{k: getattr(g, k) for k in ("prefill_flash", "flash_decode", "ragged_decode",
                                          "kv_int8", "decode_w8a8", "prefill_w8a8",
                                          "decode_attn_fp")},
            "w8a8_policy": de._w8a8_policy is not None, "w8a8_crossover": engine.w8a8_crossover,
            "slot_bucketing": de.slot_bucketing, "attn_fp_max_cells": de._attn_fp_max_cells}


def build_engine(config: str, settings: dict, device="cuda",
                 base: XTTSConfig | None = None) -> XTTSv2Engine:
    """The full-width engine of `config` (on `base`'s architecture when
    given, as a test's tiny one) with seed-0 random bf16 weights."""
    cfg = base or XTTSConfig()
    cfg.gpt = dataclasses.replace(cfg.gpt, **CONFIGS[config][0])
    return XTTSv2Engine.random_init(
        config=cfg, tokenizer=build_tokenizer(), dtype=torch.bfloat16, device=device,
        max_concurrency=CONCURRENCY, **engine_kwargs(config, settings))


def write_speaker(path: str) -> str:
    """bench.py's synthetic 6 s speaker reference at 22.05 kHz."""
    sr = 22050
    t = np.arange(sr * 6) / sr
    speaker = (0.5 * np.sin(2 * np.pi * 210 * t) * (0.8 + 0.2 * np.sin(2 * np.pi * 3 * t)))
    audio_io.write_wav(path, speaker.astype(np.float32), sr)
    return path


def _rtf_requests(speaker: str, n: int, chunks: int) -> list:
    # a "book section": the chunker packs it into ~`chunks` ~240-char chunks,
    # which all enter the decode loop as parallel sequences
    return [TTSRequest(text=SENTENCE * (2 * chunks), speaker_files=[speaker], language="en",
                       **SAMPLING) for _ in range(n)]


def _short_request(speaker: str, max_new: int | None) -> TTSRequest:
    r = TTSRequest(text=SHORT_PHRASE, speaker_files=[speaker], language="en")
    if max_new is not None:
        r.max_new_tokens = max_new
    return r


def _sync(engine) -> None:
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)


def run_cold_and_warm(tts: TTS, speaker: str, warm_requests: int = 2,
                      chunks: int = CHUNKS_PER_REQUEST) -> Section:
    """On an unwarmed engine: one uncapped short-phrase request (its
    captures are the cold cost), then bench.py's warmup, each part timed:
    precompile_decode_programs(), a batch of `warm_requests` RTF requests,
    precompile_vocoder_buckets()."""
    engine = tts.tts_engine
    sec = Section(engine)
    m = sec.metrics
    c0 = dict(graphs.counts)
    t0 = time.perf_counter()
    outs, failed = _run(tts, [tts.generate_speech_async(_short_request(speaker, None))])
    m["cold_first_request_s"] = round(time.perf_counter() - t0, 3)
    m["cold_first_request_audio_s"] = round(sum(map(_audio_s, outs)), 3)
    m["cold_first_request_captures"] = graphs.counts["captures"] - c0["captures"]
    # of its wall, the seconds spent capturing and instantiating graphs
    m["cold_first_request_capture_s"] = round(
        sum(graphs.counts[k] - c0[k] for k in ("capture_s", "instantiate_s")), 3)
    sec.count(1, failed)

    def timed(name: str, fn) -> None:
        c = graphs.counts["captures"]
        t = time.perf_counter()
        fn()
        _sync(engine)
        m[f"{name}_s"] = round(time.perf_counter() - t, 3)
        m[f"{name}_captures"] = graphs.counts["captures"] - c

    timed("precompile_decode", engine.precompile_decode_programs)

    def warm_batch():
        _, f = _run(tts, [tts.generate_speech_async(r)
                          for r in _rtf_requests(speaker, warm_requests, chunks)])
        sec.count(warm_requests, f)

    timed("warmup_batch", warm_batch)
    timed("precompile_vocoder", engine.precompile_vocoder_buckets)
    return sec


# ------------------------------------------------------------ sections
def run_rtf(tts: TTS, speaker: str, n_requests: int = N_REQUESTS,
            chunks: int = CHUNKS_PER_REQUEST, reps: int = RTF_REPS) -> Section:
    """bench.py's RTF section (config 4, e-book): `reps` timed runs of
    `n_requests` requests of ~`chunks` chunks each; the best run is `value`."""
    engine = tts.tts_engine
    de = engine.decode_engine
    sec = Section(engine)
    # runner telemetry covers only the timed runs
    de.reset_stats()
    rtfs = []
    for _ in range(reps):
        with sec.timed():
            t0 = time.time()
            outs, failed = _run(tts, [tts.generate_speech_async(r)
                                      for r in _rtf_requests(speaker, n_requests, chunks)])
            _sync(engine)
            wall = time.time() - t0
        sec.count(n_requests, failed)
        audio_s = sum(map(_audio_s, outs))
        if audio_s > 0:
            rtfs.append(wall / audio_s)
    st = dict(de.stats)
    if st["blocks"]:
        _log(f"[runner] blocks={st['blocks']} avg_occupancy="
             f"{st['occupancy_sum'] / st['blocks']:.1f}/{de.num_slots} "
             f"migrations={st['migrations']} inserts={st['inserts']} "
             f"insert_batches={st['insert_batches']} insert_s={st['insert_s']:.2f} "
             f"(upload={st['insert_upload_s']:.2f} dispatch={st['insert_dispatch_s']:.2f}) "
             f"dispatch_s={st['dispatch_s']:.2f} status_wait_s={st['status_wait_s']:.2f} "
             f"harvest_s={st['harvest_s']:.2f}")
    _log(f"[runner] rtf_runs={[round(r, 5) for r in rtfs]}")
    rtf = min(rtfs) if rtfs else None
    sec.metrics.update({
        "metric": "full-pipeline RTF (wall / generated-audio-seconds), "
        f"e-book style: {n_requests} requests x ~{chunks} chunks "
        f"@ concurrency {CONCURRENCY}, 30L GPT + HiFi-GAN",
        "value": None if rtf is None else round(rtf, 5),
        "unit": "x realtime",
        "vs_baseline": None if rtf is None else round(BASELINE_RTF / rtf, 2),
        "baseline_note": BASELINE_NOTE,
        "runs": [round(r, 5) for r in rtfs],
    })
    return sec


def run_ttfa(tts: TTS, speaker: str, streams: int = CONCURRENCY) -> Section:
    """bench.py's TTFA section (config 3): time to first audio of `streams`
    concurrent streaming requests of SENTENCE * 4, after one solo stream
    and one batch as warmup."""
    sec = Section(tts.tts_engine)

    async def ttfa_one() -> float:
        t0 = time.time()
        agen = await tts.generate_speech_async(TTSRequest(
            text=SENTENCE * 4, speaker_files=[speaker], language="en", stream=True))
        ttfa = None
        async for _chunk in agen:
            if ttfa is None:
                ttfa = time.time() - t0
        if ttfa is None:
            raise RuntimeError("the stream gave no audio")
        return ttfa

    _, failed = _run(tts, [ttfa_one()])
    sec.count(1, failed)
    _, failed = _run(tts, [ttfa_one() for _ in range(streams)])
    sec.count(streams, failed)
    with sec.timed():
        ttfas, failed = _run(tts, [ttfa_one() for _ in range(streams)])
    sec.count(streams, failed)
    ttfas = sorted(ttfas)
    if ttfas:
        p50 = ttfas[len(ttfas) // 2]
        p95 = ttfas[min(len(ttfas) - 1, int(len(ttfas) * 0.95))]
        _log(f"[ttfa] p50={p50 * 1e3:.0f} ms p95={p95 * 1e3:.0f} ms (the max of {len(ttfas)}) "
             f"@ concurrency {streams} (target <300 ms); all: "
             f"{[round(t * 1e3, 1) for t in ttfas]}")
    sec.metrics.update({
        "ttfa_p50_ms": round(p50 * 1e3, 1) if ttfas else None,
        "ttfa_p95_ms": round(p95 * 1e3, 1) if ttfas else None,
        "ttfa_ms": [round(t * 1e3, 1) for t in ttfas],
    })
    return sec


def run_short_phrase(tts: TTS, speaker: str, reps: int = SHORT_REPS) -> Section:
    """bench.py's short-phrase section: one <100-char request at a time on
    the warm engine; one warm call, `reps` calls capped at SHORT_CAP tokens
    (p50, p95 = the max), one uncapped call."""
    sec = Section(tts.tts_engine)

    async def one(max_new):
        t0 = time.perf_counter()
        out = await tts.generate_speech_async(_short_request(speaker, max_new))
        return time.perf_counter() - t0, _audio_s(out)

    _, failed = _run(tts, [one(SHORT_CAP)])
    sec.count(1, failed)
    capped = []
    with sec.timed():
        for _ in range(reps):
            got, failed = _run(tts, [one(SHORT_CAP)])
            capped += got
            sec.count(1, failed)
        uncapped, failed = _run(tts, [one(None)])
        sec.count(1, failed)
    lats = sorted(dt for dt, _ in capped)
    m = sec.metrics
    m["short_phrase_p50_ms"] = round(lats[len(lats) // 2] * 1e3, 1) if lats else None
    m["short_phrase_p95_ms"] = round(lats[-1] * 1e3, 1) if lats else None
    m["short_phrase_audio_s"] = round(capped[0][1], 2) if capped else None
    m["short_phrase_uncapped_ms"] = round(uncapped[0][0] * 1e3, 1) if uncapped else None
    m["short_phrase_uncapped_audio_s"] = round(uncapped[0][1], 2) if uncapped else None
    _log(f"[short-phrase] p50={m['short_phrase_p50_ms']} ms p95(max of {reps})="
         f"{m['short_phrase_p95_ms']} ms for {m['short_phrase_audio_s']} s audio @ concurrency "
         f"1; uncapped={m['short_phrase_uncapped_ms']} ms for "
         f"{m['short_phrase_uncapped_audio_s']} s")
    return sec


def _voice_b64(f0: float) -> str:
    sr = 22050
    t = np.arange(sr * 3) / sr
    buf = io.BytesIO()
    audio_io.write_wav(buf, (0.4 * np.sin(2 * np.pi * f0 * t)).astype(np.float32), sr)
    return base64.b64encode(buf.getvalue()).decode()


class RequestFailed(RuntimeError):
    pass


def run_server_load(tts: TTS, n_requests: int = SERVER_REQUESTS) -> Section:
    """bench.py's server-load section (config 5): the port's app in-process
    on a facade at SERVER_CONCURRENCY that shares the warm engine and its
    loop; `n_requests` multilingual POSTs with base64 voice clones and
    enhancement, uncapped and then capped at SHORT_CAP tokens. Every
    response must be a 200 with a WAV body."""
    engine = tts.tts_engine
    sec = Section(engine)
    langs = list(SERVER_TEXTS)
    voices = [_voice_b64(f0) for f0 in (180.0, 220.0, 260.0)]
    de = engine.decode_engine

    async def run() -> dict:
        # a second facade on the same engine and loop: only the admission
        # width differs (single-chunk requests hold one slot each)
        tts_srv = TTS(scheduler_max_concurrency=SERVER_CONCURRENCY).with_engine(engine)
        client = TestClient(TestServer(build_app(tts_srv)))
        await client.start_server()
        sem = asyncio.Semaphore(SERVER_CONCURRENCY)

        async def one(i: int, max_new: int | None = None):
            body = {"model": "xttsv2", "input": SERVER_TEXTS[langs[i % len(langs)]],
                    "voice": [voices[i % len(voices)]], "language": langs[i % len(langs)],
                    "enhance_speech": True, "response_format": "wav"}
            if max_new is not None:
                body["max_new_tokens"] = max_new
            async with sem:
                t0 = time.perf_counter()
                resp = await client.post("/v1/audio/speech", json=body)
                payload = await resp.read()
                dt = time.perf_counter() - t0
            if resp.status != 200 or payload[:4] != b"RIFF" or payload[8:12] != b"WAVE":
                raise RequestFailed(f"status {resp.status}: {payload[:200]!r}")
            # 44-byte header + s16le PCM at 24 kHz
            return dt, (len(payload) - 44) / 2 / SAMPLE_RATE

        async def measure(tag: str, max_new: int | None) -> dict:
            profile_summary(reset=True)
            de.reset_stats()
            with sec.timed():
                t0 = time.perf_counter()
                results, failed = await _gather([one(i, max_new) for i in range(n_requests)])
                wall = time.perf_counter() - t0
            sec.count(n_requests, failed)
            for name, rec in sorted(profile_summary().items()):
                if name.startswith(("server.", "sched.", "phase1.", "phase2.", "request.")):
                    _log(f"[server-phase:{tag}] {name:28s} n={rec['count']:<4d} "
                         f"total={rec['total_s']:8.2f}s mean={rec['mean_ms']:8.1f}ms "
                         f"max={rec['max_ms']:8.1f}ms")
            st = de.stats
            if st["blocks"]:
                _log(f"[server-runner:{tag}] blocks={st['blocks']} avg_occupancy="
                     f"{st['occupancy_sum'] / st['blocks']:.1f}/{de.num_slots} "
                     f"inserts={st['inserts']} insert_s={st['insert_s']:.2f} "
                     f"dispatch_s={st['dispatch_s']:.2f} "
                     f"status_wait_s={st['status_wait_s']:.2f} harvest_s={st['harvest_s']:.2f}")
            if not results:
                return dict.fromkeys(("req_s", "p50_ms", "p95_ms", "audio_s_per_s", "rtf"))
            lats = sorted(r[0] for r in results)
            audio_s = sum(r[1] for r in results)
            return {
                "req_s": round(len(results) / wall, 2),
                "p50_ms": round(lats[len(lats) // 2] * 1e3, 1),
                "p95_ms": round(lats[max(0, int(len(lats) * 0.95) - 1)] * 1e3, 1),
                "audio_s_per_s": round(audio_s / wall, 1),
                "rtf": round(wall / max(audio_s, 1e-9), 5),
            }

        try:
            # warmup: the new voices' conditioning
            n_warm = min(4, n_requests)
            _, failed = await _gather([one(i) for i in range(n_warm)])
            sec.count(n_warm, failed)
            full = await measure("uncapped", None)
            capped = await measure(f"capped{SHORT_CAP}", SHORT_CAP)
        finally:
            await client.close()
        return {
            "server_req_s": full["req_s"], "server_p50_ms": full["p50_ms"],
            "server_p95_ms": full["p95_ms"], "server_audio_s_per_s": full["audio_s_per_s"],
            "server_rtf": full["rtf"], "server_capped_req_s": capped["req_s"],
            "server_capped_p50_ms": capped["p50_ms"], "server_capped_p95_ms": capped["p95_ms"],
            "server_capped_audio_s_per_s": capped["audio_s_per_s"],
        }

    sec.metrics.update(tts.loop.run_until_complete(run()))
    m = sec.metrics
    _log(f"[server] req/s={m['server_req_s']} p50={m['server_p50_ms']} ms "
         f"p95={m['server_p95_ms']} ms audio_s/s={m['server_audio_s_per_s']} "
         f"(rtf {m['server_rtf']}) | capped@{SHORT_CAP}tok: req/s={m['server_capped_req_s']} "
         f"p50={m['server_capped_p50_ms']} ms p95={m['server_capped_p95_ms']} ms "
         f"@ concurrency {SERVER_CONCURRENCY}, enhancement on")
    return sec


def _rss_mib() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    return 0.0


def _memory(device) -> tuple[int, int]:
    if device.type != "cuda":
        return 0, 0
    return torch.cuda.memory_allocated(device), torch.cuda.memory_reserved(device)


def run_sustained(tts: TTS, speaker: str, waves: int = SUSTAINED_WAVES,
                  concurrency: int = CONCURRENCY) -> Section:
    """Sustained load on the warm engine (tools/sustained_onchip.py's
    watch): `waves` waves of `concurrency` requests capped at SHORT_CAP
    tokens, every third one streaming. The first wave runs both kinds (a
    plain batch, then a streaming one); after every wave the device memory
    allocated and reserved, the graph captures and the host RSS are read.
    Steady: every later wave within SUSTAINED_GROWTH_BYTES of the readings
    after the first, allocated and reserved, and no capture after it."""
    engine = tts.tts_engine
    sec = Section(engine)

    def reqs(stream: bool) -> list:
        return [TTSRequest(text=SUSTAINED_TEXT, speaker_files=[speaker], language="en",
                           stream=stream, max_new_tokens=SHORT_CAP) for _ in range(concurrency)]

    async def drain(r) -> float:
        agen = await tts.generate_speech_async(r)
        n = 0
        async for chunk in agen:
            n += len(chunk.array)
        return n / SAMPLE_RATE

    async def plain(r) -> float:
        return _audio_s(await tts.generate_speech_async(r))

    def wave(stream: bool) -> float:
        outs, failed = _run(tts, [(drain if stream else plain)(r) for r in reqs(stream)])
        sec.count(concurrency, failed)
        return sum(outs)

    rows = []
    for i in range(waves):
        t0 = time.perf_counter()
        if i == 0:
            audio_s = wave(False) + wave(True)
        else:
            with sec.timed():
                audio_s = wave(i % 3 == 2)
        dt = time.perf_counter() - t0
        gc.collect()
        alloc, reserved = _memory(engine.device)
        rows.append({"wave": i, "allocated_mib": round(alloc / 2**20, 1),
                     "reserved_mib": round(reserved / 2**20, 1),
                     "captures": graphs.counts["captures"], "rss_mib": round(_rss_mib(), 1),
                     "wall_s": round(dt, 3), "audio_s": round(audio_s, 2)})
        _log(f"[sustained] wave {i:2d}: allocated={rows[-1]['allocated_mib']:9.1f} MiB "
             f"reserved={rows[-1]['reserved_mib']:9.1f} MiB captures={rows[-1]['captures']} "
             f"rss={rows[-1]['rss_mib']:7.0f} MiB wall={dt:6.2f}s audio={audio_s:6.1f}s")
    first, last = rows[0], rows[-1]
    growth = {k: round(last[k] - first[k], 1) for k in ("allocated_mib", "reserved_mib", "rss_mib")}
    new_captures = sec.captures_in_timed
    limit = SUSTAINED_GROWTH_BYTES / 2**20
    steady = (growth["allocated_mib"] < limit and growth["reserved_mib"] < limit
              and new_captures == 0)
    _log(f"[sustained] growth after wave 0 over {waves - 1} waves: {growth}, "
         f"captures +{new_captures}: {'steady' if steady else 'NOT steady'}")
    sec.metrics["sustained"] = {"waves": rows, "growth_after_first": growth,
                                "captures_after_first": new_captures, "steady": steady}
    return sec


# ------------------------------------------------------------ main
def nvidia_smi_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else out.stderr.strip()


def main(argv: list | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", choices=sorted(CONFIGS), default="default")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_torch: no CUDA device visible; this benchmark has no CPU path",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    settings = engine_settings()
    skip_server = os.environ.get("BENCH_SKIP_SERVER", "") == "1"
    gpt_flags = CONFIGS[args.config][0]
    payload = {key: None for key in RESULT_KEYS}
    payload.update({
        "metric": "full-pipeline RTF (wall / generated-audio-seconds)",
        "unit": "x realtime",
        "skipped_sections": [],
        "backend": "torch-cuda",
        "config": {"name": args.config, **gpt_flags, **engine_kwargs(args.config, {}),
                   "kernels": list(CONFIG_KERNELS[args.config])},
        "device": {"name": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
                   "nvidia_smi": nvidia_smi_line()},
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "settings": {**settings, "server_concurrency": SERVER_CONCURRENCY,
                     "server_requests": SERVER_REQUESTS, "skip_server": skip_server,
                     "budget_s": BUDGET_S},
        "cold": {},
        "sections": {},
        "attempted": 0,
        "failed": 0,
        "peak_reserved_gib": None,
        "status": "build, engine boot and warmup in progress",
    })

    def emit() -> None:
        payload["attempted"] = sum(s["attempted"] for s in payload["sections"].values())
        payload["failed"] = sum(s["failed"] for s in payload["sections"].values())
        payload["peak_reserved_gib"] = round(torch.cuda.max_memory_reserved(dev) / 2**30, 3)
        _emit(payload)

    def record(name: str, sec: Section) -> None:
        payload["sections"][name] = sec.book()
        payload.update(sec.metrics)
        emit()

    emit()
    cold = payload["cold"]
    t0 = time.perf_counter()
    _build.library()
    cold["build_kernels_s"] = round(time.perf_counter() - t0, 3)
    cold["kernels_nvcc_s"] = (None if _build.build_seconds is None
                              else round(_build.build_seconds, 3))
    t0 = time.perf_counter()
    cold["native_audio"] = native_audio.available()
    cold["build_native_s"] = round(time.perf_counter() - t0, 3)
    t0 = time.perf_counter()
    engine = build_engine(args.config, settings, device=dev)
    torch.cuda.synchronize(dev)
    cold["boot_s"] = round(time.perf_counter() - t0, 3)
    payload["settings"]["decode_slots_fit"] = engine.decode_slots
    payload["config"]["resolved"] = resolved_flags(engine)
    _log(f"[config] {payload['config']}")
    tts = TTS(scheduler_max_concurrency=CONCURRENCY).with_engine(engine)
    with tempfile.TemporaryDirectory() as tmp:
        speaker = write_speaker(os.path.join(tmp, "bench_speaker.wav"))
        warm = run_cold_and_warm(tts, speaker)
        cold.update(warm.metrics)
        cold["reserved_after_warmup_gib"] = round(torch.cuda.memory_reserved(dev) / 2**30, 3)
        payload["status"] = "warm"
        payload["sections"]["warmup"] = warm.book()
        _log(f"[cold] {cold}")

        n_reps = 3 if _budget_left() > 270 else (2 if _budget_left() > 180 else 1)
        record("rtf", run_rtf(tts, speaker, reps=n_reps))
        skipped = payload["skipped_sections"]
        if _budget_left() > 120:
            record("ttfa", run_ttfa(tts, speaker))
        else:
            skipped.append("ttfa")
            emit()
        if _budget_left() > 90:
            record("short_phrase", run_short_phrase(tts, speaker))
        else:
            skipped.append("short_phrase")
            emit()
        if skip_server:
            skipped.append("server(env)")
            emit()
        elif _budget_left() > 180:
            record("server", run_server_load(tts))
        else:
            skipped.append("server(budget)")
            emit()
        if _budget_left() > 120:
            record("sustained", run_sustained(tts, speaker))
        else:
            skipped.append("sustained(budget)")
            emit()
        tts.loop.run_until_complete(tts.shutdown())
    if payload["failed"]:
        _log(f"bench_torch: {payload['failed']} of {payload['attempted']} requests failed")
        return 1
    if payload.get("sustained") and not payload["sustained"]["steady"]:
        _log("bench_torch: the sustained-load watch did not hold steady")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
