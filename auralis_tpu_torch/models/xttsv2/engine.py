"""XTTSv2 engine on torch: conditioning -> continuous-batched decode -> vocoder.

Counterpart of `XTTSv2Engine` in auralis_tpu/models/xttsv2/engine.py:
- conditioning (speaker d-vector + perceiver latents) runs as torch ops on
  the engine's device, LRU-cached per reference;
- token generation runs in the slot-batched decode loop (runtime/), which
  emits vocoder latents inline; with `prefill_flash` / `flash_decode` set in
  the GPT config it goes through kernels K1 / K2 on CUDA, and with an int8
  KV cache (`kv_int8=True`) plus `ragged_decode` in the GPT config through
  K1 / K4. `decode_w8a8` / `prefill_w8a8` run the block matmuls W8A8 on an
  int8 copy of the weights (`blocks_q8`), made once at construction;
- each finished chunk's latent row is vocoded on the device (HiFi-GAN, the
  MRF stages through kernel K3 on CUDA) and shipped to the host as int16,
  through `_VocodeBatcher`, which batches rows (and segments) that finish
  while an earlier batch is on the card;
- streaming (`stream=True`): the runner hands out latent snapshots while a
  chunk decodes, and fixed segments of SEG_PF frames (the first FIRST_SEG_PF)
  are vocoded from them with PAD_PF frames of context on each side, so
  their concatenation is the non-streaming waveform; the first segment is
  launched speculatively right after the young block that makes it final
  (`_SpecFirstSeg`).

The JAX engine arms int8 KV, W8A8, the per-program W8A8 policy and slot
bucketing by default only on a TPU; on any other backend they are off
unless passed, and so they are here until an H100 measurement sets them.
`slot_bucketing=True` turns bucketing on; the policy the JAX engine would
arm is `w8a8_policy()`, which a caller hands to `DecodeEngine`. The slot
count is fitted to the card's free memory after the weights
(`_fit_slots_to_hbm`). Options the port lacks are dropped with a warning,
except `tensor_parallel_size > 1`, which raises (ROADMAP.md, queue 1 item
10). `from_pretrained` loads the dual-safetensors layout that
`weights.convert_coqui_checkpoint` writes. Not ported, by design:
`precompile_vocoder_buckets` and the hot/warming row-bucket sets
(`serving_row_bucket`), which work around XLA compiles (`TTS.warmup` reaches
them through `getattr` only), and the legacy embeds-prompt branch.
"""
from __future__ import annotations

import asyncio
import dataclasses
import hashlib
import json
import math
import os
import time
from pathlib import Path
from typing import Any, AsyncGenerator, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ...common import audio_io
from ...common.dsp_np import trim_silence_db
from ...common.logger import setup_logger
from ...common.output import TTSOutput
from ...common.requests import TTSRequest
from ...common.tracing import record as trace_record, span
from ...ops.experimental.attention import CHUNK
from ...ops.mel import wav_to_mel_cloning
from ...ops.mrf import pack_hifigan_mrf
from ...ops.resample import resample_np
from ...runtime.engine_core import DecodeEngine, SamplingOptions, TokenPrompt
from ..base import BaseAsyncTTSEngine, ConditioningConfig
from .config import XTTSConfig, XTTSGPTConfig, tiny_test_config
from .gpt import quantize_decode_weights
from .hifigan import RESBLOCK_KERNELS, hifigan_generator, interp_latents
from .modules import conditioning_encoder, perceiver_resampler, speaker_encoder
from .weights import (
    find_artifact,
    load_core_params,
    load_gpt_params,
    load_safetensors,
    params_from_numpy,
    random_init,
)

logger = setup_logger("xttsv2")

LATENT_BUCKETS_STEP = 64
# row-vocoder latent buckets: a row is padded to the smallest bucket >= its
# true length + 4 (more than the generator's post-interp receptive field),
# so the trimmed output equals the full-row program's
VOCODER_LATENT_BUCKETS = (256, 384, 512, 640)

# The per-program W8A8 policy runs the int8 decode weights while a block's KV
# read is below this multiple of the bf16 weight bytes: the JAX engine's
# crossover, fitted on a TPU v5e, not an H100 measurement
W8A8_KV_TO_WEIGHT_CROSSOVER_TPU = 3
# headroom the slot fit leaves on the card for activations and the
# allocator, as a share of its memory (the JAX engine's 8%)
HBM_HEADROOM = 0.08

# Intra-chunk streaming, in post-interp frames (one frame = 256 output
# samples). The generator's receptive field is ~14 frames (conv_pre k7 and
# the MRF k11/d5 at the x8 stage dominate), so PAD_PF frames of context on
# each side make a segment's emitted frames equal the full-row vocoder's,
# and since the full row is zero-masked past its true length too, the
# concatenated segments reproduce the non-streaming waveform.
SEG_PF = 128  # ~1.37 s of audio per segment
FIRST_SEG_PF = 32  # the first ~0.34 s, out as soon as ~13 latents exist
PAD_PF = 16


class _VocodeBatcher:
    """Micro-batching of vocoder work with no added latency: while one batch
    is on the card, newly finished rows and segments gather and go together
    in the next; nothing waits on a timer.

    Kinds in priority order: seg_first (the first segment, on the
    time-to-first-audio path), seg, row. Up to MAX_INFLIGHT batches run at
    once in worker threads; they issue to the same CUDA stream as the decode
    runner, so a vocode is ordered after the block whose latents it reads.

    Unlike the JAX batcher, a batch is not padded to a fixed size (its
    `_pad`): there each batch size is its own compiled program, here nothing
    is compiled, and the MRF stages (kernel K3) are bound by operations on
    the H100 (PERF.md §6), so padding a lone segment to 4 lanes would cost
    about 4x its vocoder time."""

    MAX_BATCH = 4
    SEG_FIRST_MAX_BATCH = 8
    MAX_INFLIGHT = 3

    def __init__(self, engine: "XTTSv2Engine"):
        self.engine = engine
        self._pending = {"row": [], "seg": [], "seg_first": []}
        self._task: Optional[asyncio.Task] = None
        self._inflight: Optional[asyncio.Semaphore] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None

    async def submit(self, kind: str, item: tuple) -> np.ndarray:
        loop = asyncio.get_running_loop()
        if loop is not self._loop:
            # the engine outlives individual event loops (the sync API runs
            # one per call): a dead loop's drain task and futures never
            # resolve, so start afresh on this one
            self._pending = {"row": [], "seg": [], "seg_first": []}
            self._task = None
            self._loop = loop
        fut: asyncio.Future = loop.create_future()
        self._pending[kind].append((item, fut))
        if self._task is None or self._task.done():
            self._inflight = asyncio.Semaphore(self.MAX_INFLIGHT)
            self._task = loop.create_task(self._drain())
        return await fut

    async def _drain(self) -> None:
        loop = asyncio.get_running_loop()
        flights: list[asyncio.Task] = []
        while any(self._pending.values()) or flights:
            flights = [t for t in flights if not t.done()]
            if not any(self._pending.values()):
                if flights:
                    await asyncio.wait(flights, return_when=asyncio.FIRST_COMPLETED)
                continue
            await self._inflight.acquire()
            kind = next(k for k in ("seg_first", "seg", "row") if self._pending[k])
            cap = self.SEG_FIRST_MAX_BATCH if kind == "seg_first" else self.MAX_BATCH
            batch = self._pending[kind][:cap]
            del self._pending[kind][: len(batch)]
            flights.append(loop.create_task(self._fly(kind, batch)))

    async def _fly(self, kind: str, batch: list) -> None:
        items = [it for it, _ in batch]
        try:
            outs = await asyncio.to_thread(self._run_batch, kind, items)
        except Exception as e:  # every waiter gets the failure
            for _, fut in batch:
                try:
                    if not fut.done():
                        fut.set_exception(e)
                except RuntimeError:
                    pass  # a future of a closed loop
            return
        finally:
            self._inflight.release()
        for (_, fut), out in zip(batch, outs):
            try:
                if not fut.done():
                    fut.set_result(out)
            except RuntimeError:
                pass  # a future of a closed loop

    @torch.no_grad()
    def _run_batch(self, kind: str, items: list) -> list:
        eng = self.engine
        rows = torch.stack([it[0] for it in items])
        ns = [int(it[1]) for it in items]
        if kind == "row":  # (row, n, g)
            return eng._vocode_rows(rows, ns, [it[2] for it in items])
        if kind == "seg_first":  # (row, n_mask, g): frames [0, FIRST_SEG_PF)
            with span("vocode.seg_first_device"):
                pcm = eng._vocode_seg_first(rows, ns, [it[2] for it in items]).cpu().numpy()
            return [pcm[i, : FIRST_SEG_PF * 256].astype(np.float32) / 32767.0
                    for i in range(len(items))]
        # seg: (row, n_mask, emit_start_pf, emit_count_pf, g)
        starts = [eng._seg_slice_start(it[2]) for it in items]
        with span("vocode.seg_device"):
            pcm = eng._vocode_seg(rows, ns, starts, [it[4] for it in items]).cpu().numpy()
        outs = []
        for i, it in enumerate(items):
            offset = it[2] - starts[i]
            outs.append(pcm[i, offset * 256:(offset + it[3]) * 256].astype(np.float32) / 32767.0)
        return outs


class _SpecFirstSeg:
    """Speculative first-segment vocode for one streaming chunk.

    The runner calls `hook(row, n_claim)` on the event loop right after each
    young block is issued, before its status is read. Once the host's token
    count crosses the first-emit threshold, the first segment's vocode is
    submitted at once: it queues behind the block on the card and its
    result overlaps the status read. The claim is exact unless the slot
    stopped inside the block, so the consumer uses the result only after a
    snapshot confirms n >= claim, and discards it on an earlier final one.
    The emitted samples lie below total_pf(claim - 2) - PAD_PF, the same
    hold-back as the snapshot path, so the waveform is the same either way."""

    __slots__ = ("engine", "g", "claim_n", "emit_pf", "task")

    def __init__(self, engine: "XTTSv2Engine", speaker_embeddings):
        self.engine = engine
        self.g = speaker_embeddings
        self.claim_n: Optional[int] = None
        self.emit_pf = 0
        self.task: Optional[asyncio.Task] = None

    def hook(self, row, n_claim: int) -> bool:
        eng = self.engine
        high = max(0, eng._total_pf(max(0, n_claim - 2)) - PAD_PF)
        if high < FIRST_SEG_PF:
            return False  # not enough final samples yet; call again next block
        # exactly FIRST_SEG_PF through the small first-segment vocoder; what
        # else is final already goes into the next segment
        self.claim_n, self.emit_pf = n_claim, FIRST_SEG_PF
        loop = asyncio.get_running_loop()
        self.task = loop.create_task(
            eng._vocode_batcher.submit("seg_first", (row, n_claim, self.g)))
        # a discarded speculation must not log "exception never retrieved"
        self.task.add_done_callback(lambda t: t.exception() if not t.cancelled() else None)
        return True

    def discard(self) -> None:
        if self.task is not None and not self.task.done():
            self.task.cancel()
        self.task = None


class XTTSv2Engine(BaseAsyncTTSEngine):
    """Asynchronous XTTSv2 engine on the torch decode loop."""

    model_type = "xtts"

    def __init__(
        self,
        hifi_config: XTTSConfig,
        gpt_config: XTTSGPTConfig,
        *,
        params: dict,
        core: dict,
        tokenizer=None,
        max_concurrency: int = 10,
        decode_slots: Optional[int] = None,
        steps_per_sync: int = 16,
        device="cuda",
        cache_dtype: torch.dtype = torch.bfloat16,
        vocoder_dtype: Optional[torch.dtype] = torch.bfloat16,
        kv_int8: Optional[bool] = None,
        decode_w8a8: Optional[bool] = None,
        prefill_w8a8: Optional[bool] = None,
        slot_bucketing: Optional[bool] = None,
        tensor_parallel_size: int = 1,
        conditioning_cache_size: int = 32,
        ref_length_quantum_s: float = 1.0,
        seg_first_batch1: bool = False,
        seed: int = 0,
        **kwargs,
    ):
        if tensor_parallel_size > 1:
            raise NotImplementedError(
                f"tensor_parallel_size={tensor_parallel_size}: tensor parallelism is not "
                "ported yet (ROADMAP.md, queue 1 item 10: 'Parallel'); the port serves on "
                "one GPU")
        # the JAX engine's non-TPU defaults: kv_int8 off unless passed (it
        # keeps the config's value only under flash_decode), the W8A8 flags
        # as the config has them unless passed
        if kv_int8 is None and not gpt_config.flash_decode:
            kv_int8 = False
        flags = {"kv_int8": kv_int8, "decode_w8a8": decode_w8a8, "prefill_w8a8": prefill_w8a8}
        changed = {k: v for k, v in flags.items() if v is not None and v != getattr(gpt_config, k)}
        if changed:  # never mutate the caller's config
            gpt_config = dataclasses.replace(gpt_config, **changed)
        if kwargs:
            logger.warning("ignoring engine options the port does not have: %s", sorted(kwargs))
        if seg_first_batch1:
            logger.info("seg_first_batch1 has no effect here: the JAX engine pads first-segment "
                        "batches to fixed sizes (one compiled program each) and this flag adds "
                        "a batch-1 program; the port pads no batch")
        self.hifi_config = hifi_config
        self.gpt_config = gpt_config
        self.tokenizer = tokenizer
        self.max_concurrency = max_concurrency
        self.device = torch.device(device)
        self.mel_bos_token_id = gpt_config.start_audio_token
        self.mel_eos_token_id = gpt_config.stop_audio_token
        self.params = params
        if (gpt_config.decode_w8a8 or gpt_config.prefill_w8a8) and "blocks_q8" not in params:
            self.params = {**params, "blocks_q8": quantize_decode_weights(params["blocks"])}
        self.core = dict(core)
        if vocoder_dtype is not None:
            # the generator computes in its params' dtype; the MRF stages
            # accumulate in f32 (kernel K3's precision contract)
            self.core["hifigan"] = _cast_floats(core["hifigan"], vocoder_dtype)
        self.cache_dtype = cache_dtype
        self.decode_slots = self._fit_slots_to_hbm(
            decode_slots or max(2, 2 * max_concurrency), slots_explicit=decode_slots is not None)
        # the young block: the fewest steps after which the first segment can
        # go out. After k steps a slot holds n = k + 1 tokens, and the frames
        # safe to emit are total_pf(n - 2) - PAD_PF (the receptive-field
        # hold-back), so find the first k where that reaches FIRST_SEG_PF
        stream_block_steps = 1
        while (self._total_pf(max(0, stream_block_steps - 1)) - PAD_PF < FIRST_SEG_PF
               and stream_block_steps < gpt_config.max_audio_tokens):
            stream_block_steps += 1
        self.decode_engine = DecodeEngine(
            self.params, gpt_config, num_slots=self.decode_slots, cache_dtype=cache_dtype,
            steps_per_sync=steps_per_sync, seed=seed, slot_bucketing=bool(slot_bucketing),
            stream_block_steps=stream_block_steps, device=self.device)
        hifigan = self.core["hifigan"]
        self._packed_stages = pack_hifigan_mrf(
            hifigan["resblocks"], RESBLOCK_KERNELS, hifigan["conv_pre_w"].dtype, self.device)
        self.conditioning_cache_size = max(1, int(conditioning_cache_size))
        self.ref_length_quantum_s = float(ref_length_quantum_s)
        self._cond_cache: dict[str, tuple] = {}
        self._vocode_batcher = _VocodeBatcher(self)
        self.get_memory_usage_curve()

    # ----------------------------------------------------------- properties
    @property
    def conditioning_config(self) -> ConditioningConfig:
        return ConditioningConfig(speaker_embeddings=True, gpt_like_decoder_conditioning=True)

    def _hbm_plan_bytes(self) -> tuple[int, int]:
        """(weight bytes, bytes per slot) of the device-memory plan: weights
        are the params (blocks_q8 included) and core as held; a slot is its
        KV rows as `make_kv_cache` allocates them (T padded to the cache's
        chunk; int8 rows and f32 scale rows under kv_int8) and its latent
        row."""
        cfg = self.gpt_config
        weights = _nbytes(self.params) + _nbytes(self.core)
        t_pad = -(-cfg.max_seq_len // CHUNK) * CHUNK
        per_row = 2 * cfg.hidden_size * (1 if cfg.kv_int8 else self.cache_dtype.itemsize)
        per_row += 2 * 4 if cfg.kv_int8 else 0
        slot = cfg.num_hidden_layers * t_pad * per_row + cfg.max_audio_tokens * cfg.hidden_size * 4
        return weights, slot

    def _fit_slots_to_hbm(self, num_slots: int, *, slots_explicit: bool) -> int:
        """The slot count that fits the card: what `torch.cuda.mem_get_info`
        leaves free after the weights (already resident; memory the
        allocator holds but has not handed out counts as free), less
        HBM_HEADROOM of the card, divided by the bytes per slot. A default
        count above that is clamped; an explicit one raises, as does a card
        that cannot hold 2 slots. On the CPU nothing is enforced."""
        if self.device.type != "cuda":
            return num_slots
        _, slot_bytes = self._hbm_plan_bytes()
        free, total = torch.cuda.mem_get_info(self.device)
        free += torch.cuda.memory_reserved(self.device) - torch.cuda.memory_allocated(self.device)
        budget = free - int(total * HBM_HEADROOM)
        fit = max(0, budget) // slot_bytes
        if fit < 2 or (slots_explicit and fit < num_slots):
            raise ValueError(
                f"decode_slots={num_slots} needs {num_slots * slot_bytes / 1024**3:.2f} GiB of KV "
                f"and latent rows, but {max(0, budget) / 1024**3:.2f} GiB of the card's "
                f"{total / 1024**3:.2f} GiB are left after the weights ({fit} slots fit)")
        if fit < num_slots:
            logger.warning("decode_slots=%d does not fit the card's free memory; clamping to %d",
                           num_slots, fit)
            return fit
        return num_slots

    def get_memory_usage_curve(self) -> float:
        """Device-memory plan in GiB: weights (blocks_q8 included) + per slot
        its KV rows as allocated (int8 rows and f32 scale rows under kv_int8)
        and its latent row."""
        weights, slot = self._hbm_plan_bytes()
        self.max_gb_for_model = (weights + slot * self.decode_slots) / 1024**3
        logger.info("memory plan: %.2f GiB (weights %.2f GiB + %d slots x %.1f MiB)",
                    self.max_gb_for_model, weights / 1024**3, self.decode_slots,
                    slot / 1024**2)
        return self.max_gb_for_model

    def w8a8_policy(self):
        """The per-program W8A8 policy the JAX engine arms on a TPU: a
        function of (len_bound, slot_bound) that is True (run the int8
        decode weights) while the block's KV read is below
        W8A8_KV_TO_WEIGHT_CROSSOVER_TPU times the bytes of the block
        weights. Off by default on the card (no H100 measurement has set
        it): pass it to `DecodeEngine(w8a8_policy=...)` with `blocks_q8` in
        the params."""
        g = self.gpt_config
        d, nl = g.hidden_size, g.num_hidden_layers
        kv_elem = 1 if g.kv_int8 else self.cache_dtype.itemsize
        w_bytes = _nbytes(self.params["blocks"])

        def policy(len_bound: int, slot_bound: int) -> bool:
            kv_bytes = slot_bound * len_bound * 2 * d * nl * kv_elem
            return kv_bytes < W8A8_KV_TO_WEIGHT_CROSSOVER_TPU * w_bytes

        return policy

    # -------------------------------------------------------- construction
    @classmethod
    def from_pretrained(cls, pretrained_model_name_or_path: str, *,
                        gpt_model: Optional[str] = None,
                        torch_dtype=None,  # accepted for API compat; ignored, as in JAX
                        dtype: torch.dtype = torch.bfloat16, device="cuda",
                        **kwargs) -> "XTTSv2Engine":
        """Load from a local directory holding the dual-safetensors layout
        (`convert_coqui_checkpoint`'s output): the configs from the root's
        config.json, `xtts-v2.safetensors` under the root,
        `gpt2_model.safetensors` and tokenizer.json under `gpt_model` or the
        root. GPT weights in `dtype`, the core stack in f32. The KV cache
        takes the constructor's `cache_dtype` (bf16 unless passed), as in the
        JAX engine. Hub download is the facade's (`TTS._resolve_model_source`)."""
        from ...frontend.tokenizer import TTSTokenizer  # needs `tokenizers`

        root = Path(pretrained_model_name_or_path)
        with open(root / "config.json") as f:
            config = json.load(f)
        hifi_config = XTTSConfig.from_dict(config)
        gpt_config = XTTSGPTConfig.from_dict(config.get("gpt_config", {}))

        core_file = find_artifact(root, ("xtts-v2.safetensors",))
        gpt_root = Path(gpt_model) if gpt_model else root
        gpt_file = find_artifact(gpt_root, ("gpt2_model.safetensors",))

        tokenizer = None
        for cand_dir in (gpt_root, root):
            try:
                tokenizer = TTSTokenizer.from_pretrained(str(cand_dir))
                break
            except FileNotFoundError:
                continue
        if tokenizer is None:
            raise FileNotFoundError(f"tokenizer.json not found under {gpt_root} or {root}")

        t0 = time.perf_counter()
        core_np = load_core_params(load_safetensors(core_file), hifi_config)
        gpt_np = load_gpt_params(load_safetensors(gpt_file), gpt_config)
        gpt_np["text_wte"] = core_np["text_wte"]
        gpt_np["text_wpe"] = core_np["text_wpe"]
        params, core = params_from_numpy(gpt_np, core_np, device=device, dtype=dtype)
        del gpt_np, core_np
        logger.info("checkpoint load took %.1f s", time.perf_counter() - t0)
        return cls(hifi_config, gpt_config, params=params, core=core, tokenizer=tokenizer,
                   device=device, **kwargs)

    @classmethod
    def random_init(cls, config: Optional[XTTSConfig] = None, tokenizer=None,
                    dtype: torch.dtype = torch.float32, seed: int = 0, device="cuda",
                    **kwargs) -> "XTTSv2Engine":
        """Seeded random weights (numpy) through the same converter a real
        parameter set takes; GPT weights and the KV cache in `dtype`."""
        cfg = config or tiny_test_config()
        t0 = time.perf_counter()
        gpt_np, core_np = random_init(cfg, seed)
        params, core = params_from_numpy(gpt_np, core_np, device=device, dtype=dtype)
        del gpt_np, core_np
        logger.info("random weight init took %.1f s", time.perf_counter() - t0)
        kwargs.setdefault("cache_dtype", dtype)
        return cls(cfg, cfg.gpt, params=params, core=core, tokenizer=tokenizer, device=device,
                   seed=seed, **kwargs)

    # -------------------------------------------------------- conditioning
    def _quantize_ref_length(self, audio: np.ndarray, sr: int) -> np.ndarray:
        """Truncate the reference down to the ref_length_quantum_s grid (the
        JAX engine does this to bound compiled shapes; kept for identical
        conditioning)."""
        q = self.ref_length_quantum_s
        if not q:
            return audio
        quantum = max(1, int(sr * q))
        n = (audio.shape[-1] // quantum) * quantum
        if n == 0:
            n = audio.shape[-1]
        return audio[..., :n]

    @torch.no_grad()
    def get_gpt_cond_latents(self, audio_22k: np.ndarray, length: int = 30,
                             chunk_length: int = 6) -> np.ndarray:
        """Mean perceiver latent over `chunk_length`-second windows.
        audio_22k: [1, T] -> [1, C, D]."""
        sr = 22050
        if length > 0:
            audio_22k = audio_22k[:, : sr * length]
        step = sr * chunk_length
        chunks = [audio_22k[:, i:i + step] for i in range(0, audio_22k.shape[1], step)]
        chunks = [c for c in chunks if c.shape[-1] >= sr * 0.33] or [audio_22k]
        embs = []
        for chunk in chunks:
            wav = torch.from_numpy(np.ascontiguousarray(chunk, np.float32)).to(self.device)
            mel = wav_to_mel_cloning(
                wav, mel_norms=self.core["mel_stats"], n_fft=2048, hop_length=256,
                win_length=1024, power=2.0, sample_rate=22050, f_min=0.0, f_max=8000.0,
                n_mels=80,
            )  # [1, 80, F]
            h = conditioning_encoder(self.core["cond_encoder"], mel.transpose(1, 2),
                                     self.gpt_config.num_attention_heads)
            embs.append(perceiver_resampler(self.core["perceiver"], h).float().cpu().numpy())
        return np.mean(embs, axis=0)  # [1, C, D]

    @torch.no_grad()
    def _speaker_embedding(self, wav16: np.ndarray) -> np.ndarray:
        w = torch.from_numpy(np.ascontiguousarray(wav16, np.float32)).to(self.device)
        return speaker_encoder(self.core["speaker_encoder"], w, l2_norm=True).float().cpu().numpy()

    async def get_audio_conditioning(
        self,
        audio_reference: Union[str, bytes, List],
        max_ref_length: int = 30,
        gpt_cond_len: int = 6,
        gpt_cond_chunk_len: int = 6,
        librosa_trim_db: Optional[float] = None,
        sound_norm_refs: bool = False,
        load_sr: int = 22050,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(gpt conditioning latents [1, C, D], speaker d-vector [1, 512]),
        LRU-cached per (reference content, conditioning params)."""
        refs = audio_reference if isinstance(audio_reference, list) else [audio_reference]
        hasher = hashlib.md5()
        for ref in refs:
            if isinstance(ref, (bytes, bytearray)):
                hasher.update(ref)
            else:
                hasher.update(str(ref).encode())
                try:
                    hasher.update(str(os.path.getmtime(ref)).encode())
                except OSError:
                    pass
        hasher.update(f"{max_ref_length}|{gpt_cond_len}|{gpt_cond_chunk_len}|"
                      f"{librosa_trim_db}|{sound_norm_refs}|{load_sr}".encode())
        cache_key = hasher.hexdigest()
        hit = self._cond_cache.pop(cache_key, None)
        if hit is not None:
            self._cond_cache[cache_key] = hit  # re-insert: dict order is the LRU order
            trace_record("phase1.cond_cache_hit", 0.0)
            return hit

        t_cond = time.perf_counter()
        speaker_embs, audios = [], []
        for ref in refs:
            def _load(r=ref):
                a = audio_io.load_audio(r, load_sr)[:, : load_sr * max_ref_length]
                if librosa_trim_db is not None:
                    a = trim_silence_db(a, top_db=float(librosa_trim_db))
                a = self._quantize_ref_length(a, load_sr)
                if sound_norm_refs:
                    a = a / max(np.abs(a).max(), 1e-8) * 0.75
                return a, resample_np(a.astype(np.float32), load_sr, 16000)

            audio, wav16 = await asyncio.to_thread(_load)
            speaker_embs.append(await asyncio.to_thread(self._speaker_embedding, wav16))
            audios.append(audio.astype(np.float32))
        full_audio = np.concatenate(audios, axis=-1)
        gpt_cond = await asyncio.to_thread(
            self.get_gpt_cond_latents, full_audio, gpt_cond_len, gpt_cond_chunk_len)
        speaker = np.mean(np.stack(speaker_embs), axis=0)  # [1, 512]
        trace_record("phase1.cond_miss", time.perf_counter() - t_cond)
        while len(self._cond_cache) >= self.conditioning_cache_size:
            self._cond_cache.pop(next(iter(self._cond_cache)))
        self._cond_cache[cache_key] = (gpt_cond, speaker)
        return gpt_cond, speaker

    # ------------------------------------------------------ prompt assembly
    def _cond_device(self, cond_latents) -> torch.Tensor:
        """Voice conditioning latents as a device tensor [C, D], uploaded once
        per request and shared by all its chunks."""
        t = torch.as_tensor(np.asarray(cond_latents, np.float32))
        return t.reshape(-1, self.gpt_config.hidden_size).to(self.device)

    def _build_prompt(self, cond_dev: torch.Tensor, token_ids: List[int]) -> TokenPrompt:
        max_text = self.gpt_config.max_text_tokens
        if len(token_ids) > max_text:
            logger.warning("Text chunk of %d tokens exceeds max_text_tokens=%d; truncating",
                           len(token_ids), max_text)
            token_ids = token_ids[:max_text]
        ids = np.asarray(
            [self.tokenizer.bos_token_id, *token_ids, self.tokenizer.eos_token_id], np.int32)
        return TokenPrompt(cond=cond_dev, ids=ids)

    # ----------------------------------------------------------- generation
    async def get_generation_context(
        self,
        request: TTSRequest,
        gpt_cond_latent: Optional[np.ndarray] = None,
        speaker_embeddings: Optional[np.ndarray] = None,
    ):
        """Phase 1: conditioning + one decode submission per text chunk.
        Returns (handles, request ids, speaker embedding, conditioning). A
        handle is the chunk's decode future, or for a streaming request
        (future, snapshot mailbox, speculative first segment)."""
        if gpt_cond_latent is None or speaker_embeddings is None:
            gpt_cond_latent, speaker_embeddings = await self.get_audio_conditioning(
                request.speaker_files,
                request.max_ref_length,
                request.gpt_cond_len,
                request.gpt_cond_chunk_len,
                sound_norm_refs=request.sound_norm_refs,
                load_sr=request.load_sample_rate,
            )
        with span("phase1.tokenize"):
            token_chunks = self.tokenizer.encode_with_split(request.text, request.language)
        if not token_chunks:
            raise ValueError(
                f"TTSRequest.text contains no speakable content (text={request.text!r})")
        options = SamplingOptions(
            temperature=request.temperature,
            top_p=request.top_p,
            top_k=request.top_k,
            repetition_penalty=request.repetition_penalty,
            do_sample=request.do_sample,
            max_new_tokens=int(request.max_new_tokens or 0),
        )
        handles, request_ids = [], []
        cond_dev = self._cond_device(gpt_cond_latent)
        try:
            for idx, ids in enumerate(token_chunks):
                prompt = self._build_prompt(cond_dev, ids)
                if request.stream:
                    # a snapshot mailbox, so segments are vocoded while the
                    # chunk decodes, and the speculative first segment
                    queue = asyncio.Queue()
                    spec = _SpecFirstSeg(self, speaker_embeddings)
                    fut = asyncio.ensure_future(self.decode_engine.generate(
                        prompt, options, stream_queue=queue, on_young_block=spec.hook))
                    handles.append((fut, queue, spec))
                else:
                    handles.append(asyncio.ensure_future(
                        self.decode_engine.generate(prompt, options)))
                request_ids.append(f"{request.request_id}_{idx}")
        except BaseException:
            for handle in handles:
                self.cancel_generation_handle(handle)
            raise
        return handles, request_ids, speaker_embeddings, gpt_cond_latent

    def cancel_generation_handle(self, handle) -> None:
        """Abort one chunk's decode (and its speculative first segment); the
        decode engine drops it from its queue or releases its slot on the
        runner's next pass."""
        fut, _queue, spec = _unpack_handle(handle)
        if spec is not None:
            spec.discard()
        if not fut.done():
            fut.cancel()

    # --------------------------------------------------------------- vocode
    def _true_wav_len(self, n_latents: int) -> int:
        cfg = self.hifi_config
        z1 = math.floor(n_latents * cfg.gpt_code_stride_len / cfg.output_hop_length)
        if cfg.output_sample_rate != cfg.input_sample_rate:
            z1 = math.floor(z1 * cfg.output_sample_rate / cfg.input_sample_rate)
        return z1 * 256  # total upsample factor of the generator

    def row_bucket(self, max_n: int) -> int:
        """Smallest row-vocoder bucket that reproduces a max_n-latent row exactly."""
        need = min(self.gpt_config.max_audio_tokens, max_n + 4)
        for b in VOCODER_LATENT_BUCKETS:
            if b >= need:
                return b
        return math.ceil(self.gpt_config.max_audio_tokens / LATENT_BUCKETS_STEP) * LATENT_BUCKETS_STEP

    def _speaker_rows(self, speaker_embeddings: list) -> torch.Tensor:
        """One d-vector per lane (host [1, 512] each) -> [B, 512] f32 on the
        engine's device."""
        g = np.concatenate([np.asarray(e, np.float32).reshape(1, -1) for e in speaker_embeddings])
        return torch.from_numpy(g).to(self.device)

    def _interp(self, latents: torch.Tensor) -> torch.Tensor:
        """Latents [B, T, D] f32 -> post-interp frames [B, D, T_pf]
        (hifigan.interp_latents at this model's rates)."""
        cfg = self.hifi_config
        return interp_latents(latents, ar_mel_length_compression=cfg.gpt_code_stride_len,
                              output_hop_length=cfg.output_hop_length,
                              input_sample_rate=cfg.input_sample_rate,
                              output_sample_rate=cfg.output_sample_rate)

    def _generate(self, frames: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        """Post-interp frames [B, D, T_pf] + d-vectors [B, 512] -> waveform
        [B, T_pf * 256] f32 (HiFi-GAN, the MRF stages through kernel K3 on
        the card)."""
        wav = hifigan_generator(self.core["hifigan"], frames.transpose(1, 2), g,
                                self._packed_stages)
        return wav.float()

    @staticmethod
    def _pcm(wav: torch.Tensor) -> torch.Tensor:
        """Round to 16-bit PCM on the device: 4x fewer bytes to the host, the
        serving formats are 16-bit, and tanh bounds |wav| <= 1."""
        return torch.round(wav * 32767.0).to(torch.int16)

    @staticmethod
    def _masked(rows: torch.Tensor, ns: list, cut: int, length: int) -> torch.Tensor:
        """rows [B, >= cut, D] -> f32 [B, length, D]: the first `cut` latents
        with positions >= n[b] zeroed (stale slot data), zero-padded."""
        x = rows[:, :cut].float()
        n = torch.tensor(ns, dtype=torch.int64).to(x.device)[:, None, None]
        x = torch.where(torch.arange(cut, device=x.device)[None, :, None] < n, x, 0.0)
        return F.pad(x, (0, 0, 0, length - cut)) if length > cut else x

    @torch.no_grad()
    def _vocode_rows(self, rows: torch.Tensor, ns: list, speaker_embeddings: list) -> list:
        """The batched row vocoder: latent rows [B, T_audio, D] on the device,
        each with its own n live entries, masked and padded to the bucket of
        the largest n; returns each waveform trimmed to its true length (f32
        on the host, from 16-bit PCM)."""
        bucket = self.row_bucket(max(ns))
        x = self._masked(rows, ns, min(bucket, self.gpt_config.max_audio_tokens), bucket)
        pcm = self._pcm(self._generate(self._interp(x), self._speaker_rows(speaker_embeddings)))
        pcm = pcm.cpu().numpy()
        return [pcm[i, : self._true_wav_len(n)].astype(np.float32) / 32767.0
                for i, n in enumerate(ns)]

    def vocode_device_row(self, latents_row: torch.Tensor, n: int,
                          speaker_embedding) -> np.ndarray:
        """Vocode a slot's latent row [T_audio, D] (device) whose first n
        entries are valid: the batched row vocoder at batch 1."""
        return self._vocode_rows(latents_row[None], [n], [speaker_embedding])[0]

    @torch.no_grad()
    def vocode(self, latents: np.ndarray, speaker_embedding: np.ndarray) -> np.ndarray:
        """latents [T, D] (host) + d-vector [1, 512] -> waveform [N] at 24 kHz,
        through one fixed bucket (max_audio_tokens rounded up)."""
        n = latents.shape[0]
        bucket = max(math.ceil(self.gpt_config.max_audio_tokens / LATENT_BUCKETS_STEP)
                     * LATENT_BUCKETS_STEP, n)
        padded = torch.zeros((1, bucket, latents.shape[1]), dtype=torch.float32)
        padded[0, :n] = torch.from_numpy(np.asarray(latents, np.float32))
        frames = self._interp(padded.to(self.device))
        wav = self._generate(frames, self._speaker_rows([speaker_embedding]))
        return wav[0].cpu().numpy()[: self._true_wav_len(n)]

    # ------------------------------------------------- streaming vocoder
    def _total_pf(self, n_latents: int) -> int:
        """Post-interp frame count for n latents (== _true_wav_len // 256)."""
        return self._true_wav_len(n_latents) // 256

    @property
    def _seg_bucket(self) -> int:
        """Latent length the segment vocoder interps at: max_audio_tokens
        rounded up to LATENT_BUCKETS_STEP."""
        return math.ceil(self.gpt_config.max_audio_tokens / LATENT_BUCKETS_STEP) * LATENT_BUCKETS_STEP

    @property
    def _bucket_pf(self) -> int:
        return self._total_pf(self._seg_bucket)

    @torch.no_grad()
    def _vocode_seg(self, rows: torch.Tensor, ns: list, slice_starts: list,
                    speaker_embeddings: list) -> torch.Tensor:
        """The segment vocoder: interp each whole masked row as the full-row
        vocoder does (at `_seg_bucket`), cut one [start, start + PAD_PF +
        SEG_PF + PAD_PF) frame window per lane and run the generator on the
        windows. With PAD_PF >= the generator's receptive field, a window's
        centre equals the full-row output sample for sample. Returns 16-bit
        PCM [B, window * 256] on the device."""
        t_max = self.gpt_config.max_audio_tokens
        slice_len = PAD_PF + SEG_PF + PAD_PF
        z = self._interp(self._masked(rows, ns, t_max, self._seg_bucket))
        zs = torch.stack([z[i, :, s:s + slice_len] for i, s in enumerate(slice_starts)])
        return self._pcm(self._generate(zs, self._speaker_rows(speaker_embeddings)))

    @torch.no_grad()
    def _vocode_seg_first(self, rows: torch.Tensor, ns: list,
                          speaker_embeddings: list) -> torch.Tensor:
        """The first-segment vocoder: frames [0, FIRST_SEG_PF) from a head
        window. The interp's index map does not depend on the length, so the
        interp of only the first min(64, t_max) latents, cut to FIRST_SEG_PF
        + PAD_PF frames, equals the full row's leading frames; ~3x less
        generator work than a segment window, on the time-to-first-audio
        path. Returns 16-bit PCM [B, window * 256] on the device."""
        head = min(64, self.gpt_config.max_audio_tokens)
        z = self._interp(self._masked(rows, ns, head, head))[..., : FIRST_SEG_PF + PAD_PF]
        return self._pcm(self._generate(z, self._speaker_rows(speaker_embeddings)))

    def _seg_slice_start(self, emit_start_pf: int) -> int:
        slice_len = PAD_PF + SEG_PF + PAD_PF
        return min(max(emit_start_pf - PAD_PF, 0), max(self._bucket_pf - slice_len, 0))

    def _vocode_segment(self, latents_row: torch.Tensor, n_mask: int, emit_start_pf: int,
                        emit_count_pf: int, speaker_embedding) -> np.ndarray:
        """Frames [emit_start, emit_start + emit_count) of the full-row
        vocoder's output, 256 samples each."""
        slice_start = self._seg_slice_start(emit_start_pf)
        offset = emit_start_pf - slice_start
        pcm = self._vocode_seg(latents_row[None], [n_mask], [slice_start], [speaker_embedding])
        out = pcm[0].cpu().numpy().astype(np.float32) / 32767.0
        return out[offset * 256:(offset + emit_count_pf) * 256]

    async def process_tokens_to_speech(
        self,
        generator,  # a handle from get_generation_context
        speaker_embeddings: Optional[np.ndarray] = None,
        multimodal_data: Optional[np.ndarray] = None,
        request: TTSRequest = None,
    ) -> AsyncGenerator[TTSOutput, None]:
        """Phase 2. Non-streaming: one row vocode (through the batcher) when
        the chunk finishes. Streaming: fixed segments vocoded from latent
        snapshots while the chunk decodes; their concatenation is the
        non-streaming waveform."""
        assert speaker_embeddings is not None, "XTTSv2 needs speaker embeddings"
        future, queue, spec = _unpack_handle(generator)
        inner = self._tokens_to_speech_inner(future, queue, spec, speaker_embeddings, request)
        try:
            async for out in inner:
                yield out
        finally:
            # consumer gone or done: nothing may keep burning device time
            # (cancel() on a resolved future is a no-op; a cancelled decode
            # releases its slot in the runner)
            await inner.aclose()
            if spec is not None:
                spec.discard()
            if not future.done():
                future.cancel()

    async def _tokens_to_speech_inner(self, future, queue, spec, speaker_embeddings,
                                      request) -> AsyncGenerator[TTSOutput, None]:
        sr = self.hifi_config.output_sample_rate
        start_time = request.start_time if request else None
        if queue is None:
            with span("phase2.decode_wait"):
                tokens, row, n = await future
            if n == 0:
                return
            with span("phase2.vocode"):
                wav = await self._vocode_batcher.submit("row", (row, n, speaker_embeddings))
            yield TTSOutput(array=wav, sample_rate=sr, start_time=start_time,
                            token_length=int(len(tokens)))
            return

        emitted_pf = 0
        t_max = self.gpt_config.max_audio_tokens
        pf_per_token = self._total_pf(t_max) / max(t_max, 1)
        t_consume = time.perf_counter()
        first_wait_recorded = False
        while True:
            # race the mailbox against the future: if generate() fails before
            # the runner owns the chunk nothing feeds the queue. On success
            # the final snapshot is queued as the future resolves, with no
            # await between, so a done future means a non-empty queue.
            get_task = asyncio.ensure_future(queue.get())
            try:
                await asyncio.wait({get_task, future}, return_when=asyncio.FIRST_COMPLETED)
            except BaseException:
                get_task.cancel()  # closed or cancelled while waiting
                raise
            if get_task.done():
                row, n, final = get_task.result()
            else:
                get_task.cancel()
                if future.cancelled() or future.exception() is not None:
                    await future  # raises the decode's failure here
                row, n, final = await queue.get()
            if not first_wait_recorded:
                trace_record("phase2.first_snapshot_wait", time.perf_counter() - t_consume)
                first_wait_recorded = True
            if row is None:
                await future  # the poison sentinel: surface the runner's failure
                return
            if final:
                high = self._total_pf(n)
            else:
                # latents >= n - 2 still blend with the mask edge in the
                # interp; hold back a receptive field too, so every emitted
                # sample is final
                high = max(0, self._total_pf(max(0, n - 2)) - PAD_PF)
            if emitted_pf == 0 and spec is not None and spec.task is not None:
                if n >= spec.claim_n:
                    with span("phase2.vocode_segment"):
                        wav = await spec.task
                    emitted_pf = spec.emit_pf
                    spec = None
                    yield TTSOutput(array=wav, sample_rate=sr, start_time=start_time,
                                    token_length=int(round(emitted_pf / pf_per_token)))
                elif final:
                    # the slot stopped before the claim: the latents past n
                    # are stale and the speculation is void; emit normally
                    spec.discard()
                    spec = None
                else:
                    # the status lags the claim: valid but unconfirmed; wait
                    # for the next snapshot rather than emit it twice
                    continue
            threshold = FIRST_SEG_PF if emitted_pf == 0 else SEG_PF
            while (high - emitted_pf >= threshold) or (final and high > emitted_pf):
                emit = min(SEG_PF, high - emitted_pf)
                with span("phase2.vocode_segment"):
                    wav = await self._vocode_batcher.submit(
                        "seg", (row, n, emitted_pf, emit, speaker_embeddings))
                emitted_pf += emit
                threshold = SEG_PF
                yield TTSOutput(array=wav, sample_rate=sr, start_time=start_time,
                                token_length=int(round(emit / pf_per_token)))
            if final:
                break

    async def shutdown(self) -> None:
        await self.decode_engine.shutdown()


def _unpack_handle(handle) -> tuple:
    """(future, snapshot queue or None, _SpecFirstSeg or None) of a phase-1
    handle: a bare future, or a streaming (future, queue, spec) tuple."""
    if isinstance(handle, tuple):
        return (tuple(handle) + (None, None))[:3]
    return handle, None, None


def _nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_nbytes(v) for v in tree)
    return tree.numel() * tree.element_size() if torch.is_tensor(tree) else 0


def _cast_floats(tree: Any, dtype: torch.dtype):
    if isinstance(tree, dict):
        return {k: _cast_floats(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_cast_floats(v, dtype) for v in tree]
    return tree.to(dtype) if torch.is_tensor(tree) and tree.is_floating_point() else tree
