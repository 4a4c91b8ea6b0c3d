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

The serving defaults (`serving_defaults`) follow the JAX engine's
accelerator branch, with a CUDA device where it tests for a TPU: on one
card, without tensor parallelism, int8 KV, the per-program W8A8 policy (at
the card's KV-to-weight crossover), int8 prefill weights and slot
bucketing each default to the value an H100 A/B set (the *_CUDA constants
below, PERF.md §5): each lost there to its bf16 or unbucketed counterpart,
so each is off. A bf16 KV cache there decodes through K2 unless the config
names a decode kernel: it reads each slot's rows up to that slot's own
length, where the dense bf16 body reads every slot's up to the block's
length bound. On the CPU all of these stay off, as the JAX engine has them
off a TPU. An explicit argument always wins. The slot
count is fitted to the card's free memory after the weights, less what the
captured programs of `TTS.warmup()` will reserve (`_fit_slots_to_hbm`,
`_program_pool_bytes`). Options the port lacks are dropped with a warning.
`tensor_parallel_size > 1` shards the GPT over a (1, tp) mesh
(parallel/mesh.py) of the visible GPUs, or of tp CPU shards for a CPU
engine; conditioning and the vocoder run on the mesh's first device.
`from_pretrained` loads the dual-safetensors layout that
`weights.convert_coqui_checkpoint` writes.

On the card every vocoder batch of the batcher replays a captured CUDA
graph (runtime/graphs.py), one per (kind, row bucket, exact batch size), the
counterpart of the JAX engine's jitted `_vocode_row_fn(bucket)`,
`_vocode_seg_fn` and `_vocode_seg_first_fn`; its decode blocks replay the
runner's. A key's first call runs eagerly and is captured after it;
`precompile_vocoder_buckets` and `precompile_decode_programs`, which
`TTS.warmup()` calls, capture every key before serving. On the CPU the same
programs run their functions eagerly. The eager functions (`_vocode_rows`,
`_vocode_seg`, `_vocode_seg_first`) stay the reference. Not ported, by
design: the hot/warming row-bucket sets (`serving_row_bucket`), which keep
XLA compiles off the serving path, and the legacy embeds-prompt branch.

So is conditioning: on the card `get_gpt_cond_latents` replays one program
per 22.05 kHz chunk length ("cond", n_samples) and the speaker embedding one
per 16 kHz reference length ("speaker", n_samples), the JAX engine's
`_cond_fn(n_samples)` and `_speaker_fn(n_samples)`, captured lazily on a
key's first call (`ref_length_quantum_s` bounds the lengths, as in JAX)
in a memory pool of their own; on the CPU the same programs run eagerly.
The functions (`_cond_latents`, `_speaker_dvector`) are their bodies and
the reference.
"""
from __future__ import annotations

import asyncio
import contextvars
import dataclasses
import hashlib
import json
import math
import os
import time
import weakref
from pathlib import Path
from typing import Any, AsyncGenerator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ...common import audio_io
from ...common.dsp_np import trim_silence_db
from ...common.logger import setup_logger
from ...common.output import TTSOutput
from ...common.requests import TTSRequest
from ...common.tracing import (
    TRACE_ID, device_span, interval, record as trace_record, resolve, span)
from ...ops.experimental.attention import CHUNK, DECODE_SPLIT, PARTIAL_FLOATS
from ...ops.mel import wav_to_mel_cloning
from ...ops.mrf import pack_hifigan_mrf
from ...ops.resample import resample_np
from ...runtime.decode_loop import PREFILL_BUCKETS
from ...runtime.engine_core import DecodeEngine, SamplingOptions, TokenPrompt
from ...runtime.graphs import Program, ProgramCache, upload
from ..base import BaseAsyncTTSEngine, ConditioningConfig
from .config import XTTSConfig, XTTSGPTConfig, tiny_test_config
from .gpt import READS_BY_LENGTH, decode_route, quantize_decode_weights
from .hifigan import (
    RESBLOCK_KERNELS,
    UPSAMPLE_RATES,
    _gemm_tile_rows,
    hifigan_generator,
    interp_latents,
)
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
# The serving defaults on one CUDA device without tensor parallelism, the
# counterparts of the JAX engine's TPU defaults. Each was set on an H100 by
# prod_step_torch.py's step matrix and bench_torch.py --config default's A/B
# (PERF.md §5, "Serving defaults on the H100"): the dense int8 body, W8A8
# decode and int8 prefill were slower than bf16 in every cell, and slot
# bucketing cost e-book RTF by more than the spread of its calls, so those
# four are off. W8A8 won at no KV-to-weight ratio, so the card's crossover
# is 0. K2 (flash_decode) is on for a bf16 KV cache: on an H100 a captured
# 64-step block of 64 slots at length bound 512 took 2.99 ms a step through
# K2 against 4.1-4.3 ms through the dense bf16 body, which reads every
# slot's rows up to the bound where K2 reads each slot's up to its own
# length (PERF.md §6).
KV_INT8_CUDA = False
W8A8_AUTO_CUDA = False
PREFILL_W8A8_CUDA = False
SLOT_BUCKETING_CUDA = False
W8A8_KV_TO_WEIGHT_CROSSOVER_CUDA = 0
FLASH_DECODE_CUDA = True
# headroom the slot fit leaves on the card for activations and the
# allocator, as a share of its memory (the JAX engine's 8%)
HBM_HEADROOM = 0.08
# the live engines per CUDA device, whose pending program pools a later
# engine's slot fit counts (replicas on one card)
_ENGINES_ON: dict = {}

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
    time-to-first-audio path), seg, row. Batches run in worker threads and
    issue to the same CUDA stream as the decode runner, so a vocode is
    ordered after the block whose latents it reads. Their programs run one
    at a time, under the vocoder cache's lock (`_vocode_batch`); what
    overlaps is each batch's host copy, which waits for the stream up to its
    output, decode blocks included, and the trimming after it. So up to
    MAX_INFLIGHT batches are in flight at once: with one, the batcher forms
    no batch while that copy waits, and on an H100 (6 seeds each) the loaded
    e-book served a median 175.7 audio_s/s against 317.5 with three, and
    the loaded chat's time to first audio rose from 146 to 1752 ms at its
    median. Each item carries its chunk's trace id (tracing.TRACE_ID),
    taken when it is submitted: the batches run in the batcher's own task.

    Unlike the JAX batcher, a batch is not padded to a fixed size (its
    `_pad`): here too each batch size is its own captured program, but the
    MRF stages (kernel K3) are bound by operations on the H100 (PERF.md
    §6), so padding a lone segment to 4 lanes would cost about 4x its
    vocoder time, and a program per exact batch size (8 + 4 + 4 per row
    bucket) costs only capture time."""

    MAX_BATCH = 4
    SEG_FIRST_MAX_BATCH = 8
    MAX_INFLIGHT = 3

    def __init__(self, engine: "XTTSv2Engine"):
        self.engine = engine
        self._pending = {"row": [], "seg": [], "seg_first": []}
        self._task: Optional[asyncio.Task] = None
        self._inflight: Optional[asyncio.Semaphore] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None

    async def submit(self, kind: str, item: tuple, trace_id: Optional[str] = None) -> np.ndarray:
        loop = asyncio.get_running_loop()
        if loop is not self._loop:
            # the engine outlives individual event loops (the sync API runs
            # one per call): a dead loop's drain task and futures never
            # resolve, so start afresh on this one
            self._pending = {"row": [], "seg": [], "seg_first": []}
            self._task = None
            self._loop = loop
        fut: asyncio.Future = loop.create_future()
        self._pending[kind].append((item, fut, trace_id))
        if self._task is None or self._task.done():
            self._inflight = asyncio.Semaphore(self.MAX_INFLIGHT)
            # a context of its own: the batches serve every chunk, not the
            # submitter's (tracing.TRACE_ID)
            self._task = loop.create_task(self._drain(), context=contextvars.Context())
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
        items = [it for it, _, _ in batch]
        try:
            outs = await asyncio.to_thread(self._run_batch, kind, items,
                                           [tid for _, _, tid in batch])
        except Exception as e:  # every waiter gets the failure
            for _, fut, _ in batch:
                try:
                    if not fut.done():
                        fut.set_exception(e)
                except RuntimeError:
                    pass  # a future of a closed loop
            return
        finally:
            self._inflight.release()
        for (_, fut, _), out in zip(batch, outs):
            try:
                if not fut.done():
                    fut.set_result(out)
            except RuntimeError:
                pass  # a future of a closed loop

    @torch.no_grad()
    def _run_batch(self, kind: str, items: list, trace_ids: Sequence = ()) -> list:
        eng = self.engine
        rows = [it[0] for it in items]
        ns = [int(it[1]) for it in items]
        if kind == "row":  # (row, n, g)
            return eng._trimmed(eng._vocode_batch("row", rows, ns, [it[2] for it in items],
                                                  eng.row_bucket(max(ns)), trace_ids), ns)
        if kind == "seg_first":  # (row, n_mask, g): frames [0, FIRST_SEG_PF)
            pcm = eng._vocode_batch("seg_first", rows, ns, [it[2] for it in items],
                                    trace_ids=trace_ids)
            return [pcm[i, : FIRST_SEG_PF * 256].astype(np.float32) / 32767.0
                    for i in range(len(items))]
        # seg: (row, n_mask, emit_start_pf, emit_count_pf, g)
        starts = [eng._seg_slice_start(it[2]) for it in items]
        pcm = eng._vocode_batch("seg", rows, ns, [it[4] for it in items], starts, trace_ids)
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
    hold-back as the snapshot path, so the waveform is the same either way.
    It carries its chunk's trace id: the hook runs in the runner's task."""

    __slots__ = ("engine", "g", "trace_id", "claim_n", "emit_pf", "task")

    def __init__(self, engine: "XTTSv2Engine", speaker_embeddings,
                 trace_id: Optional[str] = None):
        self.engine = engine
        self.g = speaker_embeddings
        self.trace_id = trace_id
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
            eng._vocode_batcher.submit("seg_first", (row, n_claim, self.g), self.trace_id))
        # a discarded speculation must not log "exception never retrieved"
        self.task.add_done_callback(lambda t: t.exception() if not t.cancelled() else None)
        return True

    def discard(self) -> None:
        if self.task is not None and not self.task.done():
            self.task.cancel()
        self.task = None


@dataclasses.dataclass(frozen=True)
class ServingDefaults:
    """What `serving_defaults` resolves: the GPT config with kv_int8,
    flash_decode, decode_w8a8 and prefill_w8a8 set, whether the per-program W8A8 policy is
    armed and at which KV-to-weight crossover, and slot bucketing."""

    gpt_config: XTTSGPTConfig
    w8a8_auto: bool
    crossover: float
    slot_bucketing: bool


def serving_defaults(device_type: str, tensor_parallel_size: int, gpt_config: XTTSGPTConfig,
                     kv_int8: Optional[bool] = None, decode_w8a8: Optional[bool] = None,
                     prefill_w8a8: Optional[bool] = None,
                     slot_bucketing: Optional[bool] = None) -> ServingDefaults:
    """The engine's serving configuration, in the JAX engine's order and by
    its rules (auralis_tpu/models/xttsv2/engine.py:333-428, 526-536), with
    `device_type == "cuda"` where JAX tests for a TPU backend and the *_CUDA
    constants for the values it measured on a TPU:
    - an explicit argument wins; `kv_int8` is resolved only without
      flash_decode, and defaults off under tensor parallelism;
    - on one card a resolved bf16 KV cache (kv_int8 off) whose config sets
      neither flash_decode nor ragged_decode takes flash_decode
      (FLASH_DECODE_CUDA): K2 instead of the dense bf16 body, a step for
      the card alone, which JAX does not take;
    - the W8A8 policy arms only when `decode_w8a8` is unset, the config's
      decode_w8a8 is off and neither flash_decode nor ragged_decode is on;
    - `prefill_w8a8` arms only when `decode_w8a8 is not False`;
    - under tensor parallelism the int8 weight flags are refused (warned);
    - the caller's config is never mutated (a replaced copy comes back).
    On the CPU every default is off, as JAX has them off a TPU."""
    card = device_type == "cuda"
    single = tensor_parallel_size == 1
    if kv_int8 is None and not gpt_config.flash_decode:
        kv_int8 = card and single and KV_INT8_CUDA
    if kv_int8 is not None and kv_int8 != gpt_config.kv_int8:
        gpt_config = dataclasses.replace(gpt_config, kv_int8=kv_int8)
    if (card and single and FLASH_DECODE_CUDA and not gpt_config.kv_int8
            and not gpt_config.flash_decode and not gpt_config.ragged_decode):
        gpt_config = dataclasses.replace(gpt_config, flash_decode=True)
    if (decode_w8a8 or gpt_config.decode_w8a8) and not single:
        logger.warning(
            "decode_w8a8 is unsupported under tensor parallelism (int8 weights would "
            "replicate per device and activation quantization forces per-layer "
            "collectives); disabling.")
        decode_w8a8 = False
    w8a8_auto = (decode_w8a8 is None and not gpt_config.decode_w8a8 and card and single
                 and W8A8_AUTO_CUDA and not gpt_config.flash_decode
                 and not gpt_config.ragged_decode)
    if decode_w8a8 is not None and decode_w8a8 != gpt_config.decode_w8a8:
        gpt_config = dataclasses.replace(gpt_config, decode_w8a8=decode_w8a8)
    if prefill_w8a8 is None and not gpt_config.prefill_w8a8:
        prefill_w8a8 = card and single and PREFILL_W8A8_CUDA and decode_w8a8 is not False
    if (prefill_w8a8 or gpt_config.prefill_w8a8) and not single:
        logger.warning(
            "prefill_w8a8 is unsupported under tensor parallelism (int8 weights would "
            "replicate per device and activation quantization forces per-layer "
            "collectives); disabling.")
        prefill_w8a8 = False
    if prefill_w8a8 is not None and prefill_w8a8 != gpt_config.prefill_w8a8:
        gpt_config = dataclasses.replace(gpt_config, prefill_w8a8=prefill_w8a8)
    if slot_bucketing is None:
        slot_bucketing = card and SLOT_BUCKETING_CUDA
    crossover = W8A8_KV_TO_WEIGHT_CROSSOVER_CUDA if card else W8A8_KV_TO_WEIGHT_CROSSOVER_TPU
    return ServingDefaults(gpt_config, w8a8_auto, crossover, bool(slot_bucketing))


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
        serving: Optional[ServingDefaults] = None,
        **kwargs,
    ):
        # tensor parallelism: a (1, tp) mesh over the visible GPUs (or tp
        # CPU shards for a CPU engine) shards attention heads and MLP
        # columns (parallel/mesh.py), as the JAX engine's mesh does
        self.mesh = None
        if tensor_parallel_size > 1:
            from ...parallel.mesh import make_mesh

            if gpt_config.num_attention_heads % tensor_parallel_size:
                raise ValueError(
                    f"tensor_parallel_size={tensor_parallel_size} must divide "
                    f"num_attention_heads={gpt_config.num_attention_heads}")
            on_card = torch.device(device).type == "cuda"
            devices = (None if on_card else [torch.device("cpu")] * tensor_parallel_size)
            self.mesh = make_mesh(devices, data=1, model=tensor_parallel_size)
            device = self.mesh.first_device
        # `serving`, another engine's resolved configuration (a replica's
        # donor's), is taken as it is, flags and policy
        resolved = serving or serving_defaults(
            torch.device(device).type, tensor_parallel_size, gpt_config, kv_int8, decode_w8a8,
            prefill_w8a8, slot_bucketing)
        self.serving = resolved
        gpt_config = resolved.gpt_config
        # the per-program W8A8 policy, where the resolution arms it: the
        # int8 decode weights run while a block's KV read is below the
        # crossover times the block weights' bytes (w8a8_policy)
        self._w8a8_auto = resolved.w8a8_auto
        self.w8a8_crossover = resolved.crossover
        if self._w8a8_auto:
            logger.info("decode_w8a8 auto policy enabled (per-program int8 weights when KV "
                        "bytes < %sx weight bytes; adds blocks_q8 to the params)",
                        resolved.crossover)
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
        if self.mesh is not None:
            params = {k: v for k, v in params.items() if k != "blocks_q8"}
            self.params = params
        if ((gpt_config.decode_w8a8 or gpt_config.prefill_w8a8 or self._w8a8_auto)
                and "blocks_q8" not in params):
            self.params = {**params, "blocks_q8": quantize_decode_weights(params["blocks"])}
        self.core = dict(core)
        if self.mesh is not None:
            # conditioning and the vocoder run on the mesh's first device
            from ...parallel.mesh import replicate

            self.core = replicate(self.core, self.mesh)
        if vocoder_dtype is not None:
            # the generator computes in its params' dtype; the MRF stages
            # accumulate in f32 (kernel K3's precision contract)
            self.core["hifigan"] = _cast_floats(self.core["hifigan"], vocoder_dtype)
        self.cache_dtype = cache_dtype
        # the pools this engine's captures will reserve, until its warmup
        # has captured them: the slot fit of a later engine on the same card
        # counts them
        self._pools_pending = 0
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
            steps_per_sync=steps_per_sync, seed=seed, slot_bucketing=resolved.slot_bucketing,
            w8a8_policy=self.w8a8_policy(self.w8a8_crossover) if self._w8a8_auto else None,
            stream_block_steps=stream_block_steps, device=self.device, mesh=self.mesh)
        hifigan = self.core["hifigan"]
        self._packed_stages = pack_hifigan_mrf(
            hifigan["resblocks"], RESBLOCK_KERNELS, hifigan["conv_pre_w"].dtype, self.device)
        self.conditioning_cache_size = max(1, int(conditioning_cache_size))
        self.ref_length_quantum_s = float(ref_length_quantum_s)
        self._cond_cache: dict[str, tuple] = {}
        self._vocode_batcher = _VocodeBatcher(self)
        # the batcher's vocoder programs, in a memory pool apart from the
        # decode blocks'
        self._vocoder_programs = ProgramCache(self.device)
        # the conditioning programs, keyed by reference length, in a third
        self._cond_programs = ProgramCache(self.device)
        self.get_memory_usage_curve()
        if self.device.type == "cuda":
            self._pools_pending = self.pool_bytes
            _ENGINES_ON.setdefault(_card(self.device), weakref.WeakSet()).add(self)

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

    # ------------------------------------------------ captured-program pools
    def _vocoder_peak_bytes(self, kind: str, b: int, bucket: Optional[int] = None) -> int:
        """Peak temporaries of the vocoder program (kind, b lanes, row
        bucket), from its shapes. The generator peaks at its last conv
        (conv_post as an im2col GEMM over the last stage's C channels): per
        output sample the leaky ReLU's output, its padded copy, the im2col
        row (K x C) and the product, all in the vocoder dtype; beside them
        the fixed-row GEMM's zero-padded last tile, the interp's frames and
        the masked latents (f32, D each) and the largest upsample GEMM
        operand, which each call builds (four copies on the way)."""
        g, hg = self.gpt_config, self.core["hifigan"]
        dt = hg["conv_pre_w"].element_size()
        if kind == "row":
            latents, window = bucket, self._total_pf(bucket)
            frames = window
        elif kind == "seg":
            latents, frames = self._seg_bucket, self._bucket_pf
            window = PAD_PF + SEG_PF + PAD_PF
        else:
            latents = min(64, g.max_audio_tokens)
            frames, window = self._total_pf(latents), FIRST_SEG_PF + PAD_PF
        k_post, c_last = hg["conv_post_w"].shape[:2]
        samples = b * window * math.prod(UPSAMPLE_RATES)
        per_sample = dt * (c_last * (2 + k_post) + 1)
        tile = _gemm_tile_rows(k_post * c_last) * k_post * c_last * dt
        operand = max(3 * up["w"].shape[1] * rate * up["w"].shape[2] * dt
                      for up, rate in zip(hg["ups"], UPSAMPLE_RATES))
        kept = b * (frames + latents) * g.hidden_size * 4
        return samples * per_sample + tile + 4 * operand + kept

    def _vocoder_static_bytes(self, kind: str, b: int, bucket: Optional[int] = None) -> int:
        """Static inputs and output of a vocoder program (`_vocoder_program`):
        rows [B, width, D] f32, n and starts int64, d-vectors f32, and the
        16-bit PCM output."""
        g = self.gpt_config
        t_max = g.max_audio_tokens
        width = {"row": min(bucket or t_max, t_max), "seg": t_max,
                 "seg_first": min(64, t_max)}[kind]
        window = {"row": self._total_pf(bucket or t_max), "seg": PAD_PF + SEG_PF + PAD_PF,
                  "seg_first": FIRST_SEG_PF + PAD_PF}[kind]
        return b * (width * g.hidden_size * 4 + 16 + self.hifi_config.d_vector_dim * 4
                    + window * math.prod(UPSAMPLE_RATES) * 2)

    def vocoder_keys(self) -> list[tuple]:
        """(kind, batch size, row bucket) of every vocoder program the batcher
        can run, largest peak first (the order `precompile_vocoder_buckets`
        captures them in: later, smaller programs reuse the blocks the
        earlier ones freed in the shared pool)."""
        t_max = self.gpt_config.max_audio_tokens
        buckets = sorted({self.row_bucket(n) for n in range(1, t_max + 1)})
        keys = ([("seg_first", b, None) for b in range(1, _VocodeBatcher.SEG_FIRST_MAX_BATCH + 1)]
                + [("seg", b, None) for b in range(1, _VocodeBatcher.MAX_BATCH + 1)]
                + [("row", b, bucket) for bucket in buckets
                   for b in range(1, _VocodeBatcher.MAX_BATCH + 1)])
        return sorted(keys, key=lambda k: -self._vocoder_peak_bytes(*k))

    def _insert_peak_bytes(self, bucket: int, k: int) -> int:
        """Peak temporaries of the insert program at a prefill bucket: a
        burst of k lanes (and a single insert without K1) holds the dense
        attention's [k, H, T, T] scores in f32 three times (the previous
        layer's, the product and its scaled copy) and its probabilities in
        the activation dtype and in f32 (18 bytes an entry); K1's single
        insert holds one layer's activations (qkv, the MLP's f32 gelu)."""
        g = self.gpt_config
        if k > 1 or not g.prefill_flash:
            return k * g.num_attention_heads * bucket * bucket * 18
        return bucket * (3 * g.hidden_size * 4 + 2 * 4 * g.hidden_size * 4)

    def _program_pool_bytes(self) -> tuple[int, int]:
        """(fixed bytes, bytes per slot) that the captured programs of
        `TTS.warmup()` reserve on the engine's device, from the shapes the
        programs hold; 0 on the CPU, where nothing is captured.

        - The vocoder programs share one pool and are captured largest
          first. A program's last conv takes its im2col matrix from a new
          segment, as no block freed before it is large enough, so the pool
          holds twice the largest program's peak temporaries
          (`_vocoder_peak_bytes`), plus every program's static inputs and
          output.
        - The insert programs share the decode state's pool, also largest
          first: the largest burst's peak (`_insert_peak_bytes`), per
          prefill bucket and K = 2, 4, 8 as `precompile_inserts` forms them.
        - Each key's first run is eager: the largest program's temporaries
          are needed once more, in the allocator's own cache.
        - Per slot, the decode blocks' share: K2/K4's split workspace, or
          for the dense bodies the f32 size of a slot's K and V rows, the
          copies the dense int8 body makes; the dense bf16 body reads its
          rows in place, and its f32 scores take far less."""
        if self.device.type != "cuda":
            return 0, 0
        g = self.gpt_config
        keys = self.vocoder_keys()
        vocoder = 2 * self._vocoder_peak_bytes(*keys[0]) + sum(
            self._vocoder_static_bytes(*k) for k in keys)
        buckets = [b for b in PREFILL_BUCKETS if b <= g.max_seq_len] or [g.max_seq_len]
        inserts = max(self._insert_peak_bytes(b, k) for b in buckets
                      for k in (1, *DecodeEngine._INSERT_K_BUCKETS))
        eager = max(self._vocoder_peak_bytes(*keys[0]), inserts)
        t_pad = -(-g.max_seq_len // CHUNK) * CHUNK
        lanes = g.hidden_size // max(1, self._tp)
        if decode_route(g) in READS_BY_LENGTH:
            per_slot = g.num_attention_heads * (t_pad // DECODE_SPLIT) * PARTIAL_FLOATS * 4
        else:
            per_slot = 2 * t_pad * lanes * 4
        return vocoder + inserts + eager, per_slot

    def _slot_share_bytes(self) -> int:
        """Bytes of one slot on the mesh's most loaded device (the first: its
        KV lanes, its int8 scales and the latent row), or the whole slot
        without a mesh."""
        _, slot = self._hbm_plan_bytes()
        if self._tp == 1:
            return slot
        g = self.gpt_config
        t_pad = -(-g.max_seq_len // CHUNK) * CHUNK
        kv = g.num_hidden_layers * t_pad * 2 * g.hidden_size * (
            1 if g.kv_int8 else self.cache_dtype.itemsize)
        return slot - kv + kv // self._tp

    @property
    def _tp(self) -> int:
        return 1 if self.mesh is None else self.mesh.shape["model"]

    def _fit_slots_to_hbm(self, num_slots: int, *, slots_explicit: bool) -> int:
        """The slot count that fits the card: what `torch.cuda.mem_get_info`
        leaves free after the weights (already resident; memory the
        allocator holds but has not handed out counts as free), less
        HBM_HEADROOM of the card, less the pools that the captured programs
        of this engine and of the other unwarmed engines on the card will
        reserve (`_program_pool_bytes`), divided by the bytes per slot and
        its share of the decode blocks' pool. Under a mesh the first
        device's share counts, with the model shards' weight copies still
        to come. A default count above that is clamped; an explicit one
        raises, as does a card that cannot hold 2 slots. On the CPU nothing
        is enforced."""
        if self.device.type != "cuda":
            return num_slots
        slot_bytes = self._slot_share_bytes()
        pools, pool_slot = self._program_pool_bytes()
        others = sum(e._pools_pending for e in list(_ENGINES_ON.get(_card(self.device), ()))
                     if e is not self) if _ENGINES_ON else 0
        free, total = torch.cuda.mem_get_info(self.device)
        free += torch.cuda.memory_reserved(self.device) - torch.cuda.memory_allocated(self.device)
        budget = free - int(total * HBM_HEADROOM) - pools - others
        if self.mesh is not None:
            budget -= _nbytes(self.params["blocks"]) // self._tp
        fit = max(0, budget) // (slot_bytes + pool_slot)
        if fit < 2 or (slots_explicit and fit < num_slots):
            raise ValueError(
                f"decode_slots={num_slots} needs {num_slots * slot_bytes / 1024**3:.2f} GiB of KV "
                f"and latent rows, but {max(0, budget) / 1024**3:.2f} GiB of the card's "
                f"{total / 1024**3:.2f} GiB are left after the weights and "
                f"{(pools + others) / 1024**3:.2f} GiB of captured-program pools ({fit} slots "
                "fit)")
        if fit < num_slots:
            logger.warning("decode_slots=%d does not fit the card's free memory; clamping to %d",
                           num_slots, fit)
            return fit
        return num_slots

    def get_memory_usage_curve(self) -> float:
        """Device-memory plan in GiB: weights (blocks_q8 included) + per slot
        its KV rows as allocated (int8 rows and f32 scale rows under kv_int8)
        and its latent row + the pools of the captured programs (0 on the
        CPU), logged apart."""
        weights, slot = self._hbm_plan_bytes()
        pools, pool_slot = self._program_pool_bytes()
        pools += pool_slot * self.decode_slots
        self.pool_bytes = pools
        self.max_gb_for_model = (weights + slot * self.decode_slots + pools) / 1024**3
        logger.info("memory plan: %.2f GiB (weights %.2f GiB + %d slots x %.1f MiB + "
                    "captured-program pools %.2f GiB)", self.max_gb_for_model,
                    weights / 1024**3, self.decode_slots, slot / 1024**2, pools / 1024**3)
        return self.max_gb_for_model

    def w8a8_policy(self, crossover: float = W8A8_KV_TO_WEIGHT_CROSSOVER_TPU):
        """The per-program W8A8 policy, the JAX engine's closure: a function
        of (len_bound, slot_bound) that is True (run the int8 decode
        weights) while the block's KV read is below `crossover` times the
        bytes of the bf16 block weights. The engine arms it with its
        `w8a8_crossover` where `serving_defaults` says so; the default
        crossover is the JAX engine's, fitted on a TPU v5e."""
        g = self.gpt_config
        d, nl = g.hidden_size, g.num_hidden_layers
        kv_elem = 1 if g.kv_int8 else self.cache_dtype.itemsize
        w_bytes = _nbytes(self.params["blocks"])

        def policy(len_bound: int, slot_bound: int) -> bool:
            kv_bytes = slot_bound * len_bound * 2 * d * nl * kv_elem
            return kv_bytes < crossover * w_bytes

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
        embs = [self._conditioning("cond", chunk) for chunk in chunks]
        return np.mean(embs, axis=0)  # [1, C, D]

    @torch.no_grad()
    def _speaker_embedding(self, wav16: np.ndarray) -> np.ndarray:
        return self._conditioning("speaker", wav16)

    def _cond_latents(self, wav: torch.Tensor) -> torch.Tensor:
        """22.05 kHz wav [1, n] on the device -> perceiver latents [1, C, D]."""
        mel = wav_to_mel_cloning(
            wav, mel_norms=self.core["mel_stats"], n_fft=2048, hop_length=256,
            win_length=1024, power=2.0, sample_rate=22050, f_min=0.0, f_max=8000.0,
            n_mels=80,
        )  # [1, 80, F]
        h = conditioning_encoder(self.core["cond_encoder"], mel.transpose(1, 2),
                                 self.gpt_config.num_attention_heads)
        return perceiver_resampler(self.core["perceiver"], h)

    def _speaker_dvector(self, wav16: torch.Tensor) -> torch.Tensor:
        """16 kHz wav [1, n] on the device -> d-vector [1, 512]."""
        return speaker_encoder(self.core["speaker_encoder"], wav16, l2_norm=True)

    @torch.no_grad()
    def _conditioning(self, kind: str, wav: np.ndarray) -> np.ndarray:
        """`_cond_latents` ("cond") or `_speaker_dvector` ("speaker") of a host
        wav [1, n], f32 on the host, through the program of (kind, n)
        (captured on the card, eager on the CPU). Conditioning runs in worker
        threads, so the rule of `graphs.py`'s pool holds: under the cache's
        lock the wav is staged through pinned memory, the program runs and
        its output is cloned out of the pool; the host copy waits after the
        release."""
        wav = np.ascontiguousarray(wav, np.float32)
        if wav.ndim != 2 or wav.shape[0] != 1:
            raise ValueError(f"conditioning takes one [1, n] reference, got {wav.shape}")
        fn = self._cond_latents if kind == "cond" else self._speaker_dvector

        def build():
            inp = {"wav": torch.zeros(wav.shape, dtype=torch.float32, device=self.device)}
            return (lambda: fn(inp["wav"])), inp

        prog = self._cond_programs.get((kind, wav.shape[1]), build)
        with prog.lock:
            upload(prog.inputs["wav"], wav)
            out = prog().clone()
        return out.float().cpu().numpy()

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
            return hit

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
                chunk_id = f"{request.request_id}_{idx}"
                # the chunk's decode task inherits its trace id
                token = TRACE_ID.set(chunk_id)
                try:
                    if request.stream:
                        # a snapshot mailbox, so segments are vocoded while
                        # the chunk decodes, and the speculative first segment
                        queue = asyncio.Queue()
                        spec = _SpecFirstSeg(self, speaker_embeddings, chunk_id)
                        fut = asyncio.ensure_future(self.decode_engine.generate(
                            prompt, options, stream_queue=queue, on_young_block=spec.hook))
                        handles.append((fut, queue, spec))
                    else:
                        handles.append(asyncio.ensure_future(
                            self.decode_engine.generate(prompt, options)))
                finally:
                    TRACE_ID.reset(token)
                request_ids.append(chunk_id)
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
        return torch.from_numpy(_lane_floats(speaker_embeddings)).to(self.device)

    def _lanes(self, values: list) -> torch.Tensor:
        """Per-lane host ints -> [B] int64 on the engine's device."""
        return torch.tensor(values, dtype=torch.int64).to(self.device)

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
    def _masked(rows: torch.Tensor, n: torch.Tensor, cut: int, length: int) -> torch.Tensor:
        """rows [B, >= cut, D] -> f32 [B, length, D]: the first `cut` latents
        with positions >= n[b] zeroed (stale slot data), zero-padded; n [B]
        int64 on the rows' device."""
        x = rows[:, :cut].float()
        x = torch.where(torch.arange(cut, device=x.device)[None, :, None] < n[:, None, None],
                        x, 0.0)
        return F.pad(x, (0, 0, 0, length - cut)) if length > cut else x

    def _rows_pcm(self, rows: torch.Tensor, n: torch.Tensor, g: torch.Tensor,
                  bucket: int) -> torch.Tensor:
        """The row vocoder at `bucket` on device inputs: rows [B, >= cut, D]
        masked at n [B] and padded to the bucket, d-vectors g [B, 512] ->
        16-bit PCM [B, bucket frames * 256] on the device."""
        x = self._masked(rows, n, min(bucket, self.gpt_config.max_audio_tokens), bucket)
        return self._pcm(self._generate(self._interp(x), g))

    @torch.no_grad()
    def _vocode_rows(self, rows: torch.Tensor, ns: list, speaker_embeddings: list) -> list:
        """The batched row vocoder: latent rows [B, T_audio, D] on the device,
        each with its own n live entries, masked and padded to the bucket of
        the largest n; returns each waveform trimmed to its true length (f32
        on the host, from 16-bit PCM). Eager: the batcher runs the program of
        the same body instead (`_vocode_batch`)."""
        return self._trimmed(self._rows_pcm(rows, self._lanes(ns),
                                            self._speaker_rows(speaker_embeddings),
                                            self.row_bucket(max(ns))).cpu().numpy(), ns)

    def _trimmed(self, pcm: np.ndarray, ns: list) -> list:
        """Row-vocoder PCM [B, samples] -> each lane's waveform cut to the
        true length of its n latents, f32."""
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

    def _seg_pcm(self, rows: torch.Tensor, n: torch.Tensor, starts: torch.Tensor,
                 g: torch.Tensor) -> torch.Tensor:
        """The segment vocoder on device inputs: interp each whole masked row
        as the full-row vocoder does (at `_seg_bucket`), gather one [start,
        start + PAD_PF + SEG_PF + PAD_PF) frame window per lane (starts [B]
        int64) and run the generator on the windows. With PAD_PF >= the
        generator's receptive field, a window's centre equals the full-row
        output sample for sample. Returns 16-bit PCM [B, window * 256] on
        the device."""
        slice_len = PAD_PF + SEG_PF + PAD_PF
        z = self._interp(self._masked(rows, n, self.gpt_config.max_audio_tokens,
                                      self._seg_bucket))
        idx = starts[:, None] + torch.arange(slice_len, device=z.device)[None, :]
        zs = torch.gather(z, 2, idx[:, None, :].expand(-1, z.shape[1], -1))
        return self._pcm(self._generate(zs, g))

    @torch.no_grad()
    def _vocode_seg(self, rows: torch.Tensor, ns: list, slice_starts: list,
                    speaker_embeddings: list) -> torch.Tensor:
        """`_seg_pcm` on latent rows [B, T_audio, D] on the device and host
        per-lane n, window starts and d-vectors. Eager: the batcher runs the
        program of the same body instead (`_vocode_batch`)."""
        return self._seg_pcm(rows, self._lanes(ns), self._lanes(slice_starts),
                             self._speaker_rows(speaker_embeddings))

    def _seg_first_pcm(self, rows: torch.Tensor, n: torch.Tensor,
                       g: torch.Tensor) -> torch.Tensor:
        """The first-segment vocoder on device inputs: frames [0,
        FIRST_SEG_PF) from a head window. The interp's index map does not
        depend on the length, so the interp of only the first min(64, t_max)
        latents, cut to FIRST_SEG_PF + PAD_PF frames, equals the full row's
        leading frames; ~3x less generator work than a segment window, on
        the time-to-first-audio path. Returns 16-bit PCM [B, window * 256]
        on the device."""
        head = min(64, self.gpt_config.max_audio_tokens)
        z = self._interp(self._masked(rows, n, head, head))[..., : FIRST_SEG_PF + PAD_PF]
        return self._pcm(self._generate(z, g))

    @torch.no_grad()
    def _vocode_seg_first(self, rows: torch.Tensor, ns: list,
                          speaker_embeddings: list) -> torch.Tensor:
        """`_seg_first_pcm` on latent rows [B, T_audio, D] on the device and
        host per-lane n and d-vectors. Eager: the batcher runs the program of
        the same body instead (`_vocode_batch`)."""
        return self._seg_first_pcm(rows, self._lanes(ns), self._speaker_rows(speaker_embeddings))

    def _vocoder_program(self, kind: str, b: int, bucket: Optional[int] = None) -> Program:
        """The vocoder program of (kind, row bucket, B), the JAX
        engine's `_vocode_row_fn(bucket)` / `_vocode_seg_fn` /
        `_vocode_seg_first_fn` at batch B: static inputs rows [B, the
        latents it reads, D] f32, n [B] int64, g [B, d_vector] f32 and, for
        "seg", the window starts [B] int64."""
        def build():
            t_max, dev = self.gpt_config.max_audio_tokens, self.device
            width = {"row": min(bucket or t_max, t_max), "seg": t_max,
                     "seg_first": min(64, t_max)}[kind]
            inp = {"rows": torch.zeros((b, width, self.gpt_config.hidden_size),
                                       dtype=torch.float32, device=dev),
                   "n": torch.ones((b,), dtype=torch.int64, device=dev),
                   "g": torch.zeros((b, self.hifi_config.d_vector_dim), dtype=torch.float32,
                                    device=dev)}
            if kind == "row":
                fn = lambda: self._rows_pcm(inp["rows"], inp["n"], inp["g"], bucket)  # noqa: E731
            elif kind == "seg":
                inp["starts"] = torch.zeros((b,), dtype=torch.int64, device=dev)
                fn = lambda: self._seg_pcm(inp["rows"], inp["n"], inp["starts"], inp["g"])  # noqa: E731
            else:
                fn = lambda: self._seg_first_pcm(inp["rows"], inp["n"], inp["g"])  # noqa: E731
            return fn, inp

        return self._vocoder_programs.get((kind, bucket, b), build)

    @torch.no_grad()
    def _vocode_batch(self, kind: str, rows: list, ns: list, speaker_embeddings: list,
                      arg=None, trace_ids: Sequence = ()) -> np.ndarray:
        """One batch of the vocode batcher as 16-bit PCM [B, samples] on the
        host: kind "row" (`arg`: the row bucket), "seg" (`arg`: each lane's
        window start) or "seg_first"; rows are device latent rows [T_audio,
        D]. The batch runs the program of its kind, bucket and exact B
        (captured on the card, eager on the CPU). Batches run in worker
        threads, so the rule of `graphs.py`'s pool holds: under the vocoder
        cache's lock the inputs are staged into the program's static
        tensors, the program runs and its output is cloned out of the pool;
        the host copy waits after the release. The wait for the lock is the
        record `vocode.lock_wait`; the staging and the program are the device
        span `vocode.device.<kind>` (the lanes' `trace_ids`, the batch size),
        resolved once the PCM is on the host."""
        prog = self._vocoder_program(kind, len(rows), arg if kind == "row" else None)
        inp = prog.inputs
        t_wait = time.perf_counter()
        with prog.lock:
            trace_record("vocode.lock_wait", time.perf_counter() - t_wait)
            with device_span(f"vocode.device.{kind}", self.device, trace_ids=list(trace_ids),
                             batch=len(rows)):
                width = inp["rows"].shape[1]
                for lane, row in zip(inp["rows"], rows):
                    lane.copy_(row[:width])
                upload(inp["n"], np.asarray(ns, np.int64))
                upload(inp["g"], _lane_floats(speaker_embeddings))
                if kind == "seg":
                    upload(inp["starts"], np.asarray(arg, np.int64))
                pcm = prog()
            pcm = pcm.clone()
        out = pcm.cpu().numpy()
        resolve()
        return out

    def precompile_vocoder_buckets(self) -> None:
        """Capture every vocoder program the batcher can run before serving
        (the JAX engine's precompile of its row buckets and streaming
        programs): the first segment at B = 1..SEG_FIRST_MAX_BATCH, the
        segment window at B = 1..MAX_BATCH, and the row vocoder in every
        bucket `row_bucket` can return at B = 1..MAX_BATCH, largest first
        (`vocoder_keys`). Each key's
        first call runs once on zero rows and is captured; the call drains
        its work before it returns. On the CPU nothing is captured."""
        if not self._vocoder_programs.captures:
            return
        t0 = time.perf_counter()
        keys = self.vocoder_keys()
        for kind, b, bucket in keys:
            prog = self._vocoder_program(kind, b, bucket)
            with prog.lock:
                prog()
        torch.cuda.synchronize(self.device)
        logger.info("vocoder programs captured: %d in %.1f s", len(keys), time.perf_counter() - t0)

    def precompile_decode_programs(self) -> None:
        """Capture every program the runner can dispatch before serving: the
        decode blocks (`DecodeEngine.precompile`), then every insert program
        and `migrate_slot` (`DecodeEngine.precompile_inserts` at the
        perceiver's latent count, the cond width of every prompt), as the
        JAX engine does here."""
        self.decode_engine.precompile()
        self.decode_engine.precompile_inserts(int(self.gpt_config.num_cond_latents))
        self._pools_pending = 0  # reserved now: the card's free memory shows them

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
        """The chunk's audio; its first piece is marked on the timeline by
        the instant `phase2.first_audio` under the chunk's trace id."""
        sr = self.hifi_config.output_sample_rate
        start_time = request.start_time if request else None
        trace_id = _trace_id_of(future)

        def first_audio():
            now = time.perf_counter()
            interval("phase2.first_audio", now, now, trace_id)

        if queue is None:
            tokens, row, n = await future
            if n == 0:
                return
            wav = await self._vocode_batcher.submit("row", (row, n, speaker_embeddings), trace_id)
            first_audio()
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
                trace_record("phase2.first_snapshot_wait", time.perf_counter() - t_consume,
                             trace_id)
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
                    wav = await spec.task
                    emitted_pf = spec.emit_pf
                    spec = None
                    first_audio()
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
                wav = await self._vocode_batcher.submit(
                    "seg", (row, n, emitted_pf, emit, speaker_embeddings), trace_id)
                if not emitted_pf:
                    first_audio()
                emitted_pf += emit
                threshold = SEG_PF
                yield TTSOutput(array=wav, sample_rate=sr, start_time=start_time,
                                token_length=int(round(emit / pf_per_token)))
            if final:
                break

    async def shutdown(self) -> None:
        await self.decode_engine.shutdown()


def _card(device: torch.device) -> torch.device:
    """A CUDA device with its index (`cuda` names the current one)."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _trace_id_of(future) -> Optional[str]:
    """The chunk id a decode task was started under (tracing.TRACE_ID)."""
    get_context = getattr(future, "get_context", None)
    return get_context().get(TRACE_ID) if get_context is not None else None


def _unpack_handle(handle) -> tuple:
    """(future, snapshot queue or None, _SpecFirstSeg or None) of a phase-1
    handle: a bare future, or a streaming (future, queue, spec) tuple."""
    if isinstance(handle, tuple):
        return (tuple(handle) + (None, None))[:3]
    return handle, None, None


def _lane_floats(speaker_embeddings: list) -> np.ndarray:
    """One d-vector per lane (host [1, 512] each) -> [B, 512] f32."""
    return np.concatenate([np.asarray(e, np.float32).reshape(1, -1) for e in speaker_embeddings])


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
