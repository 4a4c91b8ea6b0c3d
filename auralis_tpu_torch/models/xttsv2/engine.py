"""XTTSv2 engine on torch: conditioning -> continuous-batched decode -> vocoder.

Counterpart of `XTTSv2Engine` in auralis_tpu/models/xttsv2/engine.py, for the
non-streaming path:
- conditioning (speaker d-vector + perceiver latents) runs as torch ops on
  the engine's device, LRU-cached per reference;
- token generation runs in the slot-batched decode loop (runtime/), which
  emits vocoder latents inline; with `prefill_flash` / `flash_decode` set in
  the GPT config it goes through kernels K1 / K2 on CUDA, and with an int8
  KV cache (`kv_int8=True`) plus `ragged_decode` in the GPT config through
  K1 / K4. `decode_w8a8` / `prefill_w8a8` run the block matmuls W8A8 on an
  int8 copy of the weights (`blocks_q8`), made once at construction;
- each finished chunk's latent row is vocoded on the device (HiFi-GAN, the
  MRF stages through kernel K3 on CUDA) and shipped to the host as int16.

The JAX engine arms int8 KV, W8A8, the per-program W8A8 policy and slot
bucketing by default only on a TPU; on any other backend they are off
unless passed, and so they are here until an H100 measurement sets them.
`slot_bucketing=True` turns bucketing on; the policy the JAX engine would
arm is `w8a8_policy()`, which a caller hands to `DecodeEngine`. The slot
count is fitted to the card's free memory after the weights
(`_fit_slots_to_hbm`). Options the port lacks are dropped with a warning,
except `tensor_parallel_size > 1`, which raises (ROADMAP.md, queue 1 item
10). Not ported yet (ROADMAP.md, queue 1): streaming (`stream=True`
raises), the vocode batcher, the speculative first segment and checkpoint
loading (`from_pretrained` raises).
"""
from __future__ import annotations

import asyncio
import dataclasses
import hashlib
import math
import os
import time
from typing import Any, AsyncGenerator, List, Optional, Tuple, Union

import numpy as np
import torch

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
from .hifigan import RESBLOCK_KERNELS, hifi_decoder
from .modules import conditioning_encoder, perceiver_resampler, speaker_encoder
from .weights import params_from_numpy, random_init

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

_STREAMING_TODO = (
    "streaming synthesis is not ported yet (ROADMAP.md, queue 1: 'streaming "
    "segments + _SpecFirstSeg + _VocodeBatcher'); use stream=False"
)


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
        self.decode_engine = DecodeEngine(
            self.params, gpt_config, num_slots=self.decode_slots, cache_dtype=cache_dtype,
            steps_per_sync=steps_per_sync, seed=seed, slot_bucketing=bool(slot_bucketing),
            device=self.device)
        hifigan = self.core["hifigan"]
        self._packed_stages = pack_hifigan_mrf(
            hifigan["resblocks"], RESBLOCK_KERNELS, hifigan["conv_pre_w"].dtype, self.device)
        self.conditioning_cache_size = max(1, int(conditioning_cache_size))
        self.ref_length_quantum_s = float(ref_length_quantum_s)
        self._cond_cache: dict[str, tuple] = {}
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
    def from_pretrained(cls, pretrained_model_name_or_path: str, **kwargs) -> "XTTSv2Engine":
        raise NotImplementedError(
            "loading the XTTSv2 safetensors checkpoint is not ported yet (ROADMAP.md, "
            "queue 1: 'checkpoint loading'); build with XTTSv2Engine.random_init or "
            "pass params/core from weights.params_from_numpy"
        )

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
        Returns (handles, request ids, speaker embedding, conditioning)."""
        if request.stream:
            raise NotImplementedError(_STREAMING_TODO)
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
                handles.append(asyncio.ensure_future(
                    self.decode_engine.generate(prompt, options)))
                request_ids.append(f"{request.request_id}_{idx}")
        except BaseException:
            for handle in handles:
                self.cancel_generation_handle(handle)
            raise
        return handles, request_ids, speaker_embeddings, gpt_cond_latent

    def cancel_generation_handle(self, handle) -> None:
        """Abort one chunk's decode; the decode engine drops it from its queue
        or releases its slot on the runner's next pass."""
        if not handle.done():
            handle.cancel()

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

    def _decode(self, latents: torch.Tensor, speaker_embedding) -> torch.Tensor:
        """[1, T, D] f32 latents on the device -> waveform [N] on the device."""
        cfg = self.hifi_config
        g = torch.as_tensor(np.asarray(speaker_embedding, np.float32)).reshape(1, -1)
        wav = hifi_decoder(
            self.core["hifigan"], latents, g.to(self.device), self._packed_stages,
            ar_mel_length_compression=cfg.gpt_code_stride_len,
            output_hop_length=cfg.output_hop_length,
            input_sample_rate=cfg.input_sample_rate,
            output_sample_rate=cfg.output_sample_rate,
        )
        return wav[0].float()

    @torch.no_grad()
    def vocode_device_row(self, latents_row: torch.Tensor, n: int,
                          speaker_embedding) -> np.ndarray:
        """Vocode a slot's latent row [T_audio, D] (device) whose first n
        entries are valid; positions >= n are zeroed, the row padded to its
        bucket, and the waveform trimmed to the true length. The samples are
        rounded to 16-bit PCM on the device (4x fewer bytes to the host; the
        serving formats are 16-bit, and tanh bounds |wav| <= 1)."""
        t_max = self.gpt_config.max_audio_tokens
        bucket = self.row_bucket(n)
        cut = min(bucket, t_max)
        rows = latents_row[None, :cut].float()
        rows = torch.where(torch.arange(cut, device=rows.device)[None, :, None] < n, rows, 0.0)
        padded = torch.zeros((1, bucket, rows.shape[-1]), dtype=torch.float32, device=rows.device)
        padded[:, :cut] = rows
        pcm = torch.round(self._decode(padded, speaker_embedding) * 32767.0).to(torch.int16)
        return pcm.cpu().numpy().astype(np.float32)[: self._true_wav_len(n)] / 32767.0

    @torch.no_grad()
    def vocode(self, latents: np.ndarray, speaker_embedding: np.ndarray) -> np.ndarray:
        """latents [T, D] (host) + d-vector [1, 512] -> waveform [N] at 24 kHz,
        through one fixed bucket (max_audio_tokens rounded up)."""
        n = latents.shape[0]
        bucket = max(math.ceil(self.gpt_config.max_audio_tokens / LATENT_BUCKETS_STEP)
                     * LATENT_BUCKETS_STEP, n)
        padded = torch.zeros((1, bucket, latents.shape[1]), dtype=torch.float32)
        padded[0, :n] = torch.from_numpy(np.asarray(latents, np.float32))
        wav = self._decode(padded.to(self.device), speaker_embedding)
        return wav.cpu().numpy()[: self._true_wav_len(n)]

    async def process_tokens_to_speech(
        self,
        generator,  # an asyncio future from get_generation_context
        speaker_embeddings: Optional[np.ndarray] = None,
        multimodal_data: Optional[np.ndarray] = None,
        request: TTSRequest = None,
    ) -> AsyncGenerator[TTSOutput, None]:
        """Phase 2: wait for the chunk's decode, vocode its latent row."""
        assert speaker_embeddings is not None, "XTTSv2 needs speaker embeddings"
        try:
            with span("phase2.decode_wait"):
                tokens, row, n = await generator
            if n == 0:
                return
            with span("phase2.vocode"):
                wav = await asyncio.to_thread(self.vocode_device_row, row, n,
                                              speaker_embeddings)
            yield TTSOutput(
                array=wav, sample_rate=self.hifi_config.output_sample_rate,
                start_time=request.start_time if request else None,
                token_length=int(len(tokens)),
            )
        finally:
            # consumer gone or done: a still-running decode must stop burning
            # device time (cancel() on a resolved future is a no-op)
            if not generator.done():
                generator.cancel()

    async def shutdown(self) -> None:
        await self.decode_engine.shutdown()


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
