"""XTTSv2 configuration types.

Field names/defaults track the reference configs
(models/xttsv2/config/xttsv2_gpt_config.py:133-228 and
xttsv2_config.py:237-301) so reference `config.json` files load unchanged.
Plain dataclasses — no transformers dependency in the hot path.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class GPTAudioConfig:
    mel_channels: int = 80
    sample_rate: int = 22050
    output_sample_rate: int = 24000


@dataclass
class XTTSAudioConfig:
    sample_rate: int = 22050
    output_sample_rate: int = 24000
    mel_channels: int = 80
    hop_length: int = 256
    win_length: int = 1024
    n_fft: int = 1024
    fmin: int = 0
    fmax: int = 8000
    power: float = 1.0
    mel_norms_file: Optional[str] = None


def _filter_kwargs(cls, d: dict) -> dict:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


@dataclass(eq=False)  # identity hash/eq so the config can be a jit static arg
class XTTSGPTConfig:
    """Architecture of the audio-token GPT."""

    hidden_size: int = 1024
    n_inner: int = 4096
    num_hidden_layers: int = 30
    num_attention_heads: int = 16

    vocab_size: int = 6681
    number_text_tokens: int = 6681
    start_text_token: Optional[int] = None
    stop_text_token: Optional[int] = None

    num_audio_tokens: int = 1026
    start_audio_token: int = 1024
    stop_audio_token: int = 1025

    max_audio_tokens: int = 605
    max_text_tokens: int = 402
    max_prompt_tokens: int = 70
    gpt_max_audio_tokens: int = 605

    use_masking_gt_prompt_approach: bool = True
    use_perceiver_resampler: bool = True
    kv_cache: bool = True
    enable_redaction: bool = False
    gpt_batch_size: int = 1

    layer_norm_epsilon: float = 1e-5
    initializer_range: float = 0.02
    activation_function: str = "gelu"
    attn_pdrop: float = 0.1
    decoder_input_dim: int = 1024

    num_cond_latents: int = 32  # perceiver output length in the sequence

    # Use the Pallas flash-decode attention kernel (TPU); False falls back to
    # the dense masked-XLA path (CPU tests, interpret-mode verification).
    flash_decode: bool = False

    # Fused Pallas prefill attention (ops/prefill_attention.py): per-head
    # VMEM-resident scores/softmax, no [H, T, T] HBM round-trip. Composes
    # with kv_int8 (the cache write path is untouched).
    prefill_flash: bool = False

    # Unroll the 30-layer loop in gpt_decode_step into straight-line code
    # instead of lax.fori_loop: XLA can then schedule each layer's weight
    # loads ahead of the previous layer's compute (a fori body is compiled
    # once and cannot overlap across iterations). Costs compile time
    # (~30x bigger step graph); measured A/B decides the default.
    unroll_layers: bool = False

    # int8 decode weights (W8A8): the four block matmul weights stored int8
    # with per-(layer, output-channel) scales; activations quantized per slot
    # row at each matmul. Halves the decode step's ~720 MB/step weight stream
    # (the matmul side of the step is weight-bandwidth-bound at M=slots MXU
    # rows). Decode-path only — prefill keeps bf16 weights (it amortizes the
    # weight read over the whole prompt and its K/V writes seed the cache).
    # Requires `params["blocks_q8"] = quantize_decode_weights(params["blocks"])`.
    decode_w8a8: bool = False

    # int8 prefill weights (W8A8 on the prompt pass): route the four prefill
    # matmuls through the same blocks_q8 tensors decode uses — zero extra HBM
    # when decode_w8a8/auto already materialized them. Prefill at the TTFA
    # bucket (128 rows) is weight-stream-bound (r4 bisect: the matmul chain
    # is the dominant rung), so halving the 0.86 GiB bf16 weight read buys
    # latency exactly where TTFA lives. Quantization noise enters the KV
    # cache (prefill K/V come from the w8a8 qkv dot) — fidelity pinned by
    # tests/unit/test_prefill_w8a8.py. The config default stays False (pure
    # functional callers opt in); the ENGINE arms it on single-chip TPU —
    # measured production-insert A/B (BENCH_NOTES r4 verdict 6): single
    # bucket-128 insert -13%, burst-8 -11% ms/chunk, layer stack -18%.
    prefill_w8a8: bool = False

    # int8 KV cache with per-(layer, slot, token) scales: halves decode's
    # KV-read bandwidth (the decode bottleneck — ~1.5x faster steps at the
    # 1024 length bound, measured tools/bench_decode_variants.py). Scores run
    # as int8 MXU matmuls (q quantized per slot x head); V scales fold into
    # the softmax probabilities. Mutually exclusive with flash_decode.
    kv_int8: bool = False

    # Small-shape int8-KV attention variant: keep the softmax probabilities
    # in bf16 for the context matmul (V converts to bf16) instead of the
    # fold-quantize-int8-matmul chain. At tiny row counts the requantize
    # chain's VPU work costs more than the bf16 copy of the V read; at
    # saturated shapes the convert's extra traffic loses. Measured r5
    # (tools/bisect_decode.py repattnnq, 30-layer chain device ms):
    # s8/b256 0.475 -> 0.429 (-10%), s16/b256 0.762 -> 0.715 (-6%). Only
    # meaningful with kv_int8; quality strictly improves (one quantization
    # step removed). Armed per decode program by the engine policy in the
    # measured small region; config default False.
    decode_attn_fp: bool = False

    # Ragged int8 Pallas flash-decode (ops/experimental/attention.py
    # ragged_decode_attention) composed with the int8 KV cache: per step each
    # slot reads only its LIVE KV rows (sum(seq_lens) traffic) instead of the
    # shared length-bucket bound, with in-kernel int8 dequant via the
    # per-token scale rows and in-kernel append. Requires kv_int8; implies
    # straight-line layers (the aliased cache pass-through can't ride a
    # fori carry). Default OFF: the r3 on-chip matrix (slots {8,32,64} x
    # bounds {256,1024}, full occupancy) has dense int8+unroll winning every
    # cell — e.g. 3.28 vs 3.98 ms/step at 32/256 and 8.64 vs 11.68 at
    # 64/1024. The dense step's batched int8 MXU matmuls beat the kernel's
    # per-slot-group grid even though it reads bound-many rows: at these
    # head counts (16) the VPU-side dequant+FLOPs per row dominate, not the
    # HBM read the ragged exit saves. Kept as the capability-parity path
    # (vLLM PagedAttention reads only live KV) for future chips/shapes; see
    # docs/advanced/performance.md.
    ragged_decode: bool = False

    # Repetition-penalty prompt scope (reference parity): the reference's
    # logits processor penalizes `prompt_token_ids + token_ids`
    # (hijack.py:67-76), and the vLLM prompt is `[1]*len(embeds) +
    # [start_audio_token]` (vllm_mm_gpt.py:300-334) — so ids {1, 1024} are
    # penalized from step 0 for EVERY sequence. Mel code 1 is a sampleable
    # token, so this changes sampled trajectories. True = seed each
    # sequence's seen-mask with {1, start_audio_token} (reference behavior);
    # False = penalize only actually-generated tokens. The divergence is
    # quantified in tests/unit/test_sampler_scope.py.
    reppen_penalize_prompt_ids: bool = True

    audio_config: GPTAudioConfig = field(default_factory=GPTAudioConfig)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def max_seq_len(self) -> int:
        """Decode-sequence ceiling: text + audio + cond latents + sentinels
        (reference sizing: XTTSv2.py:217-219)."""
        return self.max_text_tokens + self.max_audio_tokens + self.num_cond_latents + 5 + 3

    @property
    def audio_position_table(self) -> int:
        """Audio wpe rows (reference: vllm_mm_gpt.py:753 max_audio_tokens+3)."""
        return self.max_audio_tokens + 3

    @property
    def text_position_table(self) -> int:
        """Text wpe rows (reference: XTTSv2.py:107 max_text_tokens+2)."""
        return self.max_text_tokens + 2

    @classmethod
    def from_dict(cls, d: Dict) -> "XTTSGPTConfig":
        d = dict(d)
        audio = d.pop("audio_config", None)
        cfg = cls(**_filter_kwargs(cls, d))
        if audio:
            cfg.audio_config = GPTAudioConfig(**_filter_kwargs(GPTAudioConfig, audio))
        return cfg

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["model_type"] = "xtts_gpt"
        return d


@dataclass
class XTTSConfig:
    """Everything outside the GPT: vocoder, conditioning, languages."""

    input_sample_rate: int = 22050
    output_sample_rate: int = 24000
    output_hop_length: int = 256
    decoder_input_dim: int = 1024
    d_vector_dim: int = 512
    cond_d_vector_in_each_upsampling_layer: bool = True
    gpt_code_stride_len: int = 1024
    duration_const: int = 102400
    tokenizer_file: str = ""
    num_chars: int = 255
    languages: List[str] = field(
        default_factory=lambda: [
            "en", "es", "fr", "de", "it", "pt", "pl", "tr", "ru",
            "nl", "cs", "ar", "zh-cn", "hu", "ko", "ja", "hi",
        ]
    )
    audio_config: XTTSAudioConfig = field(default_factory=XTTSAudioConfig)
    gpt: XTTSGPTConfig = field(default_factory=XTTSGPTConfig)

    @classmethod
    def from_dict(cls, d: Dict) -> "XTTSConfig":
        d = dict(d)
        gpt_cfg = d.pop("gpt_config", None) or d.pop("gpt", None)
        audio = d.pop("audio_config", None)
        cfg = cls(**_filter_kwargs(cls, d))
        if audio:
            cfg.audio_config = XTTSAudioConfig(**_filter_kwargs(XTTSAudioConfig, audio))
        if gpt_cfg:
            cfg.gpt = XTTSGPTConfig.from_dict(gpt_cfg)
        return cfg

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["gpt_config"] = d.pop("gpt")
        d["model_type"] = "xtts"
        return d


def tiny_test_config() -> XTTSConfig:
    """A miniature architecture for hermetic tests (fast CPU compile)."""
    cfg = XTTSConfig()
    cfg.gpt = XTTSGPTConfig(
        hidden_size=64,
        n_inner=128,
        num_hidden_layers=2,
        num_attention_heads=4,
        vocab_size=400,
        number_text_tokens=400,
        num_audio_tokens=66,
        start_audio_token=64,
        stop_audio_token=65,
        max_audio_tokens=32,
        max_text_tokens=48,
        decoder_input_dim=64,
        num_cond_latents=8,
    )
    cfg.decoder_input_dim = 64
    # the speaker encoder always projects to 512 (reference proj_dim)
    cfg.d_vector_dim = 512
    return cfg
