"""Operations and bytes of the XTTSv2 work from its shapes, and the chip's
peaks: the yardstick that the `mfu.*` and `*_roofline.*` metrics divide
by. The peaks and `bound` are those of the repository's kernel table
(chip_smoke.py's `bound`); the counts are the work the traffic needed,
whatever implements it:
- an operation is a multiply or an add (a multiply-add counts 2);
- a kernel's bytes count each input byte read once and each output byte
  written once.
"""
from __future__ import annotations

import math

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet,
# dense): device memory, and operations per second by operand type (f32 is
# the rate outside the tensor cores).
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "f32": 67e12, "int8": 1979e12}


def bound(nbytes: float, ops: float, kind: str) -> tuple[float, str]:
    """(least ms the card could take, what bounds it): the larger of the
    bytes over the memory rate and the operations over the peak rate for
    their type."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _dims(config: dict) -> tuple[int, int, int, int]:
    a = config["model_args"]
    return (a["gpt_n_model_channels"], config["architecture"]["gpt_n_inner"], a["gpt_layers"],
            a["gpt_num_audio_tokens"])


def gpt_prefill_ops(config: dict, prompt_len: int) -> float:
    """A prompt of `prompt_len` positions through every layer (the dense
    products of each position and causal attention over the pairs), and
    the mel head at its last position."""
    d, inner, layers, audio = _dims(config)
    dense = 2 * (4 * d * d + 2 * d * inner)
    pairs = prompt_len * (prompt_len + 1) / 2
    return layers * (prompt_len * dense + 4 * d * pairs) + 2 * d * audio


def gpt_decode_ops(config: dict, context: int) -> float:
    """One decoded token whose attention reads `context` positions (itself
    included), with the mel head."""
    d, inner, layers, audio = _dims(config)
    return layers * (2 * (4 * d * d + 2 * d * inner) + 4 * d * context) + 2 * d * audio


def chunk_gpt_ops(config: dict, prompt_len: int, n: int) -> float:
    """A chunk's GPT work: its prompt, then n - 1 decoded tokens (the first
    token comes from the prompt's last position), token j attending over
    prompt_len + j positions."""
    return gpt_prefill_ops(config, prompt_len) + sum(
        gpt_decode_ops(config, prompt_len + j) for j in range(1, n))


def mrf_ops(config: dict, frames: int) -> float:
    """Kernel K3's work for `frames` post-interpolation frames: per stage
    i (C_i channels over T_i samples) 2 x C_i^2 x T_i x the taps of its
    18 convs (2 per dilation of each resblock kernel)."""
    hg = config["architecture"]["hifigan"]
    taps = 2 * len(hg["resblock_dilation_sizes"]) * sum(hg["resblock_kernel_sizes"])
    ops, t = 0.0, frames
    for i, rate in enumerate(hg["upsample_rates"]):
        t *= rate
        c = hg["upsample_initial_channel"] // 2 ** (i + 1)
        ops += 2 * c * c * t * taps
    return ops


def mrf_bytes(config: dict, frames: int) -> float:
    """K3's bytes for `frames` frames: each stage's bf16 input read and its
    mean written once, and its convs' weights and biases once."""
    hg = config["architecture"]["hifigan"]
    nbytes, t = 0.0, frames
    for i, rate in enumerate(hg["upsample_rates"]):
        t *= rate
        c = hg["upsample_initial_channel"] // 2 ** (i + 1)
        weights = 2 * len(hg["resblock_dilation_sizes"]) * sum(
            k * c * c + c for k in hg["resblock_kernel_sizes"])
        nbytes += 2 * (2 * t * c + weights)
    return nbytes


def vocoder_ops(config: dict, frames: int) -> float:
    """The whole HiFi-GAN over `frames` frames: conv_pre (k7), each
    transposed upsample (each input sample into K taps), the MRF stages
    and conv_post (k7, one channel); the d-vector products are per lane
    and left out."""
    a, hg = config["model_args"], config["architecture"]["hifigan"]
    c = hg["upsample_initial_channel"]
    ops = 2 * 7 * a["decoder_input_dim"] * c * frames
    t = frames
    for i, (rate, k) in enumerate(zip(hg["upsample_rates"], hg["upsample_kernel_sizes"])):
        out = hg["upsample_initial_channel"] // 2 ** (i + 1)
        ops += 2 * k * c * out * t
        t *= rate
        c = out
    return ops + mrf_ops(config, frames) + 2 * 7 * c * t


def frames_of(config: dict, n: int) -> int:
    """Post-interpolation frames of n latents (each 256 output samples)."""
    a = config["model_args"]
    z = math.floor(n * a["gpt_code_stride_len"] / a["output_hop_length"])
    if a["output_sample_rate"] != a["input_sample_rate"]:
        z = math.floor(z * a["output_sample_rate"] / a["input_sample_rate"])
    return z


def decode_attention_bytes(config: dict, rows: int, slots: int) -> float:
    """Kernel K2's bytes for one decode step over all layers: the K and V
    rows that the stepped slots attend over (`rows` in all, each slot's new
    row included), read once in bf16, and per slot its q, new k and v
    read and its context written."""
    d, _, layers, _ = _dims(config)
    row_b = d * 2
    return layers * (2 * rows * row_b + 4 * slots * row_b)


def decode_attention_ops(config: dict, rows: int) -> float:
    """K2's operations for one decode step over all layers: q.k and p.v
    over each of the `rows` rows."""
    d, _, layers, _ = _dims(config)
    return layers * 4 * rows * d
