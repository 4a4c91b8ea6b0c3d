"""HiFi-GAN waveform decoder as plain torch functions.

Counterpart of auralis_tpu/models/xttsv2/hifigan.py: conv_pre(k7) -> 4 x
[ConvTranspose1d upsample + speaker-conditioning 1x1 + MRF of 3 ResBlock1
averaged] -> leaky_relu -> conv_post(k7) -> tanh, with the d-vector injected
at the input and at every upsample stage, and the two linear interpolations
(x4 latent stretch, 22.05 -> 24 kHz) up front.

Activations are feature-last [B, T, C] and parameters keep the JAX layouts
(conv weights [K, I, O]; transposed-conv weights stored flipped [K, I, O]).
Every MRF stage (the JAX `_resblock1` chains and their mean) runs through
`packed_stages` (ops.mrf.pack_hifigan_mrf): kernel K3 on CUDA tensors, its
plain version on CPU tensors; K3 sums each output in a fixed order.

The other convs (conv_pre, the four transposed upsamples, conv_post) run as
im2col GEMMs in calls of a fixed row count per layer, the last call
zero-padded. cuDNN and cuBLAS pick their algorithm by shape, so through
them a sample's value depended on the length of the window it was computed
in and on the number of lanes beside it: on an H100 a streamed segment
differed from the full row, and a row in a batch of 4 from the row alone,
by up to 3 PCM steps on a third of the samples. At one GEMM shape per
layer every output row sees the same reduction order, so the streaming
segments reproduce the full row and a batched row the row alone, bit for
bit; the device time matched cuDNN's (PERF.md §6).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ...ops.interpolate import interp_linear_scale
from ...ops.quant import pad_rows

LRELU_SLOPE = 0.1

UPSAMPLE_RATES = (8, 8, 2, 2)
UPSAMPLE_KERNELS = (16, 16, 4, 4)
UPSAMPLE_INITIAL = 512
RESBLOCK_KERNELS = (3, 7, 11)
RESBLOCK_DILATIONS = (1, 3, 5)
# the speaker-conditioning products run at no fewer than this many rows
# (zero rows padded), so a lane's result does not depend on how many lanes
# share the call: cuBLAS picks its algorithm by shape, and a vocoder batch
# holds at most 8 lanes
COND_ROWS = 8


# a GEMM call's row count per layer: the power of two that puts about this
# many elements in its left operand (32 MB in bf16), at most MAX_TILE_ROWS
GEMM_TILE_ELEMS = 1 << 24
MAX_TILE_ROWS = 1 << 16


def _gemm_tile_rows(k: int) -> int:
    """Rows of every GEMM call whose reduction length is k."""
    return min(MAX_TILE_ROWS, 1 << int(math.log2(max(1, GEMM_TILE_ELEMS // k))))


def _gemm_fixed_rows(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a [M, K] @ w [K, N] in calls of exactly _gemm_tile_rows(K) rows (the
    last zero-padded), so each row's result does not depend on M."""
    rows, m = _gemm_tile_rows(a.shape[1]), a.shape[0]
    out = a.new_empty((m, w.shape[1]))
    for r0 in range(0, m, rows):
        tile = a[r0:r0 + rows]
        n = tile.shape[0]
        if n < rows:
            tile = F.pad(tile, (0, 0, 0, rows - n))
        out[r0:r0 + n] = torch.mm(tile, w)[:n]
    return out


def _conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
            padding: int = 0) -> torch.Tensor:
    """'Same' conv of x [B, T, C] with w [K, I, O] (T + 2 padding = T + K - 1)
    as an im2col GEMM: row t holds x[t - padding .. t - padding + K) k-major."""
    bsz, t, c = x.shape
    k = w.shape[0]
    cols = F.pad(x, (0, 0, padding, padding)).unfold(1, k, 1).transpose(2, 3)
    y = _gemm_fixed_rows(cols.reshape(bsz * t, k * c), w.reshape(k * c, -1)).reshape(bsz, t, -1)
    return y if b is None else y + b


def upsample_gemm_weight(w: torch.Tensor, stride: int) -> torch.Tensor:
    """The JAX package's flipped [K, I, O] transposed-conv kernel (K = 2 x
    stride, padding stride / 2) as one [3 I, stride O] GEMM operand: output
    stride * t + r takes input t + d (d = -1, 0, 1) through torch's kernel
    tap r + padding - stride * d where that lies in [0, K), else zeros."""
    k, ci, co = w.shape
    pad = (k - stride) // 2
    d = torch.arange(-1, 2, device=w.device)[:, None]
    tap = torch.arange(stride, device=w.device)[None, :] + pad - stride * d  # [3, stride]
    valid = ((tap >= 0) & (tap < k)).to(w.dtype)[..., None, None]
    big = w.flip(0)[tap.clamp(0, k - 1)] * valid  # [3, stride, I, O]
    return big.permute(0, 2, 1, 3).reshape(3 * ci, stride * co)


def _conv_transpose1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int,
                      padding: int) -> torch.Tensor:
    """torch ConvTranspose1d(stride, padding) of x [B, T, I] -> [B, T *
    stride, O], for the generator's K = 2 x stride, padding = stride / 2,
    as one GEMM over the taps t - 1, t, t + 1 (upsample_gemm_weight)."""
    k = w.shape[0]
    if k != 2 * stride or padding != (k - stride) // 2:
        raise ValueError(f"transposed conv K={k} stride={stride} padding={padding}: the GEMM "
                         "form takes K = 2 x stride and padding = stride / 2")
    bsz, t, ci = x.shape
    cols = F.pad(x, (0, 0, 1, 1)).unfold(1, 3, 1).transpose(2, 3).reshape(bsz * t, 3 * ci)
    y = _gemm_fixed_rows(cols, upsample_gemm_weight(w, stride))
    return y.reshape(bsz, t * stride, -1) + b


@torch.no_grad()
def hifigan_generator(params: dict, x: torch.Tensor, g: torch.Tensor,
                      packed_stages: list) -> torch.Tensor:
    """x [B, T, C_in], g [B, d_vector] -> waveform [B, T * prod(rates)];
    packed_stages: one PackedMRFStage per upsample stage."""
    dtype = params["conv_pre_w"].dtype
    x = x.to(dtype)
    g = g.to(dtype)
    b = g.shape[0]
    g = pad_rows(g, COND_ROWS)
    h = _conv1d(x, params["conv_pre_w"], params["conv_pre_b"], padding=3)
    h = h + (g @ params["cond_w"])[:b, None, :] + params["cond_b"]
    for i, (rate, kernel) in enumerate(zip(UPSAMPLE_RATES, UPSAMPLE_KERNELS)):
        h = F.leaky_relu(h, LRELU_SLOPE)
        up = params["ups"][i]
        h = _conv_transpose1d(h, up["w"], up["b"], stride=rate, padding=(kernel - rate) // 2)
        cond = params["conds"][i]
        h = h + (g @ cond["w"])[:b, None, :] + cond["b"]
        h = packed_stages[i](h).to(dtype)
    h = F.leaky_relu(h, 0.01)  # final lrelu uses the torch default slope
    h = _conv1d(h, params["conv_post_w"], padding=3)  # no bias
    return torch.tanh(h)[..., 0]


def interp_latents(latents: torch.Tensor, *, ar_mel_length_compression: int = 1024,
                   output_hop_length: int = 256, input_sample_rate: int = 22050,
                   output_sample_rate: int = 24000) -> torch.Tensor:
    """Latents [B, T, D] -> post-interp frames [B, D, T_pf]: the latent
    stretch, then the resampling to the output rate. Frame j's source index
    depends on j alone, not on T, so a prefix of the latents gives a prefix
    of the frames."""
    z = interp_linear_scale(latents.transpose(1, 2),
                            ar_mel_length_compression / output_hop_length)
    if output_sample_rate != input_sample_rate:
        z = interp_linear_scale(z, output_sample_rate / input_sample_rate)
    return z


def hifi_decoder(params: dict, latents: torch.Tensor, g: torch.Tensor, packed_stages: list,
                 **interp) -> torch.Tensor:
    """Latents [B, T, D] -> 24 kHz waveform (`interp`: interp_latents's
    rates)."""
    return hifigan_generator(params, interp_latents(latents, **interp).transpose(1, 2), g,
                             packed_stages)
