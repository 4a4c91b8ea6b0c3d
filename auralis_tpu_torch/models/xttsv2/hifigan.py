"""HiFi-GAN waveform decoder as plain torch functions.

Counterpart of auralis_tpu/models/xttsv2/hifigan.py: conv_pre(k7) -> 4 x
[ConvTranspose1d upsample + speaker-conditioning 1x1 + MRF of 3 ResBlock1
averaged] -> leaky_relu -> conv_post(k7) -> tanh, with the d-vector injected
at the input and at every upsample stage, and the two linear interpolations
(x4 latent stretch, 22.05 -> 24 kHz) up front.

Activations are feature-last [B, T, C] and parameters keep the JAX layouts
(conv weights [K, I, O]; transposed-conv weights stored flipped [K, I, O]);
each call permutes them to torch's layouts. Every MRF stage (the JAX
`_resblock1` chains and their mean) runs through `packed_stages`
(ops.mrf.pack_hifigan_mrf): kernel K3 on CUDA tensors, its plain version
on CPU tensors.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...ops.interpolate import interp_linear_scale

LRELU_SLOPE = 0.1

UPSAMPLE_RATES = (8, 8, 2, 2)
UPSAMPLE_KERNELS = (16, 16, 4, 4)
UPSAMPLE_INITIAL = 512
RESBLOCK_KERNELS = (3, 7, 11)
RESBLOCK_DILATIONS = (1, 3, 5)


def _conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
            padding: int = 0, dilation: int = 1) -> torch.Tensor:
    """x [B, T, C], w [K, I, O]."""
    y = F.conv1d(x.transpose(1, 2), w.permute(2, 1, 0), b, padding=padding, dilation=dilation)
    return y.transpose(1, 2)


def _conv_transpose1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int,
                      padding: int) -> torch.Tensor:
    """torch ConvTranspose1d(stride, padding); w is the JAX package's flipped
    [K, I, O] kernel, so torch's [I, O, K] weight is its transpose, unflipped."""
    y = F.conv_transpose1d(x.transpose(1, 2), w.permute(1, 2, 0).flip(-1), b,
                           stride=stride, padding=padding)
    return y.transpose(1, 2)


@torch.no_grad()
def hifigan_generator(params: dict, x: torch.Tensor, g: torch.Tensor,
                      packed_stages: list) -> torch.Tensor:
    """x [B, T, C_in], g [B, d_vector] -> waveform [B, T * prod(rates)];
    packed_stages: one PackedMRFStage per upsample stage."""
    dtype = params["conv_pre_w"].dtype
    x = x.to(dtype)
    g = g.to(dtype)
    h = _conv1d(x, params["conv_pre_w"], params["conv_pre_b"], padding=3)
    h = h + (g @ params["cond_w"])[:, None, :] + params["cond_b"]
    for i, (rate, kernel) in enumerate(zip(UPSAMPLE_RATES, UPSAMPLE_KERNELS)):
        h = F.leaky_relu(h, LRELU_SLOPE)
        up = params["ups"][i]
        h = _conv_transpose1d(h, up["w"], up["b"], stride=rate, padding=(kernel - rate) // 2)
        cond = params["conds"][i]
        h = h + (g @ cond["w"])[:, None, :] + cond["b"]
        h = packed_stages[i](h).to(dtype)
    h = F.leaky_relu(h, 0.01)  # final lrelu uses the torch default slope
    h = _conv1d(h, params["conv_post_w"], padding=3)  # no bias
    return torch.tanh(h)[..., 0]


def hifi_decoder(params: dict, latents: torch.Tensor, g: torch.Tensor, packed_stages: list,
                 *, ar_mel_length_compression: int = 1024, output_hop_length: int = 256,
                 input_sample_rate: int = 22050, output_sample_rate: int = 24000
                 ) -> torch.Tensor:
    """Latents [B, T, D] -> 24 kHz waveform."""
    z = latents.transpose(1, 2)  # [B, D, T]
    z = interp_linear_scale(z, ar_mel_length_compression / output_hop_length)
    if output_sample_rate != input_sample_rate:
        z = interp_linear_scale(z, output_sample_rate / input_sample_rate)
    return hifigan_generator(params, z.transpose(1, 2), g, packed_stages)
