"""Conditioning neural modules as plain torch functions on parameter dicts.

Counterpart of auralis_tpu/models/xttsv2/modules.py, with the same math and
the same parameter layouts (feature-last activations, [I, O] dense weights,
[kh, kw, I, O] conv weights, BatchNorm folded to scale/shift):
- conditioning_encoder: 1x1 conv 80->D + tortoise-style QKV attention blocks
- perceiver_resampler: learned latents cross-attending (queries included in
  context), GEGLU FF, RMSNorm
- speaker_encoder: SE-ResNet(3,4,6,3) + attentive stat pooling -> 512-d
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ...ops.mel import speaker_encoder_mel


# ----------------------------------------------------------- building blocks
def group_norm_32(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  groups: int, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over (group-channels, time), computed in f32. x: [B, T, C]."""
    b, t, c = x.shape
    xf = x.float().reshape(b, t, groups, c // groups)
    mu = xf.mean(dim=(1, 3), keepdim=True)
    var = xf.var(dim=(1, 3), keepdim=True, unbiased=False)
    y = ((xf - mu) * torch.rsqrt(var + eps)).reshape(b, t, c)
    return (y * scale + bias).to(x.dtype)


def norm_groups(channels: int) -> int:
    """Group count heuristic shared with the reference."""
    groups = 32
    if channels <= 16:
        groups = 8
    elif channels <= 64:
        groups = 16
    while channels % groups != 0:
        groups //= 2
    assert groups > 2
    return groups


def qkv_attention(qkv: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Tortoise QKV attention over time, double-sqrt scaling.
    qkv: [B, T, 3C] with head-major channels [H, (q|k|v), ch] -> [B, T, C]."""
    b, t, w = qkv.shape
    c = w // 3
    ch = c // n_heads
    qkv = qkv.reshape(b, t, n_heads, 3, ch)
    q, k, v = qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2]  # [B, T, H, ch]
    scale = 1.0 / math.sqrt(math.sqrt(ch))
    logits = torch.einsum("bthc,bshc->bhts", (q * scale).float(), (k * scale).float())
    probs = torch.softmax(logits, dim=-1).to(qkv.dtype)
    out = torch.einsum("bhts,bshc->bthc", probs.float(), v.float())
    return out.reshape(b, t, c).to(qkv.dtype)


def attention_block(params: dict, x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """norm -> 1x1 qkv -> attention -> 1x1 proj -> residual from the normed input."""
    c = x.shape[-1]
    h = group_norm_32(x, params["norm_scale"], params["norm_bias"], norm_groups(c))
    qkv = h @ params["qkv_w"] + params["qkv_b"]
    a = qkv_attention(qkv, n_heads)
    a = a @ params["proj_w"] + params["proj_b"]
    return h + a


def conditioning_encoder(params: dict, mel: torch.Tensor, n_heads: int) -> torch.Tensor:
    """mel [B, T, n_mels] -> [B, T, D]."""
    h = mel @ params["init_w"] + params["init_b"]
    for blk in params["blocks"]:
        h = attention_block(blk, h, n_heads)
    return h


# -------------------------------------------------------- perceiver resampler
def rms_norm(x: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """F.normalize(x, dim=-1) * sqrt(D) * gamma."""
    d = x.shape[-1]
    xf = x.float()
    normed = xf * torch.rsqrt(torch.clamp((xf * xf).sum(-1, keepdim=True), min=1e-24))
    return (normed * math.sqrt(d) * gamma).to(x.dtype)


def _perceiver_attention(p: dict, latents: torch.Tensor, ctx: torch.Tensor,
                         heads: int) -> torch.Tensor:
    """Cross-attention where the queries are prepended to the context."""
    full_ctx = torch.cat([latents, ctx], dim=1)
    q = latents @ p["to_q"]
    kv = full_ctx @ p["to_kv"]
    k, v = kv.chunk(2, dim=-1)
    b, n, e = q.shape
    dh = e // heads
    q = q.reshape(b, n, heads, dh)
    k = k.reshape(b, -1, heads, dh)
    v = v.reshape(b, -1, heads, dh)
    logits = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) / math.sqrt(dh)
    probs = torch.softmax(logits, dim=-1).to(latents.dtype)
    out = torch.einsum("bhnm,bmhd->bnhd", probs.float(), v.float())
    out = out.reshape(b, n, e).to(latents.dtype)
    return out @ p["to_out"]


def _geglu_ff(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = x @ p["w1"] + p["b1"]
    a, gate = h.chunk(2, dim=-1)
    h = F.gelu(gate.float()).to(x.dtype) * a
    return h @ p["w2"] + p["b2"]


def perceiver_resampler(params: dict, x: torch.Tensor, heads: int = 8) -> torch.Tensor:
    """x [B, T, D] -> [B, num_latents, D]."""
    b = x.shape[0]
    latents = params["latents"].expand(b, *params["latents"].shape).to(x.dtype)
    for layer in params["layers"]:
        latents = _perceiver_attention(layer["attn"], latents, x, heads) + latents
        latents = _geglu_ff(layer["ff"], latents) + latents
    return rms_norm(latents, params["norm_gamma"])


# ------------------------------------------------------------ speaker encoder
def _conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
            stride: tuple[int, int] = (1, 1), padding: int = 1) -> torch.Tensor:
    """x [B,H,W,C], w [kh,kw,I,O] (JAX layout; permuted to OIHW here)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), b,
                 stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def _se_layer(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Squeeze-excitation over [B,H,W,C]."""
    s = x.mean(dim=(1, 2))
    s = torch.relu(s @ p["fc1_w"] + p["fc1_b"])
    s = torch.sigmoid(s @ p["fc2_w"] + p["fc2_b"])
    return x * s[:, None, None, :]


def _se_block(p: dict, x: torch.Tensor, stride: tuple[int, int]) -> torch.Tensor:
    """SEBasicBlock with the reference's conv->relu->bn ordering."""
    res = x
    h = _conv2d(x, p["conv1_w"], stride=stride)
    h = torch.relu(h)
    h = h * p["bn1_scale"] + p["bn1_shift"]
    h = _conv2d(h, p["conv2_w"])
    h = h * p["bn2_scale"] + p["bn2_shift"]
    h = _se_layer(p["se"], h)
    if "down_w" in p:
        res = _conv2d(x, p["down_w"], stride=stride, padding=0)
        res = res * p["down_bn_scale"] + p["down_bn_shift"]
    return torch.relu(h + res)


def speaker_encoder(params: dict, wav_16k: torch.Tensor, l2_norm: bool = True) -> torch.Tensor:
    """wav [B, T] at 16 kHz -> d-vector [B, 512]."""
    mel = speaker_encoder_mel(wav_16k)  # [B, 64, frames]
    return speaker_encoder_from_features(params, mel, l2_norm=l2_norm)


def speaker_encoder_from_features(params: dict, feats: torch.Tensor,
                                  l2_norm: bool = True) -> torch.Tensor:
    """feats [B, 64, frames] (pre-instance-norm) -> d-vector [B, 512]."""
    mu = feats.mean(dim=-1, keepdim=True)
    var = feats.var(dim=-1, keepdim=True, unbiased=False)
    x = (feats - mu) * torch.rsqrt(var + 1e-5)
    x = x[..., None].to(params["conv1_w"].dtype)  # NHWC [B, 64, frames, 1]

    h = _conv2d(x, params["conv1_w"], params["conv1_b"])
    h = torch.relu(h)
    h = h * params["bn1_scale"] + params["bn1_shift"]
    for i, layer in enumerate(("layer1", "layer2", "layer3", "layer4")):
        for j, blk in enumerate(params[layer]):
            stride = (2, 2) if (i > 0 and j == 0) else (1, 1)
            h = _se_block(blk, h, stride)
    # [B, 8, T', 256] -> [B, T', C*H] with channel-major flattening
    b, hh, tt, cc = h.shape
    feats = h.permute(0, 2, 3, 1).reshape(b, tt, cc * hh)

    w = feats @ params["att1_w"] + params["att1_b"]
    w = torch.relu(w)
    w = w * params["att_bn_scale"] + params["att_bn_shift"]
    w = w @ params["att2_w"] + params["att2_b"]
    w = torch.softmax(w, dim=1)  # over time

    mu = (feats * w).sum(dim=1)
    sg = torch.sqrt(torch.clamp((feats**2 * w).sum(dim=1) - mu**2, min=1e-5))
    stats = torch.cat([mu, sg], dim=-1)
    out = stats @ params["fc_w"] + params["fc_b"]
    if l2_norm:
        out = out * torch.rsqrt(torch.clamp((out * out).sum(-1, keepdim=True), min=1e-24))
    return out
