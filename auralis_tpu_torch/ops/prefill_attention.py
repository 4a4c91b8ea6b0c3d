"""Causal, length-masked prefill attention (kernel K1).

Replaces the Pallas kernel `prefill_flash_attention`
(auralis_tpu/ops/prefill_attention.py:61, body `_attn_kernel`), which holds
one head's whole [T, D] Q/K/V in VMEM and runs one-shot softmax.

    ctx = softmax(mask(Q K^T / sqrt(D))) V,  mask = (k <= q) & (k < length)

f32 scores, finfo.min masking; rows >= length still attend to keys < length.

On the H100 (csrc/prefill_attention.cu) the one-shot form does not fit: a
[T, T] f32 score tile at T = 1047 is 4.4 MB, far beyond a block's 227 KB of
shared memory. The kernel is flash-attention-2 shaped instead: one block per
(head, 64-row query tile) walks 64-row key tiles up to min(causal end,
length) with an online softmax in f32 registers, so scores never leave the
SM. bf16 inputs (serving) run QK^T and PV on the tensor cores (mma.sync,
P split into bf16 hi + lo parts so it keeps ~16 bits); f32 inputs (the
reference engine) run plain f32 FMA. The kernel reads `length` from an
int32 in device memory, so a prefill captured in a CUDA graph
(runtime/graphs.py) takes each replay's length from its staged inputs.
"""
from __future__ import annotations

import math

import torch

from . import _build


def prefill_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            length: int | torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the masked softmax of `_attn_kernel` in f32.
    q/k/v [T, H, D] -> [T, H, D] f32; `length` an int or a 0-d integer
    tensor on q's device."""
    t, h, d = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    scores = torch.einsum("qhd,khd->hqk", qf, kf) * (1.0 / math.sqrt(d))
    pos = torch.arange(t, device=q.device)
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] < length)
    scores = scores.masked_fill(~mask[None], torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("hqk,khd->qhd", probs, vf)


def prefill_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            length: int | torch.Tensor) -> torch.Tensor:
    """q/k/v [T, H, D] (bf16 or f32) -> context [T, H, D] f32.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise. q, k and v may be strided views of one fused qkv row (as gpt.py
    passes them); they must share strides, with unit stride inside a head.
    `length` is an int, checked against [1, T] and written into a fresh
    int32 scalar on the card, or a 0-d integer tensor on q's device, which
    the kernel reads as it runs (no host read; the caller keeps it in
    [1, T])."""
    if not q.is_cuda:
        return prefill_attention_plain(q, k, v, length)
    _build.require_cuda(q, k, v)
    t, h, d = q.shape
    if d != 64:
        raise ValueError(f"prefill kernel supports head_dim 64, got {d}")
    if not (k.shape == v.shape == q.shape and q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k, v must share shape and dtype")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"unsupported dtype {q.dtype}")
    if torch.is_tensor(length):
        if length.dim() != 0 or length.is_floating_point() or length.device != q.device:
            raise ValueError(f"length must be a 0-d integer tensor on {q.device}")
        length = length.to(torch.int32)
    else:
        if not 1 <= length <= t:
            raise ValueError(f"length {length} outside [1, {t}]")
        length = torch.full((), int(length), dtype=torch.int32, device=q.device)
    if not (q.stride() == k.stride() == v.stride() and q.stride(2) == 1 and q.stride(1) == d):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    # the bf16 kernel copies rows into shared memory 16 bytes at a time
    if q.dtype == torch.bfloat16 and (
            q.stride(0) % 8 or any(x.data_ptr() % 16 for x in (q, k, v))):
        q, k, v = q.clone(), k.clone(), v.clone()
    out = torch.empty((t, h, d), dtype=torch.float32, device=q.device)
    lib = _build.library()
    _build.check(
        lib.prefill_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            t, h, q.stride(0), length.data_ptr(), 1.0 / math.sqrt(d),
            int(q.dtype == torch.bfloat16), _build.stream_ptr(q.device),
        ),
        "prefill_attention",
    )
    _build.count_launch(prefill_flash_attention)
    return out


prefill_flash_attention.launches = 0
