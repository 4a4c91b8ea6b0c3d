"""Fused W8A8 MLP (kernel K5): fc -> exact gelu -> fc_proj on int8 weights.

Replaces the Pallas kernel `fused_mlp_w8`
(auralis_tpu/ops/experimental/fused_mlp.py:70, body `_kernel` :36), with its
recipe: per-row int8 quantisation of x; the int8 fc product; x-scale x
fc-scale + fc-bias; exact gelu in f32; requantisation of the gelu output per
(row, `tile_i`-wide inner tile); the int8 proj product per tile; an f32 sum
over the tiles in tile order; x proj-scale + proj-bias. `tile_i` is part of
the numerics (1024, the JAX default). The one change from the Pallas body:
gelu uses erf, where Pallas used the Abramowitz-Stegun polynomial (a Mosaic
workaround, its own comment says).

It reuses the W8A8 decode weights (`blocks_q8`, models/xttsv2/gpt.py
`quantize_decode_weights`). As in the JAX package, no serving path calls it;
chip_smoke.py drives it on the card. On the H100 (csrc/fused_mlp_w8.cu) it is
three launches: fc + gelu, per-tile proj partials, and their fixed-order sum.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import _build
from ..quant import int8_mm, quantize_rows


def fused_mlp_w8_plain(x: torch.Tensor, fc_wq: torch.Tensor, fc_ws: torch.Tensor,
                       fc_b: torch.Tensor, proj_wq: torch.Tensor, proj_ws: torch.Tensor,
                       proj_b: torch.Tensor, *, tile_i: int = 1024) -> torch.Tensor:
    """Plain PyTorch version of K5's recipe. Returns [S, D] in x's dtype."""
    s, d = x.shape
    xq, xs = quantize_rows(x)
    yf = int8_mm(xq, fc_wq).float() * xs[:, None] * fc_ws.float()[None] + fc_b.float()[None]
    g = F.gelu(yf)  # exact (erf) gelu in f32
    out = torch.zeros((s, d), dtype=torch.float32, device=x.device)
    for t0 in range(0, fc_wq.shape[1], tile_i):
        gq, gs = quantize_rows(g[:, t0:t0 + tile_i], eps=1e-20)
        out = out + int8_mm(gq, proj_wq[t0:t0 + tile_i]).float() * gs[:, None]
    return (out * proj_ws.float()[None] + proj_b.float()[None]).to(x.dtype)


def mlp_w8_reference(x, fc_wq, fc_ws, fc_b, proj_wq, proj_ws, proj_b) -> torch.Tensor:
    """The serving composition (gpt.py `_dot_w8a8` x2 around gelu): the gelu
    output is rounded to x's dtype and requantised per full row."""
    from ...models.xttsv2.gpt import _dot_w8a8, _gelu

    y = _dot_w8a8(x, fc_wq, fc_ws, fc_b)
    return _dot_w8a8(_gelu(y), proj_wq, proj_ws, proj_b)


def fused_mlp_w8(x: torch.Tensor, fc_wq: torch.Tensor, fc_ws: torch.Tensor,
                 fc_b: torch.Tensor, proj_wq: torch.Tensor, proj_ws: torch.Tensor,
                 proj_b: torch.Tensor, *, tile_i: int = 1024) -> torch.Tensor:
    """x [S, D] (post-ln2 activations); fc_wq [D, I] and proj_wq
    [I, D] int8; fc_ws/fc_b [I] and proj_ws/proj_b [D]. Returns [S, D] in
    x's dtype (the caller adds the residual).

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise. The kernel takes bf16 x (the int8 decode path's activation
    dtype), row-major (contiguous) weights, D a multiple of
    128 up to 1024, I a multiple of 128 and of tile_i, and tile_i a multiple
    of 32 up to 1024. `quantize_decode_weights` lays its weights out
    column-major for the library GEMM: give K5 `.contiguous()` copies, made
    once."""
    if not x.is_cuda:
        return fused_mlp_w8_plain(x, fc_wq, fc_ws, fc_b, proj_wq, proj_ws, proj_b, tile_i=tile_i)
    _build.require_cuda(x, fc_wq, fc_ws, fc_b, proj_wq, proj_ws, proj_b)
    s, d = x.shape
    i = fc_wq.shape[1]
    if fc_wq.shape != (d, i) or proj_wq.shape != (i, d):
        raise ValueError(f"weights must be [D, I] and [I, D]; got {tuple(fc_wq.shape)}, "
                         f"{tuple(proj_wq.shape)} for x {tuple(x.shape)}")
    if fc_wq.dtype != torch.int8 or proj_wq.dtype != torch.int8:
        raise ValueError("K5 needs int8 weights")
    if not (fc_wq.is_contiguous() and proj_wq.is_contiguous()):
        raise ValueError("K5 needs row-major (contiguous) weights")
    if fc_ws.shape != (i,) or fc_b.shape != (i,) or proj_ws.shape != (d,) or proj_b.shape != (d,):
        raise ValueError("scales and biases must be [I] (fc) and [D] (proj)")
    if not (d % 128 == 0 and d <= 1024 and i % 128 == 0 and i % tile_i == 0
            and tile_i % 32 == 0 and tile_i <= 1024):
        raise ValueError(f"K5 does not take D={d}, I={i}, tile_i={tile_i}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"K5 takes bf16 activations, got {x.dtype}")
    x = x.contiguous()
    fc_ws, fc_b, proj_ws, proj_b = (t.float().contiguous() for t in (fc_ws, fc_b, proj_ws, proj_b))
    g = torch.empty((s, i), dtype=torch.float32, device=x.device)
    part = torch.empty((i // tile_i, s, d), dtype=torch.float32, device=x.device)
    out = torch.empty((s, d), dtype=x.dtype, device=x.device)
    lib = _build.library()
    _build.check(
        lib.fused_mlp_w8(
            x.data_ptr(), fc_wq.data_ptr(), fc_ws.data_ptr(), fc_b.data_ptr(),
            proj_wq.data_ptr(), proj_ws.data_ptr(), proj_b.data_ptr(), g.data_ptr(),
            part.data_ptr(), out.data_ptr(), s, d, i, tile_i, _build.stream_ptr(x.device),
        ),
        "fused_mlp_w8",
    )
    fused_mlp_w8.launches += 1
    return out


fused_mlp_w8.launches = 0
