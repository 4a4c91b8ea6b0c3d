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
`quantize_decode_weights`) in their own layout, WEIGHT_LAYOUT. As in the JAX
package, no serving path calls it; chip_smoke.py drives it on the card. On
the H100 (csrc/fused_mlp_w8.cu) it is two launches, the second overlapping
the first: fc + gelu over blocks of COLS inner columns, then proj over
blocks of COLS output columns x one inner tile, whose last block per column
block sums the tiles in order (`mlp_plan` gives the grids and the
workspace).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .. import _build
from ..quant import int8_mm, quantize_rows

# K5 reads each [Din, Dout] int8 weight with Din contiguous (strides (1,
# Din)): the layout quantize_decode_weights stores for the library GEMM
WEIGHT_LAYOUT = "column-major"
ROWS = 8  # activation rows per block (csrc/fused_mlp_w8.cu)
COLS = 32  # weight columns per block
MAX_K = 1024  # longest contraction one block takes: D (fc) and tile_i (proj)


class MLPPlan(NamedTuple):
    """K5's launch shape and workspace for one (S, D, I, tile_i)."""

    fc_grid: tuple[int, int]  # (I / COLS column blocks, row blocks)
    proj_grid: tuple[int, int, int]  # (D / COLS column blocks, I / tile_i tiles, row blocks)
    gmax_shape: tuple[int, int]  # per-row max |gelu| of each fc block: [S, I / COLS]
    part_shape: tuple[int, int, int, int]  # per-tile partials: [row blocks, tiles, ROWS, D]
    tickets_shape: tuple[int, int]  # one per (row block, proj column block)


def mlp_plan(s: int, d: int, i: int, tile_i: int) -> MLPPlan:
    """The kernel's grids and workspace shapes; raises ValueError on a shape
    it does not take."""
    if not (s > 0 and d % 128 == 0 and 0 < d <= MAX_K and i > 0 and i % 128 == 0
            and tile_i > 0 and tile_i % COLS == 0 and tile_i <= MAX_K and i % tile_i == 0):
        raise ValueError(f"K5 does not take S={s}, D={d}, I={i}, tile_i={tile_i}")
    rb, tiles = -(-s // ROWS), i // tile_i
    return MLPPlan((i // COLS, rb), (d // COLS, tiles, rb), (s, i // COLS),
                   (rb, tiles, ROWS, d), (rb, d // COLS))


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


_workspaces: dict = {}


def _workspace(device: torch.device, s: int, d: int, i: int, tile_i: int):
    """(g [S, I] f32, gmax, part, tickets) of `mlp_plan`, allocated once per
    (device, S, D, I, tile_i) and reused by every later launch: the kernels
    allocate nothing and leave the tickets at zero. Launches that share a
    workspace must not run concurrently (one stream)."""
    key = (device, s, d, i, tile_i)
    ws = _workspaces.get(key)
    if ws is None:
        plan = mlp_plan(s, d, i, tile_i)
        f32 = dict(dtype=torch.float32, device=device)
        ws = (torch.empty((s, i), **f32), torch.empty(plan.gmax_shape, **f32),
              torch.empty(plan.part_shape, **f32),
              torch.zeros(plan.tickets_shape, dtype=torch.int32, device=device))
        _workspaces[key] = ws
    return ws


def fused_mlp_w8(x: torch.Tensor, fc_wq: torch.Tensor, fc_ws: torch.Tensor,
                 fc_b: torch.Tensor, proj_wq: torch.Tensor, proj_ws: torch.Tensor,
                 proj_b: torch.Tensor, *, tile_i: int = 1024) -> torch.Tensor:
    """x [S, D] (post-ln2 activations); fc_wq [D, I] and proj_wq
    [I, D] int8; fc_ws/fc_b [I] and proj_ws/proj_b [D]. Returns [S, D] in
    x's dtype (the caller adds the residual).

    CPU tensors take the plain version, in any layout; CUDA tensors launch
    the kernel or raise. The kernel takes bf16 x (the int8 decode path's
    activation dtype) and both weights column-major (WEIGHT_LAYOUT: strides
    (1, Din), as `quantize_decode_weights` stores them) at 16-byte aligned
    addresses, D a multiple of 128 up to 1024, I a multiple of 128 and of
    tile_i, and tile_i a multiple of 32 up to 1024."""
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
    if not (fc_wq.t().is_contiguous() and proj_wq.t().is_contiguous()):
        raise ValueError("K5 needs column-major weights (strides (1, Din)), the layout "
                         "quantize_decode_weights stores")
    if fc_wq.data_ptr() % 16 or proj_wq.data_ptr() % 16:
        raise ValueError("K5 needs 16-byte aligned weights")
    if fc_ws.shape != (i,) or fc_b.shape != (i,) or proj_ws.shape != (d,) or proj_b.shape != (d,):
        raise ValueError("scales and biases must be [I] (fc) and [D] (proj)")
    mlp_plan(s, d, i, tile_i)  # raises on a shape the kernel does not take
    if x.dtype != torch.bfloat16:
        raise ValueError(f"K5 takes bf16 activations, got {x.dtype}")
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    fc_ws, fc_b, proj_ws, proj_b = (t.float().contiguous() for t in (fc_ws, fc_b, proj_ws, proj_b))
    g, gmax, part, tickets = _workspace(x.device, s, d, i, tile_i)
    out = torch.empty((s, d), dtype=x.dtype, device=x.device)
    lib = _build.library()
    _build.check(
        lib.fused_mlp_w8(
            x.data_ptr(), fc_wq.data_ptr(), fc_ws.data_ptr(), fc_b.data_ptr(),
            proj_wq.data_ptr(), proj_ws.data_ptr(), proj_b.data_ptr(), g.data_ptr(),
            gmax.data_ptr(), part.data_ptr(), tickets.data_ptr(), out.data_ptr(), s, d, i,
            tile_i, _build.stream_ptr(x.device),
        ),
        "fused_mlp_w8",
    )
    _build.count_launch(fused_mlp_w8)
    return out


fused_mlp_w8.launches = 0
