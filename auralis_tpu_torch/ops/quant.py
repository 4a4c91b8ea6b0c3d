"""Symmetric int8 helpers shared by the int8 KV cache, the W8A8 matmuls and
the plain versions of kernels K4 and K5.

`quantize_rows` is the JAX package's `_quantize_rows` recipe
(auralis_tpu/models/xttsv2/gpt.py:95): per-row scale max(max|x|, eps) / 127
and round-half-to-even of x / scale, as the JAX package runs it: under jit,
where XLA turns the division by the constant 127 into a multiplication by
its f32 reciprocal (eager JAX divides, and its scales differ in the last bit
for ~4% of rows). The division x / scale stays an IEEE division. Its int8
values and scales are bit-equal to jitted JAX on the CPU and to kernels
K4/K5 on the card.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def pad_rows(a: torch.Tensor, rows: int) -> torch.Tensor:
    """a [M, ...] with zero rows appended up to `rows` when M is smaller."""
    if a.shape[0] >= rows:
        return a
    return torch.cat([a, a.new_zeros((rows - a.shape[0], *a.shape[1:]))])


def row_scales(row_max: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """The int8 scales of rows whose largest magnitudes are `row_max` (f32):
    max(row_max, eps) x f32(1/127), as `quantize_rows` takes them."""
    return torch.clamp(row_max, min=eps).mul_(1.0 / 127.0)


def quantize_rows(x: torch.Tensor, eps: float = 1e-8,
                  scale: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """x [..., D] -> (int8 [..., D], f32 scale [...]) with x ~ int8 * scale.
    Written for few launches (decode is host-bound): max |x| as one
    inf-norm reduction, and x / scale promotes bf16 x to f32 exactly.
    `scale` [...] f32 replaces the rows' own scales when x holds only some
    lanes of each row (a model shard's heads): given the scales of the
    whole rows (`row_scales` of the max over all lanes), the int8 lanes
    equal those of the whole rows."""
    if scale is None:
        scale = row_scales(torch.linalg.vector_norm(x, math.inf, dim=-1, dtype=torch.float32),
                           eps)
    return torch.div(x, scale[..., None]).round_().to(torch.int8), scale


def int8_weight(wq: torch.Tensor) -> torch.Tensor:
    """The same int8 weight [..., Din, Dout] stored with Din contiguous
    (each matrix column-major). cuBLASLt's int8 GEMM behind `torch._int_mm`
    takes 7-11x less time with B in this layout at decode shapes (4.5 vs 31
    us at 32 x 1024 x 3072 on an H100)."""
    return wq.transpose(-1, -2).contiguous().transpose(-1, -2)


def int8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] int8 @ b [K, N] int8 -> the exact int32 product [M, N].

    A library GEMM (`torch._int_mm`), as the JAX package leaves these
    products to XLA; fast with b laid out by `int8_weight`. On CUDA
    `_int_mm` needs M > 16 and K, N multiples of 8, so fewer than 17 rows
    are zero-padded to 32 (zero rows give zero products and are cut off
    again)."""
    m = a.shape[0]
    return torch._int_mm((pad_rows(a, 32) if m <= 16 else a).contiguous(), b)[:m]
