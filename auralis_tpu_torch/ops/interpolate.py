"""1-D linear interpolation matching torch.nn.functional.interpolate semantics.

Counterpart of auralis_tpu/ops/interpolate.py: the same explicit index map
(torch's area_pixel_compute_source_index with the *given* scale), so the
result equals the JAX version gather for gather.
"""
from __future__ import annotations

import math

import numpy as np
import torch


_tables: dict = {}


def _index_table(t_in: int, scale_factor: float, device, dtype) -> tuple:
    """(lo, hi, w_lo, w_hi) of the index map on `device`, made once per (T,
    scale, device, dtype): later calls upload nothing, so a call can be
    captured in a CUDA graph once the same shapes have run eagerly."""
    key = (t_in, scale_factor, str(device), dtype)
    table = _tables.get(key)
    if table is None:
        t_out = int(math.floor(t_in * scale_factor))
        src = (np.arange(t_out, dtype=np.float64) + 0.5) / scale_factor - 0.5
        src = np.clip(src, 0.0, None)
        lo = np.floor(src).astype(np.int64)
        lo = np.minimum(lo, t_in - 1)
        hi = np.minimum(lo + 1, t_in - 1)
        w_hi = (src - lo).astype(np.float32)
        w_hi = np.where(lo == hi, 0.0, w_hi).astype(np.float32)
        w_lo = (1.0 - w_hi).astype(np.float32)
        table = (torch.from_numpy(lo).to(device), torch.from_numpy(hi).to(device),
                 torch.from_numpy(w_lo).to(device, dtype), torch.from_numpy(w_hi).to(device, dtype))
        _tables[key] = table
    return table


def interp_linear_scale(x: torch.Tensor, scale_factor: float) -> torch.Tensor:
    """x: [..., T] -> [..., floor(T*scale)] (torch align_corners=False)."""
    lo_t, hi_t, w_lo, w_hi = _index_table(x.shape[-1], scale_factor, x.device, x.dtype)
    return x[..., lo_t] * w_lo + x[..., hi_t] * w_hi
