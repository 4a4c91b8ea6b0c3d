"""1-D linear interpolation matching torch.nn.functional.interpolate semantics.

Counterpart of auralis_tpu/ops/interpolate.py: the same explicit index map
(torch's area_pixel_compute_source_index with the *given* scale), so the
result equals the JAX version gather for gather.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def interp_linear_scale(x: torch.Tensor, scale_factor: float) -> torch.Tensor:
    """x: [..., T] -> [..., floor(T*scale)] (torch align_corners=False)."""
    t_in = x.shape[-1]
    t_out = int(math.floor(t_in * scale_factor))
    src = (np.arange(t_out, dtype=np.float64) + 0.5) / scale_factor - 0.5
    src = np.clip(src, 0.0, None)
    lo = np.floor(src).astype(np.int64)
    lo = np.minimum(lo, t_in - 1)
    hi = np.minimum(lo + 1, t_in - 1)
    w_hi = (src - lo).astype(np.float32)
    w_hi = np.where(lo == hi, 0.0, w_hi).astype(np.float32)
    w_lo = (1.0 - w_hi).astype(np.float32)
    dev = x.device
    lo_t = torch.from_numpy(lo).to(dev)
    hi_t = torch.from_numpy(hi).to(dev)
    return (
        x[..., lo_t] * torch.from_numpy(w_lo).to(dev, x.dtype)
        + x[..., hi_t] * torch.from_numpy(w_hi).to(dev, x.dtype)
    )
