"""Windowed-sinc polyphase resampler.

Counterpart of auralis_tpu/ops/resample.py. `_sinc_kernel` and `resample_np`
are verbatim copies of the JAX package's numpy code (host-side request
preprocessing); `resample_torch` replaces `resample_jax` for on-device
feature pipelines.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch


@functools.lru_cache(maxsize=32)
def _sinc_kernel(
    orig_freq: int,
    new_freq: int,
    lowpass_filter_width: int = 6,
    rolloff: float = 0.99,
) -> tuple[np.ndarray, int]:
    """Polyphase kernel [new_freq, 1, kernel_width] and the left pad width."""
    assert orig_freq > 0 and new_freq > 0
    base_freq = min(orig_freq, new_freq) * rolloff
    width = math.ceil(lowpass_filter_width * orig_freq / base_freq)

    idx = np.arange(-width, width + orig_freq, dtype=np.float64)[None] / orig_freq
    t = np.arange(0, -new_freq, -1, dtype=np.float64)[:, None] / new_freq + idx
    t *= base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)

    window = np.cos(t * math.pi / lowpass_filter_width / 2) ** 2
    t *= math.pi
    kernel = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t)) * window
    kernel *= base_freq / orig_freq
    return kernel[:, None].astype(np.float32), width


def resample_np(x: np.ndarray, orig_freq: int, new_freq: int, **kw) -> np.ndarray:
    """Resample [..., T] numpy array on host."""
    if orig_freq == new_freq:
        return x
    g = math.gcd(int(orig_freq), int(new_freq))
    orig, new = int(orig_freq) // g, int(new_freq) // g
    kernel, width = _sinc_kernel(orig, new, **kw)
    length = x.shape[-1]
    lead = x.shape[:-1]
    xf = x.reshape(-1, length).astype(np.float32)
    xf = np.pad(xf, ((0, 0), (width, width + orig)))
    num_wins = (xf.shape[-1] - kernel.shape[-1]) // orig + 1
    # strided frame view: [B, num_wins, kernel_width]
    frames = np.lib.stride_tricks.sliding_window_view(xf, kernel.shape[-1], axis=-1)[:, ::orig][
        :, :num_wins
    ]
    out = np.einsum("bwk,pk->bpw", frames, kernel[:, 0, :])  # [B, new, num_wins]
    out = out.transpose(0, 2, 1).reshape(xf.shape[0], -1)
    target_length = math.ceil(new * length / orig)
    return out[:, :target_length].reshape(*lead, target_length)


def resample_torch(x: torch.Tensor, orig_freq: int, new_freq: int, **kw) -> torch.Tensor:
    """Resample [..., T] via polyphase framing + one matmul (f32 accumulate)."""
    if orig_freq == new_freq:
        return x
    g = math.gcd(int(orig_freq), int(new_freq))
    orig, new = int(orig_freq) // g, int(new_freq) // g
    kernel, width = _sinc_kernel(orig, new, **kw)
    k = kernel.shape[-1]
    length = x.shape[-1]
    lead = x.shape[:-1]
    xf = x.reshape(-1, length).float()
    xf = torch.nn.functional.pad(xf, (width, width + orig))
    num_wins = (xf.shape[-1] - k) // orig + 1
    frames = xf.unfold(-1, k, orig)[:, :num_wins]  # [B, num_wins, K]
    w = torch.from_numpy(np.ascontiguousarray(kernel[:, 0, :].T)).to(x.device)
    out = torch.einsum("bwk,kp->bwp", frames, w)  # [B, num_wins, new]
    out = out.reshape(out.shape[0], -1)
    target_length = math.ceil(new * length / orig)
    return out[:, :target_length].reshape(*lead, target_length)
