"""Host-side numpy DSP helpers: STFT/ISTFT, phase vocoder, LUFS loudness.

These serve arbitrary-length per-request preprocessing (enhancement, speed
change, loudness normalization) where static-shape jit would recompile per
length. The fixed-shape hot paths live in `auralis_tpu.ops` as JAX.

LUFS measurement implements ITU-R BS.1770-4 (K-weighting + gated integration),
replacing the reference's `pyloudnorm` dependency (reference:
common/definitions/enhancer.py:126-138).
"""
from __future__ import annotations

import numpy as np


def stft_np(
    x: np.ndarray, n_fft: int = 2048, hop: int = 512, window: np.ndarray | None = None
) -> np.ndarray:
    """Centered reflect-padded STFT of [T] -> complex [n_fft//2+1, n_frames]."""
    if window is None:
        window = np.hanning(n_fft + 1)[:-1]
    pad = n_fft // 2
    # numpy's reflect pad needs >= 2 samples to reflect; degenerate inputs
    # (a truncated upload can be a single sample) zero-pad instead of
    # crashing the request (found by the audio edge fuzz)
    mode = "reflect" if len(x) >= 2 else "constant"
    xp = np.pad(x, (pad, pad), mode=mode)
    n_frames = 1 + (len(xp) - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = xp[idx] * window[None, :]
    return np.fft.rfft(frames, axis=-1).T


def istft_np(
    spec: np.ndarray, n_fft: int = 2048, hop: int = 512, window: np.ndarray | None = None
) -> np.ndarray:
    """Inverse of `stft_np` with overlap-add + window-square normalization."""
    if window is None:
        window = np.hanning(n_fft + 1)[:-1]
    frames = np.fft.irfft(spec.T, n=n_fft, axis=-1) * window[None, :]
    n_frames = frames.shape[0]
    out_len = n_fft + hop * (n_frames - 1)
    out = np.zeros(out_len, dtype=np.float64)
    norm = np.zeros(out_len, dtype=np.float64)
    w2 = window.astype(np.float64) ** 2
    for i in range(n_frames):
        out[i * hop : i * hop + n_fft] += frames[i]
        norm[i * hop : i * hop + n_fft] += w2
    out = out / np.maximum(norm, 1e-10)
    pad = n_fft // 2
    return out[pad:-pad].astype(np.float32)


def phase_vocoder(
    spec: np.ndarray, rate: float, hop: int = 512
) -> np.ndarray:
    """Time-stretch a complex STFT by `rate` (>1 = faster/shorter)."""
    n_freqs, n_frames = spec.shape
    time_steps = np.arange(0, n_frames, rate)
    phi_advance = np.linspace(0, np.pi * hop, n_freqs)[:, None]

    out = np.zeros((n_freqs, len(time_steps)), dtype=np.complex128)
    phase_acc = np.angle(spec[:, :1])
    spec_pad = np.concatenate([spec, np.zeros((n_freqs, 2), dtype=spec.dtype)], axis=1)

    for t, step in enumerate(time_steps):
        i0 = int(np.floor(step))
        frac = step - i0
        s0, s1 = spec_pad[:, i0], spec_pad[:, i0 + 1]
        mag = (1 - frac) * np.abs(s0) + frac * np.abs(s1)
        out[:, t : t + 1] = mag[:, None] * np.exp(1j * phase_acc)
        dphase = np.angle(s1) - np.angle(s0) - phi_advance[:, 0]
        dphase -= 2 * np.pi * np.round(dphase / (2 * np.pi))
        phase_acc[:, 0] += phi_advance[:, 0] + dphase
    return out


# --- ITU-R BS.1770-4 loudness ------------------------------------------------


def _k_weighting_coeffs(fs: float) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Pre-filter (shelving) + RLB high-pass biquads for sample rate fs."""
    # Stage 1: spherical-head shelving filter
    f0, G, Q = 1681.9744509555319, 3.99984385397, 0.7071752369554193
    K = np.tan(np.pi * f0 / fs)
    Vh = 10.0 ** (G / 20.0)
    Vb = Vh**0.4996667741545416
    a0 = 1.0 + K / Q + K * K
    b1 = np.array([(Vh + Vb * K / Q + K * K) / a0, 2.0 * (K * K - Vh) / a0, (Vh - Vb * K / Q + K * K) / a0])
    a1 = np.array([1.0, 2.0 * (K * K - 1.0) / a0, (1.0 - K / Q + K * K) / a0])
    # Stage 2: RLB high-pass (numerator is [1,-2,1] un-normalized per BS.1770)
    f0, Q = 38.13547087602444, 0.5003270373238773
    K = np.tan(np.pi * f0 / fs)
    d0 = 1.0 + K / Q + K * K
    b2 = np.array([1.0, -2.0, 1.0])
    a2 = np.array([1.0, 2.0 * (K * K - 1.0) / d0, (1.0 - K / Q + K * K) / d0])
    return b1, a1, b2, a2


def _biquad(x: np.ndarray, b: np.ndarray, a: np.ndarray) -> np.ndarray:
    """Direct-form II transposed biquad (a[0] == 1)."""
    y = np.empty_like(x, dtype=np.float64)
    z1 = z2 = 0.0
    b0, bb1, bb2 = b
    _, aa1, aa2 = a
    for i in range(len(x)):
        xi = x[i]
        yi = b0 * xi + z1
        z1 = bb1 * xi - aa1 * yi + z2
        z2 = bb2 * xi - aa2 * yi
        y[i] = yi
    return y


def _biquad_fast(x: np.ndarray, b: np.ndarray, a: np.ndarray) -> np.ndarray:
    try:
        from scipy.signal import lfilter

        return lfilter(b, a, x)
    except Exception:
        return _biquad(x, b, a)


def integrated_loudness(audio: np.ndarray, fs: int) -> float:
    """Gated integrated loudness (LUFS) of mono or [C,T] audio, BS.1770-4."""
    x = np.atleast_2d(np.asarray(audio, dtype=np.float64))
    b1, a1, b2, a2 = _k_weighting_coeffs(float(fs))
    block = int(0.4 * fs)  # 400 ms blocks
    hop = int(0.1 * fs)  # 75% overlap
    if x.shape[-1] < block:
        return -np.inf
    powers = []
    for ch in x:
        y = _biquad_fast(_biquad_fast(ch, b1, a1), b2, a2)
        n_blocks = 1 + (len(y) - block) // hop
        idx = np.arange(block)[None, :] + hop * np.arange(n_blocks)[:, None]
        powers.append(np.mean(y[idx] ** 2, axis=1))
    z = np.sum(powers, axis=0)  # channel weights = 1 for mono/stereo L,R
    loudness_blocks = -0.691 + 10.0 * np.log10(np.maximum(z, 1e-12))
    # absolute gate at -70 LUFS
    mask = loudness_blocks > -70.0
    if not mask.any():
        return -np.inf
    # relative gate at -10 LU below the absolute-gated mean
    rel_threshold = -0.691 + 10.0 * np.log10(np.mean(z[mask])) - 10.0
    mask &= loudness_blocks > rel_threshold
    if not mask.any():
        return -np.inf
    return float(-0.691 + 10.0 * np.log10(np.mean(z[mask])))


# --- silence trim (librosa.effects.trim semantics) ---------------------------


def trim_silence_db(
    audio: np.ndarray, top_db: float = 60.0,
    frame_length: int = 2048, hop_length: int = 512,
) -> np.ndarray:
    """Trim leading/trailing silence below `top_db` relative to the peak
    frame RMS (first-party librosa.effects.trim equivalent — reference
    XTTSv2.py:450-451 uses it on voice references when librosa_trim_db is
    set). audio: [..., T]; returns the trimmed view along the last axis.
    All-silent input returns the input unchanged."""
    x = np.asarray(audio, np.float32)
    mono = x.reshape(-1, x.shape[-1]).mean(axis=0)
    t = mono.shape[-1]
    if t < frame_length:
        return audio
    n_frames = 1 + (t - frame_length) // hop_length
    idx = (
        np.arange(frame_length)[None, :]
        + hop_length * np.arange(n_frames)[:, None]
    )
    rms = np.sqrt(np.mean(mono[idx] ** 2, axis=-1) + 1e-20)
    db = 20.0 * np.log10(rms + 1e-20)
    keep = np.nonzero(db > db.max() - top_db)[0]
    if keep.size == 0:
        return audio
    start = int(keep[0]) * hop_length
    # a kept FINAL frame keeps the tail remainder too (frames tile the
    # signal with a partial last hop; trimming it would cut real content)
    end = t if int(keep[-1]) == n_frames - 1 else int(keep[-1]) * hop_length + frame_length
    return audio[..., start:end]
