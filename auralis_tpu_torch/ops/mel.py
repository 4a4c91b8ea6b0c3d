"""STFT / mel-spectrogram ops.

Counterpart of auralis_tpu/ops/mel.py. The filterbank and window helpers are
verbatim copies of the JAX package's numpy code (`mel_filterbank` is also
what the copied host enhancer imports); the STFT and mel pipelines run in
torch with the same semantics as torchaudio (centered, reflect-padded,
|.|**power magnitude, no per-window normalization). The named windows and
the filterbanks are uploaded once per (device, dtype, parameters) and
kept as device tables, so a call whose shapes have run once uploads
nothing and can be captured in a CUDA graph (the engine's conditioning
programs).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F


def hz_to_mel(freq: np.ndarray | float, mel_scale: str = "htk") -> np.ndarray | float:
    if mel_scale == "htk":
        return 2595.0 * np.log10(1.0 + np.asarray(freq, dtype=np.float64) / 700.0)
    # slaney scale
    f = np.asarray(freq, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = math.log(6.4) / 27.0
    return np.where(f >= min_log_hz, min_log_mel + np.log(f / min_log_hz) / logstep, mels)


def mel_to_hz(mels: np.ndarray, mel_scale: str = "htk") -> np.ndarray:
    if mel_scale == "htk":
        return 700.0 * (10.0 ** (np.asarray(mels, dtype=np.float64) / 2595.0) - 1.0)
    m = np.asarray(mels, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = math.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


@functools.lru_cache(maxsize=32)
def mel_filterbank(
    n_freqs: int,
    n_mels: int,
    sample_rate: int,
    f_min: float = 0.0,
    f_max: float | None = None,
    norm: str | None = None,
    mel_scale: str = "htk",
) -> np.ndarray:
    """Triangular mel filterbank, shape [n_freqs, n_mels] (torchaudio layout)."""
    f_max = f_max if f_max is not None else sample_rate / 2.0
    all_freqs = np.linspace(0.0, sample_rate // 2, n_freqs)

    m_min = hz_to_mel(f_min, mel_scale)
    m_max = hz_to_mel(f_max, mel_scale)
    m_pts = np.linspace(m_min, m_max, n_mels + 2)
    f_pts = mel_to_hz(m_pts, mel_scale)

    f_diff = f_pts[1:] - f_pts[:-1]  # (n_mels + 1,)
    slopes = f_pts[None, :] - all_freqs[:, None]  # (n_freqs, n_mels + 2)
    down_slopes = (-slopes[:, :-2]) / f_diff[:-1]
    up_slopes = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down_slopes, up_slopes))

    if norm == "slaney":
        enorm = 2.0 / (f_pts[2 : n_mels + 2] - f_pts[:n_mels])
        fb *= enorm[None, :]
    return fb.astype(np.float32)


def hann_window(win_length: int, dtype=np.float32) -> np.ndarray:
    # torch.hann_window(periodic=True)
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * math.pi * n / win_length)).astype(dtype)


def hamming_window(win_length: int, dtype=np.float32) -> np.ndarray:
    # torch.hamming_window(periodic=True)
    n = np.arange(win_length, dtype=np.float64)
    return (0.54 - 0.46 * np.cos(2.0 * math.pi * n / win_length)).astype(dtype)


_WINDOWS = {"hann": hann_window, "hamming": hamming_window}
_tables: dict = {}


def _device_table(key: tuple, make) -> torch.Tensor:
    """The device tensor of `key` (made by make() on first use, then kept)."""
    table = _tables.get(key)
    if table is None:
        table = _tables[key] = make()
    return table


def _window_table(window: str, win_length: int, n_fft: int, device, dtype) -> torch.Tensor:
    """A named periodic window of `win_length`, centre-padded to n_fft as
    torch.stft pads it, on `device`."""
    def make():
        w = _WINDOWS[window](win_length)
        lpad = (n_fft - win_length) // 2
        return torch.from_numpy(np.pad(w, (lpad, n_fft - win_length - lpad))).to(device, dtype)

    return _device_table(("window", window, win_length, n_fft, str(device), dtype), make)


def _reflect_pad(x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """Reflect-pad the last axis of [..., T] (numpy/jnp "reflect" mode)."""
    lead = x.shape[:-1]
    y = F.pad(x.reshape(-1, 1, x.shape[-1]), (left, right), mode="reflect")
    return y.reshape(*lead, y.shape[-1])


def stft_mag(
    x: torch.Tensor,
    n_fft: int,
    hop_length: int,
    win_length: int,
    window: np.ndarray | str = "hann",
    power: float = 2.0,
    center: bool = True,
) -> torch.Tensor:
    """Magnitude (|.|**power) STFT of [..., T] -> [..., n_fft//2+1, n_frames].

    Matches torch.stft(center=True, pad_mode="reflect", normalized=False,
    onesided=True) followed by abs()**power. `window` names a periodic
    window ("hann", "hamming"; a device table) or is an array of
    `win_length` values (uploaded per call).
    """
    if isinstance(window, str):
        win = _window_table(window, win_length, n_fft, x.device, x.dtype)
    else:
        lpad = (n_fft - win_length) // 2  # torch center-pads the window to n_fft
        win = torch.from_numpy(np.pad(np.asarray(window), (lpad, n_fft - win_length - lpad))).to(
            x.device, x.dtype)
    if center:
        pad = n_fft // 2
        x = _reflect_pad(x, pad, pad)
    frames = x.unfold(-1, n_fft, hop_length)  # [..., n_frames, n_fft]
    frames = frames * win
    spec = torch.fft.rfft(frames, n=n_fft, dim=-1)  # [..., n_frames, n_fft//2+1]
    mag = spec.abs()
    if power != 1.0:
        mag = mag**power
    return mag.transpose(-1, -2)  # [..., n_freqs, n_frames]


def mel_spectrogram(
    x: torch.Tensor,
    sample_rate: int,
    n_fft: int,
    hop_length: int,
    win_length: int,
    n_mels: int,
    f_min: float = 0.0,
    f_max: float | None = None,
    power: float = 2.0,
    norm: str | None = None,
    mel_scale: str = "htk",
    window: np.ndarray | str = "hann",
) -> torch.Tensor:
    """[..., T] -> [..., n_mels, n_frames]; torchaudio.transforms.MelSpectrogram."""
    spec = stft_mag(x, n_fft, hop_length, win_length, window=window, power=power)
    args = (n_fft // 2 + 1, n_mels, sample_rate, f_min, f_max, norm, mel_scale)
    fb = _device_table(("mel", *args, str(x.device), spec.dtype), lambda: torch.from_numpy(
        mel_filterbank(*args)).to(x.device, spec.dtype))
    return torch.einsum("...ft,fm->...mt", spec, fb)


def wav_to_mel_cloning(
    wav: torch.Tensor,
    mel_norms: torch.Tensor,
    n_fft: int = 4096,
    hop_length: int = 1024,
    win_length: int = 4096,
    power: float = 2.0,
    sample_rate: int = 22050,
    f_min: float = 0.0,
    f_max: float = 8000.0,
    n_mels: int = 80,
) -> torch.Tensor:
    """Voice-cloning conditioning mel: log-clamped slaney-normalized mel
    divided per-bin by the checkpoint's mel_norms. wav: [B, T] -> [B, n_mels, n_frames]."""
    mel = mel_spectrogram(
        wav,
        sample_rate=sample_rate,
        n_fft=n_fft,
        hop_length=hop_length,
        win_length=win_length,
        n_mels=n_mels,
        f_min=f_min,
        f_max=f_max,
        power=power,
        norm="slaney",
        mel_scale="htk",
    )
    mel = torch.log(torch.clamp(mel, min=1e-5))
    return mel / mel_norms[None, :, None]


def preemphasis(x: torch.Tensor, coefficient: float = 0.97) -> torch.Tensor:
    """y[t] = x[t] - c*x[t-1] with reflect pre-pad of 1. x: [..., T]."""
    x_pad = _reflect_pad(x, 1, 0)
    return x_pad[..., 1:] - coefficient * x_pad[..., :-1]


def speaker_encoder_mel(x: torch.Tensor, *, sample_rate: int = 16000) -> torch.Tensor:
    """The speaker-encoder input featurizer: PreEmphasis(0.97) ->
    MelSpectrogram(16k, n_fft=512, win=400, hop=160, hamming window, 64 mels,
    power=2, no norm) -> log(x + 1e-6). x: [B, T] -> [B, 64, n_frames]."""
    x = preemphasis(x, 0.97)
    mel = mel_spectrogram(
        x,
        sample_rate=sample_rate,
        n_fft=512,
        hop_length=160,
        win_length=400,
        n_mels=64,
        power=2.0,
        norm=None,
        mel_scale="htk",
        window="hamming",
    )
    return torch.log(mel + 1e-6)
