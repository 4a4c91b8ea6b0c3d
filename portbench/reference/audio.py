"""The reference's audio front end: the speaker WAV as the benchmark wrote
it, the windowed-sinc resampling to 16 kHz, the two log-mel featurizers,
and the voice conditioning built from them (a frozen copy of the
published XTTS math: `xtts.py` `get_gpt_cond_latents`,
`get_speaker_embedding`, `wav_to_mel_cloning`, torchaudio's
`MelSpectrogram` and `resample`)."""
from __future__ import annotations

import math
import struct

import numpy as np
import torch

from . import model


def read_wav_f32(path: str) -> tuple[np.ndarray, int]:
    """A mono IEEE-float WAV -> (samples [T] f32, sample rate)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path} is not a WAV file")
    pos, rate, samples = 12, None, None
    while pos + 8 <= len(data):
        cid, size = data[pos:pos + 4], struct.unpack_from("<I", data, pos + 4)[0]
        body = data[pos + 8:pos + 8 + size]
        if cid == b"fmt ":
            tag, channels, rate, _, _, bits = struct.unpack_from("<HHIIHH", body)
            if (tag, channels, bits) != (3, 1, 32):
                raise ValueError(f"{path}: expected mono 32-bit float, got {tag, channels, bits}")
        elif cid == b"data":
            samples = np.frombuffer(body, "<f4").astype(np.float32)
        pos += 8 + size + (size & 1)
    return samples, rate


def resample(x: np.ndarray, orig: int, new: int, width: int = 6,
             rolloff: float = 0.99) -> np.ndarray:
    """torchaudio's sinc_interp_hann resampling of [T] (the published
    speaker path's `torchaudio.functional.resample`), in float64."""
    g = math.gcd(orig, new)
    orig, new = orig // g, new // g
    base = min(orig, new) * rolloff
    w = math.ceil(width * orig / base)
    idx = np.arange(-w, w + orig, dtype=np.float64)[None] / orig
    t = (np.arange(0, -new, -1, dtype=np.float64)[:, None] / new + idx) * base
    t = np.clip(t, -width, width)
    window = np.cos(t * math.pi / width / 2) ** 2
    t = t * math.pi
    kernel = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t)) * window * base / orig
    xp = np.pad(x.astype(np.float64), (w, w + orig))
    n_win = (xp.shape[0] - kernel.shape[1]) // orig + 1
    frames = np.stack([xp[i * orig:i * orig + kernel.shape[1]] for i in range(n_win)])
    out = (frames @ kernel.T).reshape(-1)
    return out[: math.ceil(new * x.shape[0] / orig)].astype(np.float32)


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


def mel_filters(n_freqs: int, n_mels: int, rate: int, f_max: float, slaney: bool) -> np.ndarray:
    """torchaudio's triangular HTK-scale filterbank [n_freqs, n_mels],
    with slaney area normalisation when asked."""
    freqs = np.linspace(0.0, rate // 2, n_freqs)
    f_pts = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(f_max), n_mels + 2))
    diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - freqs[:, None]
    fb = np.maximum(0.0, np.minimum(-slopes[:, :-2] / diff[:-1], slopes[:, 2:] / diff[1:]))
    if slaney:
        fb *= (2.0 / (f_pts[2:n_mels + 2] - f_pts[:n_mels]))[None, :]
    return fb.astype(np.float32)


def _power_mel(x, n_fft, hop, win, window, n_mels, rate, f_max, slaney):
    spec = torch.stft(x, n_fft, hop_length=hop, win_length=win, window=window, center=True,
                      pad_mode="reflect", return_complex=True).abs() ** 2  # [B, F, T]
    fb = torch.from_numpy(mel_filters(n_fft // 2 + 1, n_mels, rate, f_max, slaney)).to(x.device)
    return torch.einsum("bft,fm->bmt", spec, fb)


def cloning_mel(wav: torch.Tensor, mel_norms: torch.Tensor, ce: dict) -> torch.Tensor:
    """wav [B, T] at 22.05 kHz -> log mel [B, 80, frames] / mel_norms."""
    window = torch.hann_window(ce["win_length"], periodic=True, device=wav.device)
    mel = _power_mel(wav, ce["n_fft"], ce["hop_length"], ce["win_length"], window,
                     ce["n_mels"], 22050, ce["fmax"], True)
    return torch.log(torch.clamp(mel, min=1e-5)) / mel_norms.float()[None, :, None]


def speaker_mel(wav: torch.Tensor, se: dict) -> torch.Tensor:
    """wav [B, T] at 16 kHz -> log(mel + 1e-6) [B, 64, frames] after a 0.97
    pre-emphasis (reflect-padded by one sample)."""
    x = torch.cat([wav[:, 1:2], wav], dim=1)
    x = x[:, 1:] - 0.97 * x[:, :-1]
    window = torch.hamming_window(400, periodic=True, device=wav.device)
    mel = _power_mel(x, 512, 160, 400, window, se["n_mels"], se["sample_rate"],
                     se["sample_rate"] / 2, False)
    return torch.log(mel + 1e-6)


def conditioning(core: dict, config: dict, wav22: np.ndarray, max_ref_length: int,
                 cond_len: int, cond_chunk_len: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """A 22.05 kHz reference [T] -> (GPT conditioning latents [C, D], the
    speaker d-vector [512]): the reference cut to max_ref_length seconds and
    to whole seconds; latents averaged over cond_chunk_len-second windows
    of its first cond_len seconds (windows under 0.33 s dropped); the
    d-vector from its 16 kHz resampling. f32 throughout."""
    arch, heads = config["architecture"], config["model_args"]["gpt_n_heads"]
    num, sr = model.Numerics(), 22050
    a = np.clip(wav22, -1.0, 1.0)[: sr * max_ref_length]
    a = a[: (a.shape[0] // sr) * sr or a.shape[0]]
    feats = speaker_mel(torch.from_numpy(resample(a, sr, 16000))[None].to(device),
                        arch["speaker_encoder"])
    dvec = model.speaker_encoder(core["speaker_encoder"], feats)[0]
    head = a[: sr * cond_len]
    step = sr * cond_chunk_len
    windows = [head[i:i + step] for i in range(0, head.shape[0], step)]
    windows = [w for w in windows if w.shape[0] >= sr * 0.33] or [head]
    lats = []
    for w in windows:
        mel = cloning_mel(torch.from_numpy(w)[None].to(device), core["mel_stats"],
                          arch["cond_encoder"])
        h = model.conditioning_encoder(core["cond_encoder"], mel, heads, num)
        lats.append(model.perceiver(core["perceiver"], h, arch["perceiver"]["heads"], num)[0])
    return torch.stack(lats).mean(0), dvec
