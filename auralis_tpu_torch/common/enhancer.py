"""Reference-audio enhancement pipeline (capability parity with
reference common/definitions/enhancer.py — VAD trim, spectral-gating noise
reduction, ~2 kHz clarity boost, LUFS loudness normalization with soft clip).

Implemented first-party on numpy (this image has no librosa/pyloudnorm):
arbitrary-length host preprocessing, so numpy beats per-length XLA recompiles.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .dsp_np import integrated_loudness, istft_np, stft_np


@dataclass
class AudioPreprocessingConfig:
    """Knobs for speaker-reference preprocessing. Field names and defaults
    mirror the reference public API (enhancer.py:11-31)."""

    sample_rate: int = 22050
    normalize: bool = True
    trim_silence: bool = True
    remove_noise: bool = True
    enhance_speech: bool = True

    # VAD parameters
    vad_threshold: float = 0.02
    vad_frame_length: int = 1024 * 4

    # Noise reduction
    noise_reduce_margin: float = 1.0
    noise_reduce_frames: int = 25

    # Enhancement
    enhance_amount: float = 1.0

    # Normalization target
    target_lufs: float = -18.0


def _log_mel_energy(audio: np.ndarray, sr: int) -> np.ndarray:
    """Per-frame summed log-mel energy used as the spectral VAD feature."""
    from ..ops.mel import mel_filterbank

    spec = np.abs(stft_np(audio, n_fft=2048, hop=512)) ** 2  # [F, T]
    fb = mel_filterbank(spec.shape[0], 80, sr)  # [F, M]
    mel = np.log(np.maximum(fb.T @ spec, 1e-5))  # [M, T]
    return mel.sum(axis=0)


class EnhancedAudioProcessor:
    """Chains VAD trim -> spectral gating -> clarity boost -> LUFS normalize."""

    def __init__(self, config: AudioPreprocessingConfig):
        self.config = config

    def vad_split(self, audio: np.ndarray) -> np.ndarray:
        """Energy + spectral voice-activity mask, applied as a soft gain."""
        cfg = self.config
        frame, hop = cfg.vad_frame_length, cfg.vad_frame_length // 2
        if len(audio) < frame:
            return audio
        n_frames = 1 + (len(audio) - frame) // hop
        idx = np.arange(frame)[None, :] + hop * np.arange(n_frames)[:, None]
        energy = np.sum(audio[idx] ** 2, axis=1)
        energy = energy / max(energy.max(), 1e-12)

        spectral = _log_mel_energy(audio, cfg.sample_rate)
        spectral = spectral / max(np.abs(spectral).max(), 1e-12)

        # align the two feature tracks on a common time axis
        n = max(len(energy), len(spectral))
        grid = np.linspace(0, 1, n)
        energy = np.interp(grid, np.linspace(0, 1, len(energy)), energy)
        spectral = np.interp(grid, np.linspace(0, 1, len(spectral)), spectral)

        vad = (energy + spectral) / 2.0
        mask = (np.abs(vad) > cfg.vad_threshold).astype(np.float64)
        gain = np.interp(np.linspace(0, 1, len(audio)), grid, mask)
        return (audio * gain).astype(np.float32)

    def spectral_gating(self, audio: np.ndarray) -> np.ndarray:
        """Noise reduction: estimate a noise floor from the quietest frames
        and apply a Wiener-style soft mask."""
        cfg = self.config
        D = stft_np(audio)
        mag = np.abs(D)
        noise = np.mean(np.sort(mag, axis=1)[:, : cfg.noise_reduce_frames], axis=1)[:, None]
        mask = np.clip(mag - noise * cfg.noise_reduce_margin, 0.0, None)
        mask = mask / (mask + np.maximum(noise, 1e-12))
        out = istft_np(mask * D)
        if out.size == 0:
            # the centered stft/istft roundtrip collapses sub-frame inputs
            # (a truncated upload) to zero length — keep them unchanged
            # rather than deleting the reference (audio edge fuzz). Ordinary
            # inputs come back up to hop-1 samples shorter, which is fine.
            return audio
        return out[: len(audio)]

    def enhance_clarity(self, audio: np.ndarray) -> np.ndarray:
        """Gentle spectral shaping boost centered on 2 kHz."""
        cfg = self.config
        audio = np.nan_to_num(audio, nan=0.0, posinf=0.0, neginf=0.0)
        D = stft_np(audio)
        freqs = np.fft.rfftfreq(2048, 1.0 / cfg.sample_rate)
        boost = np.exp(-np.abs(freqs - 2000.0) / 1000.0) * cfg.enhance_amount
        out = istft_np(D * (1.0 + boost[:, None]))
        if out.size == 0:
            return audio  # sub-frame input; see spectral_gating
        return out[: len(audio)]

    def normalize_loudness(self, audio: np.ndarray) -> np.ndarray:
        """Gain to target LUFS (BS.1770 gated) with tanh soft clipping."""
        lufs = integrated_loudness(audio, self.config.sample_rate)
        if not np.isfinite(lufs):
            return audio
        gain = 10.0 ** ((self.config.target_lufs - lufs) / 20.0)
        return np.tanh(audio * gain).astype(np.float32)

    def process(self, audio: np.ndarray) -> np.ndarray:
        cfg = self.config
        audio = np.asarray(audio, dtype=np.float32)
        if cfg.trim_silence:
            audio = self.vad_split(audio)
        if cfg.remove_noise:
            audio = self.spectral_gating(audio)
        if cfg.enhance_speech:
            audio = self.enhance_clarity(audio)
        if cfg.normalize:
            audio = self.normalize_loudness(audio)
        return audio.astype(np.float32)
