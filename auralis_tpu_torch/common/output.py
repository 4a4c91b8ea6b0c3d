"""TTSOutput — audio output container with integrated utilities.

Public surface mirrors the reference (common/definitions/output.py): numpy
waveform + sample rate, `combine_outputs`, byte/format conversion, save,
resample, phase-vocoder speed change, playback helpers. WAV/PCM/FLAC are
first-party; mp3/opus/aac delegate to an ffmpeg binary when one is on PATH
(same seam the reference uses via torchaudio) and raise a clear error
otherwise.
"""
from __future__ import annotations

import io
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Tuple, Union

import numpy as np

from . import audio_io
from .audio_io import UnsupportedAudioFormat
from .dsp_np import istft_np, phase_vocoder, stft_np


@dataclass
class TTSOutput:
    """Container for TTS inference output with integrated audio utilities."""

    array: Union[np.ndarray, bytes]
    sample_rate: int = 24000
    bit_depth: int = 32
    bit_rate: int = 192  # kbps (kept for API compatibility)
    compression: int = 10
    channel: int = 1

    start_time: Optional[float] = None
    end_time: Optional[float] = None
    token_length: Optional[int] = None

    def __post_init__(self):
        if isinstance(self.array, bytes):
            pcm = np.frombuffer(self.array, dtype=np.int16).astype(np.float32) / 32768.0
            fade_len = min(100, len(pcm))
            fade = np.ones(len(pcm), dtype=np.float32)
            fade[:fade_len] = np.linspace(0, 1, fade_len)
            self.array = pcm * fade

    # ------------------------------------------------------------- transforms
    def change_speed(self, speed_factor: float) -> "TTSOutput":
        """Phase-vocoder time stretch; >1.0 speeds up, <1.0 slows down."""
        if speed_factor <= 0:
            raise ValueError("Speed factor must be positive")
        if speed_factor == 1.0:
            return self
        wav = np.asarray(self.array, dtype=np.float32)
        n_fft, hop = 2048, 512
        D = stft_np(wav, n_fft=n_fft, hop=hop)
        D2 = phase_vocoder(D, rate=speed_factor, hop=hop)
        out = istft_np(D2, n_fft=n_fft, hop=hop)
        if out.size == 0:
            # sub-frame input at a high rate leaves the vocoder with zero
            # frames after the centered-pad trim — fall back to a plain
            # linear time-stretch instead of crashing (output edge fuzz)
            n_out = max(1, int(round(len(wav) / speed_factor)))
            out = np.interp(
                np.linspace(0, max(len(wav) - 1, 0), n_out),
                np.arange(len(wav)), wav,
            )
        peak = np.abs(out).max()
        if peak > 0:
            # unconditional peak normalization is REFERENCE behavior
            # (librosa.util.normalize(norm=inf), output.py:86) — kept for
            # parity even though it changes loudness for any speed != 1.0
            out = out / peak
        return TTSOutput(array=out.astype(np.float32), sample_rate=self.sample_rate)

    def resample(self, new_sample_rate: int) -> "TTSOutput":
        from ..ops.resample import resample_np

        wav = np.asarray(self.array, dtype=np.float32)
        out = resample_np(wav[None], self.sample_rate, new_sample_rate)[0]
        return TTSOutput(array=out, sample_rate=new_sample_rate)

    @staticmethod
    def combine_outputs(outputs: List["TTSOutput"]) -> "TTSOutput":
        """Concatenate chunks (all at the first chunk's sample rate)."""
        combined = np.concatenate([np.asarray(o.array) for o in outputs])
        return TTSOutput(array=combined, sample_rate=outputs[0].sample_rate)

    # ------------------------------------------------------------ conversions
    def to_tensor(self):
        """Waveform as a torch tensor when torch is importable, else the
        numpy array (reference output.py:113-118 returns torch.Tensor; this
        runtime has no torch dependency, so it stays optional)."""
        try:
            import torch

            return torch.from_numpy(np.asarray(self.array))
        except ImportError:  # pragma: no cover - torch is present in CI image
            return np.asarray(self.array)

    def to_bytes(self, format: str = "wav", sample_width: int = 2) -> bytes:
        """Serialize to 'wav', raw 'pcm', or 'flac' (first-party C++ encoder,
        native/src/flac.cc). mp3/opus/aac need an external encoder and raise."""
        wav = np.clip(np.asarray(self.array, dtype=np.float32), -1.0, 1.0)
        if format == "wav":
            buf = io.BytesIO()
            audio_io.write_wav(buf, wav, self.sample_rate, sample_width=sample_width)
            return buf.getvalue()
        if format == "pcm":
            if sample_width == 2:
                return np.round(wav * 32767.0).astype("<i2").tobytes()
            if sample_width == 4:
                return np.round(wav * 2147483647.0).astype("<i4").tobytes()
            if sample_width == 1:
                return np.round(wav * 127.0).astype(np.int8).tobytes()
            raise UnsupportedAudioFormat(
                f"pcm sample_width must be 1, 2 or 4 bytes, got {sample_width}"
            )
        if format == "flac":
            from . import native_audio

            return native_audio.flac_encode(
                wav, self.sample_rate,
                bits_per_sample=16 if sample_width <= 2 else 24,
            )
        if format in ("mp3", "opus", "aac"):
            from . import ffmpeg_codec

            if ffmpeg_codec.available():
                return ffmpeg_codec.encode(
                    wav, self.sample_rate, format, bitrate_kbps=self.bit_rate
                )
            raise ValueError(
                f"No {format} encoder is available in this environment "
                "(install ffmpeg to enable it); use format='wav', 'flac' "
                "or 'pcm'"
            )
        raise ValueError(
            f"Unsupported format: {format}. Supported formats are: wav, flac, "
            "pcm, and mp3/opus/aac when ffmpeg is installed"
        )

    def save(
        self,
        filename: Union[str, Path],
        sample_rate: Optional[int] = None,
        format: Optional[str] = None,
    ) -> None:
        out = self
        if sample_rate and sample_rate != self.sample_rate:
            out = self.resample(sample_rate)
        fmt = format or Path(filename).suffix.lstrip(".").lower() or "wav"
        if fmt != "wav":
            Path(filename).write_bytes(out.to_bytes(format=fmt))
            return
        audio_io.write_wav(
            filename,
            np.asarray(out.array, dtype=np.float32),
            out.sample_rate,
            sample_width=4 if self.bit_depth == 32 else 2,
        )

    # -------------------------------------------------------------- metadata
    def get_info(self) -> Tuple[int, int, float]:
        n = len(self.array)
        return n, self.sample_rate, n / self.sample_rate

    @classmethod
    def from_file(cls, filename: Union[str, Path]) -> "TTSOutput":
        data = Path(filename).read_bytes()
        if data[:4] == b"fLaC":
            from . import native_audio

            audio, sr = native_audio.flac_decode(data)
            if audio.ndim == 2:
                audio = audio.mean(axis=1)
            return cls(array=audio, sample_rate=sr)
        audio, sr = audio_io.read_wav(io.BytesIO(data))
        audio = np.asarray(audio)
        if audio.ndim == 2 and audio.shape[0] > 1:
            audio = audio.mean(axis=0)  # downmix like the FLAC branch
        return cls(array=audio.squeeze(), sample_rate=sr)

    @classmethod
    def from_array(cls, array, sample_rate: int = 24000) -> "TTSOutput":
        return cls(array=np.asarray(array).squeeze(), sample_rate=sample_rate)

    # API-compat alias (reference exposes from_tensor for torch tensors)
    from_tensor = from_array

    # --------------------------------------------------------------- playback
    def play(self) -> None:
        """Play through the default sound device (needs `sounddevice`)."""
        try:
            import sounddevice as sd  # optional, not in the base image
        except ImportError as e:
            raise RuntimeError(
                "Audio playback requires the optional 'sounddevice' package"
            ) from e
        wav = np.clip(np.asarray(self.array, dtype=np.float32), -1.0, 1.0)
        sd.play(wav, self.sample_rate, blocksize=2048)
        sd.wait()

    def display(self):
        """Render a Jupyter audio widget when IPython is available."""
        try:
            from IPython.display import Audio, display as ipy_display
        except ImportError:
            return None
        widget = Audio(self.to_bytes("wav"), rate=self.sample_rate, autoplay=False)
        ipy_display(widget)
        return widget

    def preview(self) -> None:
        """Display in a notebook if possible, else play on the sound device."""
        try:
            if self.display() is None:
                self.play()
        except Exception as e:  # playback is best-effort
            print(f"Error playing audio: {e}")
