"""Host-side audio file I/O (first-party; the environment has no
torchaudio/librosa/soundfile).

Reads/writes RIFF WAV (PCM 8/16/24/32-bit and IEEE float 32/64), mixes to
mono, resamples with the windowed-sinc resampler and clips to [-1, 1] —
the behavior the reference gets from torchaudio.load + resample
(reference: common/utilities.py:74-98 `load_audio`).

FLAC decodes through the first-party native codec; other compressed
containers (mp3/ogg/aac/...) decode through an ffmpeg binary when one is
on PATH and raise a clear error otherwise.
"""
from __future__ import annotations

import io
import struct
from pathlib import Path
from typing import Union

import numpy as np

from ..ops.resample import resample_np

AudioSource = Union[str, Path, bytes, io.BytesIO]

WAVE_FORMAT_PCM = 0x0001
WAVE_FORMAT_IEEE_FLOAT = 0x0003
WAVE_FORMAT_EXTENSIBLE = 0xFFFE


class UnsupportedAudioFormat(ValueError):
    pass


def _open(source: AudioSource) -> bytes:
    if isinstance(source, (str, Path)):
        return Path(source).read_bytes()
    if isinstance(source, io.BytesIO):
        return source.getvalue()
    if isinstance(source, (bytes, bytearray)):
        return bytes(source)
    raise TypeError(f"Unsupported audio source type: {type(source)}")


def read_wav(source: AudioSource) -> tuple[np.ndarray, int]:
    """Decode a WAV file -> (float32 samples [channels, T], sample_rate)."""
    data = _open(source)
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        head = data[:4]
        if head[:3] == b"ID3" or head[:2] in (b"\xff\xfb", b"\xff\xf3"):
            raise UnsupportedAudioFormat("MP3 decoding is not available in this build; provide WAV input")
        if head == b"fLaC":
            # first-party C++ decoder (native/src/flac.cc): full RFC 9639
            # subframe coverage incl. LPC + stereo decorrelation
            from . import native_audio

            audio, sr = native_audio.flac_decode(data)
            if audio.ndim == 1:
                audio = audio[None]
            else:
                audio = audio.T
            return audio.astype(np.float32), sr
        if head == b"OggS":
            raise UnsupportedAudioFormat("Ogg/Opus decoding is not available in this build; provide WAV input")
        raise UnsupportedAudioFormat("Not a RIFF/WAVE file")

    pos = 12
    fmt = None
    raw = None
    while pos + 8 <= len(data):
        chunk_id = data[pos : pos + 4]
        (chunk_size,) = struct.unpack_from("<I", data, pos + 4)
        body = data[pos + 8 : pos + 8 + chunk_size]
        if chunk_id == b"fmt ":
            fmt = struct.unpack_from("<HHIIHH", body, 0)
            if fmt[0] == WAVE_FORMAT_EXTENSIBLE and chunk_size >= 40:
                (sub_format,) = struct.unpack_from("<H", body, 24)
                fmt = (sub_format,) + fmt[1:]
        elif chunk_id == b"data":
            raw = body
        pos += 8 + chunk_size + (chunk_size & 1)
    if fmt is None or raw is None:
        raise UnsupportedAudioFormat("WAV file missing fmt/data chunk")

    audio_format, n_channels, sample_rate, _, _, bits = fmt
    if audio_format == WAVE_FORMAT_PCM:
        if bits == 8:
            x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 16:
            x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8)
            b = b[: len(b) - len(b) % 3].reshape(-1, 3)
            x = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            x = np.where(x >= 1 << 23, x - (1 << 24), x).astype(np.float32) / float(1 << 23)
        elif bits == 32:
            x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
        else:
            raise UnsupportedAudioFormat(f"Unsupported PCM bit depth: {bits}")
    elif audio_format == WAVE_FORMAT_IEEE_FLOAT:
        x = np.frombuffer(raw, dtype="<f4" if bits == 32 else "<f8").astype(np.float32)
    else:
        raise UnsupportedAudioFormat(f"Unsupported WAV format tag: {audio_format:#x}")

    n_frames = len(x) // n_channels
    x = x[: n_frames * n_channels].reshape(n_frames, n_channels).T  # [C, T]
    return np.ascontiguousarray(x), sample_rate


def wav_stream_header(
    sample_rate: int, n_channels: int = 1, sample_width: int = 2
) -> bytes:
    """RIFF header for a PCM stream of UNKNOWN length (chunked HTTP
    responses): the RIFF and data chunk sizes are 0xFFFFFFFF, the streaming
    convention players, browsers and ffmpeg accept (they read until EOF).
    Pair with raw little-endian sample frames written after it."""
    if sample_width == 2:
        fmt_tag, bits = WAVE_FORMAT_PCM, 16
    elif sample_width == 4:
        fmt_tag, bits = WAVE_FORMAT_IEEE_FLOAT, 32
    else:
        raise UnsupportedAudioFormat(f"Unsupported sample width: {sample_width}")
    byte_rate = sample_rate * n_channels * (bits // 8)
    block_align = n_channels * (bits // 8)
    return b"".join(
        [
            b"RIFF",
            struct.pack("<I", 0xFFFFFFFF),
            b"WAVE",
            b"fmt ",
            struct.pack(
                "<IHHIIHH", 16, fmt_tag, n_channels, sample_rate, byte_rate,
                block_align, bits,
            ),
            b"data",
            struct.pack("<I", 0xFFFFFFFF),
        ]
    )


def write_wav(
    target: Union[str, Path, io.BytesIO],
    audio: np.ndarray,
    sample_rate: int,
    sample_width: int = 2,
) -> bytes | None:
    """Encode float [-1,1] audio ([T] or [C,T]) to WAV (16-bit PCM or float32)."""
    if audio.ndim == 1:
        audio = audio[None]
    interleaved = np.ascontiguousarray(audio.T)  # [T, C]
    n_channels = interleaved.shape[1]
    if sample_width == 2:
        fmt_tag, bits = WAVE_FORMAT_PCM, 16
        payload = (np.clip(interleaved, -1.0, 1.0) * 32767.0).astype("<i2").tobytes()
    elif sample_width == 4:
        fmt_tag, bits = WAVE_FORMAT_IEEE_FLOAT, 32
        payload = interleaved.astype("<f4").tobytes()
    else:
        raise UnsupportedAudioFormat(f"Unsupported sample width: {sample_width}")

    byte_rate = sample_rate * n_channels * (bits // 8)
    block_align = n_channels * (bits // 8)
    header = b"".join(
        [
            b"RIFF",
            struct.pack("<I", 36 + len(payload)),
            b"WAVE",
            b"fmt ",
            struct.pack("<IHHIIHH", 16, fmt_tag, n_channels, sample_rate, byte_rate, block_align, bits),
            b"data",
            struct.pack("<I", len(payload)),
        ]
    )
    blob = header + payload
    if isinstance(target, io.BytesIO):
        target.write(blob)
        return None
    if target is None:
        return blob
    Path(target).write_bytes(blob)
    return None


def load_audio(source: AudioSource, sampling_rate: int) -> np.ndarray:
    """Load audio -> mono float32 [1, T] at `sampling_rate`, clipped to [-1,1]
    (reference behavior: common/utilities.py:74-98). WAV and FLAC decode
    first-party; other containers (mp3/ogg/aac/...) go through ffmpeg when
    a binary is available."""
    data = _open(source)
    if data[:4] == b"fLaC":
        from . import native_audio

        try:
            decoded, sr = native_audio.flac_decode(data)
        except (ValueError, RuntimeError) as e:
            # a first-party decode failure (corrupt stream, or the native
            # lib missing) must never dead-end a file ffmpeg could handle
            from . import ffmpeg_codec

            if not ffmpeg_codec.available():
                raise UnsupportedAudioFormat(
                    f"FLAC decode failed ({e}) and no ffmpeg binary is on "
                    "PATH to fall back to"
                ) from e
            mono, _ = ffmpeg_codec.decode(data, target_sample_rate=sampling_rate)
            return np.clip(mono[None].astype(np.float32), -1.0, 1.0)
        audio = decoded.T if decoded.ndim == 2 else decoded[None]
    elif data[:4] == b"RIFF":
        audio, sr = read_wav(data)
    else:
        from . import ffmpeg_codec

        if not ffmpeg_codec.available():
            raise UnsupportedAudioFormat(
                "Input is not WAV or FLAC and no ffmpeg binary is on PATH "
                "to decode compressed formats"
            )
        # resample once inside ffmpeg straight to the model rate (avoids
        # decode-at-guessed-rate followed by a second sinc resample here)
        mono, sr = ffmpeg_codec.decode(data, target_sample_rate=sampling_rate)
        audio = mono[None]
    if audio.shape[0] != 1:
        audio = audio.mean(axis=0, keepdims=True)
    if sr != sampling_rate:
        audio = resample_np(audio, sr, sampling_rate)
    return np.clip(audio, -1.0, 1.0)
