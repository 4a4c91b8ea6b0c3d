"""Optional external-encoder bridge for compressed audio codecs.

The reference delegates mp3/opus/aac encoding to torchaudio, which in turn
shells out to ffmpeg (reference: common/definitions/output.py:119-187).
This module is the equivalent seam: when an `ffmpeg` binary is present on
PATH (the shipped Docker image installs one), TTSOutput.to_bytes gains
mp3/opus/aac support by piping raw PCM through it; when absent, callers
fall back to the first-party codecs (wav/flac/pcm) with a clear error.

Nothing here touches the device path — encoding runs host-side on the
final waveform, exactly like the reference.
"""
from __future__ import annotations

import functools
import shutil
import subprocess

import numpy as np

# (ffmpeg muxer, codec, default kbps) per supported compressed format
_FORMATS = {
    "mp3": ("mp3", "libmp3lame", 192),
    "opus": ("ogg", "libopus", 128),
    "aac": ("adts", "aac", 192),
}


@functools.lru_cache(maxsize=1)
def ffmpeg_path() -> str | None:
    return shutil.which("ffmpeg")


def available() -> bool:
    return ffmpeg_path() is not None


def supported_formats() -> tuple[str, ...]:
    return tuple(_FORMATS) if available() else ()


def encode(
    wav: np.ndarray,
    sample_rate: int,
    format: str,
    bitrate_kbps: int | None = None,
) -> bytes:
    """Encode a mono float waveform in [-1, 1] to `format` bytes via ffmpeg."""
    if format not in _FORMATS:
        raise ValueError(f"Unknown compressed format: {format}")
    exe = ffmpeg_path()
    if exe is None:
        raise RuntimeError(
            f"'{format}' encoding needs an ffmpeg binary on PATH "
            "(none found); use format='wav', 'flac' or 'pcm'"
        )
    muxer, codec, default_kbps = _FORMATS[format]
    kbps = bitrate_kbps or default_kbps
    # round-to-nearest matches the other float->int16 paths (native_audio,
    # vocoder); truncation would bias the lossy encoder input by up to 1 LSB
    pcm = np.round(np.clip(np.asarray(wav, np.float32), -1.0, 1.0) * 32767.0).astype("<i2")
    cmd = [
        exe, "-hide_banner", "-loglevel", "error",
        "-f", "s16le", "-ar", str(sample_rate), "-ac", "1", "-i", "pipe:0",
        "-codec:a", codec, "-b:a", f"{kbps}k",
        "-f", muxer, "pipe:1",
    ]
    proc = subprocess.run(cmd, input=pcm.tobytes(), capture_output=True)
    if proc.returncode != 0 or not proc.stdout:
        raise RuntimeError(
            f"ffmpeg {format} encode failed (rc={proc.returncode}): "
            f"{proc.stderr.decode(errors='replace').strip()[:500]}"
        )
    return proc.stdout


def decode(
    data: bytes, target_sample_rate: int | None = None
) -> tuple[np.ndarray, int]:
    """Decode compressed audio bytes -> (mono float32 waveform, sample_rate).

    With `target_sample_rate`, ffmpeg resamples directly to it in one pass
    (callers that would otherwise sinc-resample the result again should pass
    their model rate here). Without it, the source rate is probed via
    ffprobe, falling back to 48 kHz."""
    exe = ffmpeg_path()
    if exe is None:
        raise RuntimeError(
            "Decoding this compressed format needs an ffmpeg binary on PATH "
            "(none found); supported first-party inputs are wav and flac"
        )
    sr = target_sample_rate or _probe_sample_rate(data) or 48000
    cmd = [
        exe, "-hide_banner", "-loglevel", "error",
        "-i", "pipe:0",
        "-f", "f32le", "-acodec", "pcm_f32le", "-ac", "1", "-ar", str(sr),
        "pipe:1",
    ]
    proc = subprocess.run(cmd, input=data, capture_output=True)
    if proc.returncode != 0 or not proc.stdout:
        raise RuntimeError(
            f"ffmpeg decode failed (rc={proc.returncode}): "
            f"{proc.stderr.decode(errors='replace').strip()[:500]}"
        )
    return np.frombuffer(proc.stdout, dtype=np.float32).copy(), sr


def _probe_sample_rate(data: bytes) -> int | None:
    exe = shutil.which("ffprobe")
    if exe is None:
        return None
    cmd = [
        exe, "-hide_banner", "-loglevel", "error",
        "-select_streams", "a:0",
        "-show_entries", "stream=sample_rate",
        "-of", "default=noprint_wrappers=1:nokey=1",
        "-i", "pipe:0",
    ]
    proc = subprocess.run(cmd, input=data, capture_output=True)
    try:
        return int(proc.stdout.decode().strip().splitlines()[0])
    except (ValueError, IndexError):
        return None
