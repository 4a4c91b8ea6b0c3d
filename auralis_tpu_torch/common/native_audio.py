"""ctypes bindings for the first-party C++ host audio runtime
(native/libauralis_native.so): FLAC encode/decode, fast PCM conversion, and
the windowed-sinc resampler.

The reference delegates these to third-party native libraries (ffmpeg /
AudioSegment for codecs, torchaudio C++ for resampling — reference
common/definitions/output.py:119-187, common/utilities.py:93-94); here they
are first-party C++. The library is built on demand with `make -C native`;
every entry point has a numpy fallback so the framework works unbuilt.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parent.parent.parent / "native"
# installed deployments (where the repo layout is gone) point here instead
_LIB_PATH = Path(
    os.environ.get("AURALIS_NATIVE_LIB", _NATIVE_DIR / "libauralis_native.so")
)

_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_tried = False


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.at_abi_version.restype = ctypes.c_int
    lib.at_free.argtypes = [ctypes.c_void_p]
    lib.at_flac_encode.restype = ctypes.c_int
    lib.at_flac_encode.argtypes = [
        f32p, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(u8p), ctypes.POINTER(ctypes.c_int64),
    ]
    lib.at_flac_decode.restype = ctypes.c_int
    lib.at_flac_decode.argtypes = [
        u8p, ctypes.c_int64, ctypes.POINTER(f32p),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.at_f32_to_i16.argtypes = [f32p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int16)]
    lib.at_i16_to_f32.argtypes = [ctypes.POINTER(ctypes.c_int16), ctypes.c_int64, f32p]
    lib.at_peak_abs.restype = ctypes.c_float
    lib.at_peak_abs.argtypes = [f32p, ctypes.c_int64]
    lib.at_resample.restype = ctypes.c_int
    lib.at_resample.argtypes = [
        f32p, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.POINTER(f32p), ctypes.POINTER(ctypes.c_int64),
    ]
    return lib


def get_lib(build: bool = True) -> Optional[ctypes.CDLL]:
    """Load (building once if needed) the native library, or None."""
    global _lib, _lib_tried
    with _lib_lock:
        if _lib is not None:
            return _lib
        if _lib_tried:
            return None
        _lib_tried = True
        if not _LIB_PATH.exists() and build and (_NATIVE_DIR / "Makefile").exists():
            try:
                subprocess.run(
                    ["make", "-C", str(_NATIVE_DIR)],
                    check=True, capture_output=True, timeout=120,
                )
            except (subprocess.SubprocessError, OSError):
                return None
        if not _LIB_PATH.exists():
            return None
        try:
            _lib = _bind(ctypes.CDLL(str(_LIB_PATH)))
        except OSError:
            return None
        return _lib


def available() -> bool:
    return get_lib() is not None


# ------------------------------------------------------------------- FLAC

def flac_encode(
    samples: np.ndarray,
    sample_rate: int,
    bits_per_sample: int = 16,
    block_size: int = 4096,
) -> bytes:
    """Encode float32 PCM ([-1,1], [T] mono or [T, C<=2]) to a FLAC stream."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError(
            "native FLAC encoder unavailable (build native/ with `make -C native`)"
        )
    arr = np.ascontiguousarray(samples, np.float32)
    if arr.ndim == 1:
        channels, frames = 1, arr.shape[0]
    elif arr.ndim == 2 and arr.shape[1] in (1, 2):
        channels, frames = arr.shape[1], arr.shape[0]
    else:
        raise ValueError(f"expected [T] or [T, 1|2] samples, got {samples.shape}")
    out = ctypes.POINTER(ctypes.c_uint8)()
    out_len = ctypes.c_int64()
    rc = lib.at_flac_encode(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        frames, channels, int(sample_rate), int(bits_per_sample),
        int(block_size), ctypes.byref(out), ctypes.byref(out_len),
    )
    if rc != 0:
        raise ValueError(f"FLAC encode failed (code {rc})")
    try:
        return ctypes.string_at(out, out_len.value)
    finally:
        lib.at_free(out)


def flac_decode(data: bytes) -> Tuple[np.ndarray, int]:
    """Decode a FLAC stream -> (float32 [T] or [T, C], sample_rate).
    Full RFC 9639 subframe coverage: constant/verbatim/fixed/LPC with
    left/side, right/side and mid/side stereo decorrelation — libFLAC- and
    ffmpeg-encoded files decode first-party."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native FLAC decoder unavailable")
    buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
    out = ctypes.POINTER(ctypes.c_float)()
    frames = ctypes.c_int64()
    channels = ctypes.c_int()
    sr = ctypes.c_int()
    rc = lib.at_flac_decode(
        ctypes.cast(buf, ctypes.POINTER(ctypes.c_uint8)), len(data),
        ctypes.byref(out), ctypes.byref(frames), ctypes.byref(channels),
        ctypes.byref(sr),
    )
    if rc == -2:
        raise ValueError("unsupported FLAC feature")
    if rc != 0:
        raise ValueError(f"FLAC decode failed (code {rc})")
    try:
        n = frames.value * channels.value
        arr = np.ctypeslib.as_array(out, shape=(n,)).copy()
    finally:
        lib.at_free(out)
    if channels.value > 1:
        arr = arr.reshape(frames.value, channels.value)
    return arr, sr.value


# ------------------------------------------------------------- conversions

def f32_to_i16(samples: np.ndarray) -> np.ndarray:
    arr = np.ascontiguousarray(samples, np.float32)
    lib = get_lib()
    if lib is None:  # numpy fallback, same rounding
        return np.round(np.clip(arr, -1.0, 1.0) * 32767.0).astype(np.int16)
    out = np.empty(arr.shape, np.int16)
    lib.at_f32_to_i16(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), arr.size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
    )
    return out


def i16_to_f32(samples: np.ndarray) -> np.ndarray:
    arr = np.ascontiguousarray(samples, np.int16)
    lib = get_lib()
    if lib is None:
        return (arr.astype(np.float32)) / 32768.0
    out = np.empty(arr.shape, np.float32)
    lib.at_i16_to_f32(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), arr.size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out


# --------------------------------------------------------------- resampling

def resample(
    x: np.ndarray, orig_freq: int, new_freq: int,
    lowpass_filter_width: int = 6, rolloff: float = 0.99,
) -> np.ndarray:
    """Mono [T] float32 resample through the native kernel; numpy fallback."""
    lib = get_lib()
    if lib is None:
        from ..ops.resample import resample_np

        return resample_np(
            np.asarray(x, np.float32)[None], orig_freq, new_freq,
            lowpass_filter_width=lowpass_filter_width, rolloff=rolloff,
        )[0]
    arr = np.ascontiguousarray(x, np.float32)
    out = ctypes.POINTER(ctypes.c_float)()
    n_out = ctypes.c_int64()
    rc = lib.at_resample(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), arr.shape[-1],
        int(orig_freq), int(new_freq), int(lowpass_filter_width),
        float(rolloff), ctypes.byref(out), ctypes.byref(n_out),
    )
    if rc != 0:
        raise ValueError(f"native resample failed (code {rc})")
    try:
        return np.ctypeslib.as_array(out, shape=(n_out.value,)).copy()
    finally:
        lib.at_free(out)
