"""Build and bind the port's CUDA kernels (auralis_tpu_torch/csrc/*.cu).

The sources are compiled by `nvcc` for sm_90a into ONE shared library with a
plain C interface and loaded with ctypes: no PyTorch headers, so a build
takes seconds. The library lands in `auralis_tpu_torch/_build/`, named by a
hash of the sources and flags, on first use; later calls in any process
reuse it. A failed build raises: nothing falls back to the plain versions.

Every C entry point takes raw device pointers and the CUDA stream as
`void*`, launches on that stream without synchronising, and returns
`cudaGetLastError()` as an int; `check` raises on a non-zero code.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C signature of every entry point: name -> argument types (restype is int)
SIGNATURES = {
    # q, k, v, out, T, H, row_stride, length, scale, is_bf16, stream
    "prefill_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
    # q, k_new, v_new, k_cache, v_cache, write_pos, ctx,
    # S, H, T, layer, scale, is_bf16 (q, rows and caches), stream
    "flash_decode_append": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
    # src, w, b, out, B, T, C, K, dilation, is_bf16, src_is_f32, stream
    "mrf_conv_lrelu": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # act, res, w, b, y, acc, out, B, T, C, K, dilation, is_bf16, res_is_f32,
    # epilogue (0 none, 1 chain end: acc(+)=z, 2 stage end: out=(acc+z)/n),
    # first_chain, n_chains, stream
    "mrf_conv_residual": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                          _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # wall time of this process's build (None: not built)


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def _digest() -> str:
    h = hashlib.sha256()
    for p in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library() -> ctypes.CDLL:
    """The bound kernel library, built on first call (thread-safe)."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        so = BUILD_DIR / f"libauralis_kernels_{_digest()}.so"
        if not so.exists():
            t0 = time.perf_counter()
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *ARCH_FLAGS, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   *map(str, sources())]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                    f"{proc.stdout}\n{proc.stderr}"
                )
            os.replace(tmp, so)
            build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(so))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {code}")


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def require_cuda(*tensors) -> None:
    """Kernel wrappers take CUDA tensors only (CPU tensors use the plain
    version before reaching here); everything must sit on one device."""
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"expected CUDA tensors on {dev}, got {t.device}")
