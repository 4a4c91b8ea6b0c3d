"""Build and bind the port's CUDA kernels (auralis_tpu_torch/csrc/*.cu).

The sources are compiled by `nvcc` for sm_90a, one process per source, all
started together, and linked into ONE shared library with a plain C
interface, loaded with ctypes: no PyTorch headers, so a build takes
seconds. The library lands in `auralis_tpu_torch/_build/`, named by a
hash of the sources and flags, on first use; later calls in any process
reuse it. A failed build raises: nothing falls back to the plain versions.

Every C entry point takes raw device pointers and the CUDA stream as
`void*`, launches on that stream without synchronising, and returns
`cudaGetLastError()` as an int; `check` raises on a non-zero code.
"""
from __future__ import annotations

import contextlib
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
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C signature of every entry point: name -> argument types (restype is int)
SIGNATURES = {
    # q, k, v, out, T, H, row_stride, length (int32 on the device), scale,
    # is_bf16, stream
    "prefill_attention": [_P, _P, _P, _P, _I, _I, _I, _P, _F, _I, _P],
    # q, k_new, v_new, k_cache, v_cache, write_pos, ctx, partials, tickets,
    # S (the step's), S_cache, H, the row stride of q, k_new and v_new, T,
    # layer, split, scale, is_bf16 (q, rows and caches), stream
    "flash_decode_append": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                            _F, _I, _P],
    # q, k_new, v_new (bf16), k_cache, v_cache, k_scale, v_scale, write_pos, ctx,
    # partials, tickets, k_row_scale, v_row_scale (f32 [S] or both NULL), S (the
    # step's), S_cache, H, T, layer, split, attn_scale, stream
    "ragged_decode": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                      _I, _F, _P],
    # x (bf16), fc_wq, fc_ws, fc_b, proj_wq, proj_ws, proj_b, g, gmax, part,
    # tickets, out (bf16), S, D, I, tile_i, stream
    "fused_mlp_w8": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # cudaGraph_t, counts (int[2]: full and programmatic edges)
    "graph_edge_types": [_P, _P],
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
            _build(so)
            build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(so))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def _build(so: Path) -> None:
    """Compile every source to an object file in parallel, then link `so`."""
    work = so.with_name(f"{so.stem}.{os.getpid()}.objs")
    work.mkdir(exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    for src in sources():
        cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o",
               str(work / f"{src.stem}.o"), str(src)]
        jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                           text=True)))
    failed = []
    for cmd, proc in jobs:  # wait for every compiler before reporting any failure
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{out}\n{err}")
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    if not failed:
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *(str(work / f"{src.stem}.o")
                                                               for src in sources())]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    shutil.rmtree(work, ignore_errors=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    os.replace(tmp, so)


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {code}")


_capturing = threading.local()


def count_launch(wrapper) -> None:
    """Count one launch of `wrapper`'s kernel in `wrapper.launches`. While
    this thread captures a CUDA graph (`tally_launches`), the launch goes
    into the capture's tally instead: a capture runs nothing, and each
    replay of the graph adds the tally (runtime/graphs.py)."""
    tally = getattr(_capturing, "tally", None)
    if tally is None:
        wrapper.launches += 1
    else:
        tally[wrapper] = tally.get(wrapper, 0) + 1


@contextlib.contextmanager
def tally_launches():
    """Within the block, this thread's kernel launches are tallied in the
    yielded dict {wrapper: count} and not counted on the wrappers."""
    tally: dict = {}
    _capturing.tally = tally
    try:
        yield tally
    finally:
        _capturing.tally = None


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
