"""Decode attention with in-place K/V append on the slot cache (kernel K2).

Replaces the Pallas kernel `flash_decode_append_attention`
(auralis_tpu/ops/experimental/attention.py:151, body `_kernel` :34): for each
slot it writes this step's K/V row at `write_pos[s]` of `layer`, in place,
then runs online-softmax attention (f32 m/l/acc) over that slot's
`write_pos + 1` live keys only.

On the H100 (csrc/flash_decode.cu) one block runs per (slot, head); each
block appends only its own head's 64-lane slice, so the append needs no
cross-block ordering, and reads only the slot's live rows. The step is bound
by device-memory bandwidth: ~sum(live rows) x 4 KB of K/V reads per layer in
bf16 at H*D = 1024 (the header of the .cu file has the arithmetic).
"""
from __future__ import annotations

import math

import torch

from .. import _build

CHUNK = 256  # the cache's T dim is padded to a multiple of this (see gpt.make_kv_cache)


def flash_decode_plain(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                       k_cache: torch.Tensor, v_cache: torch.Tensor, layer: int,
                       write_pos: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel's math: index-put of the new rows
    (in place), then f32 softmax attention over cache[:write_pos+1] with f32
    probabilities. Returns ctx [S, H, D] in q's dtype. A write position
    outside [0, T) raises, as the kernel does."""
    s, h, d = q.shape
    t = k_cache.shape[2]
    slots = torch.arange(s, device=q.device)
    # a negative position would wrap around; send it past the end, so that
    # any position outside [0, T) fails the index-put (IndexError on the CPU,
    # a device-side assert on the card, with no host sync), as the kernel traps
    wp = torch.where(write_pos < 0, t, write_pos).long()
    k_cache[layer, slots, wp] = k_new.to(k_cache.dtype)
    v_cache[layer, slots, wp] = v_new.to(v_cache.dtype)
    kh = k_cache[layer, :s].float().reshape(s, t, h, d)
    vh = v_cache[layer, :s].float().reshape(s, t, h, d)
    qs = q.float() * (1.0 / math.sqrt(d))
    scores = torch.einsum("shd,sthd->sht", qs, kh)
    live = torch.arange(t, device=q.device)[None, :] <= wp[:, None]
    scores = scores.masked_fill(~live[:, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("sht,sthd->shd", probs, vh).to(q.dtype)


def flash_decode_append_attention(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                                  k_cache: torch.Tensor, v_cache: torch.Tensor, layer: int,
                                  write_pos: torch.Tensor) -> torch.Tensor:
    """q [S, H, D]; k_new/v_new [S, H*D]; caches [L, S, T, H*D] (updated in
    place); write_pos [S] int32 (= keys already cached = append index), each
    in [0, T). Returns ctx [S, H, D] in q's dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise. The kernel takes q and caches of one dtype, bf16 or f32. It reads
    write_pos on the device, so an out-of-range position is not caught here
    (that would cost a host sync per layer): the kernel traps, and the next
    synchronising call raises. Unlike the JAX function, which returns the
    aliased caches, the caches here are mutated in place and not returned."""
    if not q.is_cuda:
        return flash_decode_plain(q, k_new, v_new, k_cache, v_cache, layer, write_pos)
    _build.require_cuda(q, k_new, v_new, k_cache, v_cache, write_pos)
    s, h, d = q.shape
    n_layers, n_slots, t, hd = k_cache.shape
    if d != 64 or hd != h * d:
        raise ValueError(f"decode kernel needs head_dim 64 and H*D lanes; got {q.shape}, {k_cache.shape}")
    if v_cache.shape != k_cache.shape or v_cache.dtype != k_cache.dtype:
        raise ValueError("k_cache and v_cache must match")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("caches must be contiguous (they are updated in place)")
    if t % CHUNK:
        raise ValueError(f"cache T dim ({t}) must be a multiple of {CHUNK}")
    if s != n_slots or not 0 <= layer < n_layers:
        raise ValueError(f"slots {s} / layer {layer} outside cache {tuple(k_cache.shape)}")
    if k_cache.dtype not in (torch.bfloat16, torch.float32) or q.dtype != k_cache.dtype:
        raise ValueError(f"decode kernel needs q and caches in one dtype, bf16 or f32; "
                         f"got q={q.dtype} cache={k_cache.dtype}")
    if write_pos.dtype != torch.int32 or write_pos.shape != (s,):
        raise ValueError("write_pos must be int32 [S]")
    q = q.contiguous()
    k_new = k_new.to(k_cache.dtype).contiguous()
    v_new = v_new.to(k_cache.dtype).contiguous()
    write_pos = write_pos.contiguous()
    ctx = torch.empty((s, h, d), dtype=q.dtype, device=q.device)
    lib = _build.library()
    _build.check(
        lib.flash_decode_append(
            q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_cache.data_ptr(),
            v_cache.data_ptr(), write_pos.data_ptr(), ctx.data_ptr(),
            n_slots, h, t, int(layer), 1.0 / math.sqrt(d), int(q.dtype == torch.bfloat16),
            _build.stream_ptr(q.device),
        ),
        "flash_decode_append",
    )
    flash_decode_append_attention.launches += 1
    return ctx


flash_decode_append_attention.launches = 0
