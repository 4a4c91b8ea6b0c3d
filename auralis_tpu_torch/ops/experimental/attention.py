"""Decode attention with in-place K/V append on the slot cache: kernels K2
(bf16/f32 cache) and K4 (int8 cache with per-token scales).

K2 replaces the Pallas kernel `flash_decode_append_attention`
(auralis_tpu/ops/experimental/attention.py:151, body `_kernel` :34): for each
slot it writes this step's K/V row at `write_pos[s]` of `layer`, in place,
then runs online-softmax attention (f32 m/l/acc) over that slot's
`write_pos + 1` live keys only.

K4 replaces `ragged_decode_attention` (:436, body `_ragged_kernel` :245):
the same append and live-length attention on the int8 cache. The new rows
are quantised per slot over all H*D lanes, or at scales the caller gives
(a model shard's lanes at the whole row's scale, as the JAX kernel takes
its scales as inputs), q per (slot, head); scores are
int8 x int8 dot products scaled by the key's and the query's scale; the
context sums p x v_scale x v_int8 in f32 (csrc/ragged_decode.cu).

On the H100 both are split-K flash-decoding kernels (csrc/flash_decode.cu,
csrc/ragged_decode.cu, shared helpers in csrc/common.cuh). The cache's T
rows are cut into splits of DECODE_SPLIT rows (`split_plan`), and one block
of 4 warps runs per (head, slot, split). The grid depends only on T, never
on `write_pos`, which the host does not read (no sync; the launch can be
captured in a CUDA graph). A block whose split starts past `write_pos[s]`
returns at once; the others stage their live K and V rows in shared memory
with coalesced 16-byte `cp.async` copies, run QK with lanes across each row,
an f32 softmax over the split, and PV with lanes across the head dims. The
block of the split that holds `write_pos[s]` alone appends the new row (K4:
quantises it first), and no block reads it back from the cache. Each split
leaves (m, l, acc) in a workspace that the wrapper allocates once per
(device, S, H, splits); the last split of a (slot, head) to arrive merges
them in split order (the math of `combine_splits_plain`), so ctx does not
depend on the order in which blocks finish. Both kernels are bound by
device-memory bandwidth: per layer, the live rows' K and V (~4 KB a row in
bf16, ~2 KB in int8 at H*D = 1024), from HBM on a real step, since each
layer's slab is a different one.
"""
from __future__ import annotations

import math

import torch

from .. import _build
from ..quant import quantize_rows

CHUNK = 256  # the cache's T dim is padded to a multiple of this (see gpt.make_kv_cache)
DECODE_SPLIT = 128  # rows per split of K2 and K4 (kSplitRows in csrc/common.cuh)
PARTIAL_FLOATS = 4 + 64  # one split's (m, l, 2 pad, acc[64]) record (kPartialFloats)


def split_plan(t_max: int, split: int = DECODE_SPLIT) -> list[tuple[int, int]]:
    """The row ranges [start, end) into which K2 and K4 cut a cache of
    `t_max` rows: t_max / split splits of `split` rows, one block each per
    (head, slot). The launch shape depends on nothing else."""
    if t_max <= 0 or t_max % CHUNK or split <= 0 or CHUNK % split:
        raise ValueError(f"cache T ({t_max}) must be a positive multiple of {CHUNK}, and the "
                         f"split ({split}) must divide {CHUNK}")
    return [(start, start + split) for start in range(0, t_max, split)]


def combine_splits_plain(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernels' merge of per-split partials: m, l
    [..., n] (each split's largest logit and sum of exp(logit - m)) and acc
    [..., n, D] (its sum of exp(logit - m) v). An empty split has m = -inf,
    l = 0 and weighs nothing; all splits empty give 0, not NaN. Returns
    sum_i acc_i e^(m_i - M) / max(sum_i l_i e^(m_i - M), 1e-9), M = max_i m_i."""
    mx = m.amax(dim=-1, keepdim=True)
    w = torch.where(m == float("-inf"), torch.zeros_like(m), torch.exp(m - mx))
    total = (l * w).sum(dim=-1)
    return (acc * w[..., None]).sum(dim=-2) / torch.clamp(total, min=1e-9)[..., None]


_workspaces: dict = {}


def _split_workspace(device: torch.device, s: int, h: int, n_splits: int):
    """(partials [S, H, n_splits, PARTIAL_FLOATS] f32, tickets [S, H] int32,
    zero), allocated once per (device, S, H, n_splits), S the grid's (the
    step's slot count, not the cache's), and reused by every
    later launch: the kernels allocate nothing and leave the tickets at zero.
    Launches that share a workspace must not run concurrently (one stream)."""
    key = (device, s, h, n_splits)
    ws = _workspaces.get(key)
    if ws is None:
        ws = (torch.empty((s, h, n_splits, PARTIAL_FLOATS), dtype=torch.float32, device=device),
              torch.zeros((s, h), dtype=torch.int32, device=device))
        _workspaces[key] = ws
    return ws


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
    """q [S, H, D]; k_new/v_new [S, H*D]; caches [L, S_cache, T, H*D]
    (updated in place) with S <= S_cache: the step covers cache slots
    0..S-1 and leaves the others untouched, as the JAX kernel's grid over
    q's slots does; write_pos [S] int32 (= keys already cached = append
    index), each in [0, T). Returns ctx [S, H, D] in q's dtype.

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
    n_splits = len(split_plan(t))
    if not 0 < s <= n_slots or not 0 <= layer < n_layers:
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
    partials, tickets = _split_workspace(q.device, s, h, n_splits)
    lib = _build.library()
    _build.check(
        lib.flash_decode_append(
            q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_cache.data_ptr(),
            v_cache.data_ptr(), write_pos.data_ptr(), ctx.data_ptr(), partials.data_ptr(),
            tickets.data_ptr(), s, n_slots, h, t, int(layer), DECODE_SPLIT, 1.0 / math.sqrt(d),
            int(q.dtype == torch.bfloat16), _build.stream_ptr(q.device),
        ),
        "flash_decode_append",
    )
    _build.count_launch(flash_decode_append_attention)
    return ctx


flash_decode_append_attention.launches = 0


def ragged_decode_plain(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                        attn_scale: float, layer: int, write_pos: torch.Tensor,
                        k_cache: torch.Tensor, v_cache: torch.Tensor, k_scale: torch.Tensor,
                        v_scale: torch.Tensor, row_scales: tuple | None = None) -> torch.Tensor:
    """Plain PyTorch version of K4's math: quantise the new rows (per slot
    over H*D lanes, or at the given `row_scales`) and q (per slot and head),
    index-put the int8 rows and their scales (in place), then f32 softmax
    over the `write_pos + 1` live keys of int8 scores x k-scale x (q-scale x
    attn_scale), with the context sum(p x v_scale x v_int8) / max(sum p,
    1e-9). Returns ctx [S, H*D] f32. A write position outside [0, T)
    raises, as the kernel traps."""
    s, h, d = q.shape
    t = k_cache.shape[2]
    slots = torch.arange(s, device=q.device)
    wp = torch.where(write_pos < 0, t, write_pos).long()  # see flash_decode_plain
    given = (None, None) if row_scales is None else row_scales
    for rows, scales, new, sc in ((k_cache, k_scale, k_new, given[0]),
                                  (v_cache, v_scale, v_new, given[1])):
        rows[layer, slots, wp], scales[layer, slots, wp] = quantize_rows(new, scale=sc)
    q_i8, q_s = quantize_rows(q)  # [S, H, D], [S, H]
    kh = k_cache[layer, :s].float().reshape(s, t, h, d)
    vh = v_cache[layer, :s].float().reshape(s, t, h, d)
    # integer scores (exact in f32: 64 products of magnitude <= 127^2)
    scores = torch.einsum("shd,sthd->sht", q_i8.float(), kh)
    logits = scores * k_scale[layer, :s][:, None, :] * (q_s * attn_scale)[:, :, None]
    live = torch.arange(t, device=q.device)[None, :] <= wp[:, None]
    logits = logits.masked_fill(~live[:, None, :], float("-inf"))
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    acc = torch.einsum("sht,sthd->shd", p * v_scale[layer, :s][:, None, :], vh)
    return (acc / torch.clamp(p.sum(dim=-1), min=1e-9)[:, :, None]).reshape(s, h * d)


def ragged_decode_attention(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                            attn_scale: float, layer: int, write_pos: torch.Tensor,
                            k_cache: torch.Tensor, v_cache: torch.Tensor,
                            k_scale: torch.Tensor, v_scale: torch.Tensor,
                            row_scales: tuple | None = None) -> torch.Tensor:
    """q [S, H, D] and k_new/v_new [S, H*D] (before quantisation); int8
    caches [L, S_cache, T, H*D] and f32 scales [L, S_cache, T] (updated in
    place) with S <= S_cache: the step covers cache slots 0..S-1 only;
    write_pos [S] int32 (= keys already cached = append index), each in
    [0, T). `row_scales` (k_s, v_s), each [S] f32, are the new rows' scales
    when the caller has them: a model shard's H heads are some lanes of a
    wider row, whose scale is over all its lanes (JAX's kernel takes them
    as inputs too). Without them the rows' scales are over their H*D lanes.
    Returns ctx [S, H*D] f32.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise. The kernel takes bf16 q and rows (the int8 decode path's
    activation dtype) and quantises them itself, with results bit-equal to
    `quantize_rows` (at the given scales, when given). An out-of-range
    position traps the kernel (no host sync here), and the next
    synchronising call raises. Unlike the JAX function, the caches are
    mutated in place and not returned."""
    if not q.is_cuda:
        return ragged_decode_plain(q, k_new, v_new, attn_scale, layer, write_pos,
                                   k_cache, v_cache, k_scale, v_scale, row_scales)
    _build.require_cuda(q, k_new, v_new, k_cache, v_cache, k_scale, v_scale, write_pos,
                        *(row_scales or ()))
    s, h, d = q.shape
    n_layers, n_slots, t, hd = k_cache.shape
    if d != 64 or hd != h * d:
        raise ValueError(f"K4 needs head_dim 64 and H*D lanes; got {q.shape}, {k_cache.shape}")
    if k_cache.dtype != torch.int8 or v_cache.shape != k_cache.shape or v_cache.dtype != torch.int8:
        raise ValueError("K4 needs int8 k_cache and v_cache of one shape")
    for sc in (k_scale, v_scale):
        if sc.dtype != torch.float32 or sc.shape != k_cache.shape[:3]:
            raise ValueError(f"scales must be f32 {tuple(k_cache.shape[:3])}, got {sc.dtype} "
                             f"{tuple(sc.shape)}")
    if not all(x.is_contiguous() for x in (k_cache, v_cache, k_scale, v_scale)):
        raise ValueError("caches and scales must be contiguous (they are updated in place)")
    n_splits = len(split_plan(t))
    if not 0 < s <= n_slots or not 0 <= layer < n_layers:
        raise ValueError(f"slots {s} / layer {layer} outside cache {tuple(k_cache.shape)}")
    if not q.dtype == k_new.dtype == v_new.dtype == torch.bfloat16:
        raise ValueError(f"K4 takes bf16 q and rows, got {q.dtype}, {k_new.dtype}, {v_new.dtype}")
    if write_pos.dtype != torch.int32 or write_pos.shape != (s,):
        raise ValueError("write_pos must be int32 [S]")
    if row_scales is not None:
        if len(row_scales) != 2 or any(
                sc.dtype != torch.float32 or sc.shape != (s,) for sc in row_scales):
            raise ValueError("row_scales must be two f32 [S] tensors (k_s, v_s)")
        row_scales = tuple(sc.contiguous() for sc in row_scales)
    q = q.contiguous()
    k_new = k_new.contiguous()
    v_new = v_new.contiguous()
    write_pos = write_pos.contiguous()
    ctx = torch.empty((s, hd), dtype=torch.float32, device=q.device)
    partials, tickets = _split_workspace(q.device, s, h, n_splits)
    lib = _build.library()
    _build.check(
        lib.ragged_decode(
            q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_cache.data_ptr(),
            v_cache.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(), write_pos.data_ptr(),
            ctx.data_ptr(), partials.data_ptr(), tickets.data_ptr(),
            *((None, None) if row_scales is None else (sc.data_ptr() for sc in row_scales)),
            s, n_slots, h, t, int(layer), DECODE_SPLIT, float(attn_scale),
            _build.stream_ptr(q.device),
        ),
        "ragged_decode",
    )
    _build.count_launch(ragged_decode_attention)
    return ctx


ragged_decode_attention.launches = 0
