"""The XTTS audio-token GPT as plain torch functions on a parameter dict.

Counterpart of auralis_tpu/models/xttsv2/gpt.py. The parameter dict has the
JAX package's keys and layouts (per-layer tensors stacked on a leading [L]
axis, dense weights [Din, Dout], the int8 copy of the four block matmul
weights under `blocks_q8`), and the sequence semantics are the same:
prompt = `[cond ⊕ text] + embed(start_audio)`; generated token i gets
`wte[tok] + wpe[i]`; logits = `mel_head(final_norm(ln_f(h)))`; vocoder
latent = `final_norm(final_norm(ln_f(h)))` (the reference's double
final_norm).

Differences from the JAX module:
- the KV cache (and its scale rows) is updated IN PLACE (the JAX functions
  return a new cache);
- layers run as a Python loop (what `unroll_layers` asked XLA for);
- `prefill_flash` routes prefill attention through kernel K1
  (ops/prefill_attention.py); `decode_route` routes decode attention:
  `flash_decode` through kernel K2 and `kv_int8` + `ragged_decode` through
  kernel K4 (ops/experimental/attention.py), otherwise the dense masked
  bodies below, in the cache dtype or, under `kv_int8`, on int8 rows with
  per-token scales;
- the int8 x int8 products that XLA runs as int32 dots are `torch._int_mm`
  (ops/quant.py) for the W8A8 matmuls and exact f32/f64 sums of integers in
  the dense int8 attention body;
- the per-call values of a prefill (the single prefill's length and slot,
  the batched prefill's lengths and slots) may be device tensors, which no
  code path reads on the host, so a prefill can replay inside a captured
  CUDA graph (runtime/graphs.py) as the JAX functions take traced scalars;
  Python numbers are accepted too;
- the batched prefill takes its target slots as host ints, whose padding
  lanes (slot >= num_slots) are skipped on the host instead of by a dropping
  scatter, or as a device tensor of distinct real slots (no padding lane:
  torch's index writes neither drop out-of-range indices nor define
  duplicates);
- under a mesh (`ShardedParams`, `ShardedKVCache`: parallel/mesh.py) the
  layers run model-sharded, each shard over its heads and MLP columns, with
  the row-parallel products summed in shard order on every shard's device
  (the all-reduce GSPMD emits for the JAX package's sharded params); the
  head count comes from the weights a call receives.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ...ops.experimental.attention import (
    CHUNK,
    flash_decode_append_attention,
    ragged_decode_attention,
)
from ...ops.prefill_attention import prefill_flash_attention
from ...ops.quant import int8_mm, int8_weight, pad_rows
from ...ops.quant import quantize_rows as _quantize_rows
from ...ops.quant import row_scales as _row_scales
from .config import XTTSGPTConfig


@dataclass
class KVCache:
    """Dense slot-batched KV cache: k/v are [L, S, T_pad, H*Dh], heads flat
    in the minor dimension (the JAX layout), T padded to the 256-row chunk.
    With cfg.kv_int8 k/v are int8 and `k_scale`/`v_scale` hold the
    per-(layer, slot, token) f32 dequantisation scales [L, S, T_pad]."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None

    @property
    def num_slots(self) -> int:
        return self.k.shape[1]

    @property
    def max_len(self) -> int:
        return self.k.shape[2]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def dtype(self) -> torch.dtype:
        return self.k.dtype

    def tensors(self) -> list[torch.Tensor]:
        """Every tensor of the cache: rows, and scales under kv_int8."""
        return [t for t in (self.k, self.v, self.k_scale, self.v_scale) if t is not None]


# the routes that read each slot's rows to its own length, not to the bound
READS_BY_LENGTH = frozenset({"k2", "k4"})


def decode_route(cfg: XTTSGPTConfig) -> str:
    """The decode attention the flags pick, the one reader of flash_decode
    and ragged_decode: "k2", "k4" (kv_int8 + ragged_decode), "int8" (the
    dense int8 body) or "dense". Raises on flags no cache serves."""
    if cfg.ragged_decode and not cfg.kv_int8:
        raise ValueError("ragged_decode composes with (requires) kv_int8")
    if cfg.kv_int8:
        if cfg.flash_decode:
            raise ValueError("kv_int8 and flash_decode are exclusive")
        return "k4" if cfg.ragged_decode else "int8"
    return "k2" if cfg.flash_decode else "dense"


def make_kv_cache(cfg: XTTSGPTConfig, num_slots: int, dtype=torch.bfloat16,
                  device="cuda") -> KVCache:
    """Zeroed cache in `dtype` on `device` (the card unless the caller names
    another; raises without one); under cfg.kv_int8 int8 rows with scales
    initialised to ones (`dtype` is then unused)."""
    t_pad = -(-cfg.max_seq_len // CHUNK) * CHUNK
    shape = (cfg.num_hidden_layers, num_slots, t_pad, cfg.num_attention_heads * cfg.head_dim)
    decode_route(cfg)
    if cfg.kv_int8:
        return KVCache(torch.zeros(shape, dtype=torch.int8, device=device),
                       torch.zeros(shape, dtype=torch.int8, device=device),
                       torch.ones(shape[:3], dtype=torch.float32, device=device),
                       torch.ones(shape[:3], dtype=torch.float32, device=device))
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


# ------------------------------------------------- int8 decode weights (W8A8)


def quantize_decode_weights(blocks: dict) -> dict:
    """Per-(layer, output-channel) symmetric int8 quantisation of the four
    block matmul weights [L, Din, Dout]: the `blocks_q8` dict that the W8A8
    matmuls of `gpt_prefill` (cfg.prefill_w8a8) and `gpt_decode_step`
    (cfg.decode_w8a8) read. Bit-equal to the JAX function under jit; the
    int8 weights are laid out by `int8_weight` (same values, faster GEMM)."""
    out = {}
    for name in ("attn_w", "attn_proj_w", "fc_w", "fc_proj_w"):
        w = blocks[name].float()
        s = torch.clamp(w.abs().amax(dim=1), min=1e-8) * (1.0 / 127.0)  # [L, Dout], see quant.py
        out[name + "_q"] = int8_weight(torch.round(w / s[:, None, :]).to(torch.int8))
        out[name + "_s"] = s
    return out


def _dot_w8a8(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
              b: torch.Tensor) -> torch.Tensor:
    """x [S, Din] (bf16/f32) @ int8 weight [Din, Dout] with per-output-channel
    scales [Dout]: per-row activation quantisation, exact int32 product,
    rescale and bias in f32, result in x's dtype."""
    xq, xs = _quantize_rows(x)
    # int32 * f32 promotes to f32 as .float() would; the bias joins in f32
    return torch.mul(int8_mm(xq, wq), xs[:, None]).mul_(ws).add_(b).to(x.dtype)


# -------------------------------------------------------------------- math


def device_scalar(x, dtype: torch.dtype, device) -> torch.Tensor:
    """A per-call value as a 0-d `dtype` tensor on `device`: a tensor (a
    captured program's staged input) is cast without a host read, a Python
    or numpy number is written by a fill (no upload)."""
    if torch.is_tensor(x):
        return x.to(device=device, dtype=dtype)
    return torch.full((), x, dtype=dtype, device=device)


def device_values(x, dtype: torch.dtype, device) -> torch.Tensor:
    """Per-lane values as a `dtype` tensor on `device`: a tensor is cast
    without a host read, host numbers are uploaded."""
    if torch.is_tensor(x):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(x, dtype=dtype, device=device)



def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm computed in f32 regardless of activation dtype, result in
    x's dtype. With scale and bias in x's dtype one kernel does it: torch's
    LayerNorm on bf16 reduces and normalises in f32 and rounds once."""
    if x.dtype == scale.dtype == bias.dtype:
        return F.layer_norm(x, (x.shape[-1],), scale, bias, eps)
    y = F.layer_norm(x.float(), (x.shape[-1],), scale.float(), bias.float(), eps)
    return y.to(x.dtype)


def _dot(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """x [.., Din] @ w [Din, Dout] (+ b) in the promoted dtype of x and w (as
    jnp.dot promotes bf16 activations against f32 weights), result in x's
    dtype."""
    dt = torch.promote_types(x.dtype, w.dtype)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).to(dt)
    y = torch.mm(x2, w.to(dt)) if b is None else torch.addmm(b.to(dt), x2, w.to(dt))
    return y.reshape(*lead, w.shape[-1]).to(x.dtype)


def _gelu(y: torch.Tensor) -> torch.Tensor:
    return F.gelu(y)  # exact erf GELU, computed in f32 on bf16 too


def text_embeddings(params: dict, token_ids: torch.Tensor) -> torch.Tensor:
    """[T] -> [T, D]: text wte + learned text positions."""
    t = token_ids.shape[0]
    return params["text_wte"][token_ids] + params["text_wpe"][:t]


def start_audio_embedding(params: dict, cfg: XTTSGPTConfig) -> torch.Tensor:
    """embed(start_audio) = wte[start] + wpe[0]."""
    return params["wte"][cfg.start_audio_token] + params["wpe"][0]


def heads(params: dict, h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """h (pre-ln_f) -> (mel logits f32, vocoder latent)."""
    g = layer_norm(h, params["ln_f_scale"], params["ln_f_bias"])
    f1 = layer_norm(g, params["final_norm_scale"], params["final_norm_bias"])
    logits = _dot(f1, params["mel_head_w"], params["mel_head_b"]).float()
    latent = layer_norm(f1, params["final_norm_scale"], params["final_norm_bias"])
    return logits, latent


def _mm(params: dict, layer: int, name: str, x: torch.Tensor, w8: bool) -> torch.Tensor:
    """x [..., Din] @ blocks[name][layer] + its bias; W8A8 against blocks_q8
    when `w8`, on the rows of x flattened to [N, Din] (each row quantised on
    its own, as the JAX batched prefill flattens [K, T])."""
    bias = params["blocks"][name[:-2] + "_b"][layer]
    if w8:
        bq = params["blocks_q8"]
        flat = _dot_w8a8(x.reshape(-1, x.shape[-1]), bq[name + "_q"][layer],
                         bq[name + "_s"][layer], bias)
        return flat.reshape(*x.shape[:-1], flat.shape[-1])
    return _dot(x, params["blocks"][name][layer], bias)


def _mlp(params: dict, layer: int, x: torch.Tensor, w8: bool) -> torch.Tensor:
    bp = params["blocks"]
    xn = layer_norm(x, bp["ln2_scale"][layer], bp["ln2_bias"][layer])
    y = _gelu(_mm(params, layer, "fc_w", xn, w8))
    return x + _mm(params, layer, "fc_proj_w", y, w8)


# --------------------------------------------------------- attention bodies


def _prefill_attention_batched(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               mask: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Dense masked prompt attention of K lanes (one for a single prompt): q/k/v
    [K, T, H, Dh], mask [K, T, T] -> ctx [K, T, H, Dh] f32, probabilities in `dtype`."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (1.0 / math.sqrt(q.shape[-1]))
    scores = scores.masked_fill(~mask[:, None], torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [B, M, K] @ b [B, K, N] -> [B, M, N] f32, with f32 sums. On the card
    one batched tensor-core product reads bf16 (or f16) operands as they are
    stored: a strided view whose rows, or columns, are contiguous is read in
    place, whatever its batch stride. The CPU has no such kernel, so there
    the operands are upcast first. Products of bf16 values are exact in f32,
    so the two compute the same function up to the order of the sums."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _dense_attention(cache: KVCache, layer: int, q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor, slot_idx: torch.Tensor, lens: torch.Tensor,
                     live: torch.Tensor, onehot: torch.Tensor, scale: float) -> torch.Tensor:
    """The dense body of the JAX decode step
    (auralis_tpu/models/xttsv2/gpt.py:574-605): scatter the new rows q/k/v
    [S, HD] at `lens`, then masked softmax over the flat [T, H*Dh] cache's
    first `live.shape[1]` rows; onehot [HD, H] maps lanes to heads. Returns
    ctx [S, HD] f32.

    Precision, as the JAX body's: the operands of both products are in the
    cache dtype (the cache rows, q times the scale rounded once, the
    probabilities rounded once after an f32 masked softmax); their products
    are exact in f32 and summed in f32. The cache rows are read in place,
    never copied: an f32 copy of [S, bound, HD] would cost more than the
    products themselves."""
    s, bound = live.shape
    nh = onehot.shape[1]
    dt = cache.k.dtype
    cache.k[layer, slot_idx, lens] = k.to(dt)
    cache.v[layer, slot_idx, lens] = v.to(dt)
    k_all = cache.k[layer, :s, :bound]  # [S, bound, HD], a view
    v_all = cache.v[layer, :s, :bound]
    # qmat[s, h]: q[s] times the scale on head h's lanes, zero on the others
    qmat = (q * scale).to(dt)[:, None, :] * onehot.T[None].to(dt)  # [S, H, HD]
    scores = _bmm_f32(qmat, k_all.transpose(1, 2))  # [S, H, bound]
    scores = torch.where(live[:, None, :], scores, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(dt)
    ctx_full = _bmm_f32(probs, v_all)  # [S, H, HD]: every head against every lane
    # each head's own lanes: ctx[s, h*Dh + d] = ctx_full[s, h, h*Dh + d]
    ctx = torch.diagonal(ctx_full.view(s, nh, nh, -1), dim1=1, dim2=2)  # [S, Dh, H]
    return ctx.transpose(1, 2).reshape(s, -1)


# ----------------------------------------------------------------- prefill


@torch.no_grad()
def gpt_prefill(params: dict, cfg: XTTSGPTConfig, embeds: torch.Tensor,
                length: int | torch.Tensor, slot: int | torch.Tensor,
                cache: KVCache) -> torch.Tensor:
    """Run the prompt `embeds` [T_pad, D] (zero-padded past `length`) through
    all layers, write its K/V rows (int8 + scales under cfg.kv_int8) into
    cache[:, slot, :T_pad] IN PLACE, and return the last real position's
    hidden state (pre-ln_f) [D]. `length` and `slot` are ints or 0-d integer
    tensors on the device (read there only). With cfg.prefill_w8a8 and
    `blocks_q8` in params the four matmuls run W8A8."""
    if isinstance(params, ShardedParams):
        return _gpt_prefill_tp(params, cfg, embeds, length, slot, cache)
    t_pad, d = embeds.shape
    hd = cfg.head_dim
    bp = params["blocks"]
    nh = bp["attn_w"].shape[-1] // (3 * hd)
    w8 = cfg.prefill_w8a8 and "blocks_q8" in params
    x = embeds
    length = device_scalar(length, torch.int64, x.device)
    slot_idx = device_scalar(slot, torch.int64, x.device).reshape(1)
    if cfg.prefill_flash:
        length32 = length.to(torch.int32)  # K1 reads it on the device
    else:
        pos = torch.arange(t_pad, device=x.device)
        mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] < length)
    for layer in range(cfg.num_hidden_layers):
        xn = layer_norm(x, bp["ln1_scale"][layer], bp["ln1_bias"][layer])
        qkv = _mm(params, layer, "attn_w", xn, w8)  # [T, 3D]
        q, k, v = (t.view(t_pad, nh, hd) for t in qkv.split(d, dim=-1))
        if cfg.prefill_flash:
            ctx = prefill_flash_attention(q, k, v, length32)  # [T, H, Dh] f32
        else:
            ctx = _prefill_attention_batched(q[None], k[None], v[None], mask[None], x.dtype)
        ctx = ctx.reshape(t_pad, d).to(x.dtype)
        x = x + _mm(params, layer, "attn_proj_w", ctx, w8)
        x = _mlp(params, layer, x, w8)
        k_rows, v_rows = k.reshape(t_pad, d), v.reshape(t_pad, d)
        if cfg.kv_int8:
            k_rows, cache.k_scale[layer, slot_idx, :t_pad] = _quantize_rows(k_rows)
            v_rows, cache.v_scale[layer, slot_idx, :t_pad] = _quantize_rows(v_rows)
        cache.k[layer, slot_idx, :t_pad] = k_rows.to(cache.k.dtype)
        cache.v[layer, slot_idx, :t_pad] = v_rows.to(cache.v.dtype)
    return x.index_select(0, (length - 1).reshape(1))[0]


@torch.no_grad()
def gpt_prefill_batched(params: dict, cfg: XTTSGPTConfig, embeds: torch.Tensor,
                        lengths, slots, cache: KVCache,
                        lanes: slice | None = None) -> torch.Tensor:
    """Burst prefill (the JAX `gpt_prefill_batched`): K prompts `embeds`
    [K, T_pad, D] through all layers together, so the weights stream once
    for the burst instead of once per prompt. `lengths` [K] are the true
    prompt lengths (0 on padding lanes), `slots` the target cache slots:
    [K] host ints (>= num_slots on padding lanes) or a [K] integer tensor
    on the device whose lanes are all real and distinct (a captured burst:
    nothing is read on the host), or, with `lanes` (a slice of the K
    lanes), the slots of those lanes only (a data shard's part of a burst
    that spans shards: every lane is computed, the others write nothing).
    Each real lane's K/V rows (int8 + scales under cfg.kv_int8) are written
    into cache[:, slot, :T_pad] IN PLACE; padding lanes write nothing.
    Returns the last real position's hidden state (pre-ln_f) per lane,
    [K, D].

    Attention is a dense masked softmax in PyTorch matmuls (causal and key
    within the lane's length), whatever cfg.prefill_flash says, as in the
    JAX function: probabilities rounded to the activation dtype, f32
    accumulation. With cfg.prefill_w8a8 and `blocks_q8` the four matmuls run
    W8A8 over the [K * T_pad] flattened rows."""
    if isinstance(params, ShardedParams):
        return _gpt_prefill_batched_tp(params, cfg, embeds, lengths, slots, cache, lanes)
    kb, t_pad, d = embeds.shape
    hd = cfg.head_dim
    bp = params["blocks"]
    nh = bp["attn_w"].shape[-1] // (3 * hd)
    dev = embeds.device
    w8 = cfg.prefill_w8a8 and "blocks_q8" in params
    lengths = device_values(lengths, torch.long, dev)
    if torch.is_tensor(slots):  # every lane real, or those of `lanes`
        lane_idx, slot_idx, any_lane = lanes, slots.to(device=dev, dtype=torch.long), True
    else:
        slots = [int(s) for s in slots]
        lanes = [i for i, s in enumerate(slots) if s < cache.num_slots]
        lane_idx = torch.tensor(lanes, dtype=torch.long, device=dev)
        slot_idx = torch.tensor([slots[i] for i in lanes], dtype=torch.long, device=dev)
        any_lane = bool(lanes)
    pos = torch.arange(t_pad, device=dev)
    # [K, T, T]: causal and key within each prompt's real length
    mask = ((pos[None, None, :] <= pos[None, :, None])
            & (pos[None, None, :] < lengths[:, None, None]))
    x = embeds
    for layer in range(cfg.num_hidden_layers):
        xn = layer_norm(x, bp["ln1_scale"][layer], bp["ln1_bias"][layer])
        qkv = _mm(params, layer, "attn_w", xn, w8)  # [K, T, 3D]
        q, k, v = (t.reshape(kb, t_pad, nh, hd) for t in qkv.split(d, dim=-1))
        ctx = _prefill_attention_batched(q, k, v, mask, x.dtype)
        x = x + _mm(params, layer, "attn_proj_w", ctx.reshape(kb, t_pad, d).to(x.dtype), w8)
        x = _mlp(params, layer, x, w8)
        if not any_lane:
            continue
        k_rows, v_rows = k.reshape(kb, t_pad, d), v.reshape(kb, t_pad, d)
        if lane_idx is not None:
            k_rows, v_rows = k_rows[lane_idx], v_rows[lane_idx]
        if cfg.kv_int8:
            k_rows, cache.k_scale[layer, slot_idx, :t_pad] = _quantize_rows(k_rows)
            v_rows, cache.v_scale[layer, slot_idx, :t_pad] = _quantize_rows(v_rows)
        cache.k[layer, slot_idx, :t_pad] = k_rows.to(cache.k.dtype)
        cache.v[layer, slot_idx, :t_pad] = v_rows.to(cache.v.dtype)
    last = torch.clamp(lengths - 1, min=0)
    return x[torch.arange(kb, device=dev), last]


# ------------------------------------------------------------- decode step


def _int8_attention(cfg: XTTSGPTConfig, cache: KVCache, layer: int, q: torch.Tensor,
                    k: torch.Tensor, v: torch.Tensor, slot_idx: torch.Tensor, lens: torch.Tensor,
                    live: torch.Tensor, new_rows: tuple | None = None) -> torch.Tensor:
    """The dense int8 body of the JAX decode step (gpt.py:505-573): scatter
    this step's quantised rows and scales, int8 scores x k-scale x q-scale,
    masked f32 softmax over the first `live.shape[1]` rows (the length
    bound), and the context either from bf16 probabilities
    (cfg.decode_attn_fp) or from probabilities requantised per (slot, head).
    `new_rows` ((k int8, k scale), (v int8, v scale)) gives the new rows
    already quantised (a model shard's lanes at the whole row's scale).
    Returns ctx [S, H, Dh] f32 over the heads of q [S, H*Dh]."""
    s, t = live.shape
    hd = cfg.head_dim
    nh = q.shape[-1] // hd
    if new_rows is None:
        new_rows = (_quantize_rows(k), _quantize_rows(v))
    for rows, scales, (q8, sc) in ((cache.k, cache.k_scale, new_rows[0]),
                                   (cache.v, cache.v_scale, new_rows[1])):
        rows[layer, slot_idx, lens], scales[layer, slot_idx, lens] = q8, sc
    k_all = cache.k[layer, :s, :t].reshape(s, t, nh, hd)
    v_all = cache.v[layer, :s, :t].reshape(s, t, nh, hd)
    k_sc, v_sc = cache.k_scale[layer, :s, :t], cache.v_scale[layer, :s, :t]  # [S, T]
    # q per (slot, head): the head with the smallest keys keeps its precision
    q_i8, q_s = _quantize_rows(q.reshape(s, nh, hd))  # [S, H, Dh], [S, H]
    # each score sums 64 products of magnitude <= 127^2: an integer below
    # 2^24, so the f32 sum is exact (the int32 dot's value) in any order
    scores_i = torch.einsum("sthd,shd->sht", k_all.float(), q_i8.float())
    scores = scores_i * k_sc[:, None, :] * (q_s * (1.0 / math.sqrt(hd)))[:, :, None]
    scores = scores.masked_fill(~live[:, None, :], torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1)
    pf = probs * v_sc[:, None, :]  # V's dequant scales folded into the probabilities
    if cfg.decode_attn_fp:
        # bf16 probabilities against V converted to bf16 (int8 values are
        # exact in bf16), f32 accumulation
        return torch.einsum("sht,sthd->shd", pf.to(torch.bfloat16).float(), v_all.float())
    p_i8, p_s = _quantize_rows(pf, eps=1e-20)  # [S, H, T], [S, H]
    # up to T x 127^2 per sum: beyond f32's exact integers, exact in f64
    ctx_i = torch.einsum("sht,sthd->shd", p_i8.double(), v_all.double())
    return ctx_i.float() * p_s[:, :, None]


def _dense_masks(route: str, seq_lens: torch.Tensor, len_bound: int | None, max_len: int,
                 d: int, hd: int) -> tuple | None:
    """The dense bodies' per-step (slot_idx, lens, live [S, bound], onehot
    [d, d/hd]) for q of d lanes, on seq_lens' device; None for K2 and K4."""
    if route in READS_BY_LENGTH:
        return None
    dev, lens = seq_lens.device, seq_lens.long()
    live = torch.arange(min(len_bound or max_len, max_len), device=dev)[None, :] <= lens[:, None]
    onehot = torch.arange(d, device=dev)[:, None] // hd == torch.arange(d // hd, device=dev)
    return torch.arange(lens.shape[0], device=dev), lens, live, onehot.float()


def _decode_attention(route: str, cfg: XTTSGPTConfig, cache: KVCache, layer: int,
                      q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, seq_lens: torch.Tensor,
                      masks: tuple | None, row_scales=None, new_rows=None) -> torch.Tensor:
    """One step's attention over q's heads by `route`, appending this step's
    k/v rows IN PLACE at seq_lens; ctx is [S, H*Dh] once reshaped. A model
    shard passes K4 its new rows' `row_scales` over all shards' lanes, or the
    dense int8 body its `new_rows` quantised at them."""
    qh, scale = q.reshape(q.shape[0], -1, cfg.head_dim), 1.0 / math.sqrt(cfg.head_dim)
    if route == "k2":
        return flash_decode_append_attention(qh, k, v, cache.k, cache.v, layer, seq_lens)
    if route == "k4":
        return ragged_decode_attention(qh, k, v, scale, layer, seq_lens, cache.k, cache.v,
                                       cache.k_scale, cache.v_scale, row_scales=row_scales)
    if route == "int8":
        return _int8_attention(cfg, cache, layer, q, k, v, *masks[:3], new_rows=new_rows)
    return _dense_attention(cache, layer, q, k, v, *masks, scale)


@torch.no_grad()
def gpt_decode_step(params: dict, cfg: XTTSGPTConfig, tokens: torch.Tensor,
                    audio_pos: torch.Tensor, seq_lens: torch.Tensor,
                    cache: KVCache, len_bound: int | None = None,
                    rows: int | None = None) -> torch.Tensor:
    """One decode step for slots 0..S-1 of the cache: tokens/audio_pos/
    seq_lens [S] int32, S at most the cache's slot count (a slot-bounded
    step covers the live low slots only). Appends this step's K/V at
    `seq_lens` IN PLACE and returns the hidden state (pre-ln_f) [S, D].
    `len_bound` caps the rows the dense bodies (`decode_route`) read
    (cache[:, :S, :bound]); the caller guarantees max(seq_lens) < bound.
    Kernels K2 and K4 read only live rows, so it changes nothing for them.
    Activations are bf16 under cfg.kv_int8, else in the cache dtype; with
    cfg.decode_w8a8 and `blocks_q8` in params the four matmuls run W8A8.

    The row-wise work (LayerNorms, matmuls, gelu) runs on the cache's slot
    count of rows, the step's S rows zero-padded: cuBLAS picks a product's
    algorithm by its shape, so otherwise a slot's result would depend on how
    many slots the step covers, and a slot-bounded step would part from the
    full-width one at greedy near-ties. The matmuls stream their weights
    once at any row count, so the padding costs little on the device; it
    adds two ops per layer to a bounded step (none at full width). `rows`
    overrides that count: a data shard's step pads to the whole decode
    state's slots, so its slots' results are those of the unsharded step."""
    if isinstance(params, ShardedParams):
        return _gpt_decode_step_tp(params, cfg, tokens, audio_pos, seq_lens, cache, len_bound,
                                   rows)
    route = decode_route(cfg)
    s = tokens.shape[0]
    rows = rows or cache.num_slots
    bp = params["blocks"]
    d = bp["attn_w"].shape[-1] // 3
    w8 = cfg.decode_w8a8 and "blocks_q8" in params
    pos = torch.clamp(audio_pos.long(), 0, cfg.audio_position_table - 1)
    x = pad_rows((params["wte"][tokens.long()] + params["wpe"][pos]).to(
        torch.bfloat16 if cfg.kv_int8 else cache.k.dtype), rows)
    masks = _dense_masks(route, seq_lens, len_bound, cache.max_len, d, cfg.head_dim)
    for layer in range(cfg.num_hidden_layers):
        xn = layer_norm(x, bp["ln1_scale"][layer], bp["ln1_bias"][layer])
        qkv = _mm(params, layer, "attn_w", xn, w8)
        q, k, v = qkv[:s].split(d, dim=-1)  # each [S, D]
        ctx = _decode_attention(route, cfg, cache, layer, q, k, v, seq_lens, masks)
        ctx = pad_rows(ctx.reshape(s, d).to(x.dtype), rows)
        x = x + _mm(params, layer, "attn_proj_w", ctx, w8)
        x = _mlp(params, layer, x, w8)
    return x[:s]


# ---------------------------------------------- tensor parallelism (model axis)
#
# Under a mesh the GPT runs Megatron-style over its model shards, driven by
# this one process as JAX's single-controller GSPMD drives its mesh. Shard r
# holds the q/k/v columns and the KV lanes of heads [r H/tp, (r+1) H/tp), the
# matching rows of attn_proj, and I/tp columns of fc with the matching rows of
# fc_proj. Per block each shard computes its column-parallel half (ln -> its
# heads' qkv -> attention over its heads -> its rows of the projection) to an
# f32 partial. The partials are summed in shard order on every shard's
# device, and the replicated bias is added once after the sum: the all-reduce
# GSPMD emits. The residual stream stays replicated, one copy per device, and
# the copies are bit-equal, each being the same sum of the same values in the
# same order. One sum of copied partials serves the CPU, one card holding
# several shards and several cards alike; it is no kernel (an NCCL all-reduce
# across cards is later work, ROADMAP.md).

class ShardedParams(dict):
    """The GPT parameters on a mesh's model axis (parallel/mesh.py
    `shard_gpt_params`). The dict holds the replicated leaves (embeddings,
    ln_f, final_norm, the mel head) on the mesh's first device, which the
    prompt assembly and `heads` read; `shards[r]` is shard r's whole
    parameter dict on `devices[r]`, its block matmuls split per head and
    per MLP column. `blocks` is only in the shards."""

    def __init__(self, shards: list[dict]):
        super().__init__({k: v for k, v in shards[0].items() if k != "blocks"})
        self.shards = shards
        self.devices = [p["blocks"]["attn_w"].device for p in shards]
        # the first shard on each distinct device: its replicated leaves
        # serve that device's copy of the residual stream
        self.lead: dict = {}
        for r, dev in enumerate(self.devices):
            self.lead.setdefault(dev, r)
        self.multi_device = len(self.lead) > 1

    def on(self, r: int):
        """Shard r's device made current across cards (a kernel launches on
        the current device's stream); a no-op when one device holds every
        shard."""
        dev = self.devices[r]
        if self.multi_device and dev.type == "cuda":
            return torch.cuda.device(dev)
        return contextlib.nullcontext()


@dataclass
class ShardedKVCache:
    """A KV cache split on its lane axis over a mesh's model shards
    (parallel/mesh.py `shard_decode_state`): shard r's `KVCache` holds its
    heads' lanes of every row and, under kv_int8, a whole copy of the
    per-token scales (each shard quantises at the scale over all lanes)."""

    shards: list

    @property
    def num_slots(self) -> int:
        return self.shards[0].num_slots

    @property
    def max_len(self) -> int:
        return self.shards[0].max_len

    @property
    def quantized(self) -> bool:
        return self.shards[0].quantized

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    def tensors(self) -> list[torch.Tensor]:
        return [t for c in self.shards for t in c.tensors()]


def _tp_copies(params: ShardedParams, x: torch.Tensor) -> dict:
    """x on every device of the mesh (one copy per device)."""
    return {dev: x.to(dev) for dev in params.lead}


def _tp_partial(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [.., Din] @ w [Din, Dout] in the promoted dtype of x and w, as f32:
    one shard's term of a row-parallel product."""
    dt = torch.promote_types(x.dtype, w.dtype)
    y = torch.mm(x.reshape(-1, x.shape[-1]).to(dt), w.to(dt))
    return y.reshape(*x.shape[:-1], w.shape[-1]).float()


def _tp_reduce(params: ShardedParams, xs: dict, partials: list, layer: int,
               bias: str) -> dict:
    """x + (sum of the shards' partials in shard order + bias) on every
    device: the row-parallel products' all-reduce."""
    out = {}
    for dev, x in xs.items():
        acc = partials[0].to(dev)
        for p in partials[1:]:
            acc = acc + p.to(dev)
        b = params.shards[params.lead[dev]]["blocks"][bias][layer]
        out[dev] = x + (acc + b.float()).to(x.dtype)
    return out


def _tp_row_scales(params: ShardedParams, rows: list) -> dict:
    """The int8 scales of rows split by lanes over the shards (rows[r] on
    shard r's device), one copy per device: `quantize_rows`'s scales of the
    whole rows, from the max of the shards' row maxima (exact in any
    order). Every shard quantises its lanes at them, so its int8 lanes and
    the scales equal those of the unsharded row ("every head shard needs
    every token scale", auralis_tpu/parallel/mesh.py); the prefill's
    writes, the dense int8 body and K4 all take them from here."""
    maxes = [torch.linalg.vector_norm(r, math.inf, dim=-1, dtype=torch.float32) for r in rows]
    out = {}
    for dev in params.lead:
        m = maxes[0].to(dev)
        for other in maxes[1:]:
            m = torch.maximum(m, other.to(dev))
        out[dev] = _row_scales(m)
    return out


def _tp_quantize(params: ShardedParams, rows: list) -> list:
    """`_quantize_rows` of rows split by lanes over the shards, each shard's
    lanes at the whole rows' scales (`_tp_row_scales`): (int8, scales) per
    shard."""
    scales = _tp_row_scales(params, rows)
    return [_quantize_rows(r, scale=scales[dev]) for r, dev in zip(rows, params.devices)]


def _tp_write_rows(params: ShardedParams, cfg: XTTSGPTConfig, cache: ShardedKVCache,
                   layer: int, slot_idx: dict, ks: list, vs: list, t_pad: int) -> None:
    """Each shard's K/V rows [..., T, D_r] into its cache at (layer,
    slot_idx[device], :t_pad); int8 at the whole row's scale under
    cfg.kv_int8. In place."""
    for name, rows in (("k", ks), ("v", vs)):
        quantized = _tp_quantize(params, rows) if cfg.kv_int8 else None
        for r, c in enumerate(cache.shards):
            idx = slot_idx[params.devices[r]]
            if quantized is None:
                getattr(c, name)[layer, idx, :t_pad] = rows[r].to(c.dtype)
            else:
                getattr(c, name)[layer, idx, :t_pad] = quantized[r][0]
                getattr(c, name + "_scale")[layer, idx, :t_pad] = quantized[r][1]


def _tp_block(params: ShardedParams, layer: int, xs: dict, attend) -> dict:
    """One transformer block over the model shards. xs: the residual stream
    per device; attend(qkv) takes each shard's (q, k, v) [..., D_r] and
    returns its context [..., D_r] in the activation dtype (writing its
    cache rows)."""
    devs = params.devices

    def ln(dev, name):
        bp = params.shards[params.lead[dev]]["blocks"]
        return layer_norm(xs[dev], bp[name + "_scale"][layer], bp[name + "_bias"][layer])

    xn = {dev: ln(dev, "ln1") for dev in xs}
    qkv = []
    for r, p in enumerate(params.shards):
        bp = p["blocks"]
        with params.on(r):
            y = _dot(xn[devs[r]], bp["attn_w"][layer], bp["attn_b"][layer])
        qkv.append(y.split(y.shape[-1] // 3, dim=-1))
    ctxs = attend(qkv)
    partials = []
    for r, p in enumerate(params.shards):
        with params.on(r):
            partials.append(_tp_partial(ctxs[r], p["blocks"]["attn_proj_w"][layer]))
    xs = _tp_reduce(params, xs, partials, layer, "attn_proj_b")
    xn = {dev: ln(dev, "ln2") for dev in xs}
    partials = []
    for r, p in enumerate(params.shards):
        bp = p["blocks"]
        with params.on(r):
            h = _gelu(_dot(xn[devs[r]], bp["fc_w"][layer], bp["fc_b"][layer]))
            partials.append(_tp_partial(h, bp["fc_proj_w"][layer]))
    return _tp_reduce(params, xs, partials, layer, "fc_proj_b")


def _gpt_prefill_tp(params: ShardedParams, cfg: XTTSGPTConfig, embeds: torch.Tensor,
                    length, slot, cache: ShardedKVCache) -> torch.Tensor:
    """`gpt_prefill` over the model shards; returns the last real position's
    hidden state on the mesh's first device."""
    t_pad, hd = embeds.shape[0], cfg.head_dim
    xs = _tp_copies(params, embeds)
    lengths = {dev: device_scalar(length, torch.int64, dev) for dev in params.lead}
    slot_idx = {dev: device_scalar(slot, torch.int64, dev).reshape(1) for dev in params.lead}
    masks = {}
    for dev, n in lengths.items():
        if cfg.prefill_flash:
            masks[dev] = n.to(torch.int32)  # K1 reads it on the device
        else:
            pos = torch.arange(t_pad, device=dev)
            masks[dev] = (pos[None, :] <= pos[:, None]) & (pos[None, :] < n)

    for layer in range(cfg.num_hidden_layers):
        def attend(qkv):
            ctxs = []
            for r, (q, k, v) in enumerate(qkv):
                dev, nh = params.devices[r], q.shape[-1] // hd
                qh, kh, vh = (t.view(t_pad, nh, hd) for t in (q, k, v))
                with params.on(r):
                    if cfg.prefill_flash:
                        ctx = prefill_flash_attention(qh, kh, vh, masks[dev])
                    else:
                        ctx = _prefill_attention_batched(qh[None], kh[None], vh[None],
                                                         masks[dev][None], embeds.dtype)
                ctxs.append(ctx.reshape(t_pad, -1).to(embeds.dtype))
            _tp_write_rows(params, cfg, cache, layer, slot_idx, [t[1] for t in qkv],
                           [t[2] for t in qkv], t_pad)
            return ctxs

        xs = _tp_block(params, layer, xs, attend)
    first = params.devices[0]
    return xs[first].index_select(0, (lengths[first] - 1).reshape(1))[0]


def _gpt_prefill_batched_tp(params: ShardedParams, cfg: XTTSGPTConfig, embeds: torch.Tensor,
                            lengths, slots, cache: ShardedKVCache,
                            lanes: slice | None = None) -> torch.Tensor:
    """`gpt_prefill_batched` over the model shards; returns [K, D] on the
    mesh's first device."""
    kb, t_pad, _ = embeds.shape
    hd = cfg.head_dim
    xs = _tp_copies(params, embeds)
    lens = {dev: device_values(lengths, torch.long, dev) for dev in params.lead}
    if torch.is_tensor(slots):  # every lane real, or those of `lanes`
        real = slots
        lane_idx = {dev: lanes for dev in params.lead}
    else:
        slots = [int(s) for s in slots]
        lanes = [i for i, s in enumerate(slots) if s < cache.num_slots]
        real = [slots[i] for i in lanes]
        lane_idx = {dev: torch.tensor(lanes, dtype=torch.long, device=dev)
                    for dev in params.lead}
    slot_idx = {dev: device_values(real, torch.long, dev) for dev in params.lead}
    pos = {dev: torch.arange(t_pad, device=dev) for dev in params.lead}
    masks = {dev: ((p[None, None, :] <= p[None, :, None])
                   & (p[None, None, :] < lens[dev][:, None, None])) for dev, p in pos.items()}

    for layer in range(cfg.num_hidden_layers):
        def attend(qkv):
            ctxs, ks, vs = [], [], []
            for r, (q, k, v) in enumerate(qkv):
                dev, nh = params.devices[r], q.shape[-1] // hd
                q4, k4, v4 = (t.reshape(kb, t_pad, nh, hd) for t in (q, k, v))
                ctx = _prefill_attention_batched(q4, k4, v4, masks[dev], embeds.dtype)
                ctxs.append(ctx.reshape(kb, t_pad, -1).to(embeds.dtype))
                idx = lane_idx[dev]
                ks.append(k if idx is None else k[idx])
                vs.append(v if idx is None else v[idx])
            if torch.is_tensor(real) or real:
                _tp_write_rows(params, cfg, cache, layer, slot_idx, ks, vs, t_pad)
            return ctxs

        xs = _tp_block(params, layer, xs, attend)
    first = params.devices[0]
    last = torch.clamp(lens[first] - 1, min=0)
    return xs[first][torch.arange(kb, device=first), last]


def _gpt_decode_step_tp(params: ShardedParams, cfg: XTTSGPTConfig, tokens: torch.Tensor,
                        audio_pos: torch.Tensor, seq_lens: torch.Tensor,
                        cache: ShardedKVCache, len_bound: int | None,
                        rows: int | None = None) -> torch.Tensor:
    """`gpt_decode_step` over the model shards, each attending over its heads
    (K4 and the dense int8 body at the new rows' scales over all shards'
    lanes). Returns [S, D] on the mesh's first device."""
    route = decode_route(cfg)
    s, rows, hd = tokens.shape[0], rows or cache.num_slots, cfg.head_dim
    pos = torch.clamp(audio_pos.long(), 0, cfg.audio_position_table - 1)
    x = pad_rows((params["wte"][tokens.long()] + params["wpe"][pos]).to(
        torch.bfloat16 if cfg.kv_int8 else cache.dtype), rows)
    xs = _tp_copies(params, x)
    wpos = {dev: seq_lens.to(dev) for dev in params.lead}
    d_r = params.shards[0]["blocks"]["attn_w"].shape[-1] // 3
    masks = {dev: _dense_masks(route, w, len_bound, cache.max_len, d_r, hd)
             for dev, w in wpos.items()}

    for layer in range(cfg.num_hidden_layers):
        def attend(qkv):
            qkv = [(q[:s], k[:s], v[:s]) for q, k, v in qkv]
            row_scales = new_rows = [None] * len(qkv)
            if route == "k4":
                k_s, v_s = (_tp_row_scales(params, [t[i] for t in qkv]) for i in (1, 2))
                row_scales = [(k_s[dev], v_s[dev]) for dev in params.devices]
            elif route == "int8":
                new_rows = list(zip(*(_tp_quantize(params, [t[i] for t in qkv]) for i in (1, 2))))
            ctxs = []
            for r, (q, k, v) in enumerate(qkv):
                dev = params.devices[r]
                with params.on(r):
                    ctx = _decode_attention(route, cfg, cache.shards[r], layer, q, k, v,
                                            wpos[dev], masks[dev], row_scales[r], new_rows[r])
                ctxs.append(pad_rows(ctx.reshape(s, -1).to(x.dtype), rows))
            return ctxs

        xs = _tp_block(params, layer, xs, attend)
    return xs[params.devices[0]][:s]


# --------------------------------------------------- reference-shape prompt


def build_prompt_embeds(params: dict, cfg: XTTSGPTConfig, cond_latents: torch.Tensor,
                        text_ids, bos_id: int, eos_id: int) -> torch.Tensor:
    """`[cond ⊕ text(bos..eos) ⊕ start_audio]` -> [C+T+1, D]."""
    dev = params["wte"].device
    ids = torch.tensor([bos_id, *map(int, text_ids), eos_id], dtype=torch.long, device=dev)
    text = text_embeddings(params, ids)
    start = start_audio_embedding(params, cfg)[None]
    return torch.cat([torch.as_tensor(cond_latents, device=dev).to(text.dtype), text, start])
