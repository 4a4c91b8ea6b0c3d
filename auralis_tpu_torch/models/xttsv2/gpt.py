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
  (ops/prefill_attention.py), `flash_decode` routes decode attention through
  kernel K2 and `kv_int8` + `ragged_decode` through kernel K4
  (ops/experimental/attention.py); otherwise the dense masked bodies below
  run, in the cache dtype or, under `kv_int8`, on int8 rows with per-token
  scales;
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
  duplicates).
"""
from __future__ import annotations

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


def make_kv_cache(cfg: XTTSGPTConfig, num_slots: int, dtype=torch.bfloat16,
                  device="cuda") -> KVCache:
    """Zeroed cache in `dtype` on `device` (the card unless the caller names
    another; raises without one); under cfg.kv_int8 int8 rows with scales
    initialised to ones (`dtype` is then unused)."""
    t_pad = -(-cfg.max_seq_len // CHUNK) * CHUNK
    shape = (cfg.num_hidden_layers, num_slots, t_pad, cfg.num_attention_heads * cfg.head_dim)
    if cfg.ragged_decode and not cfg.kv_int8:
        raise ValueError("ragged_decode composes with (requires) kv_int8")
    if cfg.kv_int8:
        if cfg.flash_decode:
            raise ValueError("kv_int8 and flash_decode are exclusive")
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
    """LayerNorm computed in f32 regardless of activation dtype."""
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
    return F.gelu(y.float()).to(y.dtype)  # exact erf GELU in f32


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
    t_pad, d = embeds.shape
    nh, hd = cfg.num_attention_heads, cfg.head_dim
    bp = params["blocks"]
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
            scores = torch.einsum("qhd,khd->hqk", q.float(), k.float()) * (1.0 / math.sqrt(hd))
            scores = scores.masked_fill(~mask[None], torch.finfo(torch.float32).min)
            probs = torch.softmax(scores, dim=-1).to(x.dtype)
            ctx = torch.einsum("hqk,khd->qhd", probs.float(), v.float())
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
                        lengths, slots, cache: KVCache) -> torch.Tensor:
    """Burst prefill (the JAX `gpt_prefill_batched`): K prompts `embeds`
    [K, T_pad, D] through all layers together, so the weights stream once
    for the burst instead of once per prompt. `lengths` [K] are the true
    prompt lengths (0 on padding lanes), `slots` the target cache slots:
    [K] host ints (>= num_slots on padding lanes) or a [K] integer tensor
    on the device whose lanes are all real and distinct (a captured burst:
    nothing is read on the host). Each real lane's K/V rows (int8 + scales
    under cfg.kv_int8) are written into cache[:, slot, :T_pad] IN PLACE;
    padding lanes write nothing. Returns the last real position's hidden
    state (pre-ln_f) per lane, [K, D].

    Attention is a dense masked softmax in PyTorch matmuls (causal and key
    within the lane's length), whatever cfg.prefill_flash says, as in the
    JAX function: probabilities rounded to the activation dtype, f32
    accumulation. With cfg.prefill_w8a8 and `blocks_q8` the four matmuls run
    W8A8 over the [K * T_pad] flattened rows."""
    kb, t_pad, d = embeds.shape
    nh, hd = cfg.num_attention_heads, cfg.head_dim
    bp = params["blocks"]
    dev = embeds.device
    w8 = cfg.prefill_w8a8 and "blocks_q8" in params
    lengths = device_values(lengths, torch.long, dev)
    if torch.is_tensor(slots):  # every lane real
        lane_idx, slot_idx, any_lane = None, slots.to(device=dev, dtype=torch.long), True
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
    neg = torch.finfo(torch.float32).min
    x = embeds
    for layer in range(cfg.num_hidden_layers):
        xn = layer_norm(x, bp["ln1_scale"][layer], bp["ln1_bias"][layer])
        qkv = _mm(params, layer, "attn_w", xn, w8)  # [K, T, 3D]
        q, k, v = (t.reshape(kb, t_pad, nh, hd) for t in qkv.split(d, dim=-1))
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (1.0 / math.sqrt(hd))
        scores = scores.masked_fill(~mask[:, None], neg)
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        ctx = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
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
                    k: torch.Tensor, v: torch.Tensor, lens: torch.Tensor,
                    live: torch.Tensor) -> torch.Tensor:
    """The dense int8 body of the JAX decode step (gpt.py:505-573): scatter
    this step's quantised rows and scales, int8 scores x k-scale x q-scale,
    masked f32 softmax over the first `live.shape[1]` rows (the length
    bound), and the context either from bf16 probabilities
    (cfg.decode_attn_fp) or from probabilities requantised per (slot, head).
    Returns ctx [S, H, Dh] f32."""
    s, t = live.shape
    nh, hd = cfg.num_attention_heads, cfg.head_dim
    slot_idx = torch.arange(s, device=q.device)
    for rows, scales, new in ((cache.k, cache.k_scale, k), (cache.v, cache.v_scale, v)):
        rows[layer, slot_idx, lens], scales[layer, slot_idx, lens] = _quantize_rows(new)
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


@torch.no_grad()
def gpt_decode_step(params: dict, cfg: XTTSGPTConfig, tokens: torch.Tensor,
                    audio_pos: torch.Tensor, seq_lens: torch.Tensor,
                    cache: KVCache, len_bound: int | None = None) -> torch.Tensor:
    """One decode step for slots 0..S-1 of the cache: tokens/audio_pos/
    seq_lens [S] int32, S at most the cache's slot count (a slot-bounded
    step covers the live low slots only). Appends this step's K/V at
    `seq_lens` IN PLACE and returns the hidden state (pre-ln_f) [S, D].
    `len_bound` caps the rows the dense bodies read (cache[:, :S, :bound]);
    the caller guarantees max(seq_lens) < bound. Kernels K2 and K4 read only
    live rows, so it changes nothing for them. Activations are bf16 under
    cfg.kv_int8, else in the cache dtype; with cfg.decode_w8a8 and
    `blocks_q8` in params the four matmuls run W8A8.

    The row-wise work (LayerNorms, matmuls, gelu) runs on the cache's slot
    count of rows, the step's S rows zero-padded: cuBLAS picks a product's
    algorithm by its shape, so otherwise a slot's result would depend on how
    many slots the step covers, and a slot-bounded step would part from the
    full-width one at greedy near-ties. The matmuls stream their weights
    once at any row count, so the padding costs little on the device; it
    adds two ops per layer to a bounded step (none at full width)."""
    s = tokens.shape[0]
    rows = cache.num_slots
    d, nh, hd = cfg.hidden_size, cfg.num_attention_heads, cfg.head_dim
    scale = 1.0 / math.sqrt(hd)
    bp = params["blocks"]
    w8 = cfg.decode_w8a8 and "blocks_q8" in params
    pos = torch.clamp(audio_pos.long(), 0, cfg.audio_position_table - 1)
    x = pad_rows((params["wte"][tokens.long()] + params["wpe"][pos]).to(
        torch.bfloat16 if cfg.kv_int8 else cache.k.dtype), rows)
    if not (cfg.flash_decode or cfg.ragged_decode):
        slot_idx = torch.arange(s, device=x.device)
        lens = seq_lens.long()
        bound = min(len_bound or cache.max_len, cache.max_len)
        live = torch.arange(bound, device=x.device)[None, :] <= lens[:, None]
        onehot = (torch.arange(d, device=x.device)[:, None] // hd
                  == torch.arange(nh, device=x.device)[None, :]).float()  # [HD, H]
    for layer in range(cfg.num_hidden_layers):
        xn = layer_norm(x, bp["ln1_scale"][layer], bp["ln1_bias"][layer])
        qkv = _mm(params, layer, "attn_w", xn, w8)
        q, k, v = qkv[:s].split(d, dim=-1)  # each [S, D]
        if cfg.flash_decode:
            ctx = flash_decode_append_attention(
                q.reshape(s, nh, hd), k, v, cache.k, cache.v, layer, seq_lens)
        elif cfg.kv_int8 and cfg.ragged_decode:
            ctx = ragged_decode_attention(
                q.reshape(s, nh, hd), k, v, scale, layer, seq_lens, cache.k, cache.v,
                cache.k_scale, cache.v_scale)
        elif cfg.kv_int8:
            ctx = _int8_attention(cfg, cache, layer, q, k, v, lens, live)
        else:
            # the dense body of the JAX decode step (gpt.py:574-605): scatter
            # the new rows, then masked softmax over the flat [T, H*Dh] cache
            cache.k[layer, slot_idx, lens] = k.to(cache.k.dtype)
            cache.v[layer, slot_idx, lens] = v.to(cache.v.dtype)
            k_all = cache.k[layer, :s, :bound].float()  # [S, bound, HD]
            v_all = cache.v[layer, :s, :bound].float()
            qmat = (q.float() * scale)[:, :, None] * onehot[None]  # [S, HD, H]
            qmat = qmat.to(cache.k.dtype).float()
            scores = torch.einsum("stc,sch->sht", k_all, qmat)
            scores = scores.masked_fill(~live[:, None, :], torch.finfo(torch.float32).min)
            probs = torch.softmax(scores, dim=-1).to(cache.v.dtype).float()
            ctx_full = torch.einsum("sht,stc->shc", probs, v_all)  # [S, H, HD]
            ctx = (ctx_full * onehot.T[None]).sum(dim=1)
        ctx = pad_rows(ctx.reshape(s, d).to(x.dtype), rows)
        x = x + _mm(params, layer, "attn_proj_w", ctx, w8)
        x = _mlp(params, layer, x, w8)
    return x[:s]


# --------------------------------------------------- reference-shape prompt


def build_prompt_embeds(params: dict, cfg: XTTSGPTConfig, cond_latents: torch.Tensor,
                        text_ids, bos_id: int, eos_id: int) -> torch.Tensor:
    """`[cond ⊕ text(bos..eos) ⊕ start_audio]` -> [C+T+1, D]."""
    dev = params["wte"].device
    ids = torch.tensor([bos_id, *map(int, text_ids), eos_id], dtype=torch.long, device=dev)
    text = text_embeddings(params, ids)
    start = start_audio_embedding(params, cfg)[None]
    return torch.cat([torch.as_tensor(cond_latents, device=dev).to(text.dtype), text, start])
