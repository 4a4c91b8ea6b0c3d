"""The XTTS audio-token GPT as plain torch functions on a parameter dict.

Counterpart of auralis_tpu/models/xttsv2/gpt.py, dense bf16/f32 path. The
parameter dict has the JAX package's keys and layouts (per-layer tensors
stacked on a leading [L] axis, dense weights [Din, Dout]), and the sequence
semantics are the same: prompt = `[cond ⊕ text] + embed(start_audio)`;
generated token i gets `wte[tok] + wpe[i]`; logits =
`mel_head(final_norm(ln_f(h)))`; vocoder latent =
`final_norm(final_norm(ln_f(h)))` (the reference's double final_norm).

Differences from the JAX module:
- the KV cache is updated IN PLACE (the JAX functions return a new cache);
- layers run as a Python loop (what `unroll_layers` asked XLA for);
- `prefill_flash` routes prefill attention through kernel K1
  (ops/prefill_attention.py) and `flash_decode` routes decode attention
  through kernel K2 (ops/experimental/attention.py); otherwise the dense
  masked bodies below run;
- int8 KV, W8A8 and the batched prefill are not ported yet and raise.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ...ops.experimental.attention import CHUNK, flash_decode_append_attention
from ...ops.prefill_attention import prefill_flash_attention
from .config import XTTSGPTConfig

NOT_PORTED = (
    "int8 KV / W8A8 are not ported yet (ROADMAP.md, queue 1: 'int8 KV and W8A8 "
    "with K4/K5')"
)


def check_supported(cfg: XTTSGPTConfig) -> None:
    """Refuse config flags whose code paths the port does not have yet."""
    on = [f for f in ("kv_int8", "ragged_decode", "decode_w8a8", "prefill_w8a8")
          if getattr(cfg, f)]
    if on:
        raise NotImplementedError(f"{on}: {NOT_PORTED}")


@dataclass
class KVCache:
    """Dense slot-batched KV cache: k/v are [L, S, T_pad, H*Dh], heads flat
    in the minor dimension (the JAX layout), T padded to the 256-row chunk."""

    k: torch.Tensor
    v: torch.Tensor

    @property
    def num_slots(self) -> int:
        return self.k.shape[1]

    @property
    def max_len(self) -> int:
        return self.k.shape[2]


def make_kv_cache(cfg: XTTSGPTConfig, num_slots: int, dtype=torch.bfloat16,
                  device="cpu") -> KVCache:
    check_supported(cfg)
    t_pad = -(-cfg.max_seq_len // CHUNK) * CHUNK
    shape = (cfg.num_hidden_layers, num_slots, t_pad, cfg.num_attention_heads * cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


# -------------------------------------------------------------------- math


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm computed in f32 regardless of activation dtype."""
    y = F.layer_norm(x.float(), (x.shape[-1],), scale.float(), bias.float(), eps)
    return y.to(x.dtype)


def _dot(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """x [.., Din] @ w [Din, Dout] (+ b), f32 accumulate, result in x's dtype."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    y = torch.mm(x2, w.to(x.dtype)) if b is None else torch.addmm(b.to(x.dtype), x2, w.to(x.dtype))
    return y.reshape(*lead, w.shape[-1])


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


def _mlp(bp: dict, layer: int, x: torch.Tensor) -> torch.Tensor:
    xn = layer_norm(x, bp["ln2_scale"][layer], bp["ln2_bias"][layer])
    y = _gelu(_dot(xn, bp["fc_w"][layer], bp["fc_b"][layer]))
    return x + _dot(y, bp["fc_proj_w"][layer], bp["fc_proj_b"][layer])


# ----------------------------------------------------------------- prefill


@torch.no_grad()
def gpt_prefill(params: dict, cfg: XTTSGPTConfig, embeds: torch.Tensor, length: int,
                slot: int, cache: KVCache) -> torch.Tensor:
    """Run the prompt `embeds` [T_pad, D] (zero-padded past `length`) through
    all layers, write its K/V rows into cache[:, slot, :T_pad] IN PLACE, and
    return the last real position's hidden state (pre-ln_f) [D]."""
    check_supported(cfg)
    t_pad, d = embeds.shape
    nh, hd = cfg.num_attention_heads, cfg.head_dim
    bp = params["blocks"]
    x = embeds
    if not cfg.prefill_flash:
        pos = torch.arange(t_pad, device=x.device)
        mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] < length)
    for layer in range(cfg.num_hidden_layers):
        xn = layer_norm(x, bp["ln1_scale"][layer], bp["ln1_bias"][layer])
        qkv = _dot(xn, bp["attn_w"][layer], bp["attn_b"][layer])  # [T, 3D]
        q, k, v = (t.view(t_pad, nh, hd) for t in qkv.split(d, dim=-1))
        if cfg.prefill_flash:
            ctx = prefill_flash_attention(q, k, v, length)  # [T, H, Dh] f32
        else:
            scores = torch.einsum("qhd,khd->hqk", q.float(), k.float()) * (1.0 / math.sqrt(hd))
            scores = scores.masked_fill(~mask[None], torch.finfo(torch.float32).min)
            probs = torch.softmax(scores, dim=-1).to(x.dtype)
            ctx = torch.einsum("hqk,khd->qhd", probs.float(), v.float())
        ctx = ctx.reshape(t_pad, d).to(x.dtype)
        x = x + _dot(ctx, bp["attn_proj_w"][layer], bp["attn_proj_b"][layer])
        x = _mlp(bp, layer, x)
        cache.k[layer, slot, :t_pad] = k.reshape(t_pad, d).to(cache.k.dtype)
        cache.v[layer, slot, :t_pad] = v.reshape(t_pad, d).to(cache.v.dtype)
    return x[length - 1]


# ------------------------------------------------------------- decode step


@torch.no_grad()
def gpt_decode_step(params: dict, cfg: XTTSGPTConfig, tokens: torch.Tensor,
                    audio_pos: torch.Tensor, seq_lens: torch.Tensor,
                    cache: KVCache) -> torch.Tensor:
    """One decode step for every slot: tokens/audio_pos/seq_lens [S] int32.
    Appends this step's K/V at `seq_lens` IN PLACE and returns the hidden
    state (pre-ln_f) [S, D]."""
    check_supported(cfg)
    s = tokens.shape[0]
    d, nh, hd = cfg.hidden_size, cfg.num_attention_heads, cfg.head_dim
    bp = params["blocks"]
    pos = torch.clamp(audio_pos.long(), 0, cfg.audio_position_table - 1)
    x = (params["wte"][tokens.long()] + params["wpe"][pos]).to(cache.k.dtype)
    if not cfg.flash_decode:
        slot_idx = torch.arange(s, device=x.device)
        lens = seq_lens.long()
        live = torch.arange(cache.max_len, device=x.device)[None, :] <= lens[:, None]
        onehot = (torch.arange(d, device=x.device)[:, None] // hd
                  == torch.arange(nh, device=x.device)[None, :]).float()  # [HD, H]
    for layer in range(cfg.num_hidden_layers):
        xn = layer_norm(x, bp["ln1_scale"][layer], bp["ln1_bias"][layer])
        qkv = _dot(xn, bp["attn_w"][layer], bp["attn_b"][layer])
        q, k, v = qkv.split(d, dim=-1)  # each [S, D]
        if cfg.flash_decode:
            ctx = flash_decode_append_attention(
                q.reshape(s, nh, hd), k, v, cache.k, cache.v, layer, seq_lens)
        else:
            # the dense body of the JAX decode step (gpt.py:574-605): scatter
            # the new rows, then masked softmax over the flat [T, H*Dh] cache
            cache.k[layer, slot_idx, lens] = k.to(cache.k.dtype)
            cache.v[layer, slot_idx, lens] = v.to(cache.v.dtype)
            k_all = cache.k[layer, :s].float()  # [S, T, HD]
            v_all = cache.v[layer, :s].float()
            qmat = (q.float() * (1.0 / math.sqrt(hd)))[:, :, None] * onehot[None]  # [S, HD, H]
            qmat = qmat.to(cache.k.dtype).float()
            scores = torch.einsum("stc,sch->sht", k_all, qmat)
            scores = scores.masked_fill(~live[:, None, :], torch.finfo(torch.float32).min)
            probs = torch.softmax(scores, dim=-1).to(cache.v.dtype).float()
            ctx_full = torch.einsum("sht,stc->shc", probs, v_all)  # [S, H, HD]
            ctx = (ctx_full * onehot.T[None]).sum(dim=1)
        ctx = ctx.reshape(s, d).to(x.dtype)
        x = x + _dot(ctx, bp["attn_proj_w"][layer], bp["attn_proj_b"][layer])
        x = _mlp(bp, layer, x)
    return x


# --------------------------------------------------- reference-shape prompt


def build_prompt_embeds(params: dict, cfg: XTTSGPTConfig, cond_latents: torch.Tensor,
                        text_ids, bos_id: int, eos_id: int) -> torch.Tensor:
    """`[cond ⊕ text(bos..eos) ⊕ start_audio]` -> [C+T+1, D]."""
    dev = params["wte"].device
    ids = torch.tensor([bos_id, *map(int, text_ids), eos_id], dtype=torch.long, device=dev)
    text = text_embeddings(params, ids)
    start = start_audio_embedding(params, cfg)[None]
    return torch.cat([torch.as_tensor(cond_latents, device=dev).to(text.dtype), text, start])
