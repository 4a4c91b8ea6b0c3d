"""Slot-based continuous-batching decode loop.

Counterpart of auralis_tpu/runtime/decode_loop.py: a fixed-shape `[slots, ...]`
decode state on the device, host-side insertion of prefilled sequences into
free slots, and harvest of finished ones. Vocoder latents accumulate inline
during decode (no second logits-only pass).

The JAX functions are pure and donate the state; here the state is a
dataclass of device tensors that every function below updates IN PLACE
(including the KV cache, through gpt.py). Sampling noise comes from the
state's torch.Generator unless a caller injects it.

Ported: the single insert (`_insert_body`), N-step decode blocks without
`len_bound`/`slot_bound` (kernel K2 reads only live rows), status packing,
release and harvest. Not ported yet: batched inserts and slot migration.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..models.xttsv2.config import XTTSGPTConfig
from ..models.xttsv2.gpt import KVCache, gpt_decode_step, gpt_prefill, heads, make_kv_cache
from .sampler import SamplingState, init_sampling_state, sample_tokens

PREFILL_BUCKETS = (64, 128, 256, 512)


def _prompt_seen_row(cfg: XTTSGPTConfig, device="cpu") -> torch.Tensor:
    """Initial seen-mask row for a fresh sequence: with
    cfg.reppen_penalize_prompt_ids (reference parity) ids {1,
    start_audio_token} are penalized from step 0."""
    row = torch.zeros((cfg.num_audio_tokens,), dtype=torch.bool, device=device)
    if cfg.reppen_penalize_prompt_ids:
        row[1] = True
        row[cfg.start_audio_token] = True
    return row


def prefill_bucket(length: int, max_len: int) -> int:
    for b in PREFILL_BUCKETS:
        if length <= b <= max_len:
            return b
    return max_len


@dataclass
class DecodeState:
    """All device-resident decode state (mutated in place)."""

    cache: KVCache
    sampling: SamplingState
    seq_lens: torch.Tensor  # [S] i32 — cache positions filled (prompt + generated-1)
    audio_pos: torch.Tensor  # [S] i32 — audio position of the next input token
    last_token: torch.Tensor  # [S] i32 — next input token
    active: torch.Tensor  # [S] bool — currently decoding
    done: torch.Tensor  # [S] bool — finished, awaiting harvest
    tokens_buf: torch.Tensor  # [S, T_audio] i32
    latents_buf: torch.Tensor  # [S, T_audio, D] f32
    n_generated: torch.Tensor  # [S] i32
    generator: torch.Generator  # sampling noise


def init_decode_state(cfg: XTTSGPTConfig, num_slots: int, seed: int = 0,
                      dtype=torch.bfloat16, device="cpu") -> DecodeState:
    assert cfg.max_audio_tokens < (1 << 14), (
        f"max_audio_tokens={cfg.max_audio_tokens} overflows the packed status word"
    )
    s, t, d = num_slots, cfg.max_audio_tokens, cfg.hidden_size
    i32 = dict(dtype=torch.int32, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return DecodeState(
        cache=make_kv_cache(cfg, s, dtype=dtype, device=device),
        sampling=init_sampling_state(s, cfg.num_audio_tokens, device=device),
        seq_lens=torch.zeros((s,), **i32),
        audio_pos=torch.zeros((s,), **i32),
        last_token=torch.zeros((s,), **i32),
        active=torch.zeros((s,), dtype=torch.bool, device=device),
        done=torch.zeros((s,), dtype=torch.bool, device=device),
        tokens_buf=torch.zeros((s, t), **i32),
        latents_buf=torch.zeros((s, t, d), dtype=torch.float32, device=device),
        n_generated=torch.zeros((s,), **i32),
        generator=gen,
    )


def _record_and_advance(cfg: XTTSGPTConfig, state: DecodeState, latent: torch.Tensor,
                        new_tokens: torch.Tensor, was_active: torch.Tensor) -> None:
    """Store (latent, token) at index n_generated for every active slot,
    advance its counters and flag completion (stop token or cap). In place."""
    s = new_tokens.shape[0]
    slot_idx = torch.arange(s, device=new_tokens.device)
    idx = torch.clamp(state.n_generated, 0, cfg.max_audio_tokens - 1).long()
    act = was_active
    state.latents_buf[slot_idx, idx] = torch.where(
        act[:, None], latent.to(state.latents_buf.dtype), state.latents_buf[slot_idx, idx])
    state.tokens_buf[slot_idx, idx] = torch.where(
        act, new_tokens, state.tokens_buf[slot_idx, idx])
    step = act.to(torch.int32)
    state.n_generated += step
    hit_eos = act & (new_tokens == cfg.stop_audio_token)
    max_new = state.sampling.max_new
    limit = torch.where(max_new > 0, torch.clamp(max_new, max=cfg.max_audio_tokens),
                        torch.full_like(max_new, cfg.max_audio_tokens))
    newly_done = hit_eos | (act & (state.n_generated >= limit))
    state.seq_lens += step
    state.audio_pos += step
    state.last_token.copy_(torch.where(act, new_tokens, state.last_token))
    state.active &= ~newly_done
    state.done |= newly_done


def _assemble_prompt(params: dict, cfg: XTTSGPTConfig, cond: torch.Tensor,
                     ids: torch.Tensor, n_ids: int) -> torch.Tensor:
    """[cond ⊕ text(ids)+text_wpe ⊕ start-audio] -> [C + Tb, D]. Row
    C + n_ids carries the start-audio embed (wte[start] + wpe[0]); rows
    beyond are garbage and masked by gpt_prefill's length mask."""
    tb = ids.shape[0]
    pos = torch.clamp(torch.arange(tb, device=ids.device), max=params["text_wpe"].shape[0] - 1)
    text = params["text_wte"][ids.long()] + params["text_wpe"][pos]
    start = params["wte"][cfg.start_audio_token] + params["wpe"][0]
    text[n_ids] = start
    return torch.cat([cond.to(text.dtype), text], dim=0)


@torch.no_grad()
def insert_sequence(params: dict, cfg: XTTSGPTConfig, state: DecodeState,
                    embeds: torch.Tensor, length: int, slot: int, temperature: float,
                    top_p: float, top_k: int, repetition_penalty: float, do_sample: bool,
                    max_new: int = 0, gumbel: torch.Tensor | None = None) -> None:
    """Prefill a prompt into `slot`, sample its first token, mark it active
    (the JAX `_insert_body`). In place."""
    s = state.seq_lens.shape[0]
    dev = state.seq_lens.device
    onehot = torch.arange(s, device=dev) == slot

    h_last = gpt_prefill(params, cfg, embeds, length, slot, state.cache)
    logits, latent = heads(params, h_last[None])  # [1, V], [1, D]

    sp = state.sampling
    sp.temperature[slot] = temperature
    sp.top_p[slot] = top_p
    sp.top_k[slot] = top_k
    sp.repetition_penalty[slot] = repetition_penalty
    sp.do_sample[slot] = bool(do_sample)
    sp.max_new[slot] = max_new
    sp.seen[slot] = _prompt_seen_row(cfg, dev)

    logits_s = torch.where(onehot[:, None], logits, torch.zeros_like(logits))
    tokens = sample_tokens(logits_s, sp, state.generator, gumbel=gumbel, mark=onehot)

    state.seq_lens[slot] = length - 1
    state.audio_pos[slot] = 0
    state.active[slot] = True
    state.done[slot] = False
    state.n_generated[slot] = 0
    latent_full = torch.where(onehot[:, None], latent, torch.zeros_like(latent))
    _record_and_advance(cfg, state, latent_full, tokens, onehot)


def insert_sequence_tokens(params: dict, cfg: XTTSGPTConfig, state: DecodeState,
                           cond: torch.Tensor, ids: torch.Tensor, n_ids: int, slot: int,
                           temperature: float, top_p: float, top_k: int,
                           repetition_penalty: float, do_sample: bool, max_new: int = 0,
                           gumbel: torch.Tensor | None = None) -> None:
    """Assemble the prompt from device conditioning latents [C, D] and padded
    text ids [Tb] (bos/eos included, n_ids real), then insert it."""
    embeds = _assemble_prompt(params, cfg, cond, ids, n_ids).to(state.cache.k.dtype)
    length = cond.shape[0] + n_ids + 1
    insert_sequence(params, cfg, state, embeds, length, slot, temperature, top_p, top_k,
                    repetition_penalty, do_sample, max_new, gumbel=gumbel)


@torch.no_grad()
def decode_steps(params: dict, cfg: XTTSGPTConfig, state: DecodeState, n_steps: int = 1,
                 gumbel: torch.Tensor | None = None) -> None:
    """Run `n_steps` decode iterations over all slots (inactive slots are
    masked out of the bookkeeping). `gumbel` [n_steps, S, V] optionally
    injects the sampling noise. In place."""
    for i in range(n_steps):
        was_active = state.active.clone()
        h = gpt_decode_step(params, cfg, state.last_token, state.audio_pos, state.seq_lens,
                            state.cache)
        logits, latent = heads(params, h)
        tokens = sample_tokens(logits, state.sampling, state.generator,
                               gumbel=None if gumbel is None else gumbel[i], mark=was_active)
        _record_and_advance(cfg, state, latent, tokens, was_active)


def pack_status(state: DecodeState) -> torch.Tensor:
    """One int32 per slot: n_generated | active<<14 | done<<15, so one small
    device-to-host copy carries a block's status."""
    return (state.n_generated + (state.active.to(torch.int32) << 14)
            + (state.done.to(torch.int32) << 15))


def unpack_status(packed: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    n = packed & 0x3FFF
    active = (packed >> 14) & 1
    done = (packed >> 15) & 1
    return active.astype(bool), done.astype(bool), n


def release_slot(state: DecodeState, slot: int) -> None:
    state.active[slot] = False
    state.done[slot] = False
    state.n_generated[slot] = 0


def release_slots(state: DecodeState, mask: torch.Tensor) -> None:
    """Free every slot where mask[s] is True. In place."""
    state.active &= ~mask
    state.done &= ~mask
    state.n_generated.masked_fill_(mask, 0)


def status(state: DecodeState) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(active, done, n_generated) on the host."""
    return unpack_status(pack_status(state).cpu().numpy())


def harvest(state: DecodeState, slot: int) -> tuple[np.ndarray, np.ndarray]:
    """A finished slot's (tokens, latents) on the host, trimmed to its length
    (latents keep the step that predicted a trailing stop token)."""
    n = int(state.n_generated[slot])
    return (state.tokens_buf[slot, :n].cpu().numpy(),
            state.latents_buf[slot, :n].cpu().numpy())


def harvest_latents_device(state: DecodeState, slot: int) -> torch.Tensor:
    """A finished slot's full latent row [T_audio, D] as an independent device
    copy, so the slot can be refilled while the vocoder consumes it;
    positions >= n hold stale values and must be masked by the consumer."""
    return state.latents_buf[slot].clone()
