"""Slot-based continuous-batching decode loop.

Counterpart of auralis_tpu/runtime/decode_loop.py: a fixed-shape `[slots, ...]`
decode state on the device, host-side insertion of prefilled sequences into
free slots, and harvest of finished ones. Vocoder latents accumulate inline
during decode (no second logits-only pass).

The JAX functions are pure and donate the state; here the state is a
dataclass of device tensors that every function below updates IN PLACE
(including the KV cache, through gpt.py). Sampling noise comes from the
state's torch.Generator unless a caller injects it.

Ported: the single insert (`_insert_body`), the burst insert
(`_insert_batch_body`: K prompts through one batched prefill), N-step decode
blocks with `len_bound` (the dense bodies' read bound, keying only their
programs) and `slot_bound` (the step covers the first `slot_bound` slots
only), the block with its packed status left on the device, slot migration,
status packing, release and harvest, with a bf16/f32 or an int8 KV cache.

The per-call values of an insert (slot or slots, id counts, lengths and
the sampling options) and of a migration (source and destination) may be
device tensors, as the JAX functions take traced scalars: nothing on those
paths reads the device on the host, uploads a host list or branches on a
device value, so the runner replays each as a captured CUDA graph
(runtime/graphs.py). Python numbers are accepted as before.

Under a mesh (parallel/mesh.py) with one data shard the params and the KV
cache are the model-sharded `ShardedParams` and `ShardedKVCache`: the gpt
functions run the shards, and every other field of the state lives on the
mesh's first device, so the functions here are the same. With several data
shards the state is a `DataShardedState` (the single-controller form of
JAX's `P(dp)` slot split) and the params a `DataShardedParams`: every
function here takes them, routes each slot to the shard that holds it and
runs that shard's part on its own devices. Sampling noise is drawn once
for all the stepped slots from the state's one generator and each shard
gets its rows, and a shard's row-wise work pads to the whole state's slot
count, so a data-sharded run gives the unsharded run's bits, sampled or
greedy. A burst that spans shards runs its batched prefill on each shard
it reaches, which keeps its own lanes' rows (JAX replicates the prefill
over the data axis the same way).

A slot-bounded step needs no merge: `_slice_state` returns views of the
first `sb` slots of every per-slot tensor (the cache stays whole, its rows
addressed by slot), and every update below is in place, so it writes
through the views into the full state.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..models.xttsv2.config import XTTSGPTConfig
from ..models.xttsv2.gpt import (
    KVCache,
    gpt_decode_step,
    gpt_prefill,
    gpt_prefill_batched,
    device_scalar,
    device_values,
    heads,
    make_kv_cache,
)
from ..ops.quant import pad_rows
from .sampler import SamplingState, gumbel_noise, init_sampling_state, sample_tokens

PREFILL_BUCKETS = (64, 128, 256, 512)


def _prompt_seen_row(cfg: XTTSGPTConfig, device="cuda") -> torch.Tensor:
    """Initial seen-mask row for a fresh sequence: with
    cfg.reppen_penalize_prompt_ids (reference parity) ids {1,
    start_audio_token} are penalized from step 0."""
    ids = torch.arange(cfg.num_audio_tokens, device=device)
    if cfg.reppen_penalize_prompt_ids:
        # built by comparison: a host number written into one element is an
        # upload, which a captured insert cannot hold
        return (ids == 1) | (ids == cfg.start_audio_token)
    return torch.zeros_like(ids, dtype=torch.bool)


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

    @property
    def num_slots(self) -> int:
        return self.seq_lens.shape[0]

    @property
    def device(self) -> torch.device:
        """Where the per-slot fields live."""
        return self.seq_lens.device


def init_decode_state(cfg: XTTSGPTConfig, num_slots: int, seed: int = 0,
                      dtype=torch.bfloat16, device="cuda") -> DecodeState:
    """The decode state of `num_slots` slots on `device`: the card unless the
    caller names another (raises without one)."""
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
                     ids: torch.Tensor, n_ids) -> torch.Tensor:
    """[cond ⊕ text(ids)+text_wpe ⊕ start-audio] -> [C + Tb, D]. Row
    C + n_ids carries the start-audio embed (wte[start] + wpe[0]); rows
    beyond are garbage and masked by gpt_prefill's length mask. `n_ids` is
    an int or a 0-d integer tensor on the device."""
    n = device_scalar(n_ids, torch.int64, ids.device).reshape(1)
    return _assemble_prompts(params, cfg, cond[None], ids[None], n)[0]


def _set_rows(field: torch.Tensor, onehot: torch.Tensor, value) -> None:
    """field[s] = value on the slots where onehot [S] is set; `value` a
    number or a 0-d tensor on the device. In place, no host read."""
    value = device_scalar(value, field.dtype, field.device)
    field.copy_(torch.where(onehot.reshape(-1, *(1,) * (field.dim() - 1)), value, field))


@torch.no_grad()
def insert_sequence(params: dict, cfg: XTTSGPTConfig, state: DecodeState,
                    embeds: torch.Tensor, length, slot, temperature, top_p, top_k,
                    repetition_penalty, do_sample, max_new=0,
                    gumbel: torch.Tensor | None = None, shard_lanes=None) -> None:
    """Prefill a prompt into `slot`, sample its first token, mark it active
    (the JAX `_insert_body`). `length`, `slot` and the sampling options are
    Python numbers or 0-d tensors on the device (a captured insert's staged
    inputs; nothing is read on the host). On a `DataShardedState` a device
    `slot` needs `shard_lanes`, the lanes (here one) per data shard, which
    names the shard that holds it. In place."""
    if isinstance(state, DataShardedState):
        (i, local, _), = _routes(state, [slot] if shard_lanes is None else slot.reshape(1),
                                 shard_lanes)
        sh = state.shards[i]
        return insert_sequence(params.shards[i], cfg, sh, embeds.to(sh.device), length, local[0],
                               temperature, top_p, top_k, repetition_penalty, do_sample, max_new,
                               gumbel=_noise(state, gumbel, state.num_slots)[i])
    s = state.seq_lens.shape[0]
    dev = state.seq_lens.device
    slot = device_scalar(slot, torch.int64, dev)
    length = device_scalar(length, torch.int64, dev)
    onehot = torch.arange(s, device=dev) == slot

    h_last = gpt_prefill(params, cfg, embeds, length, slot, state.cache)
    logits, latent = heads(params, h_last[None])  # [1, V], [1, D]

    sp = state.sampling
    for field, value in ((sp.temperature, temperature), (sp.top_p, top_p), (sp.top_k, top_k),
                         (sp.repetition_penalty, repetition_penalty),
                         (sp.do_sample, do_sample), (sp.max_new, max_new)):
        _set_rows(field, onehot, value)
    _set_rows(sp.seen, onehot, _prompt_seen_row(cfg, dev))

    logits_s = torch.where(onehot[:, None], logits, torch.zeros_like(logits))
    tokens = sample_tokens(logits_s, sp, state.generator, gumbel=gumbel, mark=onehot)

    _set_rows(state.seq_lens, onehot, length - 1)
    for field in (state.audio_pos, state.done, state.n_generated):
        _set_rows(field, onehot, 0)
    _set_rows(state.active, onehot, True)
    latent_full = torch.where(onehot[:, None], latent, torch.zeros_like(latent))
    _record_and_advance(cfg, state, latent_full, tokens, onehot)


@torch.no_grad()
def insert_sequences(params: dict, cfg: XTTSGPTConfig, state: DecodeState,
                     embeds: torch.Tensor, lengths, slots, temperature, top_p, top_k,
                     repetition_penalty, do_sample, max_new=0,
                     gumbel: torch.Tensor | None = None, shard_lanes=None,
                     lanes: slice | None = None) -> None:
    """Burst insert (the JAX `_insert_batch_body`): prefill K prompts
    `embeds` [K, T_pad, D] in one batched pass (gpt_prefill_batched), set
    the K slots' sampling rows and seen rows, sample all K first tokens in
    one `sample_tokens` call over [S, V] and record them. `lengths` [K] (0
    on padding lanes); `slots` [K] host ints (>= num_slots on padding lanes,
    which touch nothing) or a [K] integer tensor on the device of distinct
    real slots (a captured burst: no padding lane, nothing read on the
    host); the sampling arguments are [K] sequences or tensors, or scalars
    for every lane. `gumbel` [S, V] optionally injects the noise. One draw
    covers the burst, so sampled tokens differ from K single inserts; greedy
    ones are equal. With device `slots`, `lanes` (a slice of the K lanes)
    names the lanes they belong to, the others being computed but written
    nowhere. On a `DataShardedState` device `slots` need `shard_lanes`, the
    number of lanes per data shard, the lanes ordered by shard; host slots
    may span shards in any order. In place."""
    if isinstance(state, DataShardedState):
        noise = _noise(state, gumbel, state.num_slots)
        for i, local, part in _routes(state, slots, shard_lanes):
            sh = state.shards[i]
            insert_sequences(params.shards[i], cfg, sh, embeds.to(sh.device), lengths, local,
                             temperature, top_p, top_k, repetition_penalty, do_sample, max_new,
                             gumbel=noise[i], lanes=part)
        return
    s = state.seq_lens.shape[0]
    dev = state.seq_lens.device
    kb = embeds.shape[0]
    lengths = device_values(lengths, torch.int32, dev)
    if torch.is_tensor(slots):  # every lane real, or those of `lanes`
        lane_idx, slot_idx = lanes, slots.to(device=dev, dtype=torch.long)
        h_last = gpt_prefill_batched(params, cfg, embeds, lengths, slot_idx, state.cache,
                                     lanes=lanes)
    else:
        slots = [int(x) for x in slots]
        lanes = [i for i, x in enumerate(slots) if x < s]
        h_last = gpt_prefill_batched(params, cfg, embeds, lengths, slots, state.cache)
        if not lanes:
            return
        lane_idx = torch.tensor(lanes, dtype=torch.long, device=dev)
        slot_idx = torch.tensor([slots[i] for i in lanes], dtype=torch.long, device=dev)

    def real(lane_vals: torch.Tensor) -> torch.Tensor:
        return lane_vals if lane_idx is None else lane_vals[lane_idx]

    logits, latent = heads(params, h_last)  # [K, V], [K, D]
    khot = (torch.arange(s, device=dev)[:, None] == slot_idx[None, :]).any(dim=1)

    sp = state.sampling
    for field, values in ((sp.temperature, temperature), (sp.top_p, top_p), (sp.top_k, top_k),
                          (sp.repetition_penalty, repetition_penalty),
                          (sp.do_sample, do_sample), (sp.max_new, max_new)):
        field[slot_idx] = real(device_values(values, field.dtype, dev).expand(kb))
    sp.seen[slot_idx] = _prompt_seen_row(cfg, dev)

    logits_s = torch.zeros((s, logits.shape[-1]), dtype=logits.dtype, device=dev)
    logits_s[slot_idx] = real(logits)
    tokens = sample_tokens(logits_s, sp, state.generator, gumbel=gumbel, mark=khot)

    state.seq_lens[slot_idx] = real(lengths) - 1
    for field in (state.audio_pos, state.done, state.n_generated):
        _set_rows(field, khot, 0)
    _set_rows(state.active, khot, True)
    latent_full = torch.zeros((s, latent.shape[-1]), dtype=latent.dtype, device=dev)
    latent_full[slot_idx] = real(latent)
    _record_and_advance(cfg, state, latent_full, tokens, khot)


def _assemble_prompts(params: dict, cfg: XTTSGPTConfig, cond: torch.Tensor,
                      ids: torch.Tensor, n_ids: torch.Tensor) -> torch.Tensor:
    """`_assemble_prompt` for every lane at once: cond [K, C, D], padded
    ids [K, Tb], true id counts n_ids [K] (on the device; no host read) ->
    [K, C + Tb, D]."""
    tb = ids.shape[1]
    pos = torch.arange(tb, device=ids.device)
    text = params["text_wte"][ids.long()] + params["text_wpe"][
        torch.clamp(pos, max=params["text_wpe"].shape[0] - 1)][None]
    start = params["wte"][cfg.start_audio_token] + params["wpe"][0]
    text = torch.where((pos[None, :] == n_ids[:, None])[..., None], start, text)
    return torch.cat([cond.to(text.dtype), text], dim=1)


def insert_sequences_tokens(params: dict, cfg: XTTSGPTConfig, state: DecodeState,
                            cond: torch.Tensor, ids: torch.Tensor, n_ids, slots, temperature,
                            top_p, top_k, repetition_penalty, do_sample, max_new=0,
                            gumbel: torch.Tensor | None = None, shard_lanes=None) -> None:
    """Transfer-thin burst insert: per-lane prompt assembly from device
    conditioning latents cond [K, C, D] (often one voice repeated) and
    padded text ids [K, Tb] (one upload for the burst), then
    `insert_sequences`. Lengths are C + n_ids + 1, and 0 on padding lanes
    (host slots >= num_slots), as in JAX; device `slots` have no padding
    lane (and on a `DataShardedState` need `shard_lanes`, as
    `insert_sequences` takes them). The prompts are in the cache dtype, or
    bf16 under cfg.kv_int8."""
    dev = state.device
    n_ids = device_values(n_ids, torch.long, dev)
    embeds = _assemble_prompts(params, cfg, cond.to(dev), ids.to(dev), n_ids).to(
        prompt_dtype(cfg, state))
    lengths = cond.shape[1] + n_ids + 1
    if not torch.is_tensor(slots):
        real = torch.tensor([int(x) < state.num_slots for x in slots], device=dev)
        lengths = torch.where(real, lengths, 0)
    insert_sequences(params, cfg, state, embeds, lengths, slots, temperature, top_p, top_k,
                     repetition_penalty, do_sample, max_new, gumbel=gumbel,
                     shard_lanes=shard_lanes)


def insert_sequence_tokens(params: dict, cfg: XTTSGPTConfig, state: DecodeState,
                           cond: torch.Tensor, ids: torch.Tensor, n_ids, slot, temperature,
                           top_p, top_k, repetition_penalty, do_sample, max_new=0,
                           gumbel: torch.Tensor | None = None, shard_lanes=None) -> None:
    """Assemble the prompt from device conditioning latents [C, D] and padded
    text ids [Tb] (bos/eos included, n_ids real), then insert it. The prompt
    is in the cache dtype, or bf16 under cfg.kv_int8 (the activation dtype).
    The per-call values are Python numbers or 0-d tensors on the device, as
    `insert_sequence` takes them (with `shard_lanes` for a device slot on a
    `DataShardedState`)."""
    dev = state.device
    embeds = _assemble_prompt(params, cfg, cond.to(dev), ids.to(dev), n_ids).to(
        prompt_dtype(cfg, state))
    length = cond.shape[0] + n_ids + 1
    insert_sequence(params, cfg, state, embeds, length, slot, temperature, top_p, top_k,
                    repetition_penalty, do_sample, max_new, gumbel=gumbel,
                    shard_lanes=shard_lanes)


def _slice_state(state: DecodeState, sb: int) -> DecodeState:
    """Views of the first `sb` slots of every per-slot tensor; the cache is
    whole (its rows are addressed by slot, and a step over [sb] tokens
    reads and writes slots 0..sb-1 only). In-place updates of the views
    write through into `state`: this is the JAX `_slice_state` and
    `_merge_state` together."""
    return DecodeState(
        cache=state.cache,
        sampling=SamplingState(*(t[:sb] for t in state.sampling.tensors())),
        seq_lens=state.seq_lens[:sb],
        audio_pos=state.audio_pos[:sb],
        last_token=state.last_token[:sb],
        active=state.active[:sb],
        done=state.done[:sb],
        tokens_buf=state.tokens_buf[:sb],
        latents_buf=state.latents_buf[:sb],
        n_generated=state.n_generated[:sb],
        generator=state.generator,
    )


@torch.no_grad()
def decode_steps(params: dict, cfg: XTTSGPTConfig, state: DecodeState, n_steps: int = 1,
                 len_bound: int | None = None, slot_bound: int | None = None,
                 gumbel: torch.Tensor | None = None) -> None:
    """Run `n_steps` decode iterations (inactive slots are masked out of
    the bookkeeping). `len_bound` caps the dense bodies' attention read: the
    caller guarantees max(seq_lens) + n_steps < len_bound. `slot_bound`
    restricts the steps to the first `slot_bound` slots (the runner fills
    the lowest free slot and compacts stragglers down, so few live slots sit
    low); slots >= slot_bound must not be active. The noise is then drawn
    for [slot_bound, V], so sampled trajectories depend on the bound and
    greedy ones do not. `gumbel` [n_steps, S', V] (S' = the stepped slots)
    optionally injects the noise. On a `DataShardedState` the shards whose
    slots meet [0, slot_bound) step their part, each step's noise drawn
    once for the S' slots. In place."""
    if isinstance(state, DataShardedState):
        bound = state.num_slots if slot_bound is None else min(slot_bound, state.num_slots)
        for i in range(n_steps):
            noise = _noise(state, None if gumbel is None else gumbel[i], bound)
            for p, sh, nz in zip(params.shards, state.shards, noise):
                if nz is not None:
                    n = nz.shape[0]
                    _decode_steps(p, cfg, sh, 1, len_bound, n if n < sh.num_slots else None,
                                  nz[None], rows=state.num_slots)
        return
    _decode_steps(params, cfg, state, n_steps, len_bound, slot_bound, gumbel)


def _decode_steps(params: dict, cfg: XTTSGPTConfig, state: DecodeState, n_steps: int,
                  len_bound: int | None, slot_bound: int | None, gumbel: torch.Tensor | None,
                  rows: int | None = None) -> None:
    """`decode_steps` on a DecodeState; the row-wise work pads to `rows`
    (default the cache's slot count; a data shard's step pads to the whole
    state's)."""
    if slot_bound is not None and slot_bound < state.seq_lens.shape[0]:
        state = _slice_state(state, slot_bound)
    rows = rows or state.cache.num_slots
    for i in range(n_steps):
        was_active = state.active.clone()
        h = gpt_decode_step(params, cfg, state.last_token, state.audio_pos, state.seq_lens,
                            state.cache, len_bound=len_bound, rows=rows)
        # the heads' product at the cache's slot count of rows, as in
        # gpt_decode_step: a slot's logits do not depend on the bound
        s = h.shape[0]
        logits, latent = (t[:s] for t in heads(params, pad_rows(h, rows)))
        tokens = sample_tokens(logits, state.sampling, state.generator,
                               gumbel=None if gumbel is None else gumbel[i], mark=was_active)
        _record_and_advance(cfg, state, latent, tokens, was_active)


def decode_steps_status(params: dict, cfg: XTTSGPTConfig, state: DecodeState,
                        n_steps: int = 1, len_bound: int | None = None,
                        slot_bound: int | None = None,
                        gumbel: torch.Tensor | None = None) -> torch.Tensor:
    """`decode_steps`, then the packed status vector of every slot as a
    device tensor (no host sync: the caller copies it when it chooses)."""
    decode_steps(params, cfg, state, n_steps, len_bound, slot_bound, gumbel)
    return pack_status(state)


@torch.no_grad()
def migrate_slot(state: DecodeState, src, dst, shards: tuple | None = None) -> None:
    """Move slot `src`'s whole decode state into slot `dst` (which must be
    free): KV rows (and int8 scales), the sampling rows including `seen`,
    the counters, and the token and latent buffers; then clear `src`'s
    `active`, `done` and `n_generated`. Device-local copies, no host sync;
    `src` and `dst` are ints or 0-d integer tensors on the device (a
    captured migration's staged inputs). On a `DataShardedState` the two
    slots may lie in different shards (the rows then move between their
    devices); device `src`/`dst` need `shards`, the data shards that hold
    them. The runner migrates drain stragglers down so the slot bound can
    narrow. A packed status read before the move indexes stale slots. In
    place."""
    if isinstance(state, DataShardedState):
        ends = []
        for slot, shard in ((src, None if shards is None else shards[0]),
                            (dst, None if shards is None else shards[1])):
            (i, local, _), = _routes(state, [slot] if shard is None else slot.reshape(1),
                                     None if shard is None else _one_lane(state, shard))
            ends.append((state.shards[i], local[0]))
        (a, ls), (b, ld) = ends
        _move_slot(a, b, ls, ld)
        return
    _move_slot(state, state, src, dst)


def _move_slot(src_state: DecodeState, dst_state: DecodeState, src, dst) -> None:
    """Slot `src` of src_state into slot `dst` of dst_state (the same state
    or another data shard's), then `src` cleared; see `migrate_slot`."""
    src = device_scalar(src, torch.int64, src_state.device).reshape(1)
    dst = device_scalar(dst, torch.int64, dst_state.device).reshape(1)
    # every model shard's rows under a mesh, each on its own device
    for ts, td in zip(src_state.cache.tensors(), dst_state.cache.tensors()):
        td[:, dst.to(td.device)] = ts[:, src.to(ts.device)].to(td.device)
    fields = ("seq_lens", "audio_pos", "last_token", "active", "done", "tokens_buf",
              "latents_buf", "n_generated")
    for ts, td in zip((*src_state.sampling.tensors(), *(getattr(src_state, f) for f in fields)),
                      (*dst_state.sampling.tensors(), *(getattr(dst_state, f) for f in fields))):
        td[dst] = ts[src].to(td.device)
    src_hot = torch.arange(src_state.num_slots, device=src_state.device) == src
    for field in (src_state.active, src_state.done, src_state.n_generated):
        _set_rows(field, src_hot, 0)


def pack_status(state: DecodeState) -> torch.Tensor:
    """One int32 per slot: n_generated | active<<14 | done<<15, so one small
    device-to-host copy carries a block's status (on the first data
    shard's device for a `DataShardedState`)."""
    if isinstance(state, DataShardedState):
        return torch.cat([pack_status(sh).to(state.device) for sh in state.shards])
    return (state.n_generated + (state.active.to(torch.int32) << 14)
            + (state.done.to(torch.int32) << 15))


def unpack_status(packed: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    n = packed & 0x3FFF
    active = (packed >> 14) & 1
    done = (packed >> 15) & 1
    return active.astype(bool), done.astype(bool), n


def release_slot(state: DecodeState, slot: int) -> None:
    if isinstance(state, DataShardedState):
        i, local = state.locate(slot)
        return release_slot(state.shards[i], local)
    state.active[slot] = False
    state.done[slot] = False
    state.n_generated[slot] = 0


def release_slots(state: DecodeState, mask: torch.Tensor) -> None:
    """Free every slot where mask[s] is True. In place."""
    if isinstance(state, DataShardedState):
        per = state.per_shard
        for i, sh in enumerate(state.shards):
            release_slots(sh, mask[i * per:(i + 1) * per].to(sh.device))
        return
    state.active &= ~mask
    state.done &= ~mask
    state.n_generated.masked_fill_(mask, 0)


def status(state: DecodeState) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(active, done, n_generated) on the host."""
    return unpack_status(pack_status(state).cpu().numpy())


def harvest(state: DecodeState, slot: int) -> tuple[np.ndarray, np.ndarray]:
    """A finished slot's (tokens, latents) on the host, trimmed to its length
    (latents keep the step that predicted a trailing stop token)."""
    if isinstance(state, DataShardedState):
        i, local = state.locate(slot)
        return harvest(state.shards[i], local)
    n = int(state.n_generated[slot])
    return (state.tokens_buf[slot, :n].cpu().numpy(),
            state.latents_buf[slot, :n].cpu().numpy())


def harvest_latents_device(state: DecodeState, slot: int) -> torch.Tensor:
    """A finished slot's full latent row [T_audio, D] as an independent device
    copy (on the first data shard's device for a `DataShardedState`), so
    the slot can be refilled while the vocoder consumes it; positions >= n
    hold stale values and must be masked by the consumer."""
    if isinstance(state, DataShardedState):
        i, local = state.locate(slot)
        return harvest_latents_device(state.shards[i], local).to(state.device)
    return state.latents_buf[slot].clone()


def harvest_tokens_device(state: DecodeState, slots: list[int]) -> torch.Tensor:
    """The token rows [len(slots), T_audio] of `slots` gathered on the
    device (the first data shard's for a `DataShardedState`), for one copy
    to the host."""
    if isinstance(state, DataShardedState):
        rows = []
        for slot in slots:
            i, local = state.locate(slot)
            rows.append(state.shards[i].tokens_buf[local:local + 1].to(state.device))
        return torch.cat(rows)
    return state.tokens_buf[torch.tensor(slots, dtype=torch.long).to(state.device)]


def prompt_dtype(cfg: XTTSGPTConfig, state) -> torch.dtype:
    """Prompt embeddings' dtype: bf16 under kv_int8 (the activation dtype),
    else the cache's."""
    if cfg.kv_int8:
        return torch.bfloat16
    return (state.shards[0] if isinstance(state, DataShardedState) else state).cache.dtype


# ------------------------------------------------------- data-sharded states


class DataShardedParams(dict):
    """The GPT parameters of a mesh's data shards (parallel/mesh.py
    `shard_gpt_params`): `shards[i]` is data shard i's set, a
    `ShardedParams` over its model shards or a dict on its device. The dict
    holds shard 0's replicated leaves (embeddings, ln_f, final_norm, the
    mel head), which prompt assembly and `heads` read on the first
    device."""

    def __init__(self, shards: list):
        super().__init__({k: v for k, v in shards[0].items() if k != "blocks"})
        self.shards = shards


@dataclass
class DataShardedState:
    """A decode state split over a mesh's data shards (parallel/mesh.py
    `shard_decode_state`): `shards[i]` is a `DecodeState` of slots
    [i P, (i + 1) P), P = num_slots / shards, dcn-major then data as JAX's
    `P(dp)` cuts the slot axis; its cache lives on its model devices and its
    per-slot fields on its first device. `generator` is the state's one
    generator: the functions of this module draw each step's noise from it
    for every stepped slot at once and hand each shard its rows, so a draw
    does not depend on the sharding (JAX replicates the key). Each shard's
    own `generator` is that object too, and never drawn from directly."""

    shards: list
    generator: torch.Generator

    @property
    def num_slots(self) -> int:
        return sum(sh.num_slots for sh in self.shards)

    @property
    def per_shard(self) -> int:
        return self.shards[0].num_slots

    @property
    def device(self) -> torch.device:
        """The first data shard's device: status, harvested rows and
        prompt assembly land there."""
        return self.shards[0].device

    def locate(self, slot: int) -> tuple[int, int]:
        """(data shard, slot within it) of a host slot index."""
        slot = int(slot)
        if not 0 <= slot < self.num_slots:
            raise IndexError(f"slot {slot} outside [0, {self.num_slots})")
        return divmod(slot, self.per_shard)

    def field(self, name: str) -> torch.Tensor:
        """A per-slot field of every shard (a DecodeState field or a
        SamplingState one) as one [S, ...] tensor on the first device: a
        copy, for reading."""
        def get(sh):
            return getattr(sh.sampling if hasattr(sh.sampling, name) else sh, name)

        return torch.cat([get(sh).to(self.device) for sh in self.shards])


def _one_lane(state: DataShardedState, shard: int) -> tuple:
    return tuple(int(i == shard) for i in range(len(state.shards)))


def _routes(state: DataShardedState, slots, shard_lanes) -> list:
    """(shard, its slots, its lanes) for every data shard that receives a
    lane of `slots`. Host slots (numbers; >= num_slots marks a padding
    lane): each shard gets every lane, its own at their local index and the
    others as padding (its slot count), lanes None. Device slots with
    `shard_lanes` (lanes per shard, the lanes ordered by shard): each shard
    gets its lanes' slots made local on its device and their slice."""
    per, out = state.per_shard, []
    if shard_lanes is None:
        slots = [int(x) for x in slots]
        for i in range(len(state.shards)):
            lo = i * per
            local = [x - lo if lo <= x < lo + per else per for x in slots]
            if any(x < per for x in local):
                out.append((i, local, None))
        return out
    if len(shard_lanes) != len(state.shards) or sum(shard_lanes) != slots.shape[0]:
        raise ValueError(f"shard_lanes {tuple(shard_lanes)} do not split {slots.shape[0]} lanes "
                         f"over {len(state.shards)} data shards")
    off = 0
    for i, (sh, n) in enumerate(zip(state.shards, shard_lanes)):
        if n:
            local = slots[off:off + n].to(device=sh.device, dtype=torch.long) - i * per
            out.append((i, local, slice(off, off + n)))
        off += n
    return out


def _noise(state: DataShardedState, gumbel: torch.Tensor | None, rows: int) -> list:
    """Each data shard's rows of the Gumbel noise [rows, V] for the first
    `rows` slots, on its device (None for a shard past them): `gumbel` when
    given, else one draw from the state's generator, as an unsharded step
    over those slots draws it."""
    if gumbel is None:
        vocab = state.shards[0].sampling.seen.shape[1]
        gumbel = gumbel_noise((rows, vocab), state.generator, state.generator.device)
    per, out = state.per_shard, []
    for i, sh in enumerate(state.shards):
        lo = i * per
        n = min(rows, lo + per) - lo
        out.append(gumbel[lo:lo + n].to(sh.device) if n > 0 else None)
    return out
