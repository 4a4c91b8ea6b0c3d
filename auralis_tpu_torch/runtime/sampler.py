"""Vectorized token sampler over decode slots.

Counterpart of auralis_tpu/runtime/sampler.py: the XTTS repetition penalty
(divide positive / multiply negative logits of every previously-seen token),
temperature, top-k, top-p and greedy fallback, batched over slots.

The JAX sampler draws Gumbel noise from its PRNG key; torch cannot reproduce
those bits. `sample_tokens` therefore takes the noise as an optional
argument (a test feeds it JAX's own draw and must get the same tokens), and
otherwise draws it from an explicit torch.Generator. The noise is added BY
RANK, after the descending sort, exactly as the JAX sampler does.
"""
from __future__ import annotations

from dataclasses import dataclass, fields

import torch

NEG_INF = torch.finfo(torch.float32).min


@dataclass
class SamplingState:
    """Per-slot sampling configuration + seen-token mask (tensors on the
    decode device; updated in place by the decode loop)."""

    temperature: torch.Tensor  # [S] f32
    top_p: torch.Tensor  # [S] f32
    top_k: torch.Tensor  # [S] i32 (0 => disabled)
    repetition_penalty: torch.Tensor  # [S] f32
    do_sample: torch.Tensor  # [S] bool
    max_new: torch.Tensor  # [S] i32 (0 => config max_audio_tokens)
    seen: torch.Tensor  # [S, V] bool

    def tensors(self) -> list[torch.Tensor]:
        return [getattr(self, f.name) for f in fields(self)]


def init_sampling_state(num_slots: int, vocab_size: int, device="cpu") -> SamplingState:
    s = num_slots
    return SamplingState(
        temperature=torch.full((s,), 0.75, dtype=torch.float32, device=device),
        top_p=torch.full((s,), 0.85, dtype=torch.float32, device=device),
        top_k=torch.full((s,), 50, dtype=torch.int32, device=device),
        repetition_penalty=torch.full((s,), 5.0, dtype=torch.float32, device=device),
        do_sample=torch.ones((s,), dtype=torch.bool, device=device),
        max_new=torch.zeros((s,), dtype=torch.int32, device=device),
        seen=torch.zeros((s, vocab_size), dtype=torch.bool, device=device),
    )


def apply_repetition_penalty(logits: torch.Tensor, seen: torch.Tensor,
                             penalty: torch.Tensor) -> torch.Tensor:
    """XTTS-style penalty: seen & logit>0 -> /p ; seen & logit<0 -> *p."""
    p = penalty[:, None]
    penalized = torch.where(logits > 0, logits / p, logits * p)
    return torch.where(seen, penalized, logits)


def gumbel_noise(shape, generator: torch.Generator | None, device) -> torch.Tensor:
    """Standard Gumbel draws, -log(-log(u)) with u in (tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def sample_tokens(logits: torch.Tensor, state: SamplingState,
                  generator: torch.Generator | None = None,
                  gumbel: torch.Tensor | None = None,
                  mark: torch.Tensor | None = None) -> torch.Tensor:
    """Sample the next token for every slot (logits [S, V] f32). Returns
    tokens [S] int32 and marks them in `state.seen` IN PLACE — only on the
    rows where `mark` [S] bool is set, when given (the JAX callers protect
    the other rows' masks the same way)."""
    s, v = logits.shape
    logits = apply_repetition_penalty(logits, state.seen, state.repetition_penalty)
    greedy = torch.argmax(logits, dim=-1)

    temp = torch.clamp(state.temperature, min=1e-5)[:, None]
    scaled = logits / temp
    # stable ascending sort of -scaled == lax.sort's order (ties keep index order)
    neg_sorted, order = torch.sort(-scaled, dim=-1, stable=True)
    sorted_logits = -neg_sorted

    rank = torch.arange(v, device=logits.device)[None, :]
    k = torch.where(state.top_k <= 0, torch.full_like(state.top_k, v), state.top_k)[:, None]
    keep_k = rank < k
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_p = (cum - probs) < state.top_p[:, None]
    keep = keep_k & keep_p
    keep[:, 0] = True

    masked = torch.where(keep, sorted_logits, torch.full_like(sorted_logits, NEG_INF))
    if gumbel is None:
        gumbel = gumbel_noise((s, v), generator, logits.device)
    choice_rank = torch.argmax(masked + gumbel, dim=-1)
    sampled = torch.gather(order, 1, choice_rank[:, None])[:, 0]

    tokens = torch.where(state.do_sample, sampled, greedy).to(torch.int32)
    rows, cols = torch.arange(s, device=logits.device), tokens.long()
    if mark is None:
        state.seen[rows, cols] = True
    else:
        state.seen[rows, cols] = state.seen[rows, cols] | mark
    return tokens
