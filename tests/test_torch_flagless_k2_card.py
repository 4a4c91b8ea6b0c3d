"""An engine built with no kernel flag on one card decodes through K2.

Skips without a CUDA device. On an H100 (the repository's conftest imports
JAX, which a card's machine may lack, so leave it out):

    python -m pytest --noconftest -p no:cacheprovider -q -s tests/test_torch_flagless_k2_card.py

On one card `serving_defaults` gives a bf16 KV cache whose config names no
decode kernel K2 (`flash_decode_append_attention`), which reads each slot's
rows up to that slot's own length, where the dense bf16 body reads every
slot's rows up to the block's length bound.

- An `XTTSv2Engine` given no flag (full widths, two layers) resolves
  flash_decode on its bf16 cache, its first block, which runs eagerly,
  launches K2 on every layer of every step, and each block's
  `decode.block_device` span names the route ("bf16_k2").
- At 4 and at 57 owned slots of 64, a 64-step greedy block replayed as a
  CUDA graph serves tokens that the f32 formulation (K2's plain version:
  f32 operands and probabilities over the same bf16 rows), fed the same
  tokens, scores within the benchmark's `logit_gap` limit of its best
  logit. The other slots are idle at length 0, as a released slot's that
  never held a chunk.
- It prints each route's device ms a step at both occupancies: K2's block
  and the dense body's at the length bound the runner gives it.
- A full-width engine's precompile (64 slots, every decode key's eager
  first block and its capture) launches K2 on the QKV product's rows where
  they lie: the tracing counter `k2.input_copies` does not move.
"""
import asyncio
import dataclasses

import numpy as np
import pytest
import torch

from auralis_tpu_torch.common import tracing
from auralis_tpu_torch.models.xttsv2 import gpt as tgpt
from auralis_tpu_torch.models.xttsv2.config import XTTSConfig, XTTSGPTConfig
from auralis_tpu_torch.models.xttsv2.engine import XTTSv2Engine, serving_defaults
from auralis_tpu_torch.ops.experimental.attention import (
    flash_decode_append_attention,
    flash_decode_plain,
)
from auralis_tpu_torch.runtime import graphs
from auralis_tpu_torch.runtime.decode_loop import (
    _record_and_advance,
    decode_steps_status,
    init_decode_state,
)
from auralis_tpu_torch.runtime.engine_core import DecodeEngine, SamplingOptions, TokenPrompt
from auralis_tpu_torch.runtime.sampler import apply_repetition_penalty

SLOTS = 64
BLOCK = 64
OWNED = (4, 57)
# owned slots' lengths: narration-sized prompts plus what they decoded,
# below the runner's 512 bucket after a 64-step block
LENGTHS = (150, 440)
# a served greedy token's penalised logit may lie this far below the f32
# formulation's best: the limit portbench's correctness check holds served
# greedy tokens to against its f32 reference (portbench/limits)
GAP = 0.09


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; none is visible")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def cfg():
    return serving_defaults("cuda", 1, XTTSGPTConfig()).gpt_config


def test_flagless_engine_resolves_and_launches_k2(card):
    """No flag: the engine's config and its runner's take flash_decode on a
    bf16 cache, the first block of a greedy chunk launches K2 on every
    layer of each of its steps, and the block spans name the route."""
    base = XTTSConfig()
    base.gpt = dataclasses.replace(base.gpt, num_hidden_layers=2)
    engine = XTTSv2Engine.random_init(base, dtype=torch.bfloat16, device=card, decode_slots=8,
                                      max_concurrency=1)
    de = engine.decode_engine
    assert engine.gpt_config.flash_decode and de.cfg.flash_decode
    assert not (engine.gpt_config.kv_int8 or engine.gpt_config.ragged_decode)
    assert de.state.cache.k.dtype == torch.bfloat16
    assert not base.gpt.flash_decode
    g = engine.gpt_config
    rng = np.random.default_rng(0)
    prompt = TokenPrompt(
        cond=torch.from_numpy((0.3 * rng.standard_normal(
            (g.num_cond_latents, g.hidden_size))).astype(np.float32)).to(card),
        ids=rng.integers(5, 300, 40).astype(np.int64))
    steps = de.steps_per_sync
    launched = []
    block = DecodeEngine._decode_block

    def first_block(self, *args, **kwargs):
        before = flash_decode_append_attention.launches
        out = block(self, *args, **kwargs)
        launched.append(flash_decode_append_attention.launches - before)
        return out

    async def serve():
        out = await de.generate(prompt, SamplingOptions(do_sample=False,
                                                        max_new_tokens=steps))
        await de.shutdown()
        return out

    DecodeEngine._decode_block = first_block
    tracing.clear()
    tracing.enable()
    try:
        graphs.reset_counts()
        _, _, n = asyncio.run(serve())
        programs = [e.attrs["program"] for e in tracing.events()
                    if e.name == "decode.block_device"]
    finally:
        DecodeEngine._decode_block = block
        tracing.disable()
        tracing.clear()
    print(f"\nK2 launches by block: {launched} ({g.num_hidden_layers} layers x {steps} steps "
          f"a block); block spans' programs {programs}; graphs {dict(graphs.counts)}; "
          f"{torch.cuda.get_device_name(card)}")
    assert n == steps
    assert launched[0] >= g.num_hidden_layers * steps
    assert programs and set(programs) == {"bf16_k2"}


def test_flagless_precompile_copies_no_k2_rows(card):
    base = XTTSConfig()
    base.gpt = dataclasses.replace(base.gpt, num_hidden_layers=2)
    engine = XTTSv2Engine.random_init(base, dtype=torch.bfloat16, device=card,
                                      decode_slots=SLOTS, max_concurrency=1)
    de = engine.decode_engine
    assert de.cfg.flash_decode and not de.slot_bucketing
    summary = tracing.profile_summary
    before = summary().get("k2.input_copies", {"count": 0})["count"]
    launches = flash_decode_append_attention.launches
    de.precompile()
    torch.cuda.synchronize()
    launched = flash_decode_append_attention.launches - launches
    print(f"\nprecompile of {de.precompile_keys()}: K2 launches {launched}, k2.input_copies "
          f"{summary().get('k2.input_copies')}")
    assert launched > 0
    assert summary().get("k2.input_copies", {"count": 0})["count"] == before
    asyncio.run(de.shutdown())


def _params(cfg, dev, seed=0) -> dict:
    """bf16 GPT weights drawn on the card: matrices and embeddings 0.02 N,
    biases 0.02 N, norm scales 1 + 0.02 N."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def n(*shape, base=0.0):
        return (base + 0.02 * torch.randn(shape, generator=g, device=dev)).to(torch.bfloat16)

    d, i, nl, v = cfg.hidden_size, cfg.n_inner, cfg.num_hidden_layers, cfg.num_audio_tokens
    return {
        "wte": n(v, d), "wpe": n(cfg.audio_position_table, d),
        "blocks": {
            "ln1_scale": n(nl, d, base=1.0), "ln1_bias": n(nl, d),
            "attn_w": n(nl, d, 3 * d), "attn_b": n(nl, 3 * d),
            "attn_proj_w": n(nl, d, d), "attn_proj_b": n(nl, d),
            "ln2_scale": n(nl, d, base=1.0), "ln2_bias": n(nl, d),
            "fc_w": n(nl, d, i), "fc_b": n(nl, i),
            "fc_proj_w": n(nl, i, d), "fc_proj_b": n(nl, d),
        },
        "ln_f_scale": n(d, base=1.0), "ln_f_bias": n(d),
        "final_norm_scale": n(d, base=1.0), "final_norm_bias": n(d),
        "mel_head_w": n(d, v), "mel_head_b": n(v),
    }


@pytest.fixture(scope="module")
def model(card, cfg):
    params = _params(cfg, card)
    g = torch.Generator(device=card).manual_seed(1)
    state = init_decode_state(cfg, SLOTS, device=card)
    for rows in (state.cache.k, state.cache.v):
        for layer in range(cfg.num_hidden_layers):
            rows[layer].normal_(0.0, 0.5, generator=g)
    state.last_token.copy_(torch.randint(0, 1024, (SLOTS,), generator=g, device=card))
    state.sampling.do_sample.fill_(False)
    return params, state


def _occupy(state, owned: int, seed: int) -> None:
    """Slots 0..owned-1 generating at lengths in LENGTHS, the others idle at
    length 0."""
    g = torch.Generator(device=state.device).manual_seed(seed)
    lens = torch.randint(*LENGTHS, (SLOTS,), generator=g, device=state.device)
    lens[owned:] = 0
    state.seq_lens.copy_(lens.int())
    state.audio_pos.copy_(torch.clamp(lens - 100, min=0).int())
    state.active.zero_()
    state.active[:owned] = True
    state.n_generated.zero_()


def _state_tensors(state) -> list:
    return [state.cache.k, state.cache.v, *state.sampling.tensors(), state.seq_lens,
            state.audio_pos, state.last_token, state.active, state.done, state.tokens_buf,
            state.latents_buf, state.n_generated]


def _graph_block(params, cfg, state, bound, reps=5) -> tuple:
    """A 64-step greedy block from `state`: one eager run, then captured and
    replayed from the same state. Returns the replay's tokens [S, 64] and
    the device ms a step over `reps` replays, the state restored after."""
    start = [t.clone() for t in _state_tensors(state)]

    def restore():
        for t, t0 in zip(_state_tensors(state), start):
            t.copy_(t0)

    def block():
        return decode_steps_status(params, cfg, state, BLOCK, len_bound=bound)

    block()
    torch.cuda.synchronize()
    restore()
    graph = graphs.CudaGraph(graphs.CudaGraph.new_pool(), (state.generator,))
    graph.capture(block)
    restore()
    graph.replay()
    torch.cuda.synchronize()
    tokens = state.tokens_buf[:, :BLOCK].clone()
    times = []
    for _ in range(reps):
        restore()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / BLOCK)
    restore()
    return tokens, float(np.median(times))


def _served_gaps(params, cfg, state, tokens, bound) -> torch.Tensor:
    """K2's plain version teacher-forced with `tokens` [S, 64] from `state`
    (restored after): per (slot, step) the gap of the served token's
    penalised logit below the best one, as the decode loop scores them."""
    start = [t.clone() for t in _state_tensors(state)]
    rows = torch.arange(SLOTS, device=state.device)
    gaps = []
    for i in range(BLOCK):
        was_active = state.active.clone()
        h = tgpt.gpt_decode_step(params, cfg, state.last_token, state.audio_pos,
                                 state.seq_lens, state.cache, len_bound=bound)
        logits, latent = tgpt.heads(params, h)
        pen = apply_repetition_penalty(logits, state.sampling.seen,
                                       state.sampling.repetition_penalty)
        tok = tokens[:, i]
        gaps.append(pen.max(dim=-1).values - pen[rows, tok.long()])
        state.sampling.seen[rows, tok.long()] |= was_active
        _record_and_advance(cfg, state, latent, tok, was_active)
    for t, t0 in zip(_state_tensors(state), start):
        t.copy_(t0)
    return torch.stack(gaps, 1)


@pytest.mark.parametrize("owned", OWNED)
def test_graph_block_serves_the_f32_tokens(card, cfg, model, owned, monkeypatch):
    params, state = model
    _occupy(state, owned, seed=owned)
    bound = DecodeEngine.LEN_BUCKETS[1]  # the runner's bucket above every owned length
    assert int(state.seq_lens.max()) + BLOCK < bound
    got, k2_ms = _graph_block(params, cfg, state, bound)
    dense = dataclasses.replace(cfg, flash_decode=False)
    _, dense_ms = _graph_block(params, dense, state, bound)
    monkeypatch.setattr(tgpt, "flash_decode_append_attention", flash_decode_plain)
    gaps = _served_gaps(params, cfg, state, got, bound)[:owned]
    off = gaps > 0
    print(f"\n{owned} of {SLOTS} slots owned: a 64-step graph block {k2_ms:.4f} ms a step "
          f"through K2, {dense_ms:.4f} ms through the dense bf16 body at bound {bound}; the "
          f"f32 formulation prefers another token at {int(off.sum())} of {gaps.numel()}, "
          f"largest gap {gaps.max().item():.5f}; {torch.cuda.get_device_name(card)}")
    assert gaps.max().item() <= GAP
