"""The dense bf16 decode body on the card, against its f32 formulation.

Skips without a CUDA device. On an H100 (the repository's conftest imports
JAX, which a card's machine may lack, so leave it out):

    python -m pytest --noconftest -p no:cacheprovider -q -s tests/test_torch_dense_body_card.py

`gpt._dense_attention` reads the bf16 cache rows in place and sums its
products in f32. Its f32 formulation (`f32_body` below) upcasts every
operand first, which copies each stepped slot's K/V rows to f32; the
operands hold the same bf16 values, so the two differ only in the order of
their f32 sums, and through that in the rounding of a probability to bf16
where the f32 value lies next to a rounding boundary. At the flagless
engine's widths (16 heads of 64, a bf16 cache of 64 slots at mixed lengths)
and at length bounds 256, 512, 768, 1024 and the cache's length:

- the context agrees with the f32 formulation's within one bf16 step of
  every probability (2^-7 of sum_t p_t |v_t|), and the cache rows the two
  write are equal;
- an eager decode step allocates no tensor of [S, bound, H*Dh] elements
  and runs no kernel on the cache rows but the two batched products (a
  check that flags the f32 formulation's copies);
- a 64-step greedy block replayed as a CUDA graph serves tokens that the
  f32 formulation, fed the same tokens, scores within the benchmark's
  `logit_gap` limit of its best logit (so the same token wherever its
  top-2 margin is wider).
  The f32 formulation's own replayed block is printed beside it: with
  random weights a few near-ties flip, and a flipped token sends its slot
  on another path.

The step's LayerNorm and gelu, which run on bf16 rows in one kernel each,
round the f32 result (gelu bit for bit, LayerNorm within one bf16 step).
It also prints each body's time a layer, and whether the live slots of a
slot-bounded step (8 slots) are bit-equal to the full-width step's (cuBLAS
may pick another algorithm for the smaller batch; a note, not a check).
"""
import math

import pytest
import torch

from auralis_tpu_torch.models.xttsv2 import gpt as tgpt
from auralis_tpu_torch.models.xttsv2.config import XTTSGPTConfig
from auralis_tpu_torch.runtime import graphs
from auralis_tpu_torch.runtime.decode_loop import (
    _record_and_advance,
    decode_steps_status,
    init_decode_state,
)
from auralis_tpu_torch.runtime.sampler import apply_repetition_penalty

SLOTS = 64
BLOCK = 64
BOUNDS = (256, 512, 768, 1024, None)  # None: the cache's length
# the ops that may run kernels on a tensor of the rows' shape: the two
# products, and the scatter of the new rows (its destination is the layer's
# cache, of that shape at the cache's length; it writes S rows)
ALLOWED = {"aten::bmm", "aten::_index_put_impl_"}
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
    return XTTSGPTConfig()


def f32_body(cache, layer, q, k, v, slot_idx, lens, live, onehot, scale):
    """`gpt._dense_attention`'s function with every operand upcast to f32:
    [S, bound, HD] f32 copies of the slots' K/V rows, f32 products."""
    s, bound = live.shape
    cache.k[layer, slot_idx, lens] = k.to(cache.k.dtype)
    cache.v[layer, slot_idx, lens] = v.to(cache.v.dtype)
    k_all = cache.k[layer, :s, :bound].float()
    v_all = cache.v[layer, :s, :bound].float()
    qmat = (q.float() * scale)[:, :, None] * onehot[None]  # [S, HD, H]
    qmat = qmat.to(cache.k.dtype).float()
    scores = torch.einsum("stc,sch->sht", k_all, qmat)
    scores = scores.masked_fill(~live[:, None, :], torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(cache.v.dtype).float()
    ctx_full = torch.einsum("sht,stc->shc", probs, v_all)
    return (ctx_full * onehot.T[None]).sum(dim=1)


def _bound(cfg, bound):
    return bound or -(-cfg.max_seq_len // tgpt.CHUNK) * tgpt.CHUNK


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


def _layer_inputs(cfg, dev, bound, seed):
    """One layer's bf16 cache of SLOTS slots (rows 0.5 N), this step's
    q/k/v rows and the body's masks at lengths drawn below `bound`."""
    g = torch.Generator(device=dev).manual_seed(seed)
    d, hd = cfg.hidden_size, cfg.head_dim
    t = _bound(cfg, None)
    rows = [0.5 * torch.randn((1, SLOTS, t, d), generator=g, device=dev) for _ in range(2)]
    cache = tgpt.KVCache(*(r.to(torch.bfloat16) for r in rows))
    q, k, v = ((0.6 * torch.randn((SLOTS, d), generator=g, device=dev)).to(torch.bfloat16)
               for _ in range(3))
    lens = torch.randint(0, bound, (SLOTS,), generator=g, device=dev)
    live = torch.arange(bound, device=dev)[None, :] <= lens[:, None]
    onehot = (torch.arange(d, device=dev)[:, None] // hd
              == torch.arange(d // hd, device=dev)[None, :]).float()
    slot_idx = torch.arange(SLOTS, device=dev)
    return cache, (q, k, v, slot_idx, lens, live, onehot, 1.0 / math.sqrt(hd))


def _clone(cache):
    return tgpt.KVCache(cache.k.clone(), cache.v.clone())


def _tolerance(cache, args):
    """One bf16 step of every probability: 2^-7 sum_t p_t |v_t| per lane,
    with p the f32 formulation's rounded probabilities (after its write)."""
    q, _, _, _, _, live, onehot, scale = args
    s, bound = live.shape
    k_all = cache.k[0, :s, :bound].float()
    v_all = cache.v[0, :s, :bound].float()
    qmat = ((q.float() * scale)[:, :, None] * onehot[None]).to(torch.bfloat16).float()
    scores = torch.einsum("stc,sch->sht", k_all, qmat)
    scores = scores.masked_fill(~live[:, None, :], torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(torch.bfloat16).float()
    mass = torch.einsum("sht,stc->shc", probs, v_all.abs())
    return 2.0 ** -7 * (mass * onehot.T[None]).sum(dim=1)


def _ms(fn, reps=20) -> float:
    """Device ms of one call of `fn`, replayed as a CUDA graph (eager calls
    of these shapes are bound by their launches)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@pytest.mark.parametrize("bound", BOUNDS)
def test_context_within_one_probability_rounding(card, cfg, bound):
    bound = _bound(cfg, bound)
    cache, args = _layer_inputs(cfg, card, bound, seed=bound)
    c_new, c_ref = _clone(cache), _clone(cache)
    got = tgpt._dense_attention(c_new, 0, *args)
    want = f32_body(c_ref, 0, *args)
    assert torch.equal(c_new.k, c_ref.k) and torch.equal(c_new.v, c_ref.v)
    tol = _tolerance(c_ref, args)
    err = (got - want).abs()
    differ = (err > 0).float().mean().item()
    new_ms = _ms(lambda: tgpt._dense_attention(c_new, 0, *args))
    ref_ms = _ms(lambda: f32_body(c_ref, 0, *args))
    print(f"\nbound {bound}: ctx max |err| {err.max().item():.3e}, worst err/tol "
          f"{(err / tol).max().item():.4f}, lanes differing {100 * differ:.2f}%; "
          f"a layer's body {new_ms:.4f} ms (f32 formulation {ref_ms:.4f} ms), "
          f"{torch.cuda.get_device_name(card)}")
    assert bool((err <= tol).all()), (err - tol).max().item()

    # slot-bounded: the 8 low slots alone, against the full-width step's
    c_8 = _clone(cache)
    q, k, v, slot_idx, lens, live, onehot, scale = args
    got_8 = tgpt._dense_attention(c_8, 0, q[:8], k[:8], v[:8], slot_idx[:8], lens[:8],
                                  live[:8], onehot, scale)
    err_8 = (got_8 - got[:8]).abs()
    print(f"  slot-bounded (8 of {SLOTS} slots): bit-equal {torch.equal(got_8, got[:8])}, "
          f"max |diff| {err_8.max().item():.3e}")
    assert bool((err_8 <= tol[:8]).all())


def test_layer_norm_and_gelu_round_the_f32_result(card, cfg):
    """The step's LayerNorm and gelu on bf16 rows, one kernel each: gelu is
    the f32 result rounded once, bit for bit; LayerNorm lies within one
    bf16 step of it."""
    g = torch.Generator(device=card).manual_seed(3)
    d, i = cfg.hidden_size, cfg.n_inner
    x = (3 * torch.randn((SLOTS, d), generator=g, device=card) + 0.5).to(torch.bfloat16)
    y = torch.randn((SLOTS, i), generator=g, device=card).to(torch.bfloat16)
    w = (1 + 0.02 * torch.randn(d, generator=g, device=card)).to(torch.bfloat16)
    b = (0.02 * torch.randn(d, generator=g, device=card)).to(torch.bfloat16)
    assert torch.equal(tgpt._gelu(y), torch.nn.functional.gelu(y.float()).to(y.dtype))
    got = tgpt.layer_norm(x, w, b)
    want = torch.nn.functional.layer_norm(x.float(), (d,), w.float(), b.float(), 1e-5)
    err = (got.float() - want).abs()
    print(f"\nLayerNorm: {100 * (got != want.to(got.dtype)).float().mean().item():.3f}% of "
          f"elements off the rounded f32 result")
    assert bool((err <= 2.0 ** -7 * want.abs()).all())


def _launches_on_rows(fn, shapes) -> list:
    """(op, input shapes) of each op that ran a kernel of its own on a
    tensor of one of `shapes` in an eager run of `fn`."""
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA],
        record_shapes=True)
    with prof:
        fn()
        torch.cuda.synchronize()
    hits = []
    for e in prof.events():
        if e.self_device_time_total > 0 and any(list(s) in shapes for s in e.input_shapes):
            hits.append((e.name, e.input_shapes))
    return hits


def _peak_rise(fn) -> int:
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - before


@pytest.fixture(scope="module")
def model(card, cfg):
    params = _params(cfg, card)
    g = torch.Generator(device=card).manual_seed(1)
    state = init_decode_state(cfg, SLOTS, device=card)
    for rows in (state.cache.k, state.cache.v):
        for layer in range(cfg.num_hidden_layers):
            rows[layer].normal_(0.0, 0.5, generator=g)
    state.last_token.copy_(torch.randint(0, 1024, (SLOTS,), generator=g, device=card))
    state.active.fill_(True)
    state.sampling.do_sample.fill_(False)
    return params, state


def _set_lengths(state, bound, margin, seed):
    g = torch.Generator(device=state.device).manual_seed(seed)
    lens = torch.randint(0, bound - margin, (SLOTS,), generator=g, device=state.device)
    state.seq_lens.copy_(lens.int())
    state.audio_pos.copy_(torch.clamp(lens - 100, min=0).int())


@pytest.mark.parametrize("bound", BOUNDS)
def test_step_reads_rows_in_place(card, cfg, model, bound, monkeypatch):
    params, state = model
    bound = _bound(cfg, bound)
    _set_lengths(state, bound, 1, seed=bound)
    s, d = SLOTS, cfg.hidden_size
    shapes = ([s, bound, d], [s, d, bound])
    row_bytes = s * bound * d * state.cache.k.element_size()

    def step():
        tgpt.gpt_decode_step(params, cfg, state.last_token, state.audio_pos, state.seq_lens,
                             state.cache, len_bound=bound)

    step()
    rise, hits = _peak_rise(step), _launches_on_rows(step, shapes)
    print(f"\nbound {bound}: a step's peak allocation {rise / 2**20:.1f} MiB "
          f"(one [S, bound, HD] bf16 tensor {row_bytes / 2**20:.1f} MiB); "
          f"ops on the rows {sorted({name for name, _ in hits})}")
    assert rise < row_bytes
    assert hits and {name for name, _ in hits} <= ALLOWED, hits

    # the same checks see the f32 formulation's copies
    monkeypatch.setattr(tgpt, "_dense_attention", f32_body)
    step()
    rise, hits = _peak_rise(step), _launches_on_rows(step, shapes)
    assert rise >= row_bytes
    assert {name for name, _ in hits} - ALLOWED, hits


def _block_tokens(params, cfg, state, bound) -> torch.Tensor:
    """A 64-step greedy block from `state`: one eager run, then captured and
    replayed from the same state. Returns the replay's tokens [S, 64]."""
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
    restore()
    return tokens


def _state_tensors(state) -> list:
    return [state.cache.k, state.cache.v, *state.sampling.tensors(), state.seq_lens,
            state.audio_pos, state.last_token, state.active, state.done, state.tokens_buf,
            state.latents_buf, state.n_generated]


def _served_gaps(params, cfg, state, tokens, bound) -> tuple:
    """The f32 formulation teacher-forced with `tokens` [S, 64] from
    `state` (restored after): per (slot, step) the gap of the served
    token's penalised logit below the best one, and the best's margin over
    the runner-up, as the decode loop scores them."""
    start = [t.clone() for t in _state_tensors(state)]
    rows = torch.arange(SLOTS, device=state.device)
    gaps, margins = [], []
    for i in range(BLOCK):
        was_active = state.active.clone()
        h = tgpt.gpt_decode_step(params, cfg, state.last_token, state.audio_pos,
                                 state.seq_lens, state.cache, len_bound=bound)
        logits, latent = tgpt.heads(params, h)
        pen = apply_repetition_penalty(logits, state.sampling.seen,
                                       state.sampling.repetition_penalty)
        top2 = pen.topk(2, dim=-1).values
        tok = tokens[:, i]
        gaps.append(top2[:, 0] - pen[rows, tok.long()])
        margins.append(top2[:, 0] - top2[:, 1])
        state.sampling.seen[rows, tok.long()] |= was_active
        _record_and_advance(cfg, state, latent, tok, was_active)
    for t, t0 in zip(_state_tensors(state), start):
        t.copy_(t0)
    return torch.stack(gaps, 1), torch.stack(margins, 1)


@pytest.mark.parametrize("bound", (768, None))
def test_greedy_block_graph_serves_the_f32_tokens(card, cfg, model, bound, monkeypatch):
    params, state = model
    bound = _bound(cfg, bound)
    _set_lengths(state, bound, BLOCK + 1, seed=bound + 1)
    state.n_generated.zero_()
    got = _block_tokens(params, cfg, state, bound)
    monkeypatch.setattr(tgpt, "_dense_attention", f32_body)
    free = _block_tokens(params, cfg, state, bound)
    gaps, margins = _served_gaps(params, cfg, state, got, bound)
    same = (got == free).all(dim=1)
    first = [int(torch.nonzero(got[s] != free[s])[0]) for s in range(SLOTS) if not same[s]]
    off = gaps > 0
    print(f"\nbound {bound}: the f32 formulation's own block serves {int(same.sum())} of "
          f"{SLOTS} slots' {BLOCK} tokens alike (the others part at steps {sorted(first)}); "
          f"fed the served tokens, it prefers another at {int(off.sum())} of {got.numel()}, "
          f"largest gap {gaps.max().item():.5f}, their margins "
          f"{sorted(round(m, 5) for m in margins[off].tolist())[:12]}")
    assert gaps.max().item() <= GAP
