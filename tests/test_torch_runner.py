"""The port's concurrency machinery against the JAX package on CPU, tiny
config (2 layers, width 64, 4 heads): the batched prefill, the burst insert,
decode blocks at a slot bound and a length bound, slot migration, the
runner's bucketing, compaction and W8A8-policy decisions, the engine's
policy, kernels K2 and K4 (plain versions) on a slot-sliced step, and the
pipelined runner end to end. Inputs are numpy arrays from a seed; each
tolerance is stated where it is asserted."""
import asyncio
import dataclasses
import math
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from helpers import build_tiny_engine
from test_torch_int8 import RAGGED_F64_ATOL, _jax_ragged_blocking, _ragged_f64

from auralis_tpu.models.xttsv2 import gpt as jgpt
from auralis_tpu.models.xttsv2.config import tiny_test_config as jax_tiny
from auralis_tpu.ops.experimental.attention import CHUNK
from auralis_tpu.ops.experimental.attention import (
    flash_decode_append_attention as jax_flash_decode,
)
from auralis_tpu.runtime import decode_loop as jloop
from auralis_tpu.runtime import engine_core as jcore
from auralis_tpu_torch.models.xttsv2 import gpt as tgpt
from auralis_tpu_torch.models.xttsv2 import weights as tw
from auralis_tpu_torch.models.xttsv2.config import tiny_test_config as torch_tiny
from auralis_tpu_torch.models.xttsv2.engine import XTTSv2Engine
from auralis_tpu_torch.ops.experimental.attention import (
    flash_decode_append_attention,
    ragged_decode_attention,
)
from auralis_tpu_torch.runtime import decode_loop as tloop
from auralis_tpu_torch.runtime import engine_core as tcore
from auralis_tpu_torch.runtime import sampler as tsamp

STATE_INTS = ("tokens_buf", "n_generated", "seq_lens", "audio_pos", "active", "done")


def _params(seed=0):
    """Tiny GPT params (f32) with non-trivial LayerNorm scales and biases."""
    p = tw.init_gpt_params(torch_tiny().gpt, seed)
    rng = np.random.default_rng(seed + 100)
    for name, arr in p["blocks"].items():
        if not name.endswith("_w"):
            base = 1.0 if name.endswith("scale") else 0.0
            p["blocks"][name] = (base + 0.05 * rng.standard_normal(arr.shape)).astype(np.float32)
    return p


def _params_run_to_cap(seed):
    """_params with the stop token's logit pushed far down, so greedy chunks
    run to their max_new_tokens (the tiny model's random weights otherwise
    stop within a few steps) and slots finish when the test says."""
    p = _params(seed)
    p["mel_head_b"][torch_tiny().gpt.stop_audio_token] = -1e4
    return p


def _both(p, q8=False):
    """The same numpy params in JAX and in torch, each with its own package's
    blocks_q8 when `q8`."""
    jp, tp = jax.tree.map(jnp.asarray, p), tw.tree_to_torch(p, "cpu")
    if q8:
        jp["blocks_q8"] = jax.jit(jgpt.quantize_decode_weights)(jp["blocks"])
        tp["blocks_q8"] = tgpt.quantize_decode_weights(tp["blocks"])
    return jp, tp


def _cfgs(**flags):
    return (dataclasses.replace(jax_tiny().gpt, **flags),
            dataclasses.replace(torch_tiny().gpt, **flags))


def _assert_int8_close(got, want, max_share, what, max_step=1):
    """int8 rows within `max_step` steps, at most `max_share` of entries off
    (noise may move a value across a rounding boundary, or move a row's
    largest value and so redraw the row's quantisation)."""
    diff = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert diff.max() <= max_step, (what, diff.max())
    assert diff.astype(bool).mean() <= max_share, (what, diff.astype(bool).mean())


def _states_equal(ts, js, latent_tol):
    for name in STATE_INTS:
        np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                      err_msg=name)
    for f in ("temperature", "top_p", "top_k", "repetition_penalty", "do_sample", "max_new",
              "seen"):
        np.testing.assert_array_equal(getattr(ts.sampling, f).numpy(),
                                      np.asarray(getattr(js.sampling, f)), err_msg=f)
    np.testing.assert_allclose(ts.latents_buf.numpy(), np.asarray(js.latents_buf),
                               rtol=latent_tol, atol=latent_tol)


# ------------------------------------------------------- batched prefill
@pytest.mark.parametrize("mode", ["f32", "bf16", "int8", "int8_w8a8"])
def test_gpt_prefill_batched_matches_jax(mode):
    """Three real lanes (lengths 41, 17, 64 into slots 2, 0, 3) and one
    padding lane (length 0, slot = num_slots) of an [4, 64, D] burst.
    f32: hidden states and cache rows within 1e-4 (summation order). bf16
    activations and cache: within 2^-6 of each tensor's largest magnitude
    per entry (a few bf16 roundings apart). int8 (bf16 activations): the
    written int8 rows within one step with at most 2% of their entries off
    (measured 1.1%), scales within 2^-7, hidden states within 2^-6 of their
    scale; under W8A8, where a moved row maximum redraws a whole row's
    activation quantisation, within two steps and 5% (measured 3.5%). Slot
    1, which only the padding lane could have touched, stays bit-equal."""
    kv_int8 = mode.startswith("int8")
    jc, tc = _cfgs(kv_int8=kv_int8, prefill_w8a8=mode == "int8_w8a8")
    jp, tp = _both(_params(1), q8=mode == "int8_w8a8")
    rng = np.random.default_rng(3)
    n_slots, t_pad = 4, 64
    shape = jgpt.make_kv_cache(jc, n_slots, dtype=jnp.float32).k.shape
    if kv_int8:
        cache0 = [rng.integers(-127, 128, shape).astype(np.int8) for _ in range(2)]
        cache0 += [(0.002 + 0.01 * rng.random(shape[:3])).astype(np.float32) for _ in range(2)]
    else:
        cache0 = [(0.2 * rng.standard_normal(shape)).astype(np.float32) for _ in range(2)]
    embeds = rng.standard_normal((4, t_pad, 64)).astype(np.float32)
    lengths = np.asarray([41, 17, 64, 0], np.int32)
    slots = np.asarray([2, 0, 3, n_slots], np.int32)
    dt_j, dt_t = (jnp.bfloat16, torch.bfloat16) if mode != "f32" else (jnp.float32, torch.float32)
    init = [np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)
            for a in _start_cache(cache0, dt_j)]  # host copies, bf16 held as f32
    cache_t = tgpt.KVCache(*(torch.from_numpy(a.copy()).to(dt_t) if a.ndim == 4 and not kv_int8
                             else torch.from_numpy(a.copy()) for a in init))
    emb_j = jnp.asarray(embeds).astype(dt_j)
    h_j, cache_j = jgpt.gpt_prefill_batched(jp, jc, emb_j, jnp.asarray(lengths),
                                            jnp.asarray(slots),
                                            jgpt.KVCache(*_start_cache(cache0, dt_j)))
    emb_t = torch.from_numpy(np.asarray(emb_j.astype(jnp.float32))).to(dt_t)
    h_t = tgpt.gpt_prefill_batched(tp, tc, emb_t, torch.from_numpy(lengths), slots.tolist(),
                                   cache_t)
    assert h_t.shape == (4, 64) and h_t.dtype == dt_t
    hj = np.asarray(h_j.astype(jnp.float32))[:3]
    ht = h_t.float().numpy()[:3]
    got = [a.float().numpy() for a in (cache_t.k, cache_t.v, cache_t.k_scale, cache_t.v_scale)
           if a is not None]
    want = [np.asarray(a.astype(jnp.float32)) for a in cache_j if a is not None]
    if mode == "f32":
        np.testing.assert_allclose(ht, hj, rtol=1e-4, atol=1e-4)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
    else:
        np.testing.assert_allclose(ht, hj, rtol=0, atol=2.0 ** -6 * np.abs(hj).max())
        if kv_int8:
            w8 = mode == "int8_w8a8"
            for g, w, name in zip(got[:2], want[:2], "kv"):  # the written rows only
                _assert_int8_close(g[:, [2, 0, 3], :t_pad], w[:, [2, 0, 3], :t_pad],
                                   0.05 if w8 else 0.02, name, max_step=2 if w8 else 1)
            for g, w in zip(got[2:], want[2:]):
                np.testing.assert_allclose(g, w, rtol=2.0 ** -7)
        else:
            for g, w in zip(got, want):
                np.testing.assert_allclose(g, w, rtol=0, atol=2.0 ** -6 * np.abs(w).max())
    for g, i in zip(got, init):
        np.testing.assert_array_equal(g[:, 1], i[:, 1])  # the padding lane wrote nothing


def _start_cache(cache0, dt):
    """The numpy start cache as JAX arrays: float rows in the activation
    dtype, int8 rows and f32 scales as they are."""
    return [jnp.asarray(a).astype(dt) if a.dtype == np.float32 and a.ndim == 4
            else jnp.asarray(a) for a in cache0]


# ----------------------------------------------------------- burst insert
def _burst_args(cfg, k, n_real, seed):
    rng = np.random.default_rng(seed)
    cond = (0.5 * rng.standard_normal((k, cfg.num_cond_latents, cfg.hidden_size))
            ).astype(np.float32)
    tb = 64 - cfg.num_cond_latents
    n_ids = np.zeros((k,), np.int32)
    n_ids[:n_real] = rng.integers(4, 30, n_real)
    ids = np.zeros((k, tb), np.int32)
    for i in range(n_real):
        ids[i, : n_ids[i]] = rng.integers(5, 300, n_ids[i])
    return cond, ids, n_ids


@pytest.mark.parametrize("sampled", [False, True])
def test_insert_sequences_tokens_matches_jax(sampled):
    """A single insert into slot 0, then a burst of three lanes (slots 4, 1,
    2) and a padding lane (slot = num_slots) on a 6-slot state. Sampled:
    JAX's own Gumbel draw for the burst is injected into the port. Token
    buffers, counters, flags and every sampling row (seen masks included)
    are equal; latents within 1e-4 (f32 summation order)."""
    jc, tc = _cfgs()
    jp, tp = _both(_params(2))
    n_slots, k = 6, 4
    js = jloop.init_decode_state(jc, n_slots, jax.random.PRNGKey(0), dtype=jnp.float32)
    ts = tloop.init_decode_state(tc, n_slots, seed=0, dtype=torch.float32, device="cpu")
    cond, ids, n_ids = _burst_args(jc, k, 3, 4)
    opts = (1.0, 1.0, 1, 5.0, False, 0)
    js = jloop.insert_sequence_tokens(jp, jc, js, jnp.asarray(cond[0]), jnp.asarray(ids[0]),
                                      jnp.int32(n_ids[0]), jnp.int32(0),
                                      *(jnp.asarray(o) for o in opts))
    tloop.insert_sequence_tokens(tp, tc, ts, torch.from_numpy(cond[0]),
                                 torch.from_numpy(ids[0]), int(n_ids[0]), 0, *opts)
    slots = np.asarray([4, 1, 2, n_slots], np.int32)
    lanes = dict(temperature=np.asarray([0.75, 1.0, 0.5, 1.0], np.float32),
                 top_p=np.asarray([0.85, 0.9, 1.0, 1.0], np.float32),
                 top_k=np.asarray([50, 0, 5, 1], np.int32),
                 repetition_penalty=np.asarray([5.0, 1.0, 2.0, 1.0], np.float32),
                 do_sample=np.asarray([sampled] * 3 + [False]),
                 max_new=np.asarray([0, 7, 3, 0], np.int32))
    gumbel = None
    if sampled:
        sub = jax.random.split(js.rng)[1]
        gumbel = torch.from_numpy(np.array(jax.random.gumbel(
            sub, (n_slots, jc.num_audio_tokens), dtype=jnp.float32)))
    js = jloop.insert_sequences_tokens(jp, jc, js, jnp.asarray(cond), jnp.asarray(ids),
                                       jnp.asarray(n_ids), jnp.asarray(slots),
                                       *(jnp.asarray(a) for a in lanes.values()))
    tloop.insert_sequences_tokens(tp, tc, ts, torch.from_numpy(cond), torch.from_numpy(ids),
                                  torch.from_numpy(n_ids), slots.tolist(),
                                  *(torch.from_numpy(a) for a in lanes.values()), gumbel=gumbel)
    _states_equal(ts, js, 1e-4)
    assert ts.active.tolist() == [True, True, True, False, True, False]
    np.testing.assert_allclose(ts.cache.k.numpy(), np.asarray(js.cache.k), rtol=1e-4, atol=1e-4)
    assert not ts.cache.k[:, 5].any() and not ts.cache.k[:, 3].any()  # padding lane: nothing


@pytest.mark.parametrize("kv_int8", [False, True])
def test_batched_insert_equals_sequential_inserts(kv_int8):
    """The port's burst insert against K single inserts of the same prompts
    (greedy), as tests/unit/test_batched_insert.py holds the JAX package:
    first tokens, counters and flags equal. f32: cache rows and latents
    within 1e-4 (the batched path's dense attention against the single
    path's). int8 (bf16 activations): int8 rows within one step with at
    most 0.5% of entries off, latents within 2^-6 of their scale."""
    _, tc = _cfgs(kv_int8=kv_int8)
    _, tp = _both(_params(3))
    dtype = torch.int8 if kv_int8 else torch.float32
    seq = tloop.init_decode_state(tc, 4, seed=0, dtype=dtype, device="cpu")
    bat = tloop.init_decode_state(tc, 4, seed=0, dtype=dtype, device="cpu")
    cond, ids, n_ids = _burst_args(tc, 3, 3, 5)
    opts = (0.75, 0.85, 50, 5.0, False, 0)
    for i in range(3):
        tloop.insert_sequence_tokens(tp, tc, seq, torch.from_numpy(cond[i]),
                                     torch.from_numpy(ids[i]), int(n_ids[i]), i, *opts)
    tloop.insert_sequences_tokens(tp, tc, bat, torch.from_numpy(cond), torch.from_numpy(ids),
                                  torch.from_numpy(n_ids), [0, 1, 2], *opts)
    for name in STATE_INTS:
        assert torch.equal(getattr(seq, name), getattr(bat, name)), name
    assert torch.equal(seq.sampling.seen, bat.sampling.seen)
    if kv_int8:
        for a, b, name in ((seq.cache.k, bat.cache.k, "k"), (seq.cache.v, bat.cache.v, "v")):
            _assert_int8_close(a.numpy(), b.numpy(), 5e-3, name)
        want = seq.latents_buf.numpy()
        np.testing.assert_allclose(bat.latents_buf.numpy(), want, rtol=0,
                                   atol=2.0 ** -6 * np.abs(want).max())
    else:
        for a, b in ((seq.cache.k, bat.cache.k), (seq.cache.v, bat.cache.v),
                     (seq.latents_buf, bat.latents_buf)):
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-4, atol=1e-4)


# ------------------------------------------------------ bounded decode
def _live_states(jc, tc, jp, tp, n_slots, seed, dtype_j=jnp.float32, dtype_t=torch.float32):
    """Both packages' states with greedy prompts in slots 0, 1 and 2."""
    js = jloop.init_decode_state(jc, n_slots, jax.random.PRNGKey(0), dtype=dtype_j)
    ts = tloop.init_decode_state(tc, n_slots, seed=0, dtype=dtype_t, device="cpu")
    cond, ids, n_ids = _burst_args(jc, 3, 3, seed)
    opts = (1.0, 1.0, 1, 5.0, False, 0)
    for slot in range(3):
        js = jloop.insert_sequence_tokens(
            jp, jc, js, jnp.asarray(cond[slot]), jnp.asarray(ids[slot]),
            jnp.int32(n_ids[slot]), jnp.int32(slot), *(jnp.asarray(o) for o in opts))
        tloop.insert_sequence_tokens(tp, tc, ts, torch.from_numpy(cond[slot]),
                                     torch.from_numpy(ids[slot]), int(n_ids[slot]), slot, *opts)
    return js, ts


@pytest.mark.parametrize("flash_decode", [False, True])
def test_decode_steps_bounds_match_jax_and_full_width(flash_decode):
    """Three live slots (0-2) of 8; one 6-step greedy block at slot_bound 4
    and len_bound 128 (the prompts are <= 64 rows) through the port's dense
    f32 body or K2's plain version. Against JAX's block (its dense body; its
    K2 has no CPU path outside interpret mode) at the same bounds:
    tokens, counters and flags equal, latents and cache within 1e-4 (f32
    summation order). Against the port's own full-width, unbounded block:
    tokens and latents bit-equal (the bounded step runs its row-wise
    products at the full slot count, gpt_decode_step), the packed status
    equal.
    Slots >= 4 are untouched: their cache rows and buffers stay bit-equal."""
    jc, tc = _cfgs()
    tc = dataclasses.replace(tc, flash_decode=flash_decode)
    jp, tp = _both(_params(4))
    js, ts = _live_states(jc, tc, jp, tp, 8, 6)
    _, full = _live_states(jc, tc, jp, tp, 8, 6)
    k_hi, lat_hi = ts.cache.k[:, 4:].clone(), ts.latents_buf[4:].clone()
    js, packed_j = jloop.decode_steps_status(jp, jc, js, n_steps=6, len_bound=128, slot_bound=4)
    packed_t = tloop.decode_steps_status(tp, tc, ts, 6, len_bound=128, slot_bound=4)
    tloop.decode_steps(tp, tc, full, 6)
    _states_equal(ts, js, 1e-4)
    np.testing.assert_array_equal(packed_t.numpy(), np.asarray(packed_j))
    np.testing.assert_allclose(ts.cache.k.numpy(), np.asarray(js.cache.k), rtol=1e-4, atol=1e-4)
    for name in STATE_INTS:
        assert torch.equal(getattr(ts, name), getattr(full, name)), name
    assert torch.equal(ts.latents_buf[:4], full.latents_buf[:4])
    assert torch.equal(ts.cache.k[:, 4:], k_hi) and torch.equal(ts.latents_buf[4:], lat_hi)


def test_decode_steps_dense_int8_bounds_match_full_width():
    """The dense int8 body (W8A8 decode) at slot_bound 4 and len_bound 128
    against the same block at full width and length: the rows past the
    bound are masked out either way (exp gives exact zeros there), so the
    live slots' appended int8 rows and scales, tokens and latents are
    bit-equal. The bounded block leaves slots >= 4 as they were."""
    _, tc = _cfgs(kv_int8=True, decode_w8a8=True)
    _, tp = _both(_params(5), q8=True)
    jc = dataclasses.replace(jax_tiny().gpt, kv_int8=True)
    jp = jax.tree.map(jnp.asarray, _params(5))
    _, ts = _live_states(jc, tc, jp, tp, 8, 7, jnp.int8, torch.int8)
    _, full = _live_states(jc, tc, jp, tp, 8, 7, jnp.int8, torch.int8)
    tloop.decode_steps(tp, tc, ts, 6, len_bound=128, slot_bound=4)
    tloop.decode_steps(tp, tc, full, 6)
    for name in STATE_INTS:
        assert torch.equal(getattr(ts, name), getattr(full, name)), name
    for a, b in zip((ts.cache.k, ts.cache.v, ts.cache.k_scale, ts.cache.v_scale),
                    (full.cache.k, full.cache.v, full.cache.k_scale, full.cache.v_scale)):
        assert torch.equal(a[:, :4], b[:, :4])
        # the full-width step also appended (masked-out) rows to the free
        # slots; the bounded one left them as they were
        assert not a[:, 4:].any() if a.dtype == torch.int8 else (a[:, 4:] == 1).all()
    assert torch.equal(ts.latents_buf[:4], full.latents_buf[:4])


# ------------------------------------------------------------- migration
def _random_state_arrays(cfg, n_slots, kv_int8, seed):
    rng = np.random.default_rng(seed)
    shape = jgpt.make_kv_cache(cfg, n_slots, dtype=jnp.float32).k.shape
    t, d, v = cfg.max_audio_tokens, cfg.hidden_size, cfg.num_audio_tokens
    if kv_int8:
        cache = [rng.integers(-127, 128, shape).astype(np.int8) for _ in range(2)]
        cache += [rng.random(shape[:3]).astype(np.float32) for _ in range(2)]
    else:
        cache = [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]
    sampling = dict(temperature=rng.random(n_slots).astype(np.float32),
                    top_p=rng.random(n_slots).astype(np.float32),
                    top_k=rng.integers(0, 60, n_slots).astype(np.int32),
                    repetition_penalty=rng.random(n_slots).astype(np.float32),
                    do_sample=rng.random(n_slots) < 0.5,
                    max_new=rng.integers(0, 30, n_slots).astype(np.int32),
                    seen=rng.random((n_slots, v)) < 0.3)
    rest = dict(seq_lens=rng.integers(0, 90, n_slots).astype(np.int32),
                audio_pos=rng.integers(0, 30, n_slots).astype(np.int32),
                last_token=rng.integers(0, v, n_slots).astype(np.int32),
                active=rng.random(n_slots) < 0.5, done=rng.random(n_slots) < 0.5,
                tokens_buf=rng.integers(0, v, (n_slots, t)).astype(np.int32),
                latents_buf=rng.standard_normal((n_slots, t, d)).astype(np.float32),
                n_generated=rng.integers(0, t, n_slots).astype(np.int32))
    return cache, sampling, rest


@pytest.mark.parametrize("kv_int8", [False, True])
def test_migrate_slot_bit_equal_jax(kv_int8):
    """Every field of a random 5-slot state, moved 4 -> 1: the port's result
    is bit-equal to JAX's (the cache rows and int8 scales, the sampling rows
    and seen masks, counters, token and latent buffers), the source's
    active, done and n_generated are cleared, and no other slot changes."""
    jc, tc = _cfgs(kv_int8=kv_int8)
    cache, sampling, rest = _random_state_arrays(jc, 5, kv_int8, 9)
    js = jloop.DecodeState(
        cache=jgpt.KVCache(*map(jnp.asarray, cache)),
        sampling=jloop.SamplingState(**{k: jnp.asarray(a) for k, a in sampling.items()}),
        rng=jax.random.PRNGKey(0), **{k: jnp.asarray(a) for k, a in rest.items()})
    ts = tloop.DecodeState(
        cache=tgpt.KVCache(*(torch.from_numpy(a.copy()) for a in cache)),
        sampling=tsamp.SamplingState(**{k: torch.from_numpy(a.copy())
                                        for k, a in sampling.items()}),
        generator=torch.Generator(), **{k: torch.from_numpy(a.copy()) for k, a in rest.items()})
    js = jloop.migrate_slot(js, jnp.int32(4), jnp.int32(1))
    tloop.migrate_slot(ts, 4, 1)
    for got, want in zip((ts.cache.k, ts.cache.v, ts.cache.k_scale, ts.cache.v_scale), js.cache):
        if want is not None:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for f in sampling:
        np.testing.assert_array_equal(getattr(ts.sampling, f).numpy(),
                                      np.asarray(getattr(js.sampling, f)), err_msg=f)
    for f in rest:
        np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)),
                                      err_msg=f)
    assert not ts.active[4] and not ts.done[4] and ts.n_generated[4] == 0
    assert torch.equal(ts.latents_buf[1], ts.latents_buf[4])
    np.testing.assert_array_equal(ts.seq_lens[[0, 2, 3]].numpy(), rest["seq_lens"][[0, 2, 3]])


# ------------------------------------------------- runner decisions
def _runner_pair(n_slots, policy=None, q8=False, **flags):
    """A JAX DecodeEngine and a port DecodeEngine on the same params."""
    jc, tc = _cfgs(**flags)
    jp, tp = _both(_params(6), q8=q8)
    je = jcore.DecodeEngine(jp, jc, num_slots=n_slots, cache_dtype=jnp.float32,
                            steps_per_sync=16, slot_bucketing=True, w8a8_policy=policy)
    te = tcore.DecodeEngine(tp, tc, num_slots=n_slots, cache_dtype=torch.float32,
                            slot_bucketing=True, w8a8_policy=policy, device="cpu")
    return je, te


def _set_tables(engine, owners, meta, steps_total):
    engine._slot_owner = {s: owners[s] for s in owners}
    engine._slot_meta = {s: dict(meta[s]) for s in owners}
    engine._steps_total = steps_total


TABLES = [  # (owned slots -> (prompt_len, steps_at_insert)), steps_total
    ({}, 0), ({0: (40, 0)}, 16), ({0: (40, 0), 1: (60, 16), 2: (64, 32)}, 200),
    ({5: (33, 0)}, 64), ({0: (20, 0), 6: (64, 0)}, 700),
    ({1: (64, 0), 3: (30, 48), 7: (50, 96)}, 900),
    ({i: (64, 16 * i) for i in range(8)}, 128), ({2: (64, 0), 3: (10, 0)}, 230),
]


@pytest.mark.parametrize("table", range(len(TABLES)))
def test_runner_decisions_match_jax(table):
    """On the same slot tables, the port's _slot_buckets, _slot_bucket,
    _len_bucket and _compact_slots decide as the JAX DecodeEngine does: the
    same bounds, the same moves (owner and meta maps after compaction, the
    migrations count), and the moved slots' states equal."""
    owned, steps_total = TABLES[table]
    je, te = _runner_pair(8)
    owners = {s: object() for s in owned}
    meta = {s: {"prompt_len": p, "steps_at_insert": a} for s, (p, a) in owned.items()}
    for e in (je, te):
        _set_tables(e, owners, meta, steps_total)
    assert te._slot_buckets() == je._slot_buckets() == (2, 4)
    assert te._slot_bucket() == je._slot_bucket()
    assert te._len_bucket() == je._len_bucket()
    assert te.LEN_BUCKETS == je.LEN_BUCKETS
    # distinct rows per slot, so a move shows in the state
    rows = np.arange(8, dtype=np.int32) * 10 + 1
    je.state = je.state._replace(seq_lens=jnp.asarray(rows))
    te.state.seq_lens.copy_(torch.from_numpy(rows))
    assert te._compact_slots() == je._compact_slots()
    assert te._slot_owner == je._slot_owner and te._slot_meta == je._slot_meta
    assert te.stats["migrations"] == je.stats["migrations"]
    np.testing.assert_array_equal(te.state.seq_lens.numpy(), np.asarray(je.state.seq_lens))
    assert te._slot_bucket() == je._slot_bucket()


def test_cfg_for_matches_jax():
    """The per-program W8A8 choice of _cfg_for over every (len bucket or
    full, slot bucket or full) pair, with a policy that flips inside the
    grid: the same decode_w8a8 and decode_attn_fp flags as JAX; without
    blocks_q8 the policy is not armed in either package."""
    policy = lambda lb, sb: lb * sb < 9000  # noqa: E731
    je, te = _runner_pair(16, policy, q8=True, kv_int8=True)
    picks = set()
    for lb in (*te.LEN_BUCKETS, None):
        for sb in (4, 8, None):
            got, want = te._cfg_for(lb, sb), je._cfg_for(lb, sb)
            assert (got.decode_w8a8, got.decode_attn_fp) == (want.decode_w8a8,
                                                              want.decode_attn_fp), (lb, sb)
            picks.add((got.decode_w8a8, got.decode_attn_fp))
    assert len(picks) == 3  # bf16 weights, W8A8 + bf16 probabilities, W8A8
    je, te = _runner_pair(16, policy)
    assert te._cfg_for(256, 4) is te.cfg and je._cfg_for(256, 4) is je.cfg


def test_engine_w8a8_policy_matches_jax(monkeypatch):
    """The engine's policy (KV bytes < 3x the block weights' bytes) equals
    the function the JAX engine arms on a TPU, over a grid of (len_bound,
    slot_bound) on the tiny config (f32 cache, as the JAX tiny engine's), in
    the float-KV and the int8-KV configurations. The JAX engine is built as
    on a TPU (its backend query answers 'tpu' during construction; every
    other TPU default is passed explicitly)."""
    for kv_int8 in (False, True):
        with monkeypatch.context() as m:
            m.setattr(jax, "default_backend", lambda: "tpu")
            jax_engine = build_tiny_engine(
                max_concurrency=1, vocoder_dtype=None, kv_int8=kv_int8, unroll_layers=False,
                prefill_w8a8=False, slot_bucketing=False)
        jax_policy = jax_engine.decode_engine._w8a8_policy
        assert jax_policy is not None
        params, core = tw.params_from_numpy(jax.device_get(jax_engine.params),
                                            jax.device_get(jax_engine.core), device="cpu")
        params.pop("blocks_q8")
        engine = XTTSv2Engine(jax_engine.hifi_config, jax_engine.gpt_config, params=params,
                              core=core, max_concurrency=1, device="cpu", kv_int8=kv_int8,
                              cache_dtype=torch.float32, vocoder_dtype=torch.float32)
        policy = engine.w8a8_policy()
        answers = [(lb, sb, policy(lb, sb)) for lb in (64, 128, 256, 512, 1024, 4096)
                   for sb in (1, 2, 4, 8, 16, 64, 256)]
        assert [(lb, sb, jax_policy(lb, sb)) for lb, sb, _ in answers] == answers
        assert {a for *_, a in answers} == {True, False}
        assert engine.decode_engine._w8a8_policy is None  # off by default off a TPU


# --------------------------------------------- K2 / K4 on a sliced step
@pytest.mark.parametrize("s", [2, 4])
def test_flash_decode_plain_on_slot_slice_matches_pallas(s):
    """K2's plain version (through the wrapper, on CPU) on the first `s`
    slots of an 8-slot cache against the Pallas kernel in interpret mode on
    the same q[:s]: ctx within the flash-decode test's 2e-4 (f32 online
    softmax against a dense one), caches bit-equal, slots >= s untouched."""
    rng = np.random.default_rng(20 + s)
    n_slots, h, d, l, t = 8, 4, 64, 2, 2 * CHUNK
    q = rng.standard_normal((s, h, d)).astype(np.float32)
    k_new, v_new = ((0.3 * rng.standard_normal((s, h * d))).astype(np.float32) for _ in range(2))
    k_cache, v_cache = ((0.3 * rng.standard_normal((l, n_slots, t, h * d))).astype(np.float32)
                        for _ in range(2))
    wp = rng.integers(0, t - 1, s).astype(np.int32)
    wp[0] = CHUNK - 1
    ctx_j, k_j, v_j = jax_flash_decode(
        jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(k_cache),
        jnp.asarray(v_cache), jnp.int32(1), jnp.asarray(wp), interpret=True)
    kc, vc = torch.from_numpy(k_cache.copy()), torch.from_numpy(v_cache.copy())
    ctx = flash_decode_append_attention(torch.from_numpy(q), torch.from_numpy(k_new),
                                        torch.from_numpy(v_new), kc, vc, 1, torch.from_numpy(wp))
    np.testing.assert_allclose(ctx.numpy(), np.asarray(ctx_j), rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(kc.numpy(), np.asarray(k_j))
    np.testing.assert_array_equal(vc.numpy(), np.asarray(v_j))
    np.testing.assert_array_equal(kc[:, s:].numpy(), k_cache[:, s:])


@pytest.mark.parametrize("s", [2, 4])
def test_ragged_plain_on_slot_slice_matches_pallas(s):
    """K4's plain version on the first `s` slots of an 8-slot int8 cache
    against the Pallas kernel in interpret mode: caches and scales
    bit-equal (slots >= s untouched), and each side's ctx within
    RAGGED_F64_ATOL of the f64 evaluation, as test_torch_int8's K4 checks."""
    rng = np.random.default_rng(30 + s)
    n_slots, l, t, h, d = 8, 2, 2 * CHUNK, 4, 32
    k_f, v_f = (rng.standard_normal((l, n_slots, t, h * d)).astype(np.float32) for _ in range(2))
    ks, vs = (np.maximum(np.abs(a).max(-1), 1e-8) / np.float32(127.0) for a in (k_f, v_f))
    k_i8 = np.round(k_f / ks[..., None]).astype(np.int8)
    v_i8 = np.round(v_f / vs[..., None]).astype(np.int8)
    q = rng.standard_normal((s, h, d)).astype(np.float32)
    k_new, v_new = (rng.standard_normal((s, h * d)).astype(np.float32) for _ in range(2))
    pos = rng.integers(0, t - 2, s).astype(np.int32)
    pos[0] = CHUNK - 1
    scale = 1.0 / math.sqrt(d)
    ctx_j, *caches_j = _jax_ragged_blocking(q, k_new, v_new, scale, 0, pos, (k_i8, v_i8, ks, vs))
    caches_t = [torch.from_numpy(a.copy()) for a in (k_i8, v_i8, ks, vs)]
    ctx_t = ragged_decode_attention(torch.from_numpy(q), torch.from_numpy(k_new),
                                    torch.from_numpy(v_new), scale, 0, torch.from_numpy(pos),
                                    *caches_t)
    for got, want, start in zip(caches_t, caches_j, (k_i8, v_i8, ks, vs)):
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got[:, s:].numpy(), start[:, s:])
    ref = _ragged_f64(q, caches_j, pos, 0, scale)
    np.testing.assert_allclose(ctx_t.numpy(), ref, rtol=0, atol=RAGGED_F64_ATOL)
    np.testing.assert_allclose(ctx_j, ref, rtol=0, atol=RAGGED_F64_ATOL)


# ------------------------------------------------------------ the runner
def _prompts(engine_cfg, n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        cond = torch.from_numpy((0.5 * rng.standard_normal(
            (engine_cfg.num_cond_latents, engine_cfg.hidden_size))).astype(np.float32))
        ids = rng.integers(5, 300, int(rng.integers(3, 30))).astype(np.int64)
        out.append(tcore.TokenPrompt(cond=cond, ids=ids))
    return out


async def _serve(engine, prompts, options, late=(), late_after=0.0):
    tasks = [asyncio.ensure_future(engine.generate(p, o)) for p, o in zip(prompts, options)]
    if late:
        await asyncio.sleep(late_after)
        tasks += [asyncio.ensure_future(engine.generate(p, o)) for p, o in late]
    out = await asyncio.wait_for(asyncio.gather(*tasks), 300)
    await engine.shutdown()
    return [(np.asarray(t), r[: n].clone(), n) for t, r, n in out]


def test_runner_bucketed_serving_equals_unbucketed():
    """12 greedy chunks at once, with max_new_tokens spread over 5-31 (the
    two longest in slots 6 and 7) so slots finish at different times and
    strand high survivors, then 4 more mid-run, through an
    8-slot runner with slot bucketing and through one without: every future
    resolves with the same tokens and n, latents within 1e-5 (f32; a
    bounded step sums over the same rows). The bucketed runner ran batched
    inserts, migrated stragglers down and stepped blocks below full width;
    no slot is left owned or active."""
    _, tc = _cfgs()
    _, tp = _both(_params_run_to_cap(7))
    prompts = _prompts(tc, 16, 11)
    caps = [5, 9, 6, 10, 7, 11, 30, 31, 5, 8, 6, 9, 5, 7, 6, 8]
    options = [tcore.SamplingOptions(do_sample=False, max_new_tokens=c) for c in caps]
    results, engines = {}, {}
    for bucketing in (False, True):
        engine = tcore.DecodeEngine(tp, tc, num_slots=8, cache_dtype=torch.float32,
                                    steps_per_sync=4, slot_bucketing=bucketing, device="cpu")
        results[bucketing] = asyncio.run(_serve(
            engine, prompts[:12], options[:12], list(zip(prompts[12:], options[12:])), 0.05))
        engines[bucketing] = engine
    for (ta, la, na), (tb, lb, nb), cap in zip(results[False], results[True], caps):
        assert na == nb == cap and np.array_equal(ta, tb)
        torch.testing.assert_close(lb, la, rtol=0, atol=1e-5)
    st = engines[True].stats
    assert st["insert_batches"] > 0 and st["migrations"] > 0 and st["slot_bound_blocks"] > 0
    assert st["inserts"] == 16 and engines[False].stats["migrations"] == 0
    for key in ("dispatch_s", "status_wait_s", "insert_s", "harvest_s", "insert_upload_s",
                "insert_dispatch_s"):
        assert st[key] > 0.0, key
    for engine in engines.values():
        assert engine.num_active == 0 and not engine.state.active.any()
    engines[True].reset_stats()
    assert not any(engines[True].stats.values())


@pytest.fixture()
def slow_blocks(monkeypatch):
    """Pad each decode block by 20 ms so the tiny model is mid-decode when
    the test cancels the low-slot requests."""
    real = tcore.decode_steps_status

    def slow(*args, **kwargs):
        time.sleep(0.02)
        return real(*args, **kwargs)

    monkeypatch.setattr(tcore, "decode_steps_status", slow)


def test_runner_compacts_stranded_survivor(slow_blocks):
    """As tests/unit/test_slot_compaction.py holds the JAX runner: fill
    slots 0-5 of 8, cancel the five low requests mid-decode. The runner
    migrates the slot-5 survivor down (stats['migrations']) and steps it
    at a narrow slot bound, and it finishes with exactly the tokens of a
    clean unbucketed engine; latents within 1e-5 (f32)."""
    _, tc = _cfgs()
    _, tp = _both(_params_run_to_cap(8))
    prompts = _prompts(tc, 6, 12)
    greedy = tcore.SamplingOptions(do_sample=False)

    async def clean():
        engine = tcore.DecodeEngine(tp, tc, num_slots=8, cache_dtype=torch.float32,
                                    device="cpu")
        tokens, row, n = await engine.generate(prompts[5], greedy)
        await engine.shutdown()
        return tokens, row[:n], n

    async def compacted():
        engine = tcore.DecodeEngine(tp, tc, num_slots=8, cache_dtype=torch.float32,
                                    slot_bucketing=True, device="cpu")
        tasks = [asyncio.ensure_future(engine.generate(p, greedy)) for p in prompts]
        t0 = time.monotonic()
        while len(engine._slot_owner) < 6:
            assert time.monotonic() - t0 < 60, "slots never filled"
            await asyncio.sleep(0.005)
        for t in tasks[:5]:
            t.cancel()
        tokens, row, n = await tasks[5]
        stats = dict(engine.stats)
        await engine.shutdown()
        return tokens, row[:n], n, stats

    want_tokens, want_lat, want_n = asyncio.run(clean())
    got_tokens, got_lat, got_n, stats = asyncio.run(compacted())
    assert stats["migrations"] >= 1, "the survivor was never compacted"
    assert stats["slot_bound_blocks"] >= 1
    assert got_n == want_n
    np.testing.assert_array_equal(got_tokens, want_tokens)
    torch.testing.assert_close(got_lat, want_lat, rtol=0, atol=1e-5)


# ------------------------------------------------------------- slot fit
class _FakeDevice:
    def __init__(self, limit):
        self.limit = limit

    def memory_stats(self):
        return {"bytes_limit": self.limit}


def test_slot_fit_matches_jax(monkeypatch):
    """_hbm_plan_bytes and _fit_slots_to_hbm against the JAX engine's on the
    same weights and config, with the card's memory faked on both sides (a
    bytes limit for JAX; for the port, mem_get_info with the weights already
    resident). max_seq_len is 256 here, a whole number of cache chunks, so
    the JAX plan's rows equal the rows the port allocates. The same default
    slot counts are kept or clamped alike, and a card that cannot hold 2
    slots raises in both; an explicit count that does not fit raises in the
    port, where the JAX engine logs an error and clamps."""
    cfg = jax_tiny()
    cfg.gpt = dataclasses.replace(cfg.gpt, max_text_tokens=208)
    assert cfg.gpt.max_seq_len == 256
    je = build_tiny_engine(config=cfg, max_concurrency=1, vocoder_dtype=None)
    params, core = tw.params_from_numpy(jax.device_get(je.params), jax.device_get(je.core),
                                        device="cpu")
    te = XTTSv2Engine(je.hifi_config, je.gpt_config, params=params, core=core, device="cpu",
                      max_concurrency=1, cache_dtype=torch.float32,
                      vocoder_dtype=torch.float32)
    weights, slot = te._hbm_plan_bytes()
    assert (weights, slot) == je._hbm_plan_bytes()
    te.device = torch.device("cuda")  # only the fit's arithmetic runs below
    # the JAX engine's 8% also covers its compiled programs; the port's
    # captured-program pools are a term of their own (held by
    # tests/test_torch_device_defaults.py), left out here
    monkeypatch.setattr(te, "_program_pool_bytes", lambda: (0, 0))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda dev: 0)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda dev: 0)
    for limit in (weights * 3 + slot * 1000, (weights + 10.5 * slot) / 0.92,
                  (weights + 1.5 * slot) / 0.92):
        limit = int(limit)
        monkeypatch.setattr(jax, "local_devices", lambda: [_FakeDevice(limit)])
        monkeypatch.setattr(torch.cuda, "mem_get_info", lambda dev: (limit - weights, limit))
        fits = int(limit * 0.92 - weights) // slot
        if fits < 2:
            with pytest.raises(RuntimeError):
                je._fit_slots_to_hbm(16, slots_explicit=False)
            with pytest.raises(ValueError):
                te._fit_slots_to_hbm(16, slots_explicit=False)
            continue
        for n in (2, 16):
            assert te._fit_slots_to_hbm(n, slots_explicit=False) == je._fit_slots_to_hbm(
                n, slots_explicit=False) == min(n, fits)
        if fits < 16:
            assert je._fit_slots_to_hbm(16, slots_explicit=True) == fits
            with pytest.raises(ValueError, match="decode_slots=16"):
                te._fit_slots_to_hbm(16, slots_explicit=True)


# ------------------------------------------------------------- engine options
def test_engine_refuses_tensor_parallel_and_takes_slot_bucketing():
    """tensor_parallel_size > 1 now builds a model mesh (a CPU engine's of
    CPU shards; parallel/mesh.py), and a degree that does not divide the
    head count raises; slot_bucketing reaches the runner; options the port
    lacks are still dropped with a warning, not raised."""
    cfg = torch_tiny()
    gpt_np, core_np = tw.random_init(cfg, 0)
    params, core = tw.params_from_numpy(gpt_np, core_np, device="cpu")
    tp = XTTSv2Engine(cfg, cfg.gpt, params=params, core=core, device="cpu",
                      tensor_parallel_size=2, max_concurrency=2)
    assert tp.mesh.shape == {"data": 1, "model": 2} and tp.decode_engine.mesh is tp.mesh
    with pytest.raises(ValueError, match="tensor_parallel_size=3 must divide"):
        XTTSv2Engine(cfg, cfg.gpt, params=params, core=core, device="cpu",
                     tensor_parallel_size=3)
    engine = XTTSv2Engine(cfg, cfg.gpt, params=params, core=core, device="cpu",
                          tensor_parallel_size=1, slot_bucketing=True, unroll_layers=True,
                          max_concurrency=2)
    assert engine.decode_engine.slot_bucketing and engine.decode_slots == 4
    assert not XTTSv2Engine(cfg, cfg.gpt, params=params, core=core, device="cpu",
                            max_concurrency=2).decode_engine.slot_bucketing
