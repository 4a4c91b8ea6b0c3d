"""The int8 decode path of the torch port against the JAX package on CPU:
int8 row quantisation and W8A8 weights, the W8A8 matmul, prefill and decode
on an int8 KV cache (dense body, both attention variants, with and without
W8A8), kernel K4's and K5's plain versions against their Pallas kernels in
interpret mode, the weight converter, the config guards, and the tiny-config
engine with every int8 flag on. Inputs are numpy arrays from a seed; each
tolerance is stated where it is asserted."""
import dataclasses
import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent))
from helpers import build_tiny_engine, sine_wav
from test_torch_kernels import split_partials

from auralis_tpu.models.xttsv2 import gpt as jgpt
from auralis_tpu.models.xttsv2.config import tiny_test_config as jax_tiny
from auralis_tpu.ops.experimental.attention import CHUNK
from auralis_tpu.ops.experimental.attention import ragged_decode_attention as jax_ragged
from auralis_tpu.ops.experimental.fused_mlp import fused_mlp_w8 as jax_fused_mlp
from auralis_tpu.runtime import decode_loop as jloop
from auralis_tpu_torch import TTS, TTSRequest
from auralis_tpu_torch.frontend.tokenizer import TTSTokenizer
from auralis_tpu_torch.models.xttsv2 import gpt as tgpt
from auralis_tpu_torch.models.xttsv2 import weights as tw
from auralis_tpu_torch.models.xttsv2.config import tiny_test_config as torch_tiny
from auralis_tpu_torch.models.xttsv2.engine import XTTSv2Engine
from auralis_tpu_torch.ops.experimental.attention import (
    DECODE_SPLIT,
    combine_splits_plain,
    ragged_decode_attention,
    split_plan,
)
from auralis_tpu_torch.ops.experimental.fused_mlp import COLS, ROWS, WEIGHT_LAYOUT
from auralis_tpu_torch.ops.experimental.fused_mlp import MAX_K as MLP_MAX_K
from auralis_tpu_torch.ops.experimental.fused_mlp import (
    fused_mlp_w8,
    fused_mlp_w8_plain,
    mlp_plan,
    mlp_w8_reference,
)
from auralis_tpu_torch.ops.quant import int8_weight, quantize_rows
from auralis_tpu_torch.runtime import decode_loop as tloop

Q8_NAMES = ("attn_w", "attn_proj_w", "fc_w", "fc_proj_w")


def snr_db(ref, got) -> float:
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    err = np.sum((got - ref) ** 2)
    return math.inf if err == 0 else 10 * np.log10(np.sum(ref ** 2) / err)


def _params(seed=0):
    """Tiny GPT params (f32) with non-trivial LayerNorm scales and biases."""
    p = tw.init_gpt_params(torch_tiny().gpt, seed)
    rng = np.random.default_rng(seed + 100)
    for name, arr in p["blocks"].items():
        if not name.endswith("_w"):
            base = 1.0 if name.endswith("scale") else 0.0
            p["blocks"][name] = (base + 0.05 * rng.standard_normal(arr.shape)).astype(np.float32)
    return p


def _both(p):
    """The same numpy params in JAX and in torch, each with its own package's
    blocks_q8."""
    jp = jax.tree.map(jnp.asarray, p)
    jp["blocks_q8"] = jax.jit(jgpt.quantize_decode_weights)(jp["blocks"])
    tp = tw.tree_to_torch(p, "cpu")
    tp["blocks_q8"] = tgpt.quantize_decode_weights(tp["blocks"])
    return jp, tp


def _cfgs(**flags):
    return (dataclasses.replace(jax_tiny().gpt, **flags),
            dataclasses.replace(torch_tiny().gpt, **flags))


def _int8_cache(cfg, slots, seed):
    """Random int8 rows with per-row scales (numpy), as prefill leaves them."""
    shape = jgpt.make_kv_cache(cfg, slots).k.shape
    rng = np.random.default_rng(seed)
    rows = [rng.integers(-127, 128, shape).astype(np.int8) for _ in range(2)]
    scales = [(0.002 + 0.01 * rng.random(shape[:3])).astype(np.float32) for _ in range(2)]
    return rows + scales


def _jax_cache(arrs):
    return jgpt.KVCache(*map(jnp.asarray, arrs))


def _torch_cache(arrs):
    return tgpt.KVCache(*(torch.from_numpy(a.copy()) for a in arrs))


def _assert_int8_close(got, want, max_share, what):
    """int8 rows: every entry within one int8 step, and at most `max_share`
    of them off at all (a value at a rounding boundary may round either way
    when the f32 sums before it differ in their last bit)."""
    diff = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert diff.max() <= 1, (what, diff.max())
    assert diff.astype(bool).mean() <= max_share, (what, diff.astype(bool).mean())


# ------------------------------------------------------ quantisation, W8A8
def test_quantize_rows_and_decode_weights_bit_equal_jax():
    """Against the JAX functions under jit, as the JAX package runs them
    (eager JAX divides by 127 where jit multiplies by its reciprocal)."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((64, 96)) * rng.uniform(1e-3, 30, (64, 1))).astype(np.float32)
    x[3] = 0.0  # an all-zero row takes the 1e-8 floor
    qj, sj = jax.jit(jgpt._quantize_rows)(jnp.asarray(x))
    qt, st = tgpt._quantize_rows(torch.from_numpy(x))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))

    p = _params(1)
    jq = jax.jit(jgpt.quantize_decode_weights)(jax.tree.map(jnp.asarray, p["blocks"]))
    tq = tgpt.quantize_decode_weights(tw.tree_to_torch(p["blocks"], "cpu"))
    assert sorted(tq) == sorted(jq)
    for name, arr in tq.items():
        assert arr.dtype == (torch.int8 if name.endswith("_q") else torch.float32), name
        np.testing.assert_array_equal(arr.numpy(), np.asarray(jq[name]), err_msg=name)
        if name.endswith("_q"):  # Din contiguous: the fast layout of the int8 GEMM
            assert arr.stride(1) == 1, (name, arr.stride())


def _ulps_bf16(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in bf16 steps between two same-sign bf16 tensors."""
    ia, ib = a.view(torch.int16).int(), b.view(torch.int16).int()
    return int((ia - ib).abs().max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dot_w8a8_matches_jax(dtype):
    """The int32 product is exact on both sides and the rescale is the same
    f32 operations, except that XLA fuses the last multiply and the bias add
    into one rounding (an FMA) where torch rounds twice. So the result agrees
    to one step of the output dtype, in f32 one ulp at the size of the
    addends (|out| + |b|: on a near-cancelling sum that is many ulps of the
    result)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((24, 64)).astype(np.float32)
    w = (0.02 * rng.standard_normal((1, 64, 192))).astype(np.float32)
    b = (0.01 * rng.standard_normal((192,))).astype(np.float32)
    blocks = {n: w for n in Q8_NAMES}
    jq = jax.jit(jgpt.quantize_decode_weights)(jax.tree.map(jnp.asarray, blocks))
    tq = tgpt.quantize_decode_weights(tw.tree_to_torch(blocks, "cpu"))
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    want = jax.jit(jgpt._dot_w8a8)(xj, jq["attn_w_q"][0], jq["attn_w_s"][0], jnp.asarray(b))
    got = tgpt._dot_w8a8(xt, tq["attn_w_q"][0], tq["attn_w_s"][0], torch.from_numpy(b))
    assert got.dtype == xt.dtype and got.shape == (24, 192)
    want_t = torch.from_numpy(np.asarray(want.astype(jnp.float32))).to(got.dtype)
    same_sign = (torch.sign(got.float()) == torch.sign(want_t.float())) | (got.float() == 0)
    assert same_sign.all()
    if dtype == "float32":
        ulp = np.spacing(np.abs(want_t.numpy()) + np.abs(b)[None, :])
        assert (np.abs(got.numpy() - want_t.numpy()) <= ulp).all()
    else:
        assert _ulps_bf16(got, want_t) <= 1


# ------------------------------------------------------------------ prefill
@pytest.mark.parametrize("prefill_w8a8,prefill_flash", [(False, False), (True, True)])
def test_gpt_prefill_int8_matches_jax(prefill_w8a8, prefill_flash):
    jc, tc = _cfgs(kv_int8=True, prefill_w8a8=prefill_w8a8, prefill_flash=prefill_flash)
    jp, tp = _both(_params())
    cache0 = _int8_cache(jc, 3, 1)
    embeds = np.random.default_rng(2).standard_normal((64, 64)).astype(np.float32)
    length, slot = 41, 1
    h_j, cache_j = jgpt.gpt_prefill(jp, jc, jnp.asarray(embeds), jnp.int32(length),
                                    jnp.int32(slot), _jax_cache(cache0))
    cache_t = _torch_cache(cache0)
    h_t = tgpt.gpt_prefill(tp, tc, torch.from_numpy(embeds), length, slot, cache_t)
    # f32 activations: the hidden state agrees to f32 noise, which under
    # W8A8 may also flip a rare activation quantisation step (1e-3)
    tol = 1e-3 if prefill_w8a8 else 1e-4
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), rtol=tol, atol=tol)
    for got, want, name in zip((cache_t.k, cache_t.v), (cache_j.k, cache_j.v), "kv"):
        # int8 rows: within one step, at most 0.5% of entries off (f32 noise
        # moves values across a rounding boundary)
        _assert_int8_close(got.numpy(), np.asarray(want), 5e-3, name)
    for got, want in ((cache_t.k_scale, cache_j.k_scale), (cache_t.v_scale, cache_j.v_scale)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    for i in (0, 2):  # other slots untouched
        np.testing.assert_array_equal(cache_t.k[:, i].numpy(), cache0[0][:, i])
        np.testing.assert_array_equal(cache_t.k_scale[:, i].numpy(), cache0[2][:, i])


# -------------------------------------------------------------- decode step
@pytest.mark.parametrize("decode_w8a8", [False, True])
@pytest.mark.parametrize("decode_attn_fp", [False, True])
def test_gpt_decode_step_dense_int8_matches_jax(decode_attn_fp, decode_w8a8):
    """The dense int8 body on the tiny config (2 layers). Layer 0 gets the
    same bf16 inputs in both packages, so its appended int8 rows and scales
    are bit-equal. After it, activations are bf16 (under kv_int8 in both
    packages) and requantised per row, so f32 noise in the softmax and gelu
    moves rare roundings, and a moved row maximum redraws that row's whole
    quantisation: layer 1's appended rows stay within 2 int8 steps and their
    scales within 2^-6, and the hidden state within 2^-6 of its scale per
    entry and above 40 dB SNR (measured 45.6-50.8 dB)."""
    jc, tc = _cfgs(kv_int8=True, decode_attn_fp=decode_attn_fp, decode_w8a8=decode_w8a8)
    jp, tp = _both(_params(3))
    cache0 = _int8_cache(jc, 4, 4)
    tokens = np.asarray([3, 5, 64, 9], np.int32)
    pos = np.asarray([1, 2, 0, 34], np.int32)
    lens = np.asarray([10, 0, 95, 40], np.int32)
    h_j, cache_j = jgpt.gpt_decode_step(jp, jc, jnp.asarray(tokens), jnp.asarray(pos),
                                        jnp.asarray(lens), _jax_cache(cache0))
    cache_t = _torch_cache(cache0)
    h_t = tgpt.gpt_decode_step(tp, tc, torch.from_numpy(tokens), torch.from_numpy(pos),
                               torch.from_numpy(lens), cache_t)
    assert h_t.dtype == torch.bfloat16
    hj = np.asarray(h_j.astype(jnp.float32))
    ht = h_t.float().numpy()
    np.testing.assert_allclose(ht, hj, rtol=0, atol=2.0 ** -6 * np.abs(hj).max())
    assert snr_db(hj, ht) > 40.0
    slots = np.arange(4)
    got = [a.numpy() for a in (cache_t.k, cache_t.v, cache_t.k_scale, cache_t.v_scale)]
    want = [np.asarray(a) for a in cache_j]
    for g, w, c0 in zip(got, want, cache0):
        np.testing.assert_array_equal(g[0], w[0])  # layer 0: bit-equal
        rest = np.ones(c0.shape[:3], bool)
        rest[:, slots, lens] = False
        np.testing.assert_array_equal(g[rest], c0[rest])  # only the appended rows change
    for g, w in zip(got[:2], want[:2]):
        assert np.abs(g[1].astype(np.int32) - w[1].astype(np.int32)).max() <= 2
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(g[1], w[1], rtol=2.0 ** -6)


# -------------------------------------------------------------- K4 ragged
# Both sides of the K4 checks below are held against an f64 evaluation of
# K4's math on the int8 rows and scales that the append left (bit-equal on
# both sides, checked first) and on q quantised by the shared recipe. ctx is
# an f32 softmax over at most 512 keys: each of its two sums (the normaliser
# and the weighted values) carries a rounding error of order sqrt(n) u of
# its size (n <= 512, u = 2^-24: 1.3e-6) on top of the logits' few ulps, and
# |ctx| <= max |v| <= 4 here, so an f32 evaluation lands well inside 1e-5 of
# the f64 one (measured 2.3e-7 to 3.0e-7 for the plain version and the
# Pallas kernel). A wrong int8 value, scale or mask row moves ctx by ~1e-4.
RAGGED_F64_ATOL = 1e-5


def _ragged_f64(q, caches, pos, layer, scale):
    """K4's context in f64 from the appended int8 rows and scales: q per
    (slot, head) quantised as quantize_rows does (f32 scale max|q| x
    f32(1/127), round half to even of q / scale), logits int8 q . int8 k x
    k-scale x q-scale x scale over each slot's pos + 1 keys, softmax, values
    v_int8 x v-scale. Returns [S, H*D] f64."""
    k8, v8, ks, vs = (np.asarray(c) for c in caches)
    s, h, d = q.shape
    q_s = np.maximum(np.abs(q).max(-1), np.float32(1e-8)) * np.float32(1.0 / 127.0)
    q_i = np.round(q / q_s[..., None]).astype(np.float64)
    out = np.zeros((s, h * d))
    for i in range(s):
        n = int(pos[i]) + 1
        k = k8[layer, i, :n].astype(np.float64).reshape(n, h, d)
        v = v8[layer, i, :n].astype(np.float64).reshape(n, h, d) * vs[layer, i, :n, None, None]
        logits = (np.einsum("thd,hd->ht", k, q_i[i]) * ks[layer, i, :n][None]
                  * (q_s[i].astype(np.float64) * scale)[:, None])
        p = np.exp(logits - logits.max(-1, keepdims=True))
        out[i] = np.einsum("ht,thd->hd", p / p.sum(-1, keepdims=True), v).reshape(-1)
    return out


def _jax_ragged_blocking(q, k_new, v_new, scale, layer, pos, caches):
    """The Pallas kernel in interpret mode on copies of the numpy inputs,
    waited for before anything else reads them."""
    out = jax_ragged(jnp.array(q), jnp.array(k_new), jnp.array(v_new), scale, jnp.int32(layer),
                     jnp.array(pos), *(jnp.array(c) for c in caches), interpret=True)
    return [np.asarray(a) for a in jax.block_until_ready(out)]


@pytest.mark.parametrize("seed", [0, 1])
def test_ragged_plain_matches_pallas(seed):
    """K4's plain version (through the wrapper, on CPU) against the Pallas
    kernel in interpret mode at the JAX test's shapes, positions 0 and
    CHUNK-1 included: caches and scale rows bit-equal, and each side's ctx
    within RAGGED_F64_ATOL of the f64 evaluation (see _ragged_f64)."""
    rng = np.random.default_rng(seed)
    l, s, t, h, d = 2, 16, 2 * CHUNK, 4, 32
    layer = seed % l
    k_f, v_f = (rng.standard_normal((l, s, t, h * d)).astype(np.float32) for _ in range(2))
    ks, vs = (np.maximum(np.abs(a).max(-1), 1e-8) / np.float32(127.0) for a in (k_f, v_f))
    k_i8 = np.round(k_f / ks[..., None]).astype(np.int8)
    v_i8 = np.round(v_f / vs[..., None]).astype(np.int8)
    q = rng.standard_normal((s, h, d)).astype(np.float32)
    k_new, v_new = (rng.standard_normal((s, h * d)).astype(np.float32) for _ in range(2))
    pos = rng.integers(0, t - 2, size=(s,)).astype(np.int32)
    pos[0], pos[1] = 0, CHUNK - 1
    scale = 1.0 / math.sqrt(d)
    ctx_j, *caches_j = _jax_ragged_blocking(q, k_new, v_new, scale, layer, pos,
                                            (k_i8, v_i8, ks, vs))
    caches_t = [torch.from_numpy(a.copy()) for a in (k_i8, v_i8, ks, vs)]
    before = ragged_decode_attention.launches
    ctx_t = ragged_decode_attention(torch.from_numpy(q), torch.from_numpy(k_new),
                                    torch.from_numpy(v_new), scale, layer,
                                    torch.from_numpy(pos), *caches_t)
    assert ragged_decode_attention.launches == before  # CPU: plain version, no launch
    assert ctx_t.dtype == torch.float32 and ctx_t.shape == (s, h * d)
    for got, want in zip(caches_t, caches_j):
        np.testing.assert_array_equal(got.numpy(), want)
    ref = _ragged_f64(q, caches_j, pos, layer, scale)
    np.testing.assert_allclose(ctx_t.numpy(), ref, rtol=0, atol=RAGGED_F64_ATOL)
    np.testing.assert_allclose(ctx_j, ref, rtol=0, atol=RAGGED_F64_ATOL)


@pytest.mark.parametrize("split", [DECODE_SPLIT, 64])
@pytest.mark.parametrize("seed", [0, 1])
def test_combine_splits_matches_pallas_ragged(seed, split):
    """Split-K K4 in plain PyTorch: per-split partials (int8 scores x
    k-scale x q-scale x attn_scale; values v_int8 x v-scale) over the
    appended int8 cache, merged by combine_splits_plain, and the Pallas
    kernel in interpret mode, each within RAGGED_F64_ATOL of the f64
    evaluation (see _ragged_f64), at test_ragged_plain_matches_pallas's
    shapes; NaN-free where a split is empty."""
    rng = np.random.default_rng(seed + 10)
    l, s, t, h, d = 2, 16, 2 * CHUNK, 4, 32
    layer = seed % l
    k_f, v_f = (rng.standard_normal((l, s, t, h * d)).astype(np.float32) for _ in range(2))
    ks, vs = (np.maximum(np.abs(a).max(-1), 1e-8) / np.float32(127.0) for a in (k_f, v_f))
    k_i8 = np.round(k_f / ks[..., None]).astype(np.int8)
    v_i8 = np.round(v_f / vs[..., None]).astype(np.int8)
    q = rng.standard_normal((s, h, d)).astype(np.float32)
    k_new, v_new = (rng.standard_normal((s, h * d)).astype(np.float32) for _ in range(2))
    pos = rng.integers(0, t - 2, size=(s,)).astype(np.int32)
    pos[:5] = (0, split - 1, split, split + 1, t - 1)  # one-row splits, split edges, the last row
    scale = 1.0 / math.sqrt(d)
    ctx_j, *caches_j = _jax_ragged_blocking(q, k_new, v_new, scale, layer, pos,
                                            (k_i8, v_i8, ks, vs))
    caches = [torch.from_numpy(a.copy()) for a in (k_i8, v_i8, ks, vs)]
    wpt = torch.from_numpy(pos)
    ragged_decode_attention(torch.from_numpy(q), torch.from_numpy(k_new),
                            torch.from_numpy(v_new), scale, layer, wpt, *caches)  # the append
    kc, vc, kscale, vscale = (c[layer] for c in caches)
    q_i8, q_s = tgpt._quantize_rows(torch.from_numpy(q))
    scores = torch.einsum("shd,sthd->sht", q_i8.float(), kc.float().reshape(s, t, h, d))
    logits = scores * kscale[:, None, :] * (q_s * scale)[:, :, None]
    logits = logits.masked_fill(torch.arange(t)[None, None] > wpt[:, None, None], -torch.inf)
    vals = vc.float().reshape(s, t, h, d) * vscale[:, :, None, None]
    m, l_sum, acc = split_partials(logits, vals, split_plan(t, split))
    assert torch.isinf(m).any()  # empty splits occur
    ctx = combine_splits_plain(m, l_sum, acc).reshape(s, h * d)
    assert torch.isfinite(ctx).all()
    for got, want in zip(caches, caches_j):
        np.testing.assert_array_equal(got.numpy(), want)
    ref = _ragged_f64(q, caches_j, pos, layer, scale)
    np.testing.assert_allclose(ctx.numpy(), ref, rtol=0, atol=RAGGED_F64_ATOL)
    np.testing.assert_allclose(ctx_j, ref, rtol=0, atol=RAGGED_F64_ATOL)


def test_ragged_rejects_write_pos_outside_cache():
    s, h, d, t = 2, 2, 64, CHUNK
    caches = [torch.zeros((1, s, t, h * d), dtype=torch.int8) for _ in range(2)]
    scales = [torch.ones((1, s, t)) for _ in range(2)]
    q, kn = torch.ones((s, h, d)), torch.ones((s, h * d))
    for bad in (-1, t):
        with pytest.raises(IndexError):
            ragged_decode_attention(q, kn, kn, 0.125, 0, torch.tensor([3, bad], dtype=torch.int32),
                                    *caches, *scales)
        assert not caches[0][0, 1].any() and (scales[0][0, 1] == 1).all()


# -------------------------------------------------------------- K5 MLP
D, I = 256, 1024  # the JAX test's shapes


@pytest.fixture(scope="module")
def mlp_weights():
    rng = np.random.default_rng(7)
    fc_w = (0.02 * rng.standard_normal((1, D, I))).astype(np.float32)
    proj_w = (0.02 * rng.standard_normal((1, I, D))).astype(np.float32)
    q8 = tgpt.quantize_decode_weights(tw.tree_to_torch(
        {"attn_w": fc_w, "attn_proj_w": proj_w, "fc_w": fc_w, "fc_proj_w": proj_w}, "cpu"))
    return {
        "x": rng.standard_normal((8, D)).astype(np.float32),
        "fc_wq": q8["fc_w_q"][0].numpy(), "fc_ws": q8["fc_w_s"][0].numpy(),
        "fc_b": (0.01 * rng.standard_normal((I,))).astype(np.float32),
        "proj_wq": q8["fc_proj_w_q"][0].numpy(), "proj_ws": q8["fc_proj_w_s"][0].numpy(),
        "proj_b": (0.01 * rng.standard_normal((D,))).astype(np.float32),
    }


def _mlp_args(w, lib):
    names = ("x", "fc_wq", "fc_ws", "fc_b", "proj_wq", "proj_ws", "proj_b")
    conv = jnp.asarray if lib == "jax" else (lambda a: torch.from_numpy(a.copy()))
    return [conv(w[n]) for n in names]


@pytest.mark.parametrize("tile_i", [256, 1024])
def test_fused_mlp_plain_matches_pallas(mlp_weights, tile_i):
    """K5's plain version (through the wrapper, on CPU) against the Pallas
    kernel in interpret mode. The recipes are the same, gelu aside: erf here,
    a polynomial within 1.5e-7 in Pallas. Where that moves the largest |gelu|
    of a (row, tile), the row's requantisation is redrawn and its outputs
    move at the quantisation-noise level (3.3e-4 of a 0.37 output scale at
    tile 1024). So: rows other than at most 2 of the 8 within 1e-5, all
    within 1e-3, and 50 dB SNR (measured 69 and 139 dB)."""
    want = np.asarray(jax_fused_mlp(*_mlp_args(mlp_weights, "jax"), tile_i=tile_i,
                                    interpret=True))
    before = fused_mlp_w8.launches
    got = fused_mlp_w8(*_mlp_args(mlp_weights, "torch"), tile_i=tile_i)
    assert fused_mlp_w8.launches == before  # CPU: plain version, no launch
    assert got.dtype == torch.float32 and got.shape == (8, D)
    diff = np.abs(got.numpy() - want)
    assert (diff.max(axis=1) > 1e-5).sum() <= 2 and diff.max() <= 1e-3, diff.max(axis=1)
    assert snr_db(want, got.numpy()) > 50.0


def test_fused_mlp_single_tile_is_the_serving_chain(mlp_weights):
    """With one tile spanning all of I, K5's recipe is the serving
    `_dot_w8a8` x2 chain exactly (f32 activations: the chain's rounding of
    the gelu output to x's dtype is the identity); same bound as the JAX
    test (2e-5), and 28 dB against it at the default tile."""
    args = _mlp_args(mlp_weights, "torch")
    serving = mlp_w8_reference(*args)
    np.testing.assert_allclose(fused_mlp_w8_plain(*args, tile_i=I).numpy(), serving.numpy(),
                               rtol=0, atol=2e-5)
    assert snr_db(serving.numpy(), fused_mlp_w8_plain(*args, tile_i=256).numpy()) > 28.0


def _lane_product(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a [S, K] @ w [K, C] as the kernel's warps take it: the contraction in
    16-byte chunks, chunk q to lane q % 32, each lane's int32 partial, then
    the sum over the 32 lanes (the reduce-scatter). Returns int64 [S, C]."""
    (s, k), c = a.shape, w.shape[1]
    per_chunk = torch.einsum("sqk,qkc->qsc", a.long().reshape(s, k // 16, 16),
                             w.long().reshape(k // 16, 16, c))
    lanes = torch.zeros((32, s, c), dtype=torch.int64).index_add_(
        0, torch.arange(k // 16) % 32, per_chunk)
    assert lanes.abs().max() < 2 ** 31  # each lane's partial is an int32
    return lanes.sum(0)


def _k5_blocked(x, fc_wq, fc_ws, fc_b, proj_wq, proj_ws, proj_b, tile_i):
    """K5 in plain PyTorch in the kernel's own order, block by block over
    mlp_plan's grids: per fc block of COLS inner columns the lane-split int32
    product, gelu and the block's per-row max |g| (gmax); per proj block (COLS
    output columns x one tile) the (row, tile) scale folded from the tile's
    gmax entries, the requantised tile, the lane-split int32 product x the
    scale into part; then per column block the tiles summed in order from 0
    in f32, x proj-scale + proj-bias."""
    s, d = x.shape
    i = fc_wq.shape[1]
    plan = mlp_plan(s, d, i, tile_i)
    xq, xs = quantize_rows(x)
    g = torch.zeros((s, i))
    gmax = torch.zeros(plan.gmax_shape)
    for cb in range(plan.fc_grid[0]):
        cols = slice(cb * COLS, (cb + 1) * COLS)
        y = _lane_product(xq, fc_wq[:, cols]).float()
        g[:, cols] = F.gelu(y * xs[:, None] * fc_ws[cols][None] + fc_b[cols][None])
        gmax[:, cb] = g[:, cols].abs().amax(dim=1)
    per_tile = tile_i // COLS
    part = torch.zeros((plan.proj_grid[1], s, d))
    for t in range(plan.proj_grid[1]):
        gs = torch.clamp(gmax[:, t * per_tile:(t + 1) * per_tile].amax(dim=1),
                         min=1e-20).mul_(1.0 / 127.0)
        gq = torch.div(g[:, t * tile_i:(t + 1) * tile_i], gs[:, None]).round_().to(torch.int8)
        for cb in range(plan.proj_grid[0]):
            cols = slice(cb * COLS, (cb + 1) * COLS)
            p = _lane_product(gq, proj_wq[t * tile_i:(t + 1) * tile_i, cols])
            part[t, :, cols] = p.float() * gs[:, None]
    out = torch.zeros((s, d))
    for t in range(plan.proj_grid[1]):
        out = out + part[t]
    return (out * proj_ws[None] + proj_b[None]).to(x.dtype)


@pytest.mark.parametrize("s", [1, 3, 8])
@pytest.mark.parametrize("tile_i", [256, 1024])
def test_fused_mlp_kernel_order_is_bit_equal_to_plain(mlp_weights, tile_i, s):
    """The kernel's order (lane-split int32 partials, per-block maxima
    folded per tile, f32 sum over the tiles in order) changes no bit against
    fused_mlp_w8_plain: int32 sums and maxima are exact in any order, and the
    f32 steps are the plain version's, one by one."""
    args = _mlp_args(mlp_weights, "torch")
    args[0] = args[0][:s]
    got = _k5_blocked(*args, tile_i)
    assert torch.equal(got, fused_mlp_w8_plain(*args, tile_i=tile_i))


@pytest.mark.parametrize("d", range(128, MLP_MAX_K + 1, 128))
def test_mlp_plan_covers_every_column_once(d):
    """For every supported D, I (up to 4096) and tile_i: fc blocks cover each
    inner column once, proj blocks each (output column, inner tile) once, a
    tile's gmax entries are exactly the fc blocks inside it, the row blocks
    each row once, and the lanes' 16-byte chunks each contraction byte of a
    block once."""
    for k_len in range(32, MLP_MAX_K + 1, 32):  # every D and tile_i a block contracts over
        chunks = [lane + 32 * it for it in range(MLP_MAX_K // 16 // 32) for lane in range(32)]
        bytes_ = np.bincount([16 * q + b for q in chunks if 16 * q < k_len for b in range(16)])
        assert len(bytes_) == k_len and (bytes_ == 1).all()
    for i in range(128, 4097, 128):
        for tile_i in range(COLS, min(i, MLP_MAX_K) + 1, COLS):
            if i % tile_i:
                continue
            for s in (1, 8, 9):
                plan = mlp_plan(s, d, i, tile_i)
                fc_cols = np.bincount(np.arange(plan.fc_grid[0] * COLS), minlength=i)
                assert len(fc_cols) == i and (fc_cols == 1).all()
                out_cols = np.arange(plan.proj_grid[0] * COLS)
                tiles = np.arange(plan.proj_grid[1] * tile_i)
                assert (np.bincount(out_cols) == 1).all() and len(out_cols) == d
                assert (np.bincount(tiles) == 1).all() and len(tiles) == i
                per_tile = tile_i // COLS
                for t in range(plan.proj_grid[1]):
                    folded = range(t * per_tile, (t + 1) * per_tile)
                    assert [cb for cb in range(plan.fc_grid[0])
                            if t * tile_i <= cb * COLS < (t + 1) * tile_i] == list(folded)
                assert plan.gmax_shape == (s, plan.fc_grid[0])
                rows = plan.fc_grid[1] * ROWS
                assert plan.proj_grid[2] == plan.fc_grid[1] and s <= rows < s + ROWS
                assert plan.part_shape == (plan.fc_grid[1], plan.proj_grid[1], ROWS, d)
                assert plan.tickets_shape == (plan.fc_grid[1], plan.proj_grid[0])


@pytest.mark.parametrize("s, d, i, tile_i", [(8, 1152, 4096, 1024), (8, 1000, 4096, 1024),
                                             (8, 1024, 4000, 1000), (8, 1024, 4096, 2048),
                                             (8, 1024, 4096, 48), (0, 1024, 4096, 1024)])
def test_mlp_plan_rejects_shapes_the_kernel_does_not_take(s, d, i, tile_i):
    with pytest.raises(ValueError):
        mlp_plan(s, d, i, tile_i)


def test_fused_mlp_cpu_takes_any_layout(mlp_weights):
    """On the CPU the wrapper runs the plain version whatever the weights'
    layout (the kernel takes only WEIGHT_LAYOUT) and launches nothing."""
    args = _mlp_args(mlp_weights, "torch")
    assert args[1].is_contiguous()  # row-major here
    col_major = list(args)
    col_major[1], col_major[4] = (int8_weight(args[n]) for n in (1, 4))
    assert col_major[1].t().is_contiguous() and col_major[4].t().is_contiguous()
    assert WEIGHT_LAYOUT == "column-major"
    before = fused_mlp_w8.launches
    row = fused_mlp_w8(*args, tile_i=256)
    col = fused_mlp_w8(*col_major, tile_i=256)
    assert fused_mlp_w8.launches == before
    assert torch.equal(row, col) and torch.equal(row, fused_mlp_w8_plain(*args, tile_i=256))


# --------------------------------------------------------- weights, guards
def test_params_from_numpy_keeps_q8_types():
    """A JAX blocks_q8 pytree given as numpy maps onto the port unchanged:
    with dtype=bf16 the float params become bf16, but the int8 weights stay
    int8 and the scales f32, bit-equal to the port's own quantisation."""
    p = _params(4)
    gpt = dict(p, blocks_q8=jax.device_get(
        jax.jit(jgpt.quantize_decode_weights)(jax.tree.map(jnp.asarray, p["blocks"]))))
    params, _ = tw.params_from_numpy(gpt, {}, device="cpu", dtype=torch.bfloat16)
    assert params["blocks"]["fc_w"].dtype == torch.bfloat16
    mine = tgpt.quantize_decode_weights(tw.tree_to_torch(p["blocks"], "cpu"))
    for name, arr in params["blocks_q8"].items():
        assert arr.dtype == (torch.int8 if name.endswith("_q") else torch.float32), name
        assert torch.equal(arr, mine[name]), name


def test_config_guards_raise_as_in_jax():
    for flags in ({"ragged_decode": True}, {"kv_int8": True, "flash_decode": True}):
        jc, tc = _cfgs(**flags)
        with pytest.raises(AssertionError):
            jgpt.make_kv_cache(jc, 2)
        with pytest.raises(ValueError):
            tgpt.make_kv_cache(tc, 2, device="cpu")


def test_int8_cache_layout():
    _, tc = _cfgs(kv_int8=True)
    cache = tgpt.make_kv_cache(tc, 3, device="cpu")
    want = jgpt.make_kv_cache(_cfgs(kv_int8=True)[0], 3)
    assert cache.quantized and cache.k.dtype == cache.v.dtype == torch.int8
    assert tuple(cache.k.shape) == want.k.shape and tuple(cache.k_scale.shape) == want.k_scale.shape
    assert cache.k_scale.dtype == torch.float32 and (cache.k_scale == 1).all()
    assert not tgpt.make_kv_cache(torch_tiny().gpt, 3, device="cpu").quantized


# ----------------------------------------------------------------- engine
INT8_FLAGS = dict(kv_int8=True, decode_w8a8=True, prefill_w8a8=True)


@pytest.fixture(scope="module")
def int8_engines(tmp_path_factory):
    cfg = jax_tiny()
    cfg.gpt = dataclasses.replace(cfg.gpt, ragged_decode=True)
    jax_engine = build_tiny_engine(config=cfg, max_concurrency=1, vocoder_dtype=None,
                                   **INT8_FLAGS)
    params, core = tw.params_from_numpy(jax.device_get(jax_engine.params),
                                        jax.device_get(jax_engine.core), device="cpu")
    torch_engine = XTTSv2Engine(
        jax_engine.hifi_config, dataclasses.replace(jax_engine.gpt_config, prefill_flash=True),
        params=params, core=core, tokenizer=TTSTokenizer(jax_engine.tokenizer.tokenizer),
        max_concurrency=1, vocoder_dtype=torch.float32, device="cpu", **INT8_FLAGS)
    yield jax_engine, torch_engine, sine_wav(tmp_path_factory.mktemp("voice") / "spk.wav")


def test_engine_int8_flags_and_memory_plan(int8_engines):
    jax_engine, torch_engine, _ = int8_engines
    g = torch_engine.gpt_config
    assert g.kv_int8 and g.decode_w8a8 and g.prefill_w8a8 and g.ragged_decode
    cache = torch_engine.decode_engine.state.cache
    assert cache.quantized and torch_engine.params["blocks_q8"]["fc_w_q"].dtype == torch.int8
    # per slot: int8 K and V rows plus one f32 scale each per token, + latents
    per_slot = g.num_hidden_layers * cache.max_len * (2 * g.hidden_size + 2 * 4)
    per_slot += g.max_audio_tokens * g.hidden_size * 4
    weights = sum(t.numel() * t.element_size()
                  for t in jax.tree.leaves((torch_engine.params, torch_engine.core))
                  if torch.is_tensor(t))
    want = (weights + per_slot * torch_engine.decode_slots) / 1024 ** 3
    assert torch_engine.get_memory_usage_curve() == pytest.approx(want, rel=1e-12)
    # defaults off, as the JAX engine's off a TPU: a config asking for
    # kv_int8 is overridden unless the flag is passed
    off = XTTSv2Engine(torch_engine.hifi_config, dataclasses.replace(g, ragged_decode=False),
                       params=torch_engine.params, core=torch_engine.core, max_concurrency=1,
                       device="cpu")
    assert not off.gpt_config.kv_int8 and not off.decode_engine.state.cache.quantized
    assert jax_engine.gpt_config.kv_int8  # passed explicitly, as here


def test_engine_int8_teacher_forced_matches_jax(int8_engines):
    """Both engines' own params (the port's blocks_q8 converted from JAX's),
    configs and caches: prefill one prompt through the engines' insert
    assembly, then 12 teacher-forced decode steps through K4's path (Pallas
    interpret / plain version). The test_kv_int8 rule: logits and latents
    above 40 dB SNR, and greedy tokens equal wherever the JAX top-2 logit
    margin exceeds 0.01."""
    jax_engine, torch_engine, _ = int8_engines
    jg, tg = jax_engine.gpt_config, torch_engine.gpt_config
    jp, tp = jax_engine.params, torch_engine.params
    rng = np.random.default_rng(8)
    cond = (0.3 * rng.standard_normal((jg.num_cond_latents, jg.hidden_size))).astype(np.float32)
    ids = np.zeros((56,), np.int32)
    ids[:12] = rng.integers(5, 300, 12)
    length = jg.num_cond_latents + 12 + 1
    forced = rng.integers(0, jg.num_audio_tokens - 2, 12).astype(np.int32)

    emb_j = jloop._assemble_prompt(jp, jg, jnp.asarray(cond), jnp.asarray(ids),
                                   jnp.int32(12)).astype(jnp.bfloat16)
    cache_j = jgpt.make_kv_cache(jg, 2)
    h, cache_j = jgpt.gpt_prefill(jp, jg, emb_j, jnp.int32(length), jnp.int32(0), cache_j)
    outs_j = [jgpt.heads(jp, h[None])]
    emb_t = tloop._assemble_prompt(tp, tg, torch.from_numpy(cond), torch.from_numpy(ids), 12)
    cache_t = tgpt.make_kv_cache(tg, 2, device="cpu")
    h = tgpt.gpt_prefill(tp, tg, emb_t.to(torch.bfloat16), length, 0, cache_t)
    outs_t = [tgpt.heads(tp, h[None])]
    for i, tok in enumerate(forced):
        args = (np.asarray([tok, 0], np.int32), np.asarray([1 + i, 0], np.int32),
                np.asarray([length + i, 0], np.int32))
        h, cache_j = jgpt.gpt_decode_step(jp, jg, *map(jnp.asarray, args), cache_j)
        outs_j.append(jgpt.heads(jp, h))
        outs_t.append(tgpt.heads(tp, tgpt.gpt_decode_step(
            tp, tg, *map(torch.from_numpy, args), cache_t)))
    lj = np.stack([np.asarray(lo[0], np.float32) for lo, _ in outs_j])
    zj = np.stack([np.asarray(la[0], np.float32) for _, la in outs_j])
    lt = np.stack([lo[0].float().numpy() for lo, _ in outs_t])
    zt = np.stack([la[0].float().numpy() for _, la in outs_t])
    assert snr_db(lj, lt) > 40.0 and snr_db(zj, zt) > 40.0, (snr_db(lj, lt), snr_db(zj, zt))
    top2 = np.sort(lj, axis=-1)[:, -2:]
    decisive = (top2[:, 1] - top2[:, 0]) > 0.01
    assert decisive.sum() >= 8
    match = lj.argmax(-1) == lt.argmax(-1)
    assert match[decisive].all(), np.where(decisive & ~match)[0]


def test_engine_int8_facade_request(int8_engines):
    """The whole int8 slice through the port's TTS facade: a greedy request
    gives finite 24 kHz audio of the length its tokens imply."""
    _, torch_engine, wav = int8_engines
    tts = TTS(scheduler_max_concurrency=1).with_engine(torch_engine)
    try:
        out = tts.generate_speech(TTSRequest(text="Hello world. This is a test.",
                                             speaker_files=[wav], language="en",
                                             do_sample=False))
    finally:
        tts.loop.run_until_complete(tts.shutdown())
    assert out.sample_rate == 24000 and out.array.size > 0 and np.isfinite(out.array).all()
