"""Each CUDA kernel's plain PyTorch version against the JAX package's Pallas
kernel run in interpret mode (as the JAX package's own tests run it on CPU),
on the same numpy inputs. On CPU tensors the kernel wrappers take the plain
version, so these tests go through the wrappers and also pin that a CPU call
launches nothing. The kernels themselves are checked against these plain
versions on the GPU by chip_smoke.py."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from auralis_tpu.models.xttsv2.hifigan import _resblock1
from auralis_tpu.ops.experimental.attention import (
    CHUNK,
    flash_decode_append_attention as jax_flash_decode,
)
from auralis_tpu.ops.mrf import PackedMRFStage as JaxPackedMRFStage
from auralis_tpu.ops.prefill_attention import prefill_flash_attention as jax_prefill
from auralis_tpu_torch.ops.experimental.attention import (
    DECODE_SPLIT,
    combine_splits_plain,
    flash_decode_append_attention,
    split_plan,
)
from auralis_tpu_torch.ops.mrf import PackedMRFStage, _conv, pack_conv_weight, run_fused_stage
from auralis_tpu_torch.ops.prefill_attention import (
    prefill_attention_plain,
    prefill_flash_attention,
)
from chip_smoke import k1_mask, library_conv, library_convs, sdpa_yardstick


# ------------------------------------------------------------ K1 prefill
@pytest.mark.parametrize("t,length", [(64, 64), (128, 1), (128, 65), (256, 129), (256, 256)])
def test_prefill_plain_matches_pallas(t, length):
    rng = np.random.default_rng(t + length)
    q, k, v = (rng.standard_normal((t, 4, 64)).astype(np.float32) for _ in range(3))
    want = jax_prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(length),
                       interpret=True)
    before = prefill_flash_attention.launches
    got = prefill_flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), length)
    assert prefill_flash_attention.launches == before  # CPU: plain version, no launch
    assert got.dtype == torch.float32 and got.shape == (t, 4, 64)
    # f32 softmax over <= 256 keys in both; summation order differs
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("t,length", [(128, 1), (128, 65), (256, 256)])
def test_prefill_takes_a_device_length(t, length, dtype):
    """K1's length as a 0-d integer tensor (what a captured insert stages on
    the card): the plain version, through the wrapper, equals its result
    with the int length bit for bit and the Pallas kernel in interpret mode
    within the f32 summation-order bound above."""
    rng = np.random.default_rng(t + 7 * length)
    q, k, v = (torch.from_numpy(rng.standard_normal((t, 4, 64)).astype(np.float32))
               for _ in range(3))
    got = prefill_flash_attention(q, k, v, torch.tensor(length, dtype=dtype))
    torch.testing.assert_close(got, prefill_attention_plain(q, k, v, length), rtol=0, atol=0)
    want = jax_prefill(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()), jnp.asarray(v.numpy()),
                       jnp.int32(length), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_prefill_padding_rows_do_not_affect_real_rows():
    """Garbage K/V past `length` must not reach any real row (bucket padding)."""
    rng = np.random.default_rng(2)
    t, length = 128, 64
    q, k, v = (torch.from_numpy(rng.standard_normal((t, 2, 64)).astype(np.float32))
               for _ in range(3))
    base = prefill_flash_attention(q, k, v, length)
    k2, v2 = k.clone(), v.clone()
    k2[length:] = 1e6
    v2[length:] = -1e6
    poisoned = prefill_flash_attention(q, k2, v2, length)
    torch.testing.assert_close(poisoned[:length], base[:length], rtol=0, atol=0)
    want = jax_prefill(jnp.asarray(q.numpy()), jnp.asarray(k2.numpy()), jnp.asarray(v2.numpy()),
                       jnp.int32(length), interpret=True)
    np.testing.assert_allclose(poisoned[:length].numpy(), np.asarray(want)[:length],
                               rtol=1e-5, atol=1e-5)


def test_prefill_accepts_strided_qkv_views():
    """gpt_prefill hands over q/k/v as views of one fused [T, 3D] row."""
    rng = np.random.default_rng(3)
    t, h, d = 64, 4, 64
    qkv = torch.from_numpy(rng.standard_normal((t, 3 * h * d)).astype(np.float32))
    q, k, v = (x.view(t, h, d) for x in qkv.split(h * d, dim=-1))
    got = prefill_flash_attention(q, k, v, 50)
    want = prefill_flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), 50)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# ------------------------------------------------------------ K2 decode
@pytest.mark.parametrize("write_pos", [
    [0, 7, 8, CHUNK - 1, CHUNK, 2 * CHUNK - 9],
    [2 * CHUNK - 9, CHUNK, 0, 300, 8, 7],
])
def test_flash_decode_plain_matches_pallas(write_pos):
    rng = np.random.default_rng(sum(write_pos))
    s, h, d, l, t = len(write_pos), 4, 64, 2, 2 * CHUNK
    q = rng.standard_normal((s, h, d)).astype(np.float32)
    k_new = (0.3 * rng.standard_normal((s, h * d))).astype(np.float32)
    v_new = (0.3 * rng.standard_normal((s, h * d))).astype(np.float32)
    k_cache = (0.3 * rng.standard_normal((l, s, t, h * d))).astype(np.float32)
    v_cache = (0.3 * rng.standard_normal((l, s, t, h * d))).astype(np.float32)
    wp = np.asarray(write_pos, np.int32)
    for layer in range(l):
        ctx_j, k_j, v_j = jax_flash_decode(
            jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(k_cache),
            jnp.asarray(v_cache), jnp.int32(layer), jnp.asarray(wp), interpret=True)
        kc, vc = torch.from_numpy(k_cache.copy()), torch.from_numpy(v_cache.copy())
        before = flash_decode_append_attention.launches
        ctx = flash_decode_append_attention(
            torch.from_numpy(q), torch.from_numpy(k_new), torch.from_numpy(v_new), kc, vc,
            layer, torch.from_numpy(wp))
        assert flash_decode_append_attention.launches == before
        # tolerance of the JAX package's own flash-decode test (f32 online
        # softmax vs dense softmax over up to 512 keys)
        np.testing.assert_allclose(ctx.numpy(), np.asarray(ctx_j), rtol=2e-4, atol=2e-4)
        # the append wrote exactly the new rows; every other layer, slot and
        # row is untouched (exact)
        np.testing.assert_array_equal(kc.numpy(), np.asarray(k_j))
        np.testing.assert_array_equal(vc.numpy(), np.asarray(v_j))
        other = 1 - layer
        np.testing.assert_array_equal(kc[other].numpy(), k_cache[other])
        for i, p in enumerate(wp):
            np.testing.assert_array_equal(kc[layer, i, p].numpy(), k_new[i])
            np.testing.assert_array_equal(vc[layer, i, p].numpy(), v_new[i])


def test_flash_decode_plain_uses_f32_probabilities():
    """bf16 cache and q: the plain version keeps the probabilities in f32
    (the kernel's math), unlike the bf16-probs dense body of gpt.py."""
    rng = np.random.default_rng(9)
    s, h, d, t = 2, 4, 64, CHUNK
    q = torch.from_numpy(rng.standard_normal((s, h, d)).astype(np.float32)).bfloat16()
    kc = torch.from_numpy(rng.standard_normal((1, s, t, h * d)).astype(np.float32)).bfloat16()
    vc = torch.from_numpy(rng.standard_normal((1, s, t, h * d)).astype(np.float32)).bfloat16()
    kn, vn = kc[0, :, 0].clone(), vc[0, :, 0].clone()
    wp = torch.tensor([100, 200], dtype=torch.int32)
    ctx = flash_decode_append_attention(q, kn, vn, kc, vc, 0, wp)
    assert ctx.dtype == torch.bfloat16
    kh = kc[0].float().reshape(s, t, h, d)
    vh = vc[0].float().reshape(s, t, h, d)
    scores = torch.einsum("shd,sthd->sht", q.float() / math.sqrt(d), kh)
    scores = scores.masked_fill(torch.arange(t)[None, None] > wp[:, None, None], -torch.inf)
    want = torch.einsum("sht,sthd->shd", torch.softmax(scores, -1), vh)
    torch.testing.assert_close(ctx.float(), want, rtol=0, atol=2.0 ** -7)  # one bf16 rounding
    # ctx is the f32 result rounded once: summation-order noise may flip a
    # rare rounding, but bf16 probabilities would change ~40% of the entries
    mismatch = (ctx != want.to(torch.bfloat16)).float().mean().item()
    assert mismatch <= 0.01, mismatch


def split_partials(logits: torch.Tensor, vals: torch.Tensor, plan) -> tuple:
    """Each split's partial as a K2/K4 block leaves it, in plain PyTorch:
    logits [S, H, T] (-inf past the live rows), vals [S, T, H, D]; per split
    m = max logit, l = sum exp(logit - m), acc = sum exp(logit - m) v, and
    (-inf, 0, 0) for a split with no live row."""
    ms, ls, accs = [], [], []
    for a, b in plan:
        lg = logits[..., a:b]
        m = lg.amax(dim=-1)
        p = torch.where(lg == -torch.inf, torch.zeros_like(lg), torch.exp(lg - m[..., None]))
        ms.append(m)
        ls.append(p.sum(dim=-1))
        accs.append(torch.einsum("sht,sthd->shd", p, vals[:, a:b]))
    return torch.stack(ms, -1), torch.stack(ls, -1), torch.stack(accs, -2)


@pytest.mark.parametrize("t_max", range(CHUNK, 16 * CHUNK + 1, CHUNK))
def test_split_plan_tiles_every_cache_length(t_max):
    """The kernels' grid: t_max / DECODE_SPLIT splits of DECODE_SPLIT rows
    that tile [0, t_max) in order, for every T the cache can have."""
    plan = split_plan(t_max)
    assert len(plan) == t_max // DECODE_SPLIT
    assert plan[0][0] == 0 and plan[-1][1] == t_max
    assert all(b - a == DECODE_SPLIT for a, b in plan)
    assert all(plan[i][1] == plan[i + 1][0] for i in range(len(plan) - 1))
    assert split_plan(t_max, 64) == [(a, a + 64) for a in range(0, t_max, 64)]


@pytest.mark.parametrize("t_max,split", [(CHUNK + 128, DECODE_SPLIT), (0, DECODE_SPLIT),
                                         (CHUNK, 96), (CHUNK, 0)])
def test_split_plan_rejects_bad_lengths(t_max, split):
    with pytest.raises(ValueError):
        split_plan(t_max, split)


def test_combine_splits_plain_empty_splits():
    """Empty splits weigh nothing; all splits empty give 0, not NaN."""
    m = torch.tensor([[1.0, -torch.inf, 0.5], [-torch.inf] * 3])
    l = torch.tensor([[2.0, 0.0, 1.0], [0.0] * 3])
    acc = torch.arange(2 * 3 * 4, dtype=torch.float32).reshape(2, 3, 4)
    out = combine_splits_plain(m, l, acc)
    w = torch.exp(torch.tensor([0.0, -0.5]))
    want0 = (acc[0, 0] * w[0] + acc[0, 2] * w[1]) / (2.0 * w[0] + 1.0 * w[1])
    torch.testing.assert_close(out[0], want0)
    assert torch.equal(out[1], torch.zeros(4))


@pytest.mark.parametrize("split", [DECODE_SPLIT, 64])
@pytest.mark.parametrize("write_pos", [
    [0, 127, 128, 129, 2 * CHUNK - 1, 300],   # one-row splits, split edges, the last row
    [0, 0, 1, 1, 64, 65],                     # every split but the first empty
])
def test_combine_splits_matches_pallas_flash_decode(write_pos, split):
    """Split-K K2 in plain PyTorch: per-split partials over the appended
    cache, merged by combine_splits_plain, against the Pallas kernel in
    interpret mode (the JAX flash-decode test's tolerance); NaN-free where
    a split is empty."""
    rng = np.random.default_rng(sum(write_pos) + split)
    s, h, d, l, t, layer = len(write_pos), 4, 64, 2, 2 * CHUNK, 1
    q = rng.standard_normal((s, h, d)).astype(np.float32)
    k_new, v_new = ((0.3 * rng.standard_normal((s, h * d))).astype(np.float32) for _ in range(2))
    k_cache, v_cache = ((0.3 * rng.standard_normal((l, s, t, h * d))).astype(np.float32)
                        for _ in range(2))
    wp = np.asarray(write_pos, np.int32)
    ctx_j, _, _ = jax_flash_decode(
        jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(k_cache),
        jnp.asarray(v_cache), jnp.int32(layer), jnp.asarray(wp), interpret=True)
    kc, vc = torch.from_numpy(k_cache), torch.from_numpy(v_cache)
    wpt = torch.from_numpy(wp)
    flash_decode_append_attention(torch.from_numpy(q), torch.from_numpy(k_new),
                                  torch.from_numpy(v_new), kc, vc, layer, wpt)  # the append
    kh, vh = (c[layer].reshape(s, t, h, d) for c in (kc, vc))
    logits = torch.einsum("shd,sthd->sht", torch.from_numpy(q) / math.sqrt(d), kh)
    logits = logits.masked_fill(torch.arange(t)[None, None] > wpt[:, None, None], -torch.inf)
    plan = split_plan(t, split)
    m, l_sum, acc = split_partials(logits, vh, plan)
    lens = (wpt[:, None] + 1 - torch.tensor([a for a, _ in plan])[None]).clamp(0, split)
    assert (lens == 0).any() and (lens == 1).any()  # empty and one-row splits occur
    assert torch.isinf(m[lens[:, None, :].expand_as(m) == 0]).all()
    ctx = combine_splits_plain(m, l_sum, acc)
    assert torch.isfinite(ctx).all()
    np.testing.assert_allclose(ctx.numpy(), np.asarray(ctx_j), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("bad", [-1, CHUNK])
def test_flash_decode_rejects_write_pos_outside_cache(bad):
    """A write position with no cache row raises (the kernel traps); a
    negative one does not wrap around to the cache's last rows."""
    s, h, d, t = 2, 2, 64, CHUNK
    kc = torch.zeros((1, s, t, h * d))
    vc = torch.zeros((1, s, t, h * d))
    q = torch.ones((s, h, d))
    kn = vn = torch.ones((s, h * d))
    with pytest.raises(IndexError):
        flash_decode_append_attention(q, kn, vn, kc, vc, 0, torch.tensor([3, bad], dtype=torch.int32))
    assert not kc[0, 1].any() and not vc[0, 1].any()


# ------------------------------------------------------------ K3 MRF stage
def _blocks(rng, c, kernels, scale=0.1):
    mk = lambda k: {"w": (scale * rng.standard_normal((k, c, c))).astype(np.float32),
                    "b": (scale * rng.standard_normal(c)).astype(np.float32)}
    return [{"convs1": [mk(k) for _ in range(3)], "convs2": [mk(k) for _ in range(3)]}
            for k in kernels]


def _xla_mean(blocks, x, kernels):
    acc = None
    for p, k in zip(blocks, kernels):
        z = _resblock1(jax.tree.map(jnp.asarray, p), jnp.asarray(x), k).astype(jnp.float32)
        acc = z if acc is None else acc + z
    return np.asarray(acc / len(blocks))


@pytest.mark.parametrize("kernels", [(3,), (7,), (11,), (3, 7, 11)])
@pytest.mark.parametrize("c,t", [(32, 333), (64, 97), (16, 5)])
def test_mrf_plain_matches_resblock_mean(kernels, c, t):
    """f32: every k, the narrow widths, and t=5 — shorter than one conv's
    reach (the sequence-edge zero padding is the whole answer there)."""
    rng = np.random.default_rng(c * 1000 + t + sum(kernels))
    blocks = _blocks(rng, c, kernels)
    x = rng.standard_normal((2, t, c)).astype(np.float32)
    want = _xla_mean(blocks, x, kernels)
    stage = PackedMRFStage(blocks, kernels, torch.float32, "cpu")
    before = run_fused_stage.launches
    got = stage(torch.from_numpy(x))
    assert run_fused_stage.launches == before
    assert got.shape == want.shape and got.dtype == torch.float32
    # f32 convs with up to 11 taps x 64 channels, six in a chain
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_mrf_plain_matches_pallas_stage_bf16():
    """bf16, the serving dtype: the precision contract (bf16 conv inputs, f32
    accumulate, f32 residual, bf16 chain outputs before the f32 mean) is the
    Pallas kernel's. Both round to bf16 at the same points; an f32 sum that
    differs in its last bits can flip one such rounding (2^-8 relative), and
    the flip propagates down the chain, so the bound is 2^-6 of the scale."""
    kernels = (3, 7, 11)
    c, t = 64, 150
    rng = np.random.default_rng(11)
    blocks = _blocks(rng, c, kernels)
    x = rng.standard_normal((1, t, c)).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(
        JaxPackedMRFStage(blocks, kernels, c, dtype=jnp.bfloat16)(xb, interpret=True)
        .astype(jnp.float32))
    stage = PackedMRFStage(blocks, kernels, torch.bfloat16, "cpu")
    got = stage(torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16())
    assert got.dtype == torch.bfloat16
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=2.0 ** -6 * scale)
    # the roundings sit at the same points: most outputs are bit-equal (2.5%
    # differ here), where skipping the bf16 conv inputs changes ~60%
    mismatch = float((got.float().numpy() != want).mean())
    assert mismatch <= 0.1, mismatch


@pytest.mark.parametrize("k,dil", [(3, 1), (7, 3), (11, 5)])
def test_mrf_weight_pack_round_trip(k, dil):
    """The bf16 kernel's [K, O, I] packing: transposing back gives the JAX
    [K, I, O] weight bit for bit, and a conv that reads the packed layout
    equals `_conv` exactly in f32."""
    rng = np.random.default_rng(k * 10 + dil)
    c, t = 32, 90
    w = torch.from_numpy((0.1 * rng.standard_normal((k, c, c))).astype(np.float32))
    b = torch.from_numpy((0.1 * rng.standard_normal(c)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((2, t, c)).astype(np.float32))
    packed = pack_conv_weight(w)
    assert packed.shape == (k, c, c) and packed.is_contiguous()
    assert torch.equal(packed.transpose(1, 2), w)
    assert torch.equal(packed[:, 5, 7], w[:, 7, 5])  # [tap, co, ci] = [tap, ci, co]
    y = F.conv1d(x.transpose(1, 2), packed.permute(1, 2, 0), b, padding=(k - 1) // 2 * dil,
                 dilation=dil).transpose(1, 2)
    torch.testing.assert_close(y, _conv(x, w, b, dil), rtol=0, atol=0)


def test_packed_stage_layouts_per_dtype():
    """bf16 stages hold each weight once, packed [K, O, I], behind a [K, I, O]
    view with the JAX values; f32 stages keep [K, I, O] contiguous (the FMA
    kernel's layout). The plain version reads the same values either way."""
    kernels = (3, 7, 11)
    blocks = _blocks(np.random.default_rng(4), 32, kernels)
    bf = PackedMRFStage(blocks, kernels, torch.bfloat16, "cpu")
    f32 = PackedMRFStage(blocks, kernels, torch.float32, "cpu")
    for chain_b, chain_f, p in zip(bf.chains, f32.chains, blocks):
        want = [c["w"] for pair in zip(p["convs1"], p["convs2"]) for c in pair]
        for (wb, _, db), (wf, _, df), w in zip(chain_b, chain_f, want):
            assert db == df
            assert wb.transpose(1, 2).is_contiguous() and not wb.is_contiguous()
            assert wf.is_contiguous()
            assert torch.equal(wb, torch.from_numpy(w).bfloat16())
            assert torch.equal(wf, torch.from_numpy(w))


@pytest.mark.parametrize("t,length", [(64, 64), (128, 100), (256, 129)])
def test_sdpa_yardstick_computes_k1(t, length):
    """chip_smoke's K1 yardstick (one scaled_dot_product_attention call with
    K1's boolean mask, on [1, H, T, D] views of the fused qkv rows) is K1's
    function: equal to the plain version in f32."""
    rng = np.random.default_rng(t + length)
    h, d = 4, 64
    qkv = torch.from_numpy(rng.standard_normal((t, 3 * h * d)).astype(np.float32))
    q, k, v = (x.view(t, h, d) for x in qkv.split(h * d, dim=-1))
    got = sdpa_yardstick(q, k, v, k1_mask(t, length, "cpu"))
    assert got.shape == (t, h, d)
    torch.testing.assert_close(got, prefill_attention_plain(q, k, v, length), rtol=1e-5,
                               atol=1e-5)
    # is_causal=True agrees on the rows below length
    causal = sdpa_yardstick(q, k, v, None)
    torch.testing.assert_close(causal[:length], got[:length], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("c", [32, 64])
def test_conv1d_yardstick_computes_each_conv(c):
    """chip_smoke's K3 yardstick: each of a stage's 18 convs as one
    F.conv1d on [B, C, T], equal to the plain version's `_conv` in f32."""
    kernels = (3, 7, 11)
    rng = np.random.default_rng(c)
    stage = PackedMRFStage(_blocks(rng, c, kernels), kernels, torch.float32, "cpu")
    x = torch.from_numpy(rng.standard_normal((1, 150, c)).astype(np.float32))
    convs = library_convs(stage)
    assert len(convs) == 18
    mine = [conv for chain in stage.chains for conv in chain]
    for (w, b, dil), (w_kio, b_ref, dil_ref) in zip(convs, mine):
        assert dil == dil_ref and w.shape == (c, c, w_kio.shape[0])
        got = library_conv(x.transpose(1, 2).contiguous(), w, b, dil).transpose(1, 2)
        torch.testing.assert_close(got, _conv(x, w_kio, b_ref, dil), rtol=1e-5, atol=1e-5)
