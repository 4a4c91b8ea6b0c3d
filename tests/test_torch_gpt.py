"""The torch port's GPT, sampler and decode loop against the JAX package on
the tiny config (2 layers, width 64, 4 heads), same numpy weights and inputs,
f32 on CPU. Hidden states and cache rows agree to f32 summation-order noise
(bound 1e-4); tokens must match exactly."""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from auralis_tpu.models.xttsv2 import gpt as jgpt
from auralis_tpu.models.xttsv2 import modules as jmod
from auralis_tpu.models.xttsv2.config import tiny_test_config as jax_tiny
from auralis_tpu.models.xttsv2.hifigan import init_hifigan_params
from auralis_tpu.runtime import decode_loop as jloop
from auralis_tpu.runtime import sampler as jsamp
from auralis_tpu_torch.models.xttsv2 import gpt as tgpt
from auralis_tpu_torch.models.xttsv2 import weights as tw
from auralis_tpu_torch.models.xttsv2.config import tiny_test_config as torch_tiny
from auralis_tpu_torch.runtime import decode_loop as tloop
from auralis_tpu_torch.runtime import sampler as tsamp


def _params(seed=0):
    """Tiny GPT params with non-trivial LayerNorm scales and biases."""
    p = tw.init_gpt_params(torch_tiny().gpt, seed)
    rng = np.random.default_rng(seed + 100)
    for name, arr in p["blocks"].items():
        if not name.endswith("_w"):
            base = 1.0 if name.endswith("scale") else 0.0
            p["blocks"][name] = (base + 0.05 * rng.standard_normal(arr.shape)).astype(np.float32)
    return p


def _both(p):
    return jax.tree.map(jnp.asarray, p), tw.tree_to_torch(p, "cpu")


def _cfgs(**flags):
    jc, tc = jax_tiny().gpt, torch_tiny().gpt
    return jc, dataclasses.replace(tc, **flags)


def _cache(cfg, slots, seed):
    shape = jgpt.make_kv_cache(cfg, slots, dtype=jnp.float32).k.shape
    rng = np.random.default_rng(seed)
    return [(0.2 * rng.standard_normal(shape)).astype(np.float32) for _ in range(2)]


@pytest.mark.parametrize("prefill_flash", [False, True])
def test_gpt_prefill_matches_jax(prefill_flash):
    jc, tc = _cfgs(prefill_flash=prefill_flash)
    jp, tp = _both(_params())
    k0, v0 = _cache(jc, 3, 1)
    embeds = np.random.default_rng(2).standard_normal((64, 64)).astype(np.float32)
    length, slot = 41, 1
    h_j, cache_j = jgpt.gpt_prefill(jp, jc, jnp.asarray(embeds), jnp.int32(length),
                                    jnp.int32(slot), jgpt.KVCache(jnp.asarray(k0), jnp.asarray(v0)))
    cache_t = tgpt.KVCache(torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy()))
    h_t = tgpt.gpt_prefill(tp, tc, torch.from_numpy(embeds), length, slot, cache_t)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(cache_t.k.numpy(), np.asarray(cache_j.k), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(cache_t.v.numpy(), np.asarray(cache_j.v), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(cache_t.k[:, 0].numpy(), k0[:, 0])  # other slots untouched


@pytest.mark.parametrize("flash_decode", [False, True])
def test_gpt_decode_step_matches_jax(flash_decode):
    jc, tc = _cfgs(flash_decode=flash_decode)
    jp, tp = _both(_params(3))
    k0, v0 = _cache(jc, 4, 4)
    tokens = np.asarray([3, 5, 64, 9], np.int32)
    pos = np.asarray([1, 2, 0, 34], np.int32)  # 34 > the position table: clipped
    lens = np.asarray([10, 0, 95, 40], np.int32)
    h_j, cache_j = jgpt.gpt_decode_step(
        jp, jc, jnp.asarray(tokens), jnp.asarray(pos), jnp.asarray(lens),
        jgpt.KVCache(jnp.asarray(k0), jnp.asarray(v0)))
    cache_t = tgpt.KVCache(torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy()))
    h_t = tgpt.gpt_decode_step(tp, tc, torch.from_numpy(tokens), torch.from_numpy(pos),
                               torch.from_numpy(lens), cache_t)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(cache_t.k.numpy(), np.asarray(cache_j.k), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(cache_t.v.numpy(), np.asarray(cache_j.v), rtol=1e-4, atol=1e-4)


ROUTES = {(False, False, False): "dense", (True, False, False): "k2",
          (False, True, False): "int8", (False, True, True): "k4"}


@pytest.mark.parametrize("flash_decode,kv_int8,ragged_decode",
                         list(itertools.product([False, True], repeat=3)))
def test_decode_route_over_every_flag_combination(flash_decode, kv_int8, ragged_decode):
    """decode_route maps the three flags to the four decode bodies, K2 and
    K4 being the routes that read by length; the two refused combinations
    (ragged_decode without kv_int8, kv_int8 with flash_decode) raise the
    ValueError that make_kv_cache raises for them."""
    _, tc = _cfgs(flash_decode=flash_decode, kv_int8=kv_int8, ragged_decode=ragged_decode)
    flags = (flash_decode, kv_int8, ragged_decode)
    assert tgpt.READS_BY_LENGTH == {"k2", "k4"}
    if flags in ROUTES:
        assert tgpt.decode_route(tc) == ROUTES[flags]
        assert tgpt.make_kv_cache(tc, 1, device="cpu").quantized == kv_int8
        return
    with pytest.raises(ValueError) as route_error:
        tgpt.decode_route(tc)
    with pytest.raises(ValueError) as cache_error:
        tgpt.make_kv_cache(tc, 1, device="cpu")
    assert str(route_error.value) == str(cache_error.value)
    assert ("exclusive" if kv_int8 else "requires") in str(route_error.value)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("product", ["scores", "context"])
def test_bmm_f32_on_cpu_is_the_upcast_product(product, dtype):
    """The dense body's batched product on the CPU: the f32 product of the
    upcast operands, bit for bit, with the cache operand a strided view of
    a [L, S, T, HD] cache as the body passes it (K transposed for the
    scores, V as it is for the context)."""
    s, nh, hd, t, bound = 4, 2, 16, 64, 40
    g = torch.Generator().manual_seed(11)
    cache = torch.randn((3, s + 2, t, nh * hd), generator=g).to(dtype)
    rows = cache[1, :s, :bound]  # [S, bound, HD]
    if product == "scores":
        a, b = torch.randn((s, nh, nh * hd), generator=g).to(dtype), rows.transpose(1, 2)
    else:
        a, b = torch.softmax(torch.randn((s, nh, bound), generator=g), -1).to(dtype), rows
    got = tgpt._bmm_f32(a, b)
    assert got.dtype == torch.float32
    assert torch.equal(got, torch.bmm(a.float(), b.float()))


@pytest.mark.parametrize("fn", ["layer_norm", "gelu"])
def test_bf16_layer_norm_and_gelu_round_the_f32_result(fn):
    """LayerNorm and gelu on bf16 activations (with bf16 scale and bias) run
    in bf16: gelu is the f32 result rounded once, bit for bit; LayerNorm
    lies within one bf16 step of the f32 result (its f32 sums may run in
    another order)."""
    g = torch.Generator().manual_seed(12)
    x = (3 * torch.randn((64, 1024), generator=g) + 0.5).to(torch.bfloat16)
    if fn == "gelu":
        assert torch.equal(tgpt._gelu(x), torch.nn.functional.gelu(x.float()).to(x.dtype))
        return
    w, b = (1 + 0.02 * torch.randn(1024, generator=g)).to(x.dtype), \
        (0.02 * torch.randn(1024, generator=g)).to(x.dtype)
    got = tgpt.layer_norm(x, w, b)
    want = torch.nn.functional.layer_norm(x.float(), (1024,), w.float(), b.float(), 1e-5)
    assert got.dtype == torch.bfloat16
    assert bool(((got.float() - want).abs() <= 2.0 ** -7 * want.abs()).all())


def test_heads_and_prompt_embeds_match_jax():
    jc, tc = _cfgs()
    jp, tp = _both(_params(5))
    h = np.random.default_rng(6).standard_normal((3, 64)).astype(np.float32)
    lj, zj = jgpt.heads(jp, jnp.asarray(h))
    lt, zt = tgpt.heads(tp, torch.from_numpy(h))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=1e-5, atol=1e-5)
    cond = np.random.default_rng(7).standard_normal((8, 64)).astype(np.float32)
    want = jgpt.build_prompt_embeds(jp, jc, cond, [5, 6, 7], 2, 3)
    got = tgpt.build_prompt_embeds(tp, tc, torch.from_numpy(cond), [5, 6, 7], 2, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_assemble_prompt_matches_jax():
    jc, tc = _cfgs()
    jp, tp = _both(_params(8))
    cond = np.random.default_rng(9).standard_normal((8, 64)).astype(np.float32)
    ids = np.zeros((56,), np.int32)
    ids[:12] = np.arange(2, 14)
    want = jloop._assemble_prompt(jp, jc, jnp.asarray(cond), jnp.asarray(ids), jnp.int32(12))
    got = tloop._assemble_prompt(tp, tc, torch.from_numpy(cond), torch.from_numpy(ids), 12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))  # gathers and one add


def _sampling_pair(seed, greedy):
    rng = np.random.default_rng(seed)
    s, v = 6, 66
    fields = dict(
        temperature=np.asarray([0.75, 1.0, 0.3, 2.0, 1e-6, 0.9], np.float32),
        top_p=np.asarray([0.85, 1.0, 0.5, 0.95, 0.85, 0.1], np.float32),
        top_k=np.asarray([50, 0, 5, 1, 66, 3], np.int32),
        repetition_penalty=np.asarray([5.0, 1.0, 2.0, 1.3, 5.0, 10.0], np.float32),
        do_sample=np.asarray([not greedy] * s),
        max_new=np.zeros((s,), np.int32),
        seen=rng.random((s, v)) < 0.2,
    )
    logits = (3.0 * rng.standard_normal((s, v))).astype(np.float32)
    js = jsamp.SamplingState(**{k: jnp.asarray(a) for k, a in fields.items()})
    ts = tsamp.SamplingState(**{k: torch.from_numpy(a.copy()) for k, a in fields.items()})
    return logits, js, ts


@pytest.mark.parametrize("greedy", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_tokens_exact_with_injected_gumbel(greedy, seed):
    """JAX's own Gumbel draw, fed to the port, must give the same tokens and
    the same seen masks, greedy and sampled."""
    logits, js, ts = _sampling_pair(seed, greedy)
    key = jax.random.PRNGKey(seed)
    tok_j, state_j = jsamp.sample_tokens(jnp.asarray(logits), js, key)
    gumbel = np.array(jax.random.gumbel(key, logits.shape, dtype=jnp.float32))
    tok_t = tsamp.sample_tokens(torch.from_numpy(logits), ts, gumbel=torch.from_numpy(gumbel))
    np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))
    np.testing.assert_array_equal(ts.seen.numpy(), np.asarray(state_j.seen))


def test_decode_loop_greedy_matches_jax():
    """Two inserts (slots 0 and 2) then 12 greedy decode steps: identical
    token buffers and counters, latents within f32 noise; then the same
    status, harvest and release results."""
    jc, tc = _cfgs(flash_decode=True, prefill_flash=True)
    jp, tp = _both(_params(10))
    js = jloop.init_decode_state(jc, 3, jax.random.PRNGKey(0), dtype=jnp.float32)
    ts = tloop.init_decode_state(tc, 3, seed=0, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(11)
    for slot, n_ids in ((0, 9), (2, 20)):
        cond = rng.standard_normal((8, 64)).astype(np.float32)
        ids = np.zeros((56,), np.int32)
        ids[:n_ids] = rng.integers(5, 300, n_ids)
        opts = (1.0, 1.0, 1, 5.0, False, 0)
        js = jloop.insert_sequence_tokens(
            jp, jc, js, jnp.asarray(cond), jnp.asarray(ids), jnp.int32(n_ids), jnp.int32(slot),
            *(jnp.asarray(o) for o in opts))
        tloop.insert_sequence_tokens(tp, tc, ts, torch.from_numpy(cond), torch.from_numpy(ids),
                                     n_ids, slot, *opts)
    js = jloop.decode_steps(jp, jc, js, n_steps=12)
    tloop.decode_steps(tp, tc, ts, n_steps=12)
    for name in ("tokens_buf", "n_generated", "seq_lens", "audio_pos", "active", "done"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                      err_msg=name)
    np.testing.assert_allclose(ts.latents_buf.numpy(), np.asarray(js.latents_buf),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(tloop.pack_status(ts).numpy(), np.asarray(jloop.pack_status(js)))
    for got, want in zip(tloop.status(ts), jloop.status(js)):
        np.testing.assert_array_equal(got, want)
    tok_t, lat_t = tloop.harvest(ts, 2)
    tok_j, lat_j = jloop.harvest(js, 2)
    np.testing.assert_array_equal(tok_t, tok_j)
    np.testing.assert_allclose(lat_t, lat_j, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(tloop.harvest_latents_device(ts, 2).numpy()[: len(lat_t)], lat_t)
    tloop.release_slot(ts, 0)
    js = jloop.release_slot(js, jnp.int32(0))
    mask = np.asarray([False, False, True])
    tloop.release_slots(ts, torch.from_numpy(mask))
    js = jloop.release_slots(js, jnp.asarray(mask))
    np.testing.assert_array_equal(tloop.pack_status(ts).numpy(), np.asarray(jloop.pack_status(js)))


def test_random_init_keys_and_shapes_match_jax_init():
    cfg = torch_tiny()
    gpt, core = tw.random_init(cfg, seed=0)
    jcfg = jax_tiny()
    g = jcfg.gpt
    key = jax.random.PRNGKey(0)
    want = {
        "gpt": jax.eval_shape(lambda k: jgpt.init_gpt_params(g, k), key),
        "cond_encoder": jax.eval_shape(lambda k: jmod.init_conditioning_encoder_params(
            k, spec_dim=80, embed_dim=g.hidden_size), key),
        "perceiver": jax.eval_shape(lambda k: jmod.init_perceiver_params(
            k, dim=g.hidden_size, num_latents=g.num_cond_latents), key),
        "speaker_encoder": jax.eval_shape(jmod.init_speaker_encoder_params, key),
        "hifigan": jax.eval_shape(lambda k: init_hifigan_params(
            k, in_channels=g.hidden_size, cond_channels=jcfg.d_vector_dim,
            upsample_initial=64), key),
    }
    got = {"gpt": gpt, **{k: core[k] for k in want if k != "gpt"}}
    for name in want:
        wl, wt = jax.tree_util.tree_flatten_with_path(want[name])
        gl, gt = jax.tree_util.tree_flatten_with_path(got[name])
        assert wt == gt, name
        for (wp, w), (gp, a) in zip(wl, gl):
            assert wp == gp and tuple(w.shape) == a.shape and a.dtype == np.float32, (name, wp)
    assert core["mel_stats"].shape == (80,)
