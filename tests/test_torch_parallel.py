"""Tensor parallelism over the model axis (auralis_tpu_torch/parallel/mesh.py
and the GPT's sharded forward) against the single-device run and against the
JAX package's sharded run on its virtual 8-device CPU mesh, tiny config
(2 layers, width 64, 4 heads), f32. A mesh repeats the CPU device, as phase
7b of chip_smoke.py repeats one card. Inputs are numpy arrays from a seed;
each tolerance is stated where it is asserted."""
import asyncio
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from helpers import build_tiny_tokenizer, sine_wav

from auralis_tpu.models.xttsv2.config import tiny_test_config as jax_tiny
from auralis_tpu.parallel import mesh as jmesh
from auralis_tpu.runtime import decode_loop as jloop
from auralis_tpu_torch import TTS, TTSRequest
from auralis_tpu_torch.frontend.tokenizer import TTSTokenizer
from auralis_tpu_torch.models.xttsv2 import gpt as tgpt
from auralis_tpu_torch.models.xttsv2 import weights as tw
from auralis_tpu_torch.models.xttsv2.config import tiny_test_config as torch_tiny
from auralis_tpu_torch.models.xttsv2.engine import XTTSv2Engine
from auralis_tpu_torch.parallel import mesh as tmesh
from auralis_tpu_torch.runtime import decode_loop as tloop
from auralis_tpu_torch.runtime import engine_core as tcore

CPU = torch.device("cpu")
# the sharded run sums the row-parallel partials in another order than the
# single-device product: f32 rounding, |diff| well below this on hidden
# states and latents of unit scale
F32_ATOL = 1e-5


def _params(seed=0):
    """Tiny GPT params (f32) with non-trivial LayerNorm scales and biases,
    and the stop token pushed down so greedy runs reach their step count."""
    p = tw.init_gpt_params(torch_tiny().gpt, seed)
    rng = np.random.default_rng(seed + 100)
    for name, arr in p["blocks"].items():
        if not name.endswith("_w"):
            base = 1.0 if name.endswith("scale") else 0.0
            p["blocks"][name] = (base + 0.05 * rng.standard_normal(arr.shape)).astype(np.float32)
    p["mel_head_b"][torch_tiny().gpt.stop_audio_token] = -1e4
    return p


def _mesh(tp):
    return tmesh.make_mesh([CPU] * tp, data=1, model=tp)


def _prompt(cfg, t, seed):
    return 0.3 * np.random.default_rng(seed).standard_normal((t, cfg.hidden_size)).astype(
        np.float32)


def _insert_args(length, slot):
    return dict(length=length, slot=slot, temperature=1.0, top_p=1.0, top_k=0,
                repetition_penalty=1.0, do_sample=False)


def _torch_run(params, cfg, mesh, prompts, n_steps, num_slots=4):
    """Greedy single inserts of `prompts` into slots 1, 2, ... then n_steps
    decode steps, on one device (mesh None) or sharded."""
    state = tloop.init_decode_state(cfg, num_slots, seed=1, dtype=torch.float32, device="cpu")
    if mesh is not None:
        params = tmesh.shard_gpt_params(params, mesh)
        state = tmesh.shard_decode_state(state, mesh)
    for i, prompt in enumerate(prompts):
        a = _insert_args(prompt.shape[0], i + 1)
        tloop.insert_sequence(params, cfg, state, torch.from_numpy(prompt), a["length"],
                              a["slot"], a["temperature"], a["top_p"], a["top_k"],
                              a["repetition_penalty"], a["do_sample"])
    tloop.decode_steps(params, cfg, state, n_steps=n_steps)
    return state


def _rows(cache):
    """The cache's K rows with the shards' lanes put back side by side."""
    if isinstance(cache, tgpt.ShardedKVCache):
        return torch.cat([c.k for c in cache.shards], dim=-1)
    return cache.k


@pytest.mark.parametrize("tp", [2, 4])
def test_sharded_matches_single_device(tp):
    """Greedy tokens equal, latents and the KV cache within F32_ATOL."""
    cfg = torch_tiny().gpt
    params = tw.tree_to_torch(_params(), "cpu")
    prompts = [_prompt(cfg, 16, 0), _prompt(cfg, 11, 1)]
    one = _torch_run(params, cfg, None, prompts, 6)
    sharded = _torch_run(params, cfg, _mesh(tp), prompts, 6)
    assert isinstance(sharded.cache, tgpt.ShardedKVCache) and len(sharded.cache.shards) == tp
    assert sharded.cache.shards[0].k.shape[-1] == cfg.hidden_size // tp
    for slot in (1, 2):
        t1, l1 = tloop.harvest(one, slot)
        t2, l2 = tloop.harvest(sharded, slot)
        np.testing.assert_array_equal(t2, t1)
        assert len(t1) == 7  # the prefill's token + 6 steps
        np.testing.assert_allclose(l2, l1, rtol=0, atol=F32_ATOL)
    torch.testing.assert_close(_rows(sharded.cache), one.cache.k, rtol=0, atol=F32_ATOL)


@pytest.mark.parametrize("tp", [2, 4])
def test_sharded_matches_jax_sharded_run(tp):
    """The port's model-sharded run against the JAX package's on its virtual
    CPU mesh (data=1, model=tp), same numpy weights and prompt: greedy
    tokens equal, latents within F32_ATOL."""
    if len(jax.devices()) < tp:
        pytest.fail("the JAX reference needs the 8-device virtual CPU mesh (tests/conftest.py)")
    p = _params()
    jcfg, tcfg = jax_tiny().gpt, torch_tiny().gpt
    prompt = _prompt(tcfg, 16, 0)
    jm = jmesh.make_mesh(data=1, model=tp)
    jparams = jmesh.shard_gpt_params(jax.tree.map(jnp.asarray, p), jm)
    jstate = jmesh.shard_decode_state(
        jloop.init_decode_state(jcfg, 4, jax.random.PRNGKey(1), dtype=jnp.float32), jm)
    jstate = jloop.insert_sequence(
        jparams, jcfg, jstate, jnp.asarray(prompt), jnp.int32(16), jnp.int32(1),
        jnp.float32(1.0), jnp.float32(1.0), jnp.int32(0), jnp.float32(1.0), jnp.bool_(False))
    jstate = jloop.decode_steps(jparams, jcfg, jstate, n_steps=6)
    j_tokens, j_lat = jloop.harvest(jstate, 1)
    state = _torch_run(tw.tree_to_torch(p, "cpu"), tcfg, _mesh(tp), [prompt], 6)
    t_tokens, t_lat = tloop.harvest(state, 1)
    np.testing.assert_array_equal(t_tokens, np.asarray(j_tokens))
    np.testing.assert_allclose(t_lat, np.asarray(j_lat), rtol=0, atol=F32_ATOL)


@pytest.mark.parametrize("tp", [2, 4])
def test_int8_dense_body_scales_bit_equal_under_tp(tp):
    """kv_int8 (the dense int8 body, no K4) under the mesh: every shard
    quantises its lanes at the scale over all lanes. Layer 0's rows of a
    prompt come from the same embeddings on both sides, so its per-token
    scales (every shard's copy) and int8 rows equal the unsharded run's bit
    for bit; deeper layers see hidden states summed in another order
    (within F32_ATOL), so their scales agree to rtol 1e-5 and their int8
    lanes to one step. Greedy tokens after 4 decode steps are equal."""
    cfg = dataclasses.replace(torch_tiny().gpt, kv_int8=True)
    params = tw.tree_to_torch(_params(2), "cpu")
    prompts = [_prompt(cfg, 14, 2)]
    one = _torch_run(params, cfg, None, prompts, 4)
    sharded = _torch_run(params, cfg, _mesh(tp), prompts, 4)
    assert sharded.cache.dtype == torch.int8
    rows = _rows(sharded.cache)
    for c in sharded.cache.shards:
        assert torch.equal(c.k_scale[0, :, :14], one.cache.k_scale[0, :, :14])
        assert torch.equal(c.v_scale[0, :, :14], one.cache.v_scale[0, :, :14])
        torch.testing.assert_close(c.k_scale, one.cache.k_scale, rtol=1e-5, atol=0)
        torch.testing.assert_close(c.v_scale, one.cache.v_scale, rtol=1e-5, atol=0)
    assert torch.equal(rows[0, :, :14], one.cache.k[0, :, :14])
    assert (rows.int() - one.cache.k.int()).abs().max() <= 1
    t1, l1 = tloop.harvest(one, 1)
    t2, l2 = tloop.harvest(sharded, 1)
    np.testing.assert_array_equal(t2, t1)
    np.testing.assert_allclose(l2, l1, rtol=0, atol=F32_ATOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tp", [2, 4])
def test_sharded_row_quantisation_bit_equal(tp, dtype):
    """The shards' quantisation of one set of rows, split by lanes, equals
    quantize_rows of the whole rows bit for bit: the int8 lanes put back
    side by side and every shard's scales (the row max is max-reduced over
    the shards, exact in any order)."""
    from auralis_tpu_torch.ops.quant import quantize_rows

    x = torch.from_numpy(np.random.default_rng(5).standard_normal((6, 9, 64))).to(dtype)
    x[2, 3] = 0  # a zero row takes the eps scale on every shard
    params = tmesh.shard_gpt_params(tw.tree_to_torch(_params(), "cpu"), _mesh(tp))
    got = tgpt._tp_quantize(params, list(x.chunk(tp, dim=-1)))
    want_q, want_s = quantize_rows(x)
    assert torch.equal(torch.cat([q for q, _ in got], dim=-1), want_q)
    for _, s in got:
        assert torch.equal(s, want_s)


@pytest.mark.parametrize("flags", [{}, {"prefill_flash": True, "flash_decode": True}],
                         ids=["dense", "kernels"])
def test_burst_insert_and_migrate_under_tp(flags):
    """A burst of three prompts (insert_sequences_tokens, one batched
    prefill over the shards) into non-contiguous slots, then migrate_slot
    across every shard's cache: tokens equal the unsharded engine's,
    latents within F32_ATOL, every shard's migrated rows equal its source."""
    cfg = dataclasses.replace(torch_tiny().gpt, **flags)
    params = tw.tree_to_torch(_params(3), "cpu")
    rng = np.random.default_rng(3)
    cond = torch.from_numpy(0.3 * rng.standard_normal((3, 4, cfg.hidden_size)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(5, 60, (3, 12)))
    results = []
    for mesh in (None, _mesh(2)):
        state = tloop.init_decode_state(cfg, 6, seed=1, dtype=torch.float32, device="cpu")
        p = params
        if mesh is not None:
            p = tmesh.shard_gpt_params(params, mesh)
            state = tmesh.shard_decode_state(state, mesh)
        tloop.insert_sequences_tokens(p, cfg, state, cond, ids, [9, 11, 5], [0, 3, 5],
                                      1.0, 1.0, 0, 1.0, False)
        tloop.decode_steps(p, cfg, state, n_steps=3)
        tloop.migrate_slot(state, 5, 1)
        tloop.decode_steps(p, cfg, state, n_steps=2)
        results.append(state)
    one, sharded = results
    for slot in (0, 1, 3):
        t1, l1 = tloop.harvest(one, slot)
        t2, l2 = tloop.harvest(sharded, slot)
        np.testing.assert_array_equal(t2, t1)
        np.testing.assert_allclose(l2, l1, rtol=0, atol=F32_ATOL)
    assert not sharded.active[5] and sharded.active[1]
    torch.testing.assert_close(_rows(sharded.cache), one.cache.k, rtol=0, atol=F32_ATOL)


def test_runner_on_a_mesh_matches_unsharded():
    """DecodeEngine(mesh=...) serves greedy chunks through its runner (burst
    inserts, pipelined blocks, harvest) with the tokens of the unsharded
    runner; latents within F32_ATOL."""
    cfg = dataclasses.replace(torch_tiny().gpt, prefill_flash=True, flash_decode=True)
    params = tw.tree_to_torch(_params(4), "cpu")
    rng = np.random.default_rng(4)
    prompts = [tcore.TokenPrompt(
        cond=torch.from_numpy(0.3 * rng.standard_normal((4, cfg.hidden_size)).astype(np.float32)),
        ids=rng.integers(5, 60, 6 + i).astype(np.int32)) for i in range(5)]
    opts = tcore.SamplingOptions(do_sample=False, max_new_tokens=10)

    async def serve(mesh):
        engine = tcore.DecodeEngine(params, cfg, num_slots=4, cache_dtype=torch.float32,
                                    device="cpu", mesh=mesh)
        out = await asyncio.gather(*(engine.generate(p, opts) for p in prompts))
        await engine.shutdown()
        return engine, out

    _, want = asyncio.run(serve(None))
    engine, got = asyncio.run(serve(_mesh(2)))
    assert isinstance(engine.params, tgpt.ShardedParams)
    assert engine.stats["insert_batches"] >= 1
    for (gt, gr, gn), (wt, wr, wn) in zip(got, want):
        assert gn == wn == 10
        np.testing.assert_array_equal(gt, wt)
        torch.testing.assert_close(gr[:gn], wr[:wn], rtol=0, atol=F32_ATOL)


def test_tensor_parallel_serving_end_to_end(tmp_path):
    """tensor_parallel_size=2 on a CPU engine builds a (1, 2) mesh of CPU
    shards, and the public path (tokenize -> conditioning -> sharded decode
    -> vocoder on the first device) gives finite audio."""
    eng = XTTSv2Engine.random_init(tokenizer=TTSTokenizer(build_tiny_tokenizer().tokenizer),
                                   seed=0, max_concurrency=2, device="cpu",
                                   tensor_parallel_size=2)
    assert eng.mesh is not None and eng.mesh.shape["model"] == 2
    params = eng.decode_engine.params
    assert isinstance(params, tgpt.ShardedParams) and len(params.shards) == 2
    qkv = params.shards[0]["blocks"]["attn_w"]
    assert qkv.shape[-1] == 3 * eng.gpt_config.hidden_size // 2
    tts = TTS(scheduler_max_concurrency=2).with_engine(eng)
    try:
        out = tts.generate_speech(TTSRequest(
            text="Tensor parallel serving test.", speaker_files=[sine_wav(tmp_path / "s.wav")],
            language="en", max_new_tokens=24))
        arr = np.asarray(out.array)
        assert arr.size > 500 and np.isfinite(arr).all()
    finally:
        tts.loop.run_until_complete(tts.shutdown())


def test_tensor_parallel_rejects_bad_degree():
    with pytest.raises(ValueError, match="must divide"):
        XTTSv2Engine.random_init(tokenizer=None, seed=0, device="cpu", tensor_parallel_size=3)


def test_mesh_too_small_raises(monkeypatch):
    """A mesh that needs more devices than there are raises the mesh's
    ValueError, and so does tensor_parallel_size=2 on a one-GPU card (faked
    here: the mesh is made before any tensor moves)."""
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        tmesh.make_mesh([CPU], data=1, model=2)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    cfg = torch_tiny()
    params, core = tw.params_from_numpy(*tw.random_init(cfg, 0), device="cpu")
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        XTTSv2Engine(cfg, cfg.gpt, params=params, core=core, device="cuda",
                     tensor_parallel_size=2)
    # a mesh may repeat one device
    assert tmesh.make_mesh([CPU, CPU], model=2).shape == {"data": 1, "model": 2}


def test_initialize_distributed_noop_single_process(monkeypatch):
    for name in ("AURALIS_NUM_PROCESSES", "JAX_NUM_PROCESSES"):
        monkeypatch.delenv(name, raising=False)
    assert tmesh.initialize_distributed() is False
    monkeypatch.setenv("AURALIS_NUM_PROCESSES", "1")
    assert tmesh.initialize_distributed() is False
    with pytest.raises(ValueError, match="coordinator"):
        tmesh.initialize_distributed(num_processes=2)


def test_w8a8_disabled_under_tp(monkeypatch):
    """decode_w8a8 / prefill_w8a8 are turned off with the JAX engine's
    warning under tensor parallelism; no int8 weight copy is made."""
    from auralis_tpu_torch.models.xttsv2 import engine as tengine

    warned = []
    monkeypatch.setattr(tengine.logger, "warning",
                        lambda msg, *args: warned.append(msg % args))
    eng = XTTSv2Engine.random_init(tokenizer=None, seed=0, device="cpu",
                                   tensor_parallel_size=2, decode_w8a8=True, prefill_w8a8=True)
    g = eng.gpt_config
    assert not g.decode_w8a8 and not g.prefill_w8a8 and not g.kv_int8
    assert "blocks_q8" not in eng.params
    assert [m.split(" ")[0] for m in warned if "under tensor parallelism" in m] == [
        "decode_w8a8", "prefill_w8a8"]


# ------------------------------------------- K4 under tensor parallelism
def _k4_inputs(seed, s=3, h=4, d=64, t=2 * 256):
    """Inputs of K4's plain version at H heads: q [S, H, D] and new rows
    [S, H*D] in bf16 (the int8 path's activations), an int8 cache with f32
    scales of one layer, write positions on both sides of a split edge."""
    rng = np.random.default_rng(seed)
    q, kn, vn = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        torch.bfloat16) for shape in ((s, h, d), (s, h * d), (s, h * d)))
    k_f, v_f = (rng.standard_normal((1, s, t, h * d)).astype(np.float32) for _ in range(2))
    ks, vs = (np.maximum(np.abs(a).max(-1), 1e-8).astype(np.float32) / np.float32(127.0)
              for a in (k_f, v_f))
    caches = [torch.from_numpy(a) for a in (np.round(k_f / ks[..., None]).astype(np.int8),
                                            np.round(v_f / vs[..., None]).astype(np.int8),
                                            ks, vs)]
    wp = torch.tensor([0, 127, 300][:s], dtype=torch.int32)
    return q, kn, vn, caches, wp


@pytest.mark.parametrize("tp", [2, 4])
def test_k4_plain_with_row_scales_on_shard_lanes(tp):
    """K4's plain version on one model shard's heads with the whole row's
    scales given (`row_scales`, as the sharded decode step passes them)
    against the unsharded plain version: every shard's int8 lanes, its copy
    of the scales and its ctx heads bit-equal to the unsharded ones."""
    from auralis_tpu_torch.ops.experimental.attention import ragged_decode_plain
    from auralis_tpu_torch.ops.quant import quantize_rows

    q, kn, vn, caches, wp = _k4_inputs(7)
    h, d = q.shape[1:]
    whole = [c.clone() for c in caches]
    ctx = ragged_decode_plain(q, kn, vn, 0.125, 0, wp, *whole)
    row_scales = (quantize_rows(kn)[1], quantize_rows(vn)[1])
    w = h * d // tp
    for r in range(tp):
        lanes = slice(r * w, (r + 1) * w)
        mine = [caches[0][..., lanes].clone(), caches[1][..., lanes].clone(),
                caches[2].clone(), caches[3].clone()]
        got = ragged_decode_plain(q[:, r * h // tp:(r + 1) * h // tp], kn[:, lanes], vn[:, lanes],
                                  0.125, 0, wp, *mine, row_scales=row_scales)
        assert torch.equal(got, ctx[:, lanes])
        assert torch.equal(mine[0], whole[0][..., lanes])
        assert torch.equal(mine[1], whole[1][..., lanes])
        assert torch.equal(mine[2], whole[2]) and torch.equal(mine[3], whole[3])


def test_k4_plain_without_row_scales_unchanged():
    """Without `row_scales` K4's plain version quantises each row over its
    own lanes, as before: its caches and scales equal the Pallas kernel's
    in interpret mode, and passing the rows' own scales changes no bit."""
    from test_torch_int8 import _jax_ragged_blocking

    from auralis_tpu_torch.ops.experimental.attention import ragged_decode_plain
    from auralis_tpu_torch.ops.quant import quantize_rows

    q, kn, vn, caches, wp = _k4_inputs(8)
    base = [c.clone() for c in caches]
    ctx = ragged_decode_plain(q, kn, vn, 0.125, 0, wp, *base)
    given = [c.clone() for c in caches]
    ctx_given = ragged_decode_plain(q, kn, vn, 0.125, 0, wp, *given,
                                    row_scales=(quantize_rows(kn)[1], quantize_rows(vn)[1]))
    assert torch.equal(ctx, ctx_given)
    assert all(torch.equal(a, b) for a, b in zip(base, given))
    _, *want = _jax_ragged_blocking(q.float().numpy(), kn.float().numpy(), vn.float().numpy(),
                                    0.125, 0, wp.numpy(), [c.numpy() for c in caches])
    for got, w in zip(base, want):
        np.testing.assert_array_equal(got.numpy(), np.asarray(w))


def _jax_ragged_run(jcfg, jparams, tp, prompt, n_steps):
    """JAX's greedy int8 ragged run (its Pallas kernel in interpret mode):
    an insert into slot 1 of 4 and n_steps decode steps, unsharded or on
    a (1, tp) mesh of the virtual CPU devices."""
    state = jloop.init_decode_state(jcfg, 4, jax.random.PRNGKey(1), dtype=jnp.float32)
    if tp:
        jm = jmesh.make_mesh(data=1, model=tp)
        jparams = jmesh.shard_gpt_params(jparams, jm)
        state = jmesh.shard_decode_state(state, jm)
    state = jloop.insert_sequence(
        jparams, jcfg, state, jnp.asarray(prompt), jnp.int32(prompt.shape[0]), jnp.int32(1),
        jnp.float32(1.0), jnp.float32(1.0), jnp.int32(0), jnp.float32(1.0), jnp.bool_(False))
    return jloop.harvest(jloop.decode_steps(jparams, jcfg, state, n_steps=n_steps), 1)[0]


@pytest.mark.parametrize("tp", [2, 4])
def test_ragged_int8_under_tp(tp):
    """kv_int8 + ragged_decode (K4, plain version) on a model mesh against
    the unsharded ragged run, 4 greedy decode steps: layer 0's int8 rows and
    every shard's copy of its scales bit-equal (the prompt's and each
    appended step's: layer 0 reads the same embeddings on both sides);
    deeper layers see hidden states summed in another order, so their
    scales agree to rtol 1e-5 and their int8 lanes to one step. Greedy
    tokens equal the unsharded run's and JAX's, unsharded and on its (1,
    tp) mesh (its Pallas kernel in interpret mode)."""
    flags = dict(kv_int8=True, ragged_decode=True)
    cfg = dataclasses.replace(torch_tiny().gpt, **flags)
    jcfg = dataclasses.replace(jax_tiny().gpt, **flags)
    p = _params(2)
    params = tw.tree_to_torch(p, "cpu")
    prompt = _prompt(cfg, 14, 2)
    one = _torch_run(params, cfg, None, [prompt], 4)
    sharded = _torch_run(params, cfg, _mesh(tp), [prompt], 4)
    rows = _rows(sharded.cache)
    live = 14 + 4  # the prompt's rows and the 4 appended ones
    assert torch.equal(rows[0, :, :live], one.cache.k[0, :, :live])
    for c in sharded.cache.shards:
        assert torch.equal(c.k_scale[0], one.cache.k_scale[0])
        assert torch.equal(c.v_scale[0], one.cache.v_scale[0])
        torch.testing.assert_close(c.k_scale, one.cache.k_scale, rtol=1e-5, atol=0)
        torch.testing.assert_close(c.v_scale, one.cache.v_scale, rtol=1e-5, atol=0)
    assert (rows.int() - one.cache.k.int()).abs().max() <= 1
    tokens, _ = tloop.harvest(one, 1)
    np.testing.assert_array_equal(tloop.harvest(sharded, 1)[0], tokens)
    jparams = jax.tree.map(jnp.asarray, p)
    for jtp in (None, tp):
        np.testing.assert_array_equal(tokens, np.asarray(_jax_ragged_run(jcfg, jparams, jtp,
                                                                         prompt, 4)))


def test_runner_ragged_int8_on_a_mesh():
    """DecodeEngine(mesh=) with kv_int8 + ragged_decode serves greedy chunks
    (burst inserts, pipelined blocks) with the unsharded runner's tokens."""
    cfg = dataclasses.replace(torch_tiny().gpt, kv_int8=True, ragged_decode=True,
                              prefill_flash=True)
    params = tw.tree_to_torch(_params(4), "cpu")
    rng = np.random.default_rng(4)
    prompts = [tcore.TokenPrompt(
        cond=torch.from_numpy(0.3 * rng.standard_normal((4, cfg.hidden_size)).astype(np.float32)),
        ids=rng.integers(5, 60, 6 + i).astype(np.int32)) for i in range(5)]
    opts = tcore.SamplingOptions(do_sample=False, max_new_tokens=10)

    async def serve(mesh):
        engine = tcore.DecodeEngine(params, cfg, num_slots=4, device="cpu", mesh=mesh)
        out = await asyncio.gather(*(engine.generate(p, opts) for p in prompts))
        await engine.shutdown()
        return out

    want = asyncio.run(serve(None))
    got = asyncio.run(serve(_mesh(2)))
    for (gt, _, gn), (wt, _, wn) in zip(got, want):
        assert gn == wn == 10
        np.testing.assert_array_equal(gt, wt)


def test_tensor_parallel_int8_ragged_serving(tmp_path):
    """XTTSv2Engine(tensor_parallel_size=2, kv_int8=True) with ragged_decode
    in its config serves a request through the facade (finite audio)."""
    cfg = torch_tiny()
    cfg.gpt = dataclasses.replace(cfg.gpt, ragged_decode=True, prefill_flash=True)
    eng = XTTSv2Engine.random_init(cfg, tokenizer=TTSTokenizer(build_tiny_tokenizer().tokenizer),
                                   seed=0, max_concurrency=2, device="cpu",
                                   tensor_parallel_size=2, kv_int8=True)
    g = eng.gpt_config
    assert g.kv_int8 and g.ragged_decode and eng.decode_engine.state.cache.quantized
    tts = TTS(scheduler_max_concurrency=2).with_engine(eng)
    try:
        out = tts.generate_speech(TTSRequest(
            text="Ragged int8 under tensor parallelism.",
            speaker_files=[sine_wav(tmp_path / "s.wav")], language="en", max_new_tokens=24))
        arr = np.asarray(out.array)
        assert arr.size > 500 and np.isfinite(arr).all()
    finally:
        tts.loop.run_until_complete(tts.shutdown())


def test_default_mesh_needs_a_gpu(monkeypatch):
    """With no CUDA device visible, make_mesh() without devices raises
    instead of building a CPU mesh; named CPU devices still make one."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_mesh(model=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.default_devices()
    assert tmesh.make_mesh([CPU, CPU], data=2).shape == {"data": 2, "model": 1}


def test_specs_match_jax():
    """Same keys and the same split axis per leaf as the JAX package's
    PartitionSpecs (a PartitionSpec is a tuple of axis names)."""
    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(flat(v, prefix + k + "/"))
            else:
                out[prefix + k] = tuple(v)
        return out

    assert flat(tmesh.gpt_param_specs()) == flat(jmesh.gpt_param_specs())
    for dcn in (False, True):
        assert flat(tmesh.decode_state_specs(dcn)) == flat(jmesh.decode_state_specs(dcn))
    assert (tmesh.DATA_AXIS, tmesh.MODEL_AXIS, tmesh.DCN_AXIS) == (
        jmesh.DATA_AXIS, jmesh.MODEL_AXIS, jmesh.DCN_AXIS)


def test_qkv_split_per_head():
    """Shard r holds [q_r | k_r | v_r] of its heads, not a contiguous cut of
    the fused 3D axis; the row-parallel weights split their input rows."""
    p = tw.tree_to_torch(_params(), "cpu")
    d = p["blocks"]["attn_w"].shape[1]
    sharded = tmesh.shard_gpt_params(p, _mesh(2))
    w = p["blocks"]["attn_w"]
    q, k, v = w.split(d, dim=-1)
    half = d // 2
    want = torch.cat([q[..., half:], k[..., half:], v[..., half:]], dim=-1)
    assert torch.equal(sharded.shards[1]["blocks"]["attn_w"], want)
    assert torch.equal(sharded.shards[1]["blocks"]["attn_proj_w"],
                       p["blocks"]["attn_proj_w"][:, half:])
    assert torch.equal(sharded.shards[0]["blocks"]["fc_b"],
                       p["blocks"]["fc_b"][:, :p["blocks"]["fc_b"].shape[1] // 2])
    assert torch.equal(sharded.shards[1]["blocks"]["fc_proj_b"], p["blocks"]["fc_proj_b"])
    assert "blocks" not in sharded and torch.equal(sharded["wte"], p["wte"])
