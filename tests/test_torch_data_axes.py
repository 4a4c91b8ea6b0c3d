"""The data and dcn axes of a decode state (auralis_tpu_torch/parallel/mesh.py,
runtime/decode_loop.py `DataShardedState`) and the runner's embeds prompts,
on the CPU, tiny config (2 layers, width 64, 4 heads), f32 unless stated:
against the JAX package's sharded runs on its virtual 8-device CPU mesh
(tests/unit/test_parallel.py's setups), against the port's unsharded run,
and the runner (`DecodeEngine`) on a data x model mesh and with [T, D]
embeddings prompts against JAX's runner. A mesh repeats the CPU device, as
phase 7d of chip_smoke.py repeats one card. Inputs are numpy arrays from a
seed; each tolerance is stated where it is asserted."""
import asyncio
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from auralis_tpu.models.xttsv2.config import tiny_test_config as jax_tiny
from auralis_tpu.models.xttsv2.gpt import init_gpt_params as jax_init_gpt_params
from auralis_tpu.parallel import mesh as jmesh
from auralis_tpu.runtime import decode_loop as jloop
from auralis_tpu.runtime import engine_core as jcore
from auralis_tpu_torch.models.xttsv2 import gpt as tgpt
from auralis_tpu_torch.models.xttsv2 import weights as tw
from auralis_tpu_torch.models.xttsv2.config import tiny_test_config as torch_tiny
from auralis_tpu_torch.parallel import mesh as tmesh
from auralis_tpu_torch.runtime import decode_loop as tloop
from auralis_tpu_torch.runtime import engine_core as tcore

CPU = torch.device("cpu")
# JAX's sharded runs against its own unsharded run hold latents to this
# (tests/unit/test_parallel.py); the port against JAX is held to the same:
# f32 sums in another order, |diff| well below it at unit scale
F32_ATOL = 1e-5
# (dcn, data, model) of each mesh below; its reference is the unsharded run
# when model is 1, else the (1, model) mesh: the model axis alone changes
# the rounding of the row-parallel sums, the data axis changes nothing
MESHES = {"data2": (1, 2, 1), "data4": (1, 4, 1), "data2_model2": (1, 2, 2),
          "dcn2_model2": (2, 1, 2), "data2_model4": (1, 2, 4), "dcn2_data2_model2": (2, 2, 2)}
FLAGS = {"dense": {}, "kernels": {"prefill_flash": True, "flash_decode": True},
         "int8": {"kv_int8": True},
         "int8_ragged": {"kv_int8": True, "ragged_decode": True, "prefill_flash": True}}


def snr_db(ref, got) -> float:
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    err = np.sum((got - ref) ** 2)
    return math.inf if err == 0 else 10 * np.log10(np.sum(ref ** 2) / err)


def _mesh(dcn, data, model):
    return tmesh.make_mesh([CPU] * (dcn * data * model), data=data, model=model, dcn_data=dcn)


def _reference_mesh(dcn, data, model):
    return None if model == 1 else _mesh(1, 1, model)


def _params(seed=0):
    """Tiny GPT params (f32, numpy) with non-trivial LayerNorm scales and
    biases, and the stop token pushed down so runs reach their step count."""
    p = tw.init_gpt_params(torch_tiny().gpt, seed)
    rng = np.random.default_rng(seed + 100)
    for name, arr in p["blocks"].items():
        if not name.endswith("_w"):
            base = 1.0 if name.endswith("scale") else 0.0
            p["blocks"][name] = (base + 0.05 * rng.standard_normal(arr.shape)).astype(np.float32)
    p["mel_head_b"][torch_tiny().gpt.stop_audio_token] = -1e4
    return p


def _state(cfg, params, mesh, num_slots=8):
    state = tloop.init_decode_state(cfg, num_slots, seed=1, dtype=torch.float32, device="cpu")
    if mesh is None:
        return params, state
    return tmesh.shard_gpt_params(params, mesh), tmesh.shard_decode_state(state, mesh)


STATE_FIELDS = ("seq_lens", "audio_pos", "last_token", "active", "done", "tokens_buf",
                "latents_buf", "n_generated", "temperature", "top_p", "top_k",
                "repetition_penalty", "do_sample", "max_new", "seen")


def _whole(state) -> dict:
    """Every field of a decode state as whole [S, ...] tensors (the cache's
    rows with the model shards' lanes side by side and the data shards'
    slots in order; the scales of model shard 0, every shard's copy being
    checked equal), and the generator's state."""
    shards = state.shards if isinstance(state, tloop.DataShardedState) else [state]
    out = {}
    for name in STATE_FIELDS:
        out[name] = torch.cat([
            getattr(sh.sampling if hasattr(sh.sampling, name) else sh, name) for sh in shards])
    caches = [sh.cache.shards if isinstance(sh.cache, tgpt.ShardedKVCache) else [sh.cache]
              for sh in shards]
    for name in ("k", "v", "k_scale", "v_scale"):
        if getattr(caches[0][0], name) is None:
            continue
        if name in ("k", "v"):
            out[name] = torch.cat([torch.cat([getattr(c, name) for c in cs], dim=-1)
                                   for cs in caches], dim=1)
        else:
            for cs in caches:
                for c in cs[1:]:
                    assert torch.equal(getattr(c, name), getattr(cs[0], name))
            out[name] = torch.cat([getattr(cs[0], name) for cs in caches], dim=1)
    out["generator"] = state.generator.get_state()
    return out


def _assert_states_equal(got, want):
    a, b = _whole(got), _whole(want)
    assert a.keys() == b.keys()
    for name in a:
        assert torch.equal(a[name], b[name]), name


# --------------------------------------------- against JAX's sharded runs
def _jax_run(jparams, jcfg, mesh, prompt, n_steps=6):
    """tests/unit/test_parallel.py's `_run`: a greedy insert into slot 1 of
    an 8-slot state, then n_steps decode steps."""
    state = jloop.init_decode_state(jcfg, 8, jax.random.PRNGKey(1), dtype=jnp.float32)
    if mesh is not None:
        jparams = jmesh.shard_gpt_params(jparams, mesh)
        state = jmesh.shard_decode_state(state, mesh)
    state = jloop.insert_sequence(
        jparams, jcfg, state, jnp.asarray(prompt), jnp.int32(prompt.shape[0]), jnp.int32(1),
        jnp.float32(1.0), jnp.float32(1.0), jnp.int32(0), jnp.float32(1.0), jnp.bool_(False))
    return jloop.decode_steps(jparams, jcfg, state, n_steps=n_steps)


def _torch_run(params, cfg, mesh, prompt, n_steps=6, sampled=False, slot_bound=None):
    """The same on the port (greedy, or sampled from the state's generator
    with the sampling rows JAX's test would use were it sampling)."""
    p, state = _state(cfg, params, mesh)
    tloop.insert_sequence(p, cfg, state, torch.from_numpy(prompt), prompt.shape[0], 1,
                          0.8 if sampled else 1.0, 0.9 if sampled else 1.0, 20 if sampled else 0,
                          2.0 if sampled else 1.0, sampled)
    tloop.decode_steps(p, cfg, state, n_steps=n_steps, slot_bound=slot_bound)
    return state


# tests/unit/test_parallel.py:41, :66 and :168: the config flags, the
# prompt's seed and length, and the mesh (dcn, data, model)
JAX_SETUPS = {"2x4": ({}, 0, 16, (1, 2, 4)), "int8_2x4": ({"kv_int8": True}, 2, 14, (1, 2, 4)),
              "dcn_2x2x2": ({}, 0, 16, (2, 2, 2))}


@pytest.mark.parametrize("setup", list(JAX_SETUPS))
def test_data_sharded_matches_jax_sharded_run(setup):
    """The port's data-sharded run against the JAX package's on its virtual
    CPU mesh of the same shape, on JAX's own seed-0 weights: greedy tokens
    equal; f32 latents within F32_ATOL (JAX holds its sharded run to its
    unsharded one with the same bound). Under kv_int8 both packages run
    bf16 activations, where the two implementations round apart by a few
    bf16 steps (up to 0.03 here), so the int8 latents are held as
    tests/test_torch_int8.py holds the port's int8 path against JAX's:
    above 40 dB SNR."""
    if len(jax.devices()) < 8:
        pytest.fail("the JAX reference needs the 8-device virtual CPU mesh (tests/conftest.py)")
    flags, seed, length, (dcn, data, model) = JAX_SETUPS[setup]
    jcfg = dataclasses.replace(jax_tiny().gpt, **flags)
    tcfg = dataclasses.replace(torch_tiny().gpt, **flags)
    jparams = jax_init_gpt_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    prompt = 0.3 * np.random.default_rng(seed).standard_normal(
        (length, jcfg.hidden_size)).astype(np.float32)
    jm = jmesh.make_mesh(data=data, model=model, dcn_data=dcn)
    j_tokens, j_lat = jloop.harvest(_jax_run(jparams, jcfg, jm, prompt), 1)
    params = tw.tree_to_torch(jax.tree.map(np.asarray, jparams), "cpu")
    state = _torch_run(params, tcfg, _mesh(dcn, data, model), prompt)
    assert isinstance(state, tloop.DataShardedState) and len(state.shards) == dcn * data
    t_tokens, t_lat = tloop.harvest(state, 1)
    assert len(t_tokens) == 7  # the prefill's token + 6 steps
    np.testing.assert_array_equal(t_tokens, np.asarray(j_tokens))
    if tcfg.kv_int8:
        assert snr_db(np.asarray(j_lat), t_lat) > 40.0
    else:
        np.testing.assert_allclose(t_lat, np.asarray(j_lat), rtol=0, atol=F32_ATOL)


@pytest.mark.parametrize("setup", list(JAX_SETUPS))
def test_data_sharded_matches_unsharded_run(setup):
    """The same runs against the port's unsharded run: greedy tokens equal;
    sampled from the same seed, at full width and at a slot bound of 2
    (below data shard 0's range end), tokens equal too."""
    flags, seed, length, (dcn, data, model) = JAX_SETUPS[setup]
    cfg = dataclasses.replace(torch_tiny().gpt, **flags)
    params = tw.tree_to_torch(_params(seed), "cpu")
    prompt = 0.3 * np.random.default_rng(seed).standard_normal(
        (length, cfg.hidden_size)).astype(np.float32)
    for sampled, bound in ((False, None), (True, None), (True, 2)):
        one = _torch_run(params, cfg, None, prompt, sampled=sampled, slot_bound=bound)
        sharded = _torch_run(params, cfg, _mesh(dcn, data, model), prompt, sampled=sampled,
                             slot_bound=bound)
        t1, _ = tloop.harvest(one, 1)
        t2, _ = tloop.harvest(sharded, 1)
        assert len(t1) == 7
        np.testing.assert_array_equal(t2, t1, err_msg=f"sampled={sampled} bound={bound}")


# ------------------------------------------------- against the port unsharded
def _drive(params, cfg, mesh, seed):
    """A burst of three sampled prompts into slots 1, 3 and 6 (spanning data
    shards), a single insert into slot 5, decode blocks at full width and at
    a slot bound of 3 (inside data shard 0's range on every mesh here), a
    migrate_slot 6 -> 2 (across shards) and two more steps."""
    rng = np.random.default_rng(seed)
    cond = torch.from_numpy(0.3 * rng.standard_normal((3, 4, cfg.hidden_size)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(5, 60, (3, 12)))
    prompt = torch.from_numpy(0.3 * rng.standard_normal((16, cfg.hidden_size)).astype(np.float32))
    p, state = _state(cfg, params, mesh)
    tloop.insert_sequences_tokens(p, cfg, state, cond, ids, [9, 11, 5], [1, 3, 6], 0.8, 0.9, 20,
                                  2.0, True)
    tloop.insert_sequence(p, cfg, state, prompt, 16, 5, 0.8, 0.9, 20, 2.0, True)
    tloop.decode_steps(p, cfg, state, n_steps=3)
    tloop.release_slot(state, 1)
    tloop.decode_steps(p, cfg, state, n_steps=2, slot_bound=4, len_bound=256)
    tloop.migrate_slot(state, 6, 2)
    tloop.decode_steps(p, cfg, state, n_steps=2)
    return state


@pytest.mark.parametrize("flags", list(FLAGS))
@pytest.mark.parametrize("mesh", ["data2", "data4", "data2_model2", "dcn2_model2"])
def test_burst_bound_migrate_bit_equal(mesh, flags):
    """A sampled drive with a burst spanning data shards, a slot bound
    below a shard's range and a migration across shards: every state field
    (counters, token and latent buffers, sampling rows, KV rows and int8
    scales) and the generator bit-equal to the reference run's (unsharded,
    or the model-only mesh when the mesh has model shards)."""
    cfg = dataclasses.replace(torch_tiny().gpt, **FLAGS[flags])
    params = tw.tree_to_torch(_params(3), "cpu")
    shape = MESHES[mesh]
    got = _drive(params, cfg, _mesh(*shape), 3)
    want = _drive(params, cfg, _reference_mesh(*shape), 3)
    assert isinstance(got, tloop.DataShardedState)
    assert not got.field("active")[6] and got.field("active")[2]
    _assert_states_equal(got, want)
    for slot in (2, 3, 5):
        t1, _ = tloop.harvest(want, slot)
        t2, _ = tloop.harvest(got, slot)
        np.testing.assert_array_equal(t2, t1)
    torch.testing.assert_close(tloop.harvest_latents_device(got, 5),
                               tloop.harvest_latents_device(want, 5), rtol=0, atol=0)
    np.testing.assert_array_equal(tloop.status(got)[2], tloop.status(want)[2])


def test_burst_with_device_slots_per_shard():
    """A burst with its slots as a device tensor (what a captured insert
    passes) and the lanes per data shard: the same state as the host-slot
    burst, bit for bit; lanes that do not split as stated raise."""
    cfg = torch_tiny().gpt
    params = tw.tree_to_torch(_params(4), "cpu")
    rng = np.random.default_rng(4)
    cond = torch.from_numpy(0.3 * rng.standard_normal((4, 4, cfg.hidden_size)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(5, 60, (4, 12)))
    sides = []
    for slots, split in (([0, 2, 5, 7], None), (torch.tensor([0, 2, 5, 7]), (2, 2))):
        p, state = _state(cfg, params, _mesh(1, 2, 1))
        tloop.insert_sequences_tokens(p, cfg, state, cond, ids, [9, 11, 5, 3], slots, 0.8, 0.9,
                                      20, 2.0, True, shard_lanes=split)
        tloop.decode_steps(p, cfg, state, n_steps=2)
        sides.append(state)
    _assert_states_equal(*sides)
    with pytest.raises(ValueError, match="shard_lanes"):
        tloop.insert_sequences_tokens(p, cfg, state, cond, ids, [9, 11, 5, 3],
                                      torch.tensor([0, 2, 5, 7]), 1.0, 1.0, 0, 1.0, False,
                                      shard_lanes=(1, 2))


def test_mesh_layout_and_shared_params():
    """Data shards dcn-major then data, each with its model devices; params
    of data shards on the same devices are one set; a data shard without
    model shards holds the plain dict, its cache a KVCache, and every field
    a copy that shares no memory with the source state."""
    mesh = _mesh(2, 2, 2)
    assert mesh.axis_names == ("dcn", "data", "model")
    assert [len(d) for d in mesh.shard_devices()] == [2, 2, 2, 2]
    params = tw.tree_to_torch(_params(), "cpu")
    sharded = tmesh.shard_gpt_params(params, mesh)
    assert isinstance(sharded, tloop.DataShardedParams) and len(sharded.shards) == 4
    assert all(s is sharded.shards[0] for s in sharded.shards)
    assert isinstance(sharded.shards[0], tgpt.ShardedParams)
    plain = tmesh.shard_gpt_params(params, _mesh(1, 2, 1))
    assert plain.shards[0] is plain.shards[1] and not isinstance(plain.shards[0],
                                                                 tgpt.ShardedParams)
    assert plain.shards[0]["blocks"]["attn_w"] is params["blocks"]["attn_w"]  # no copy
    state = tloop.init_decode_state(torch_tiny().gpt, 8, device="cpu")
    split = tmesh.shard_decode_state(state, _mesh(1, 2, 1))
    assert [sh.num_slots for sh in split.shards] == [4, 4]
    assert isinstance(split.shards[1].cache, tgpt.KVCache)
    split.shards[1].tokens_buf.fill_(7)
    split.shards[1].cache.k.fill_(1)
    assert not state.tokens_buf.any() and not state.cache.k.any()
    assert split.generator is state.generator


@pytest.mark.parametrize("mesh", [(1, 3, 1), (2, 2, 1), (2, 1, 2)])
def test_num_slots_must_divide_by_data_shards(mesh):
    """6 slots over 4 data shards, 6 over 4 (dcn x data) and 5 over 2 (dcn)
    raise ValueError."""
    n = {(1, 3, 1): 8, (2, 2, 1): 6, (2, 1, 2): 5}[mesh]
    state = tloop.init_decode_state(torch_tiny().gpt, n, device="cpu")
    with pytest.raises(ValueError, match="must divide"):
        tmesh.shard_decode_state(state, _mesh(*mesh))


# ------------------------------------------------------------- the runner
def _prompts(cfg, n, seed):
    rng = np.random.default_rng(seed)
    return [tcore.TokenPrompt(
        cond=torch.from_numpy(0.3 * rng.standard_normal((4, cfg.hidden_size)).astype(np.float32)),
        ids=rng.integers(5, 60, int(rng.integers(4, 20))).astype(np.int64)) for _ in range(n)]


async def _serve(engine, prompts, options):
    out = await asyncio.wait_for(asyncio.gather(
        *(engine.generate(p, o) for p, o in zip(prompts, options))), 120)
    await engine.shutdown()
    return [(np.asarray(t), r[:n].clone(), n) for t, r, n in out]


@pytest.mark.parametrize("mesh", [(1, 2, 2), (2, 1, 2)])
def test_runner_on_a_data_mesh_matches_unsharded(mesh):
    """DecodeEngine on a 2x2 (data x model) and a 2x1x2 (dcn x data x model)
    CPU mesh with slot bucketing: 10 greedy chunks with caps spread over
    4-13 (bursts, slot bounds, compaction across data shards) resolve with
    the unsharded runner's tokens and n, latents within F32_ATOL (the
    model axis sums its partials in another order); no slot is left
    active."""
    cfg = dataclasses.replace(torch_tiny().gpt, prefill_flash=True, flash_decode=True)
    params = tw.tree_to_torch(_params(5), "cpu")
    prompts = _prompts(cfg, 10, 5)
    caps = [4, 13, 5, 6, 12, 4, 7, 5, 9, 6]
    options = [tcore.SamplingOptions(do_sample=False, max_new_tokens=c) for c in caps]
    engines, results = {}, {}
    for name, m in (("one", None), ("mesh", _mesh(*mesh))):
        engines[name] = tcore.DecodeEngine(params, cfg, num_slots=8, cache_dtype=torch.float32,
                                           steps_per_sync=4, slot_bucketing=True, device="cpu",
                                           mesh=m)
        results[name] = asyncio.run(_serve(engines[name], prompts, options))
    for (ta, la, na), (tb, lb, nb), cap in zip(results["one"], results["mesh"], caps):
        assert na == nb == cap and np.array_equal(ta, tb)
        torch.testing.assert_close(lb, la, rtol=0, atol=F32_ATOL)
    eng = engines["mesh"]
    assert isinstance(eng.state, tloop.DataShardedState)
    assert eng.stats["insert_batches"] > 0 and eng.stats["slot_bound_blocks"] > 0
    assert eng.num_active == 0 and not eng.state.field("active").any()
    # every finished slot keeps its length: all of it is idle
    for e in engines.values():
        lens = e.state.field("seq_lens") if e is eng else e.state.seq_lens
        assert e.idle_rows() == int(lens.sum()) > 0


def _embeds(cfg, lengths, seed):
    rng = np.random.default_rng(seed)
    return [(0.3 * rng.standard_normal((t, cfg.hidden_size))).astype(np.float32)
            for t in lengths]


async def _serve_jax(engine, prompts, options):
    out = await asyncio.wait_for(asyncio.gather(
        *(engine.generate(p, o) for p, o in zip(prompts, options))), 300)
    await engine.shutdown()
    return [np.asarray(r[0]) for r in out]


@pytest.mark.parametrize("lengths", [(21,), (21, 30, 17, 25)], ids=["single", "burst"])
def test_runner_embeds_prompts_match_jax(lengths):
    """[T, D] embeddings prompts through DecodeEngine.generate, one alone
    and a burst of four in one prefill bucket, against the JAX runner on
    the same arrays and weights: greedy tokens equal. The burst goes
    through one batched insert."""
    jcfg, tcfg = jax_tiny().gpt, torch_tiny().gpt
    p = _params(6)
    prompts = _embeds(tcfg, lengths, 6)
    caps = [9, 7, 11, 6][:len(lengths)]
    t_opts = [tcore.SamplingOptions(do_sample=False, max_new_tokens=c) for c in caps]
    j_opts = [jcore.SamplingOptions(do_sample=False, max_new_tokens=c) for c in caps]
    te = tcore.DecodeEngine(tw.tree_to_torch(p, "cpu"), tcfg, num_slots=4,
                            cache_dtype=torch.float32, device="cpu")
    got = asyncio.run(_serve(te, prompts, t_opts))
    je = jcore.DecodeEngine(jax.tree.map(jnp.asarray, p), jcfg, num_slots=4,
                            cache_dtype=jnp.float32)
    want = asyncio.run(_serve_jax(je, prompts, j_opts))
    for (tokens, _, n), w, cap in zip(got, want, caps):
        assert n == cap
        np.testing.assert_array_equal(tokens, w)
    assert te.stats["insert_batches"] == (len(lengths) > 1)


def test_runner_embeds_prompts_on_a_data_mesh():
    """Embeds prompts and TokenPrompts mixed through a runner on a 2x2 CPU
    mesh: the same tokens as the unsharded runner, each kind grouped into
    its own bursts."""
    cfg = torch_tiny().gpt
    params = tw.tree_to_torch(_params(7), "cpu")
    prompts = _embeds(cfg, (21, 30, 17), 7) + _prompts(cfg, 3, 7)
    options = [tcore.SamplingOptions(do_sample=False, max_new_tokens=c)
               for c in (8, 5, 9, 6, 7, 4)]
    out = {}
    for name, m in (("one", None), ("mesh", _mesh(1, 2, 2))):
        engine = tcore.DecodeEngine(params, cfg, num_slots=8, cache_dtype=torch.float32,
                                    device="cpu", mesh=m)
        out[name] = asyncio.run(_serve(engine, prompts, options))
        assert engine.stats["insert_batches"] == 2
    for (ta, _, na), (tb, _, nb) in zip(out["one"], out["mesh"]):
        assert na == nb and np.array_equal(ta, tb)


def test_runner_refuses_malformed_embeds_per_request():
    """A malformed embeddings array (1-D, the wrong width, empty, or longer
    than max_seq_len - 1) fails its own request with ValueError; a good
    request submitted beside them completes."""
    cfg = torch_tiny().gpt
    engine = tcore.DecodeEngine(tw.tree_to_torch(_params(8), "cpu"), cfg, num_slots=2,
                                cache_dtype=torch.float32, device="cpu")
    bad = [np.zeros((cfg.hidden_size,), np.float32),
           np.zeros((5, cfg.hidden_size + 1), np.float32),
           np.zeros((0, cfg.hidden_size), np.float32),
           np.zeros((cfg.max_seq_len, cfg.hidden_size), np.float32)]
    good = _embeds(cfg, (12,), 8)[0]
    opts = tcore.SamplingOptions(do_sample=False, max_new_tokens=5)

    async def go():
        results = await asyncio.gather(*(engine.generate(b, opts) for b in bad),
                                       engine.generate(good, opts), return_exceptions=True)
        await engine.shutdown()
        return results

    results = asyncio.run(go())
    for r, match in zip(results[:4], ("embeds must be", "embeds must be", "outside",
                                      "outside")):
        assert isinstance(r, ValueError) and match in str(r), r
    assert results[4][2] == 5
