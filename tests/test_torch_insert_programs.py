"""The port's insert, burst-insert, migrate and conditioning programs
(runtime/engine_core.py, models/xttsv2/engine.py) on the CPU, tiny config,
with the JAX package as the reference.

A real capture needs the card (chip_smoke.py's phase 4h holds every program
against eager bit for bit there), so the programs run here through test
doubles of the CUDA graph: `RecordingGraph` (tests/test_torch_graphs.py)
and `StrictGraph`, which replays the recorded function with every host read
and host upload made to raise (`Tensor.item / tolist / cpu / numpy`,
`bool() / int() / float()` and `__index__` of a tensor, `torch.tensor /
as_tensor / from_numpy`, and a host number written by `__setitem__` into
one element or through a tensor index, which torch copies up from the
host), in the replaying thread only. A capture on the
card would fail on each of those, or bake the value it saw. Neither double
runs the function at capture, which would apply an insert twice. Inputs
are numpy arrays from a seed; each tolerance is stated where it is
asserted."""
import asyncio
import dataclasses
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from helpers import build_tiny_engine
from test_torch_graphs import RecordingGraph
from test_torch_runner import _both, _cfgs, _params, _params_run_to_cap, _states_equal

from auralis_tpu.runtime import decode_loop as jloop
from auralis_tpu.runtime import engine_core as jcore
from auralis_tpu_torch.models.xttsv2.engine import XTTSv2Engine
from auralis_tpu_torch.models.xttsv2.weights import params_from_numpy
from auralis_tpu_torch.ops import _build
from auralis_tpu_torch.runtime import decode_loop as tloop
from auralis_tpu_torch.runtime import engine_core as tcore
from auralis_tpu_torch.runtime import graphs
from auralis_tpu_torch.runtime import sampler as tsamp

N_SLOTS = 8
HOST_READS = ("item", "tolist", "cpu", "numpy", "__bool__", "__int__", "__index__", "__float__")
HOST_UPLOADS = ("tensor", "as_tensor", "from_numpy")
_strict = threading.local()
_from_numpy = torch.from_numpy  # unguarded: the injected noise is made by the test


def _guarded(name: str, original):
    def guarded(*args, **kwargs):
        if getattr(_strict, "on", False):
            raise AssertionError(f"{name} inside a captured program")
        return original(*args, **kwargs)

    return guarded


def _guarded_setitem(original):
    """Tensor.__setitem__ that raises, in strict mode, where torch would
    upload a host number: into a single element (a 0-d copy from the host)
    or through a tensor index (index_put_ moves the number to the device).
    A number written into a basic slice of several elements is a fill."""
    def setitem(self, index, value):
        if getattr(_strict, "on", False) and not torch.is_tensor(value):
            parts = index if isinstance(index, tuple) else (index,)
            if any(torch.is_tensor(i) for i in parts) or self[index].dim() == 0:
                raise AssertionError("Tensor.__setitem__ of a host number inside a captured "
                                     "program")
        return original(self, index, value)

    return setitem


class StrictGraph(RecordingGraph):
    """RecordingGraph whose replay runs the recorded function with host
    reads and uploads raising in this thread."""

    def replay(self):
        self.replays += 1
        _strict.on = True
        try:
            with _build.tally_launches():
                return self.fn()
        finally:
            _strict.on = False


@pytest.fixture()
def strict_graphs(monkeypatch):
    """Captured programs on the CPU through StrictGraph."""
    for name in HOST_READS:
        monkeypatch.setattr(torch.Tensor, name, _guarded(f"Tensor.{name}",
                                                         getattr(torch.Tensor, name)))
    for name in HOST_UPLOADS:
        monkeypatch.setattr(torch, name, _guarded(f"torch.{name}", getattr(torch, name)))
    monkeypatch.setattr(torch.Tensor, "__setitem__", _guarded_setitem(torch.Tensor.__setitem__))
    RecordingGraph.instances = []
    monkeypatch.setattr(graphs, "CudaGraph", StrictGraph)
    monkeypatch.setattr(graphs, "captures_on", lambda device: True)
    graphs.reset_counts()
    yield RecordingGraph.instances
    graphs.reset_counts()


def _write_one(t: torch.Tensor) -> None:
    t[1] = True


def _write_indexed(t: torch.Tensor) -> None:
    t[torch.arange(2)] = 0


@pytest.mark.parametrize("fn,what", [
    (lambda t: t.sum().item(), "Tensor.item"),
    (_write_one, "Tensor.__setitem__"),
    (_write_indexed, "Tensor.__setitem__"),
])
def test_strict_graph_catches_host_reads_and_uploads(strict_graphs, fn, what):
    """The double itself: a program that reads a device value on the host,
    or writes a host number into one element or through a tensor index,
    runs eagerly the first time and fails on replay; a number written into
    a slice of several elements (a fill) passes."""
    t = torch.zeros((3, 4), dtype=torch.bool)
    prog = graphs.ProgramCache("cpu").get("k", lambda: (lambda: fn(t[0]), {}))
    with prog.lock:
        prog()
    with pytest.raises(AssertionError, match=f"{what} .*inside a captured program"), prog.lock:
        prog()
    fill = graphs.ProgramCache("cpu").get("k", lambda: (lambda: t.__setitem__(
        (slice(None), 0), True), {}))
    for _ in range(2):
        with fill.lock:
            fill()
    assert t[:, 0].all()


def _state_tensors(st) -> dict:
    """Every tensor of a decode state by name (cache and scales, sampling
    rows, counters, token and latent buffers)."""
    out = {name: t for name, t in zip(("k", "v", "k_scale", "v_scale"),
                                      (st.cache.k, st.cache.v, st.cache.k_scale,
                                       st.cache.v_scale)) if t is not None}
    out.update({f"sampling.{f.name}": getattr(st.sampling, f.name)
                for f in dataclasses.fields(st.sampling)})
    out.update({f.name: getattr(st, f.name) for f in dataclasses.fields(st)
                if f.name not in ("cache", "sampling", "generator")})
    return out


def _assert_states_bit_equal(got, want) -> None:
    g, w = _state_tensors(got), _state_tensors(want)
    differ = [name for name in g if not torch.equal(g[name], w[name])]
    assert not differ, f"state tensors differ: {differ}"
    assert torch.equal(got.generator.get_state(), want.generator.get_state()), "generator"


def _prompts(cfg, k: int, seed: int):
    """k (cond [C, D] f32, ids [64 - C] int64, n_ids) prompts of bucket 64."""
    rng = np.random.default_rng(seed)
    tb = 64 - cfg.num_cond_latents
    out = []
    for _ in range(k):
        n = int(rng.integers(4, tb - 1))
        ids = np.zeros((tb,), np.int64)
        ids[:n] = rng.integers(5, 300, n)
        cond = (0.5 * rng.standard_normal((cfg.num_cond_latents, cfg.hidden_size))
                ).astype(np.float32)
        out.append((torch.from_numpy(cond), ids, n))
    return out


def _opts(sampled: bool, seed: int) -> tcore.SamplingOptions:
    rng = np.random.default_rng(seed)
    return tcore.SamplingOptions(
        temperature=float(rng.uniform(0.5, 1.2)), top_p=float(rng.uniform(0.6, 1.0)),
        top_k=int(rng.integers(0, 60)), repetition_penalty=float(rng.uniform(1.0, 5.0)),
        do_sample=sampled, max_new_tokens=int(rng.integers(0, 20)))


def _opt_args(o: tcore.SamplingOptions) -> tuple:
    return (o.temperature, o.top_p, o.top_k, o.repetition_penalty, o.do_sample,
            o.max_new_tokens)


def _inject_noise(monkeypatch, draws: list) -> list:
    """Feed `draws` ([S, V] numpy arrays) to the port's sampler: each
    state's generator gets them in order, the i-th call draws[i % len];
    returns the list of calls made."""
    calls = []

    def noise(shape, generator, device):
        calls.append(generator)
        i = calls.count(generator) - 1
        return _from_numpy(draws[i % len(draws)][: shape[0], : shape[1]])

    monkeypatch.setattr(tsamp, "gumbel_noise", noise)
    return calls


# ------------------------------------------------- replay against eager
@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("kind", ["insert", "burst"])
def test_program_replay_equals_eager_insert(strict_graphs, monkeypatch, kind, kv, sampled):
    """Each insert program captured with one set of values (its first call:
    eager, then captured) and replayed with another equals the eager module
    function run with Python values on a second state: every state tensor
    (KV rows and int8 scales, sampling and seen rows, counters, tokens,
    latents) and the generator's state bit-equal. Single: slot 2 then 5;
    burst K = 2: slots (0, 3) then (6, 1); other id counts and options each
    time. Sampled: JAX's Gumbel draws injected (both sides draw the same);
    greedy: the generator's own draws (the same on both sides). K1's plain
    version (prefill_flash) takes its length as a device tensor here."""
    _, tc = _cfgs(prefill_flash=True, kv_int8=kv == "int8")
    _, tp = _both(_params(7))
    dtype = torch.int8 if kv == "int8" else torch.bfloat16
    engine = tcore.DecodeEngine(tp, tc, num_slots=N_SLOTS, cache_dtype=dtype, seed=3,
                                device="cpu")
    eager = tloop.init_decode_state(tc, N_SLOTS, seed=3, dtype=dtype, device="cpu")
    draws = [np.array(jax.random.gumbel(jax.random.PRNGKey(i), (N_SLOTS, tc.num_audio_tokens)))
             for i in range(2)]
    if sampled:
        calls = _inject_noise(monkeypatch, draws)
    slots = [[2], [5]] if kind == "insert" else [[0, 3], [6, 1]]
    for call, lane_slots in enumerate(slots):
        prompts = _prompts(tc, len(lane_slots), seed=10 + call)
        opts = [_opts(sampled, 20 + 2 * call + i) for i in range(len(lane_slots))]
        if kind == "insert":
            (cond, ids, n), = prompts
            engine._insert_tokens([cond], ids[None], [n], lane_slots, opts)
            tloop.insert_sequence_tokens(tp, tc, eager, cond, torch.from_numpy(ids), n,
                                         lane_slots[0], *_opt_args(opts[0]))
        else:
            conds = [c for c, _, _ in prompts]
            ids = np.stack([i for _, i, _ in prompts])
            ns = [n for _, _, n in prompts]
            engine._insert_tokens(conds, ids, ns, lane_slots, opts)
            lanes = list(zip(*(_opt_args(o) for o in opts)))
            tloop.insert_sequences_tokens(tp, tc, eager, torch.stack(conds),
                                          torch.from_numpy(ids), ns, lane_slots, *lanes)
    key = ("insert", 64) if kind == "insert" else ("burst", 64, 2)
    assert engine._programs.keys() == [key]
    assert graphs.counts["captures"] == 1 and graphs.counts["replays"] == 1
    assert graphs.counts[f"{kind}.replays"] == 1
    if sampled:
        assert len(calls) == 4  # two inserts on each side
    _assert_states_bit_equal(engine.state, eager)
    inserted = [x for lane_slots in slots for x in lane_slots]
    assert eager.n_generated[inserted].tolist() == [1] * len(inserted)


@pytest.mark.parametrize("kv_int8", [False, True])
def test_migrate_program_replay_equals_eager(strict_graphs, kv_int8):
    """The migrate program captured on 4 -> 1 and replayed on 6 -> 2 of a
    state with live slots equals migrate_slot with Python ints, bit for
    bit, on every state tensor."""
    _, tc = _cfgs(kv_int8=kv_int8)
    _, tp = _both(_params(8))
    dtype = torch.int8 if kv_int8 else torch.float32
    engine = tcore.DecodeEngine(tp, tc, num_slots=N_SLOTS, cache_dtype=dtype, seed=5,
                                device="cpu")
    eager = tloop.init_decode_state(tc, N_SLOTS, seed=5, dtype=dtype, device="cpu")
    for st in (engine.state, eager):
        for slot, (cond, ids, n) in zip((4, 6), _prompts(tc, 2, seed=30)):
            tloop.insert_sequence_tokens(tp, tc, st, cond, torch.from_numpy(ids), n, slot,
                                         *_opt_args(_opts(False, 31)))
        tloop.decode_steps(tp, tc, st, 3)
    for src, dst in ((4, 1), (6, 2)):
        engine._migrate(src, dst)
        tloop.migrate_slot(eager, src, dst)
    assert engine._programs.keys() == [("migrate",)]
    assert graphs.counts["migrate.replays"] == graphs.counts["replays"] == 1
    _assert_states_bit_equal(engine.state, eager)
    assert eager.n_generated[[4, 6]].tolist() == [0, 0] and (eager.n_generated[[1, 2]] > 0).all()


# ------------------------------------------------------ against JAX
@pytest.mark.parametrize("sampled", [False, True])
def test_insert_programs_match_jax(strict_graphs, monkeypatch, sampled):
    """Single inserts into slots 0 then 3 and bursts of K = 2 into (4, 1)
    then (2, 5) through the port's programs (the second call of each
    replays) and through the JAX package's insert_sequence_tokens /
    insert_sequences_tokens, f32, on 6-slot states: tokens, counters,
    flags and every sampling and seen row equal, latents within 1e-4 (f32
    summation order). Sampled: each of JAX's Gumbel draws is injected into
    the port's sampler."""
    jc, tc = _cfgs()
    jp, tp = _both(_params(9))
    n_slots = 6
    engine = tcore.DecodeEngine(tp, tc, num_slots=n_slots, cache_dtype=torch.float32,
                                device="cpu")
    js = jloop.init_decode_state(jc, n_slots, jax.random.PRNGKey(0), dtype=jnp.float32)
    draws: list = []
    _inject_noise(monkeypatch, draws)
    steps = [("insert", [0]), ("burst", [4, 1]), ("insert", [3]), ("burst", [2, 5])]
    for i, (kind, lane_slots) in enumerate(steps):
        prompts = _prompts(tc, len(lane_slots), seed=40 + i)
        opts = [_opts(sampled, 50 + 2 * i + j) for j in range(len(lane_slots))]
        draws.append(np.array(jax.random.gumbel(jax.random.split(js.rng)[1],
                                                  (n_slots, jc.num_audio_tokens))))
        if kind == "insert":
            (cond, ids, n), = prompts
            js = jloop.insert_sequence_tokens(
                jp, jc, js, jnp.asarray(cond.numpy()), jnp.asarray(ids.astype(np.int32)),
                jnp.int32(n), jnp.int32(lane_slots[0]),
                *(jnp.asarray(a) for a in _opt_args(opts[0])))
            engine._insert_tokens([cond], ids[None], [n], lane_slots, opts)
        else:
            conds = [c for c, _, _ in prompts]
            ids = np.stack([x for _, x, _ in prompts])
            ns = [n for _, _, n in prompts]
            lanes = [np.asarray(a) for a in zip(*(_opt_args(o) for o in opts))]
            js = jloop.insert_sequences_tokens(
                jp, jc, js, jnp.asarray(torch.stack(conds).numpy()),
                jnp.asarray(ids.astype(np.int32)), jnp.asarray(ns, jnp.int32),
                jnp.asarray(lane_slots, jnp.int32), *(jnp.asarray(a) for a in lanes))
            engine._insert_tokens(conds, ids, ns, lane_slots, opts)
    assert graphs.counts["replays"] == 2
    _states_equal(engine.state, js, 1e-4)
    assert engine.state.n_generated.tolist() == [1] * n_slots


# ---------------------------------------------------- precompile_inserts
def _jax_precompile_inserts_keys(je, cond_len: int) -> list:
    """The insert programs the JAX runner's precompile_inserts runs,
    recorded from its calls: ("insert", bucket) and ("burst", bucket, K)."""
    seen = []

    def single(params, cfg, state, cond, ids, *args):
        seen.append(("insert", cond.shape[0] + ids.shape[0]))
        return state

    def burst(params, cfg, state, cond, ids, *args):
        seen.append(("burst", cond.shape[1] + ids.shape[1], cond.shape[0]))
        return state

    real = jcore.insert_sequence_tokens, jcore.insert_sequences_tokens
    jcore.insert_sequence_tokens, jcore.insert_sequences_tokens = single, burst
    try:
        je.precompile_inserts(cond_len=cond_len)
    finally:
        jcore.insert_sequence_tokens, jcore.insert_sequences_tokens = real
    return seen


def test_precompile_inserts_key_set_matches_jax(monkeypatch):
    """At max_seq_len 512 (max_text_tokens 464: every prefill bucket) and 8
    slots, the port's
    precompile_inserts captures exactly the insert programs the JAX
    runner's precompile_inserts runs (recorded from its calls): 4 buckets
    x {single, K = 2, 4, 8} = 16, as at full width, plus ("migrate",); one
    capture each, registered with the state's generator."""
    RecordingGraph.instances = []
    monkeypatch.setattr(graphs, "CudaGraph", RecordingGraph)
    monkeypatch.setattr(graphs, "captures_on", lambda device: True)
    graphs.reset_counts()
    jc, tc = _cfgs(max_text_tokens=464)
    assert tc.max_seq_len == 512
    jp, tp = _both(_params(10))
    je = jcore.DecodeEngine(jp, jc, num_slots=N_SLOTS, cache_dtype=jnp.float32)
    te = tcore.DecodeEngine(tp, tc, num_slots=N_SLOTS, cache_dtype=torch.float32, device="cpu")
    want = _jax_precompile_inserts_keys(je, jc.num_cond_latents)
    te.precompile_inserts(tc.num_cond_latents)
    got = te._programs.keys()
    assert len(want) == len(set(want)) == 16
    assert set(got) == set(want) | {("migrate",)} and len(got) == 17
    assert graphs.counts["captures"] == 17 == len(RecordingGraph.instances)
    assert all(g.generators == [te.state.generator] for g in RecordingGraph.instances)


def test_precompile_inserts_is_observably_noop(strict_graphs):
    """After precompile_inserts no slot is active, done or owned, the
    generator's state is bit-exact, and a second call captures nothing new
    and replays every key."""
    _, tc = _cfgs()
    _, tp = _both(_params(11))
    te = tcore.DecodeEngine(tp, tc, num_slots=4, cache_dtype=torch.float32, seed=3,
                            device="cpu")
    rng = te.state.generator.get_state()
    te.precompile_inserts(tc.num_cond_latents)
    keys = te._programs.keys()
    assert set(keys) == {("insert", 64), ("burst", 64, 2), ("burst", 64, 4), ("migrate",)}
    assert not te.state.active.any() and not te.state.done.any() and not te._slot_owner
    assert torch.equal(te.state.generator.get_state(), rng)
    te.precompile_inserts(tc.num_cond_latents)
    assert graphs.counts["captures"] == len(keys) and graphs.counts["replays"] == len(keys)
    assert torch.equal(te.state.generator.get_state(), rng)


def test_precompile_inserts_preserves_sampled_trajectories(strict_graphs):
    """A sampled chunk (the generator's own draws) on an engine that ran
    precompile_inserts, through the programs, equals the same chunk on an
    engine that never did, run eagerly: tokens and latents bit-equal."""
    _, tc = _cfgs()
    _, tp = _both(_params_run_to_cap(12))
    cond, ids, _ = _prompts(tc, 1, seed=60)[0]
    prompt = tcore.TokenPrompt(cond=cond, ids=ids[ids > 0])
    opts = tcore.SamplingOptions(do_sample=True, temperature=0.8, top_k=20, max_new_tokens=9)

    async def run(engine):
        try:
            return await engine.generate(prompt, opts)
        finally:
            await engine.shutdown()

    warm = tcore.DecodeEngine(tp, tc, num_slots=4, cache_dtype=torch.float32, seed=9,
                              steps_per_sync=4, device="cpu")
    warm.precompile_inserts(tc.num_cond_latents)
    tokens_w, row_w, n_w = asyncio.run(run(warm))
    assert graphs.counts["replays"] > 0  # the chunk's insert replayed the warmed program
    cold = tcore.DecodeEngine(tp, tc, num_slots=4, cache_dtype=torch.float32, seed=9,
                              steps_per_sync=4, device="cpu")
    cold._programs.captures = False  # eager, as on the CPU
    tokens_c, row_c, n_c = asyncio.run(run(cold))
    assert n_w == n_c == 9
    np.testing.assert_array_equal(tokens_w, tokens_c)
    assert torch.equal(row_w[:n_w], row_c[:n_c])


@pytest.mark.parametrize("busy", ["owned", "queued"])
def test_precompile_inserts_refuses_live_slots(strict_graphs, busy):
    """It fills and releases slots, so it refuses to run with a slot owned
    or a prompt queued."""
    _, tc = _cfgs()
    _, tp = _both(_params(13))
    te = tcore.DecodeEngine(tp, tc, num_slots=4, cache_dtype=torch.float32, device="cpu")
    if busy == "owned":
        te._slot_owner[0] = object()
    else:
        te._queue.append(object())
    with pytest.raises(RuntimeError, match="before serving"):
        te.precompile_inserts(tc.num_cond_latents)
    assert te._programs.keys() == []


# ------------------------------------------------------- the runner
def _drive(tp, tc, prompts, options, **kw):
    engine = tcore.DecodeEngine(tp, tc, num_slots=N_SLOTS, cache_dtype=torch.float32,
                                steps_per_sync=4, slot_bucketing=True, device="cpu", **kw)

    async def go():
        out = await asyncio.gather(*(engine.generate(p, o) for p, o in zip(prompts, options)))
        await engine.shutdown()
        return out

    return [(np.asarray(t), r[:n].clone(), n) for t, r, n in asyncio.run(go())], engine


@pytest.mark.parametrize("sampled", [False, True])
def test_runner_through_strict_programs_equals_eager(strict_graphs, monkeypatch, sampled):
    """Seven chunks (caps 4-13, so a burst of 4, one of 2, a single insert,
    and migrations as slots drain) through the runner with every program
    under StrictGraph (decode blocks too) and eagerly: the same tokens, n
    and latents bit for bit. Sampled, the same injected noise on both."""
    _, tc = _cfgs(prefill_flash=True)
    _, tp = _both(_params_run_to_cap(14))
    rng = np.random.default_rng(15)
    prompts = [tcore.TokenPrompt(cond=torch.from_numpy((0.5 * rng.standard_normal(
        (tc.num_cond_latents, tc.hidden_size))).astype(np.float32)),
        ids=rng.integers(5, 300, int(rng.integers(6, 30))).astype(np.int64)) for _ in range(7)]
    caps = [4, 13, 6, 11, 5, 9, 7]
    options = [tcore.SamplingOptions(do_sample=sampled, temperature=0.9, top_k=20, top_p=0.9,
                                     repetition_penalty=2.0, max_new_tokens=c) for c in caps]
    draws = [np.random.default_rng(16 + i).gumbel(size=(N_SLOTS, tc.num_audio_tokens))
             .astype(np.float32) for i in range(3)]
    if sampled:
        _inject_noise(monkeypatch, draws)
    graphed, engine = _drive(tp, tc, prompts, options)
    keys = engine._programs.keys()
    assert {("burst", 64, 4), ("burst", 64, 2), ("insert", 64)} <= set(keys)
    assert engine.stats["migrations"] > 0 and ("migrate",) in keys
    assert graphs.counts["replays"] > 0
    if sampled:
        _inject_noise(monkeypatch, draws)
    monkeypatch.setattr(graphs, "captures_on", lambda device: False)
    eager, _ = _drive(tp, tc, prompts, options)
    for (tg, lg, ng), (te, le, ne), cap in zip(graphed, eager, caps):
        assert ng == ne == cap
        np.testing.assert_array_equal(tg, te)
        assert torch.equal(lg, le)


def test_nothing_is_captured_on_the_cpu():
    """Without a double the CPU runs every insert, migration and
    conditioning call eagerly: precompile_inserts returns at once and no
    cache holds a program after a drive."""
    _, tc = _cfgs()
    _, tp = _both(_params_run_to_cap(17))
    graphs.reset_counts()
    te = tcore.DecodeEngine(tp, tc, num_slots=4, cache_dtype=torch.float32, steps_per_sync=4,
                            device="cpu")
    te.precompile_inserts(tc.num_cond_latents)
    cond, ids, _ = _prompts(tc, 1, seed=70)[0]

    async def go():
        out = await asyncio.gather(*(te.generate(tcore.TokenPrompt(cond=cond, ids=ids[:9]),
                                                 tcore.SamplingOptions(max_new_tokens=5))
                                     for _ in range(3)))
        await te.shutdown()
        return out

    assert all(n == 5 for *_, n in asyncio.run(go()))
    assert not te._programs.captures and te._programs.keys() == []
    assert graphs.counts["captures"] == 0 and te.stats["insert_batches"] == 1


# ---------------------------------------------------------- conditioning
@pytest.fixture(scope="module")
def cond_engines():
    """The JAX tiny engine and a port engine (CPU, f32) on its weights."""
    jax_engine = build_tiny_engine(max_concurrency=2, vocoder_dtype=None)
    params, core = params_from_numpy(jax.device_get(jax_engine.params),
                                     jax.device_get(jax_engine.core), device="cpu")
    engine = XTTSv2Engine(jax_engine.hifi_config, jax_engine.gpt_config, params=params,
                          core=core, max_concurrency=2, cache_dtype=torch.float32,
                          vocoder_dtype=torch.float32, device="cpu")
    return jax_engine, engine


def test_conditioning_programs_match_eager_and_jax(cond_engines, strict_graphs, monkeypatch):
    """get_gpt_cond_latents on 1.5 s and 1.0 s references (22.05 kHz) and
    the speaker embedding of their 16 kHz versions, each twice through the
    conditioning programs (the second call replays, under StrictGraph):
    bit-equal to the eager functions, and within test_torch_slice.py's
    tolerances of the JAX engine (perceiver latents 1e-4, the L2-normalised
    d-vector 1e-5). One program per (kind, sample count)."""
    jax_engine, engine = cond_engines
    monkeypatch.setattr(engine, "_cond_programs", graphs.ProgramCache("cpu"))
    rng = np.random.default_rng(18)
    keys = set()
    for seconds in (1.5, 1.0):
        wav22 = (0.3 * rng.standard_normal((1, int(22050 * seconds)))).astype(np.float32)
        wav16 = (0.3 * rng.standard_normal((1, int(16000 * seconds)))).astype(np.float32)
        want_c = jax_engine.get_gpt_cond_latents(wav22)
        want_s = np.asarray(jax_engine._speaker_fn(wav16.shape[1])(
            jax_engine.core["speaker_encoder"], jnp.asarray(wav16)))
        eager_c = engine._cond_latents(torch.from_numpy(wav22)).numpy()
        eager_s = engine._speaker_dvector(torch.from_numpy(wav16)).numpy()
        for _ in range(2):
            got_c = engine.get_gpt_cond_latents(wav22)
            got_s = engine._speaker_embedding(wav16)
            np.testing.assert_array_equal(got_c, eager_c)
            np.testing.assert_array_equal(got_s, eager_s)
            np.testing.assert_allclose(got_c, want_c, atol=1e-4)
            np.testing.assert_allclose(got_s, want_s, atol=1e-5)
        keys |= {("cond", wav22.shape[1]), ("speaker", wav16.shape[1])}
    assert set(engine._cond_programs.keys()) == keys
    assert graphs.counts["replays"] == 4


def test_precompile_decode_programs_warms_the_inserts(cond_engines, monkeypatch):
    """The engine's precompile_decode_programs (which TTS.warmup() calls)
    captures the decode blocks, every insert program at the perceiver's
    latent count and migrate_slot."""
    _, engine = cond_engines
    monkeypatch.setattr(graphs, "CudaGraph", RecordingGraph)
    monkeypatch.setattr(graphs, "captures_on", lambda device: True)
    de = engine.decode_engine
    monkeypatch.setattr(de, "_programs", graphs.ProgramCache("cpu", (de.state.generator,)))
    engine.precompile_decode_programs()
    keys = set(de._programs.keys())
    decode = {(n, lb, sb) for n, sb, lb in de.precompile_keys()}
    bursts = {("burst", 64, k) for k in de._INSERT_K_BUCKETS if k <= de.num_slots}
    assert keys == decode | {("insert", 64), ("migrate",)} | bursts
