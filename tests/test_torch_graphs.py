"""The port's captured programs (auralis_tpu_torch/runtime/graphs.py) on the
CPU, tiny config: the decode-block key set against the JAX runner's
precompile, and the capture machinery through a test double of the CUDA
graph, since a real capture needs the card (chip_smoke.py's phase 4g holds
real graphs against eager bit for bit).

`RecordingGraph` is that double. It stands in for `graphs.CudaGraph`, the
wrapper of torch.cuda.CUDAGraph: its capture records the callable and runs
nothing (a real capture issues no work), and its replay re-runs the
recorded callable on the program's static inputs, its kernel launches
uncounted (the program adds the capture's tally). So the tests below hold
what the port adds around the graph: the keys, the lazy eager-then-capture
order, the static inputs and their locks, the launch tallies and the
generator's state."""
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
from test_torch_runner import _both, _cfgs, _params_run_to_cap

from auralis_tpu.runtime import engine_core as jcore
from auralis_tpu.runtime import sampler as jsamp
from auralis_tpu_torch.models.xttsv2.config import tiny_test_config
from auralis_tpu_torch.models.xttsv2.engine import XTTSv2Engine
from auralis_tpu_torch.ops import _build
from auralis_tpu_torch.runtime import engine_core as tcore
from auralis_tpu_torch.runtime import graphs
from auralis_tpu_torch.runtime import sampler as tsamp


class RecordingGraph:
    """Test double of the CUDA graph (`graphs.CudaGraph`): capture records
    the callable and runs nothing; replay re-runs it and returns its
    outputs; the registered generators are kept for inspection."""

    instances: list = []

    @staticmethod
    def new_pool():
        return None

    def __init__(self, pool, generators=()):
        self.generators = list(generators)
        self.fn = None
        self.replays = 0
        RecordingGraph.instances.append(self)

    def capture(self, fn):
        self.fn = fn

    def replay(self):
        # a real replay runs no Python: the launches of the re-run are not
        # counted here (the program adds the capture's tally)
        self.replays += 1
        with _build.tally_launches():
            return self.fn()


@pytest.fixture()
def recording_graphs(monkeypatch):
    """Captured programs on the CPU, through RecordingGraph."""
    RecordingGraph.instances = []
    monkeypatch.setattr(graphs, "CudaGraph", RecordingGraph)
    monkeypatch.setattr(graphs, "captures_on", lambda device: True)
    graphs.reset_counts()
    yield RecordingGraph.instances
    graphs.reset_counts()


# ------------------------------------------------------------- key set
def _jax_precompile_set(je) -> list:
    """The (n_steps, slot_bound, len_bound) blocks the JAX runner's
    precompile lowers, recorded from its calls."""
    seen = []

    class Lowered:
        def compile(self):
            return None

    class Recorder:
        def lower(self, params, cfg, state, n_steps, len_bound, slot_bound):
            seen.append((n_steps, slot_bound, len_bound))
            assert cfg is je._cfg_for(len_bound, slot_bound)
            return Lowered()

    class MigrateRecorder:
        def lower(self, *args):
            return Lowered()

    real = jcore.decode_steps_status, jcore.migrate_slot
    jcore.decode_steps_status, jcore.migrate_slot = Recorder(), MigrateRecorder()
    try:
        je.precompile()
    finally:
        jcore.decode_steps_status, jcore.migrate_slot = real
    return seen


@pytest.mark.parametrize("bucketing", [False, True])
@pytest.mark.parametrize("stream_steps", [None, 13])
def test_precompile_keys_match_jax(bucketing, stream_steps, monkeypatch):
    """DecodeEngine.precompile_keys() is the set the JAX DecodeEngine's
    precompile lowers (recorded from its calls), and that set is the cross
    product of its block lengths {min(stream_block_steps, steps_per_sync),
    steps_per_sync}, its slot bounds (None and, with slot_bucketing,
    _slot_buckets()) and its length bounds (LEN_BUCKETS and None)."""
    monkeypatch.setenv("AURALIS_PAR_COMPILE", "1")
    jc, tc = _cfgs()
    jp, tp = _both(_params_run_to_cap(6))
    kw = dict(num_slots=16, steps_per_sync=16, slot_bucketing=bucketing,
              stream_block_steps=stream_steps)
    je = jcore.DecodeEngine(jp, jc, cache_dtype=jnp.float32, **kw)
    te = tcore.DecodeEngine(tp, tc, cache_dtype=torch.float32, device="cpu", **kw)
    steps = sorted({min(je.stream_block_steps, je.steps_per_sync), je.steps_per_sync})
    slots = [None] + (list(je._slot_buckets()) if bucketing else [])
    derived = {(n, sb, lb) for n in steps for sb in slots for lb in (*je.LEN_BUCKETS, None)}
    lowered = _jax_precompile_set(je)
    assert len(lowered) == len(set(lowered))
    assert set(lowered) == derived
    assert set(te.precompile_keys()) == derived
    assert len(te.precompile_keys()) == len(derived)
    assert len(derived) == len(steps) * (3 if bucketing else 1) * 5


@pytest.mark.parametrize("bucketing", [False, True])
def test_precompile_captures_the_key_set_and_restores_the_generator(recording_graphs,
                                                                    bucketing):
    """precompile() captures one program per key (through the double),
    each registered with the state's generator; the generator's state is
    restored afterwards; no slot becomes active and no counter, token or
    latent row moves. A second precompile captures nothing new. Before
    serving only: with a slot owned it raises."""
    _, tc = _cfgs()
    _, tp = _both(_params_run_to_cap(6))
    te = tcore.DecodeEngine(tp, tc, num_slots=8, cache_dtype=torch.float32, steps_per_sync=4,
                            stream_block_steps=3, slot_bucketing=bucketing, device="cpu")
    st = te.state
    st.generator.manual_seed(123)
    rng = st.generator.get_state()
    before = {k: getattr(st, k).clone() for k in ("active", "done", "n_generated", "seq_lens",
                                                  "audio_pos", "tokens_buf", "latents_buf")}
    te.precompile()
    assert torch.equal(st.generator.get_state(), rng)
    for k, v in before.items():
        assert torch.equal(getattr(st, k), v), k
    assert set(te._programs.keys()) == {(n, lb, sb) for n, sb, lb in te.precompile_keys()}
    assert graphs.counts["captures"] == len(te.precompile_keys()) == len(recording_graphs)
    assert all(g.generators == [st.generator] for g in recording_graphs)
    te.precompile()
    assert graphs.counts["captures"] == len(te.precompile_keys())
    assert graphs.counts["replays"] == len(te.precompile_keys())
    assert torch.equal(st.generator.get_state(), rng)
    te._slot_owner[0] = object()
    with pytest.raises(RuntimeError, match="before serving"):
        te.precompile()


# ------------------------------------------------------------- launches
class _FakeKernel:
    """A kernel wrapper's count: what _build.count_launch adds to."""

    launches = 0


class _RunningGraph(RecordingGraph):
    """RecordingGraph whose capture also runs the callable's Python, as a
    real capture does (its launches are recorded, not run): for a function
    without side effects."""

    def capture(self, fn):
        self.fn = fn
        fn()


def test_replays_add_the_captured_launch_counts(monkeypatch):
    """A program whose function launches a kernel three times: the eager
    first call counts 3, the capture none (it runs nothing), and each
    replay adds the 3 the capture tallied; launches outside a capture
    count as before."""
    monkeypatch.setattr(graphs, "CudaGraph", _RunningGraph)
    monkeypatch.setattr(graphs, "captures_on", lambda device: True)
    _FakeKernel.launches = 0

    def fn():
        for _ in range(3):
            _build.count_launch(_FakeKernel)
        return torch.ones(2)

    cache = graphs.ProgramCache("cpu")
    prog = cache.get("k", lambda: (fn, {}))
    with cache.lock:
        prog()
    assert _FakeKernel.launches == 3 and prog.captured
    assert prog.launches == {_FakeKernel: 3}
    for i in range(4):
        with cache.lock:
            prog()
        assert _FakeKernel.launches == 3 + 3 * (i + 1)
    _build.count_launch(_FakeKernel)
    assert _FakeKernel.launches == 16
    assert cache.get("k", lambda: pytest.fail("built twice")) is prog


def test_captures_record_their_keys(monkeypatch):
    """Each capture appends its program's key to `captured_keys`, in
    capture order, beside the kinds' tallies; replays add nothing, and
    reset_counts() clears the list with the counts."""
    monkeypatch.setattr(graphs, "CudaGraph", _RunningGraph)
    monkeypatch.setattr(graphs, "captures_on", lambda device: True)
    graphs.reset_counts()
    cache = graphs.ProgramCache("cpu")
    keys = [("row", 64, 2), (16, None, None), ("insert", 128)]
    for key in keys + keys:
        prog = cache.get(key, lambda: (lambda: torch.ones(1), {}))
        with cache.lock:
            prog()
    assert graphs.captured_keys == keys
    assert [graphs.counts[f"{k}.captures"] for k in ("row", "decode", "insert")] == [1, 1, 1]
    assert graphs.counts["captures"] == 3 and graphs.counts["replays"] == 3
    graphs.reset_counts()
    assert graphs.captured_keys == [] and graphs.counts["captures"] == 0


def test_a_failed_capture_raises(monkeypatch):
    """A capture that fails raises out of the call; nothing falls back."""

    class Failing(RecordingGraph):
        def capture(self, fn):
            raise RuntimeError("capture failed")

    monkeypatch.setattr(graphs, "CudaGraph", Failing)
    monkeypatch.setattr(graphs, "captures_on", lambda device: True)
    cache = graphs.ProgramCache("cpu")
    prog = cache.get("k", lambda: (lambda: torch.zeros(1), {}))
    with pytest.raises(RuntimeError, match="capture failed"), cache.lock:
        prog()
    assert not prog.captured


@pytest.mark.parametrize("capturing", [False, True])
def test_programs_of_a_cache_share_its_lock(monkeypatch, capturing):
    """Every program of a cache hands out the cache's one lock, and no
    program makes a lock of its own; another cache has another lock. A
    cache that does not capture (the CPU) still hands out programs, and
    each call of one runs its function eagerly: it captures nothing and
    counts no replay."""
    if capturing:
        monkeypatch.setattr(graphs, "CudaGraph", _RunningGraph)
        monkeypatch.setattr(graphs, "captures_on", lambda device: True)
    graphs.reset_counts()
    calls = []
    cache, other = graphs.ProgramCache("cpu"), graphs.ProgramCache("cpu")
    assert cache.captures is capturing and cache.lock is not other.lock
    progs = [cache.get(k, lambda: (lambda: calls.append(1) or torch.ones(1), {}))
             for k in [("row", 64, 1), ("seg", None, 2), (16, None, None)]]
    assert all(p.lock is cache.lock for p in progs)
    assert other.get("k", lambda: (lambda: torch.ones(1), {})).lock is other.lock
    for _ in range(3):
        for p in progs:
            with cache.lock:
                p()
    assert [p.captured for p in progs] == [capturing] * 3
    # a capturing cache's capture runs the function once more (_RunningGraph)
    assert len(calls) == 9 + 3 * capturing
    assert graphs.counts["captures"] == 3 * capturing
    assert graphs.counts["replays"] == cache.replays() == 6 * capturing
    assert cache.keys() == ([p.key for p in progs] if capturing else [])


# -------------------------------------------------- the runner, eager vs graphs vs JAX
def _noise(n_slots: int, vocab: int) -> np.ndarray:
    return np.random.default_rng(21).gumbel(size=(n_slots, vocab)).astype(np.float32)


def _drive_port(tp, tc, prompts, options, noise):
    engine = tcore.DecodeEngine(tp, tc, num_slots=8, cache_dtype=torch.float32,
                                steps_per_sync=4, slot_bucketing=True, device="cpu")

    async def go():
        out = await asyncio.gather(*(engine.generate(p, o) for p, o in zip(prompts, options)))
        await engine.shutdown()
        return out

    out = asyncio.run(go())
    return [(np.asarray(t), r[:n].numpy(), n) for t, r, n in out], engine


def _drive_jax(jp, jc, prompts, options):
    engine = jcore.DecodeEngine(jp, jc, num_slots=8, cache_dtype=jnp.float32, steps_per_sync=4,
                                slot_bucketing=True)

    async def go():
        out = await asyncio.gather(*(engine.generate(
            jcore.TokenPrompt(cond=jnp.asarray(p.cond.numpy()), ids=p.ids.astype(np.int32)),
            jcore.SamplingOptions(**dataclasses.asdict(o))) for p, o in zip(prompts, options)))
        await engine.shutdown()
        return out

    return [(np.asarray(t), np.asarray(lat)) for t, lat in asyncio.run(go())]


@pytest.mark.parametrize("sampled", [False, True])
def test_runner_through_graphs_equals_eager_and_jax(sampled, monkeypatch):
    """Six chunks (max_new_tokens 5-14, so they finish in different blocks
    and the slot bound narrows) through the port's runner eagerly, through
    its captured programs (the double) and through the JAX runner: the same
    tokens and n everywhere; latents bit-equal between the port's two runs
    and within 1e-4 of JAX's (f32). Sampled, both packages draw the same
    injected Gumbel noise. The graph run captured each key once and
    replayed the later blocks of each; its inserts ran as programs too."""
    jc, tc = _cfgs()
    jp, tp = _both(_params_run_to_cap(9))
    rng = np.random.default_rng(3)
    prompts = []
    for _ in range(6):
        cond = torch.from_numpy((0.5 * rng.standard_normal(
            (tc.num_cond_latents, tc.hidden_size))).astype(np.float32))
        prompts.append(tcore.TokenPrompt(cond=cond, ids=rng.integers(5, 300, 12).astype(np.int64)))
    caps = [5, 14, 7, 12, 6, 9]
    options = [tcore.SamplingOptions(do_sample=sampled, temperature=0.9, top_k=20, top_p=0.9,
                                     repetition_penalty=2.0, max_new_tokens=c) for c in caps]
    noise = _noise(8, tc.num_audio_tokens)
    if sampled:
        monkeypatch.setattr(tsamp, "gumbel_noise", lambda shape, gen, device: torch.from_numpy(
            noise[: shape[0], : shape[1]].copy()))
        monkeypatch.setattr(jsamp.jax.random, "gumbel", lambda key, shape, dtype=None: (
            jnp.asarray(noise[: shape[0], : shape[1]])))
        jax.clear_caches()  # programs traced before the patch draw their own noise
    try:
        want = _drive_jax(jp, jc, prompts, options)
    finally:
        if sampled:
            monkeypatch.undo()
            jax.clear_caches()
            monkeypatch.setattr(tsamp, "gumbel_noise", lambda shape, gen, device: (
                torch.from_numpy(noise[: shape[0], : shape[1]].copy())))
    eager, _ = _drive_port(tp, tc, prompts, options, noise)
    with monkeypatch.context() as m:
        RecordingGraph.instances = []
        m.setattr(graphs, "CudaGraph", RecordingGraph)
        m.setattr(graphs, "captures_on", lambda device: True)
        graphs.reset_counts()
        graphed, engine = _drive_port(tp, tc, prompts, options, noise)
        counts = dict(graphs.counts)
        keys = engine._programs.keys()
    # the decode blocks' keys are (n_steps, len_bound, slot_bound); the
    # inserts and migrations have their own programs ("insert", "burst",
    # "migrate") in the same cache
    decode = [k for k in keys if graphs.kind_of(k) == "decode"]
    assert counts["captures"] == len(keys) > len(decode) > 0
    assert counts["decode.replays"] > 0
    assert counts["decode.replays"] + len(decode) == engine.stats["blocks"]
    assert any(k[0] == "burst" for k in keys), "the inserts did not run as programs"
    assert any(sb is not None for _, _, sb in decode), "no block ran at a slot bound"
    for (te, le, ne), (tg, lg, ng), (tj, lj), cap in zip(eager, graphed, want, caps):
        assert ne == ng == cap
        np.testing.assert_array_equal(tg, te)
        np.testing.assert_array_equal(tj, te)
        np.testing.assert_array_equal(lg, le)
        np.testing.assert_allclose(le, lj, rtol=0, atol=1e-4)


# --------------------------------------------------------------- vocoder
@pytest.fixture(scope="module")
def vocoder_engine():
    return XTTSv2Engine.random_init(tiny_test_config(), dtype=torch.float32, device="cpu",
                                    max_concurrency=2, vocoder_dtype=torch.float32)


def _lanes(engine, b: int, seed: int):
    g = engine.gpt_config
    rng = np.random.default_rng(seed)
    rows = [torch.from_numpy(rng.standard_normal((g.max_audio_tokens, g.hidden_size))
                             .astype(np.float32)) for _ in range(b)]
    ns = [int(x) for x in rng.integers(20, g.max_audio_tokens, b)]
    spk = [rng.standard_normal((1, 512)).astype(np.float32) * 0.1 for _ in range(b)]
    return rows, ns, spk


def _eager(engine, kind, rows, ns, spk, arg):
    stacked = torch.stack(rows)
    if kind == "row":
        return engine._rows_pcm(stacked, engine._lanes(ns), engine._speaker_rows(spk),
                                arg).numpy()
    if kind == "seg":
        return engine._vocode_seg(stacked, ns, arg, spk).numpy()
    return engine._vocode_seg_first(stacked, ns, spk).numpy()


def _arg(engine, kind, ns, seed):
    if kind == "row":
        return engine.row_bucket(max(ns))
    if kind == "seg":
        rng = np.random.default_rng(seed)
        return [engine._seg_slice_start(int(x)) for x in rng.integers(0, engine._bucket_pf, len(ns))]
    return None


@pytest.mark.parametrize("kind,b", [("seg_first", 1), ("seg_first", 3), ("seg", 1), ("seg", 2),
                                    ("row", 1), ("row", 2)])
def test_vocoder_programs_equal_eager(vocoder_engine, recording_graphs, monkeypatch, kind, b):
    """Through the double, every vocoder kind at an exact batch size: the
    first call (eager, then capture) and later replays on other inputs give
    the eager functions' PCM bit for bit (the static inputs are staged
    afresh each call; the segment window is a gather on the staged starts),
    one program per (kind, bucket, B)."""
    eng = vocoder_engine
    monkeypatch.setattr(eng, "_vocoder_programs", graphs.ProgramCache("cpu"))
    for seed in range(3):
        rows, ns, spk = _lanes(eng, b, seed)
        arg = _arg(eng, kind, ns, seed)
        got = eng._vocode_batch(kind, rows, ns, spk, arg)
        np.testing.assert_array_equal(got, _eager(eng, kind, rows, ns, spk, arg))
    keys = eng._vocoder_programs.keys()
    assert all(k[0] == kind and k[2] == b for k in keys)
    assert graphs.counts["replays"] == 3 - len(keys)


def test_two_threads_through_one_vocoder_program(vocoder_engine, recording_graphs, monkeypatch):
    """Two threads run batches of the same key (seg_first, B = 2) at once,
    each with its own inputs, 6 times each: the cache's lock covers the
    staging, the replay and the copy out, so each gets the PCM of its own
    inputs."""
    eng = vocoder_engine
    monkeypatch.setattr(eng, "_vocoder_programs", graphs.ProgramCache("cpu"))
    lanes = [_lanes(eng, 2, 40 + t) for t in range(2)]
    want = [_eager(eng, "seg_first", *lane, None) for lane in lanes]
    start = threading.Barrier(2)
    errors = []

    def worker(t):
        try:
            start.wait()
            for _ in range(6):
                got = eng._vocode_batch("seg_first", *lanes[t])
                np.testing.assert_array_equal(got, want[t])
        except Exception as e:  # reported on the main thread
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errors, errors
    assert eng._vocoder_programs.keys() == [("seg_first", None, 2)]
    assert graphs.counts["replays"] == 11


class PoolGraph(RecordingGraph):
    """RecordingGraph whose replays all return their output in one buffer
    of their pool, from its first byte, as a real pool's blocks may alias:
    a later replay of any program of the pool overwrites what an earlier
    one returned. The output is a `_Watched` tensor, and `after_replay`
    (set by a test) runs in the replaying thread after each replay."""

    after_replay = None
    BYTES = 1 << 22

    @staticmethod
    def new_pool():
        return torch.empty(PoolGraph.BYTES, dtype=torch.uint8)

    def __init__(self, pool, generators=()):
        super().__init__(pool, generators)
        self.pool = pool

    def replay(self):
        out = super().replay().contiguous()
        nbytes = out.numel() * out.element_size()
        assert nbytes <= self.BYTES
        shared = self.pool[:nbytes].view(out.dtype).view(out.shape)
        shared.copy_(out)
        if PoolGraph.after_replay is not None:
            PoolGraph.after_replay()
        return shared.as_subclass(_Watched)


class _Watched(torch.Tensor):
    """A replay's output (or a tensor made from it): its host copies
    (`cpu`, `numpy`) are logged in `log`, while a test sets it."""

    log = None

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if cls.log is not None and getattr(func, "__name__", "") in ("cpu", "numpy"):
            cls.log.append("host copy")
        return super().__torch_function__(func, types, args, kwargs or {})


class _LoggedLock:
    """A lock that logs its acquires and releases in `log`."""

    def __init__(self, log: list):
        self._lock, self.log = threading.Lock(), log

    def __enter__(self):
        self._lock.acquire()
        self.log.append("acquire")

    def __exit__(self, *exc):
        self.log.append("release")
        self._lock.release()


@pytest.fixture()
def pool_graphs(monkeypatch):
    """Captured programs on the CPU through PoolGraph."""
    monkeypatch.setattr(graphs, "CudaGraph", PoolGraph)
    monkeypatch.setattr(graphs, "captures_on", lambda device: True)
    monkeypatch.setattr(PoolGraph, "after_replay", None)
    monkeypatch.setattr(_Watched, "log", None)
    graphs.reset_counts()
    yield
    graphs.reset_counts()


def _pool_calls(engine, which: str, monkeypatch) -> list:
    """(cache, [(call, want)]): two calls of `which` ("vocoder":
    `_vocode_batch`, a segment batch of 2 and a first segment;
    "conditioning": `_conditioning`, "cond" and "speaker"), each with its
    eager result, on a fresh cache that the engine uses."""
    cache = graphs.ProgramCache("cpu")
    if which == "vocoder":
        monkeypatch.setattr(engine, "_vocoder_programs", cache)
        calls = []
        for kind, b, seed in (("seg", 2, 60), ("seg_first", 1, 61)):
            rows, ns, spk = _lanes(engine, b, seed)
            arg = _arg(engine, kind, ns, seed)
            calls.append(((lambda k=kind, r=rows, n=ns, g=spk, a=arg:
                           engine._vocode_batch(k, r, n, g, a)),
                          _eager(engine, kind, rows, ns, spk, arg)))
        return cache, calls
    monkeypatch.setattr(engine, "_cond_programs", cache)
    rng = np.random.default_rng(62)
    wav22 = (0.3 * rng.standard_normal((1, 22050))).astype(np.float32)
    wav16 = (0.3 * rng.standard_normal((1, 12000))).astype(np.float32)
    with torch.no_grad():
        want = [engine._cond_latents(torch.from_numpy(wav22)).numpy(),
                engine._speaker_dvector(torch.from_numpy(wav16)).numpy()]
    return cache, [(lambda: engine._conditioning("cond", wav22), want[0]),
                   (lambda: engine._conditioning("speaker", wav16), want[1])]


@pytest.mark.parametrize("first", [0, 1])
@pytest.mark.parametrize("which", ["vocoder", "conditioning"])
def test_a_replay_of_another_key_waits_for_the_copy_out(vocoder_engine, pool_graphs,
                                                        monkeypatch, which, first):
    """All programs of one cache share its pool: through PoolGraph, every
    replay returns its output in the same bytes. Thread A replays one key
    and then waits (up to 1 s) for thread B's replay of the other key,
    before it copies its output out; B starts once A has replayed. Each
    output must equal its own key's eager run. With one lock per program B
    replays in between and A returns B's bytes; with the cache's lock B
    waits until A has copied its output out, and both are right."""
    _, calls = _pool_calls(vocoder_engine, which, monkeypatch)
    (call_a, want_a), (call_b, want_b) = calls if first == 0 else calls[::-1]
    call_a(), call_b()  # each key's first call runs eagerly and captures
    a_replayed, b_replayed = threading.Event(), threading.Event()
    got, errors = {}, []

    def after_replay():
        if threading.current_thread().name == "A":
            a_replayed.set()
            b_replayed.wait(1.0)
        else:
            b_replayed.set()

    monkeypatch.setattr(PoolGraph, "after_replay", after_replay)

    def worker(name, call):
        try:
            if name == "B":
                assert a_replayed.wait(10.0)
            got[name] = call()
        except Exception as e:  # reported on the main thread
            errors.append(e)

    threads = [threading.Thread(target=worker, args=("A", call_a), name="A"),
               threading.Thread(target=worker, args=("B", call_b), name="B")]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors
    assert a_replayed.is_set() and b_replayed.is_set()
    np.testing.assert_array_equal(got["A"], want_a)
    np.testing.assert_array_equal(got["B"], want_b)


@pytest.mark.parametrize("which", ["vocoder", "conditioning"])
def test_host_copies_wait_until_the_lock_is_released(vocoder_engine, pool_graphs, monkeypatch,
                                                     which):
    """With the cache's lock instrumented, each call of `_vocode_batch` and
    `_conditioning` replays while it holds the lock and makes its host
    copy only after releasing it: a host copy under the lock would wait
    for the whole stream. Each vocoder batch records its wait for the lock
    (`vocode.lock_wait`)."""
    from auralis_tpu_torch.common import tracing

    log = []
    cache, calls = _pool_calls(vocoder_engine, which, monkeypatch)
    cache.lock = _LoggedLock(log)
    for call, want in calls:
        np.testing.assert_array_equal(call(), want)  # eager, then captured
    monkeypatch.setattr(PoolGraph, "after_replay", lambda: log.append("replay"))
    monkeypatch.setattr(_Watched, "log", log)
    waits = tracing.profile_summary().get("vocode.lock_wait", {"count": 0})["count"]
    for _ in range(2):
        for call, want in calls:
            start = len(log)
            np.testing.assert_array_equal(call(), want)
            held, copies = False, 0
            for event in log[start:]:
                if event in ("acquire", "release"):
                    held = event == "acquire"
                elif event == "replay":
                    assert held, log[start:]
                else:
                    assert not held, log[start:]
                    copies += 1
            assert log[start:].count("replay") == 1 and copies >= 1, log[start:]
    waited = tracing.profile_summary().get("vocode.lock_wait", {"count": 0})["count"] - waits
    assert waited == (4 if which == "vocoder" else 0)


def test_precompile_vocoder_buckets_captures_every_batcher_key(vocoder_engine, recording_graphs,
                                                              monkeypatch):
    """precompile_vocoder_buckets() captures the first segment at B = 1..8,
    the segment window at B = 1..4 and the row vocoder in every bucket
    that row_bucket() returns for 1..max_audio_tokens latents at B =
    1..4: every key the batcher can form."""
    eng = vocoder_engine
    monkeypatch.setattr(eng, "_vocoder_programs", graphs.ProgramCache("cpu"))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    eng.precompile_vocoder_buckets()
    buckets = {eng.row_bucket(n) for n in range(1, eng.gpt_config.max_audio_tokens + 1)}
    want = ({("seg_first", None, b) for b in range(1, 9)} | {("seg", None, b) for b in range(1, 5)}
            | {("row", bucket, b) for bucket in buckets for b in range(1, 5)})
    assert set(eng._vocoder_programs.keys()) == want
    assert graphs.counts["captures"] == len(want)


def test_vocoder_and_decode_programs_stay_eager_on_the_cpu(vocoder_engine):
    """Without the double, a CPU engine captures nothing: its caches are
    not capturing and its precompile hooks return at once."""
    eng = vocoder_engine
    assert not eng._vocoder_programs.captures and not eng.decode_engine._programs.captures
    graphs.reset_counts()
    eng.precompile_vocoder_buckets()
    eng.precompile_decode_programs()
    assert graphs.counts["captures"] == 0
    assert eng._vocoder_programs.keys() == [] and eng.decode_engine._programs.keys() == []
