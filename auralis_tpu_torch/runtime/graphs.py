"""Captured programs: the port's counterpart of `jax.jit` with static arguments.

The JAX package compiles one XLA program per static key (a decode block per
(cfg, n_steps, len_bound, slot_bound), a vocoder per row bucket and batch,
an insert per prefill bucket and burst size, conditioning per reference
length), and each call runs it as one dispatch. Issued eagerly, the same
work is hundreds to thousands of small launches, each paid on the host.
Here a `ProgramCache` holds one `Program` per key: on the card, a
`torch.cuda.CUDAGraph` replayed as one launch; on the CPU, the eager
function itself, run on every call (as the kernels' plain versions run
there), so both take the same staged path.

A program's inputs are static tensors: the caller writes into them (the
decode state is updated in place anyway; the vocoder, the inserts and
conditioning stage their host-built inputs with `upload`) and reads the
outputs. All programs of a cache share its memory pool, so a replay's
outputs are valid only until the next replay of any program of the same
cache, whatever its key: one program's outputs may lie in blocks another
uses for temporaries. Hence one lock per cache (`ProgramCache.lock`, which
each of its programs hands out as `program.lock`): a caller holds it from
staging the inputs until it has issued a device copy of the outputs into
memory of its own (a non-blocking copy into a host tensor, issued under
the lock, counts), and waits on the host only after releasing it. This
holds because every caller of one cache issues to one stream, so a copy
issued before the next replay runs before it.

The first call of a key runs the function eagerly, and that run is the real
one; only then is the key captured. A capture issues no work, so it moves no
state, and whatever the eager run allocates or plans once (the decode
kernels' split workspaces, the mel tables, cuFFT's plans) is made outside
the graph. A capture that fails raises: nothing falls back to eager on the
card.

Captures run in `capture_error_mode="thread_local"` (other threads keep
issuing, syncing and querying events on their own streams meanwhile), one
at a time in the process (`_CAPTURE_LOCK`), with Python's cyclic collector
paused (a graph freed during a capture invalidates it). The kernel wrappers
count the launches issued during a capture in a tally
(`_build.tally_launches`), and every replay adds that tally to their counts,
so a replayed kernel counts as launched. A generator that the function
draws from is registered with the graph, so each replay advances it as the
eager run does.
"""
from __future__ import annotations

import contextlib
import gc
import threading
import time
from typing import Callable

import numpy as np
import torch

from ..ops import _build

# torch.cuda.graph captures on one side stream shared by every capture: two
# captures must not overlap
_CAPTURE_LOCK = threading.Lock()

# process-wide counts, like the kernel wrappers' `launches`: programs
# captured, their capture and instantiation seconds, and replays; and per
# program kind ("<kind>.captures", "<kind>.capture_s", "<kind>.replays"),
# the kind being a key's leading name ("insert", "burst", "migrate", "row",
# "cond", ...) or "decode" for the decode blocks' (n_steps, ...) keys
counts = {"captures": 0, "capture_s": 0.0, "instantiate_s": 0.0, "replays": 0}
# the key of every program captured, in capture order (process-wide, as
# `counts`): what a measurement names when something was captured inside it
captured_keys: list = []


def reset_counts() -> None:
    for k in list(counts):
        counts[k] = 0 if isinstance(counts[k], int) else 0.0
    captured_keys.clear()


def kind_of(key) -> str:
    return key[0] if isinstance(key, tuple) and isinstance(key[0], str) else "decode"


def _tally(kind: str, what: str, n=1) -> None:
    name = f"{kind}.{what}"
    counts[name] = counts.get(name, 0) + n


def upload(dst: torch.Tensor, values: np.ndarray) -> None:
    """Stage host values into a program's static tensor: into a device
    tensor without a host sync, through pinned memory that the copy keeps
    alive until it has run."""
    src = torch.from_numpy(values)
    dst.copy_(src.pin_memory() if dst.is_cuda else src, non_blocking=True)


@contextlib.contextmanager
def _gc_paused():
    """Python's cyclic collector paused: a collection during a capture could
    free a graph of unreachable cycle garbage, and destroying a graph while
    a stream captures invalidates the capture."""
    was_enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was_enabled:
            gc.enable()


def captures_on(device) -> bool:
    """Programs on `device` are captured on the card and run eagerly on the
    CPU."""
    return torch.device(device).type == "cuda"


class CudaGraph:
    """One torch.cuda.CUDAGraph: `capture(fn)` records fn's launches (and
    runs none of them) and keeps its outputs; `replay()` launches the graph
    on the current stream and returns those outputs, overwritten."""

    @staticmethod
    def new_pool():
        """A memory pool that graphs can share (torch.cuda.graph_pool_handle)."""
        return torch.cuda.graph_pool_handle()

    def __init__(self, pool, generators=()):
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        for gen in generators:
            self.graph.register_generator_state(gen)
        self.pool = pool
        self.outputs = None

    def capture(self, fn: Callable):
        t0 = time.perf_counter()
        with torch.cuda.graph(self.graph, pool=self.pool, capture_error_mode="thread_local"):
            self.outputs = fn()
        t1 = time.perf_counter()
        self.graph.instantiate()
        counts["capture_s"] += t1 - t0
        counts["instantiate_s"] += time.perf_counter() - t1

    def replay(self):
        self.graph.replay()
        return self.outputs


class Program:
    """One key's program. Call it with `lock` (its cache's) held: on a
    capturing cache the first call runs `fn` eagerly and captures it after,
    and every later call replays the graph; otherwise every call runs `fn`.
    The result is fn's output (a tensor or a tuple of them); after a replay
    it is the graph's static output, valid until the next replay of any
    program of the cache."""

    def __init__(self, fn: Callable, inputs: dict, key, lock, graph_args: tuple | None):
        self.fn = fn
        self.key = key
        self.kind = kind_of(key)
        self.inputs = inputs  # static input tensors, staged by the caller
        self.lock = lock
        self.launches: dict = {}  # kernel wrapper -> launches per replay
        self.replays = 0
        # the cache's (pool, generators) if it captures, not the cache: no
        # reference cycle, so a dropped cache frees its graphs at once
        self._graph_args = graph_args
        self._graph: CudaGraph | None = None

    @property
    def captured(self) -> bool:
        return self._graph is not None

    def __call__(self):
        if self._graph is None:
            out = self.fn()
            if self._graph_args is not None:
                self._capture()
            return out
        for wrapper, n in self.launches.items():
            wrapper.launches += n
        self.replays += 1
        counts["replays"] += 1
        _tally(self.kind, "replays")
        return self._graph.replay()

    def _capture(self) -> None:
        graph = CudaGraph(*self._graph_args)
        with _CAPTURE_LOCK, _build.tally_launches() as tally, _gc_paused():
            t0 = time.perf_counter()
            graph.capture(self.fn)
            _tally(self.kind, "capture_s", time.perf_counter() - t0)
        self.launches = tally
        self._graph = graph
        counts["captures"] += 1
        captured_keys.append(self.key)
        _tally(self.kind, "captures")


class ProgramCache:
    """The programs of one owner (a decode state, an engine's vocoder, its
    conditioning), keyed as the JAX package keys its jitted programs,
    sharing one memory pool and one `lock`. The rule of the pool (the
    module docstring): a replay's outputs are valid until the next replay
    of any program of the cache, so a caller holds `lock` from staging its
    inputs until it has issued a device copy of the outputs into memory of
    its own, and waits on the host only after releasing it. Every caller of
    one cache issues to one stream. The vocoder's and conditioning's caches
    have callers on several threads at once (the batcher's and
    conditioning's workers); a decode state's is called by one runner pass
    at a time, under the runner's state lock. The dict of programs has a
    lock of its own, so `get`, `keys()` and `replays()` never queue behind
    a replay, and a caller's wait for `lock` is its wait for the pool. When
    `captures` is False (the CPU) its programs run their functions eagerly
    on every call, under the same lock; the cost of one path is that
    concurrent callers of one cache run one at a time there too, and that
    it keeps a program and its static inputs per key, as the card keeps a
    graph per key."""

    def __init__(self, device, generators=(), capture: bool = True):
        # `capture=False` runs a card's programs eagerly too (a mesh over
        # several cards: one CUDA graph captures one device's stream)
        self.captures = captures_on(device) and capture
        self.generators = tuple(generators)
        self.pool = CudaGraph.new_pool() if self.captures else None
        self._programs: dict = {}
        self._lock = threading.Lock()
        self.lock = threading.Lock()

    def get(self, key, build: Callable[[], tuple[Callable, dict]]) -> Program:
        """The program of `key`, made by `build() -> (fn, static inputs)` on
        first use."""
        with self._lock:
            prog = self._programs.get(key)
            if prog is None:
                fn, inputs = build()
                prog = self._programs[key] = Program(
                    fn, inputs, key, self.lock,
                    (self.pool, self.generators) if self.captures else None)
            return prog

    def keys(self) -> list:
        with self._lock:
            return [k for k, p in self._programs.items() if p.captured]

    def replays(self) -> int:
        """Replays of this cache's programs (the process-wide tally is
        `counts`)."""
        with self._lock:
            return sum(p.replays for p in self._programs.values())
