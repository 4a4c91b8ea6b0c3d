"""Async host coordinator for the decode loop.

Counterpart of the `DecodeEngine` runner in auralis_tpu/runtime/engine_core.py:
callers submit prompts, the runner inserts them into free decode slots
(continuous batching), steps fixed-size decode blocks, and resolves
per-sequence futures with (tokens, latent_row, n): latent_row is a device
copy of the slot's full [T_audio, D] latent row, of which the first n rows
are live, so the vocoder reads it without a host round trip.

What the runner does, as the JAX one does:
- burst inserts: free slots are filled lowest-first; the inserts of one
  pass are grouped by prefill bucket and cut into exact K buckets of 8, 4
  and 2, each one batched prefill (`insert_sequences_tokens`: the weights
  stream once per burst), and the remainder goes through single inserts;
- slot bucketing (`slot_bucketing=True`): a block steps only the first
  quarter or half of the slots when every live slot sits below that bound,
  and `_compact_slots` migrates drain stragglers down so the bound narrows;
- a length bound per block (`_len_bucket`), the read bound of the dense
  attention bodies (None under K2/K4 unless the W8A8 policy reads it);
- the per-program W8A8 policy (`w8a8_policy`): a block runs the int8 decode
  weights or the bf16 ones by its (length bound, slot bound);
- a pipelined loop: block k+1 is dispatched before block k's packed status
  is read, so the status read (a non-blocking copy into pinned host memory
  behind a CUDA event) overlaps the next block. Done-detection lags one
  block; the extra masked steps of a finished slot are no-ops.

- streaming: a request submitted with a `stream_queue` gets a (latent_row,
  n, final) snapshot after every status read (mailbox semantics: only the
  newest waits), the final one with the exact n once its future resolves,
  and a poison sentinel (None, 0, True) on shutdown or a runner crash.
  While a streaming slot is young (fewer than STREAM_YOUNG_STEPS steps
  since its insert) blocks run `stream_block_steps` steps and read their own
  status at once instead of the lagged one, so early latents surface a
  block sooner; an `on_young_block` hook gets (latent_row, token count)
  right after each block is issued, before its status is read (the engine
  launches the speculative first segment from it).

Device work runs in a worker thread (`asyncio.to_thread`), so the event loop
keeps serving other coroutines while a pass is issued. On the card each
decode block is one captured CUDA graph per (n_steps, len_bound,
slot_bound) (runtime/graphs.py; the config follows from the two bounds),
the counterpart of the JAX runner's jitted `decode_steps_status`: a key's
first block runs eagerly and is captured after it, and `precompile()`
captures the whole key set before serving. So are the JAX runner's other
jitted programs: the single insert per prefill bucket ("insert", bucket),
the burst insert per (bucket, K) ("burst", bucket, K) and `migrate_slot`
("migrate",), whose per-call values (slots, id counts, sampling options)
are staged into static device tensors under the cache's lock;
`precompile_inserts()` captures them before serving. The status copy is
issued eagerly; on the CPU everything is. The decode
state is updated in place, so every latent row handed out (snapshot, hook
row, harvested row) is an independent device copy taken under
`_state_lock` on the one CUDA stream every thread issues to: it is ordered
after the block whose latents it reads and before any later release or
refill of the slot. A prompt is a TokenPrompt or, as the JAX runner takes
it for parity with the reference's embeds-based prompt API, a [T, D]
embeddings array: uploaded at insert, padded to its prefill bucket and
inserted by the module functions, one by one or as a K-bucketed burst,
eagerly (no captured program; JAX marks this path not latency-optimized).

Tracing (common/tracing.py): each pass's inserts and compaction are one
`decode.insert_device` device span and its decode block one
`decode.block_device` span (attributes: steps, bounds, program: its
weights and decode attention, e.g. "bf16_k2"; the trace ids of the chunks
inserted or owned), resolved at the status read; the
runner's host turns (`decode.handoff`, `decode.dispatch`,
`decode.status_wait`, `decode.snapshots`, `decode.hooks`,
`decode.harvest`, `decode.idle_wait`) and each chunk's life from
`generate()` to its result (`decode.chunk`) are timeline intervals. Counters:
`decode.block_steps` (the steps of each timed block, with its device time),
`decode.rows_read` (the K/V rows each block's program reads, summed over
its steps) and `decode.rows_live` (those of slots still generating), from
host state alone.

With a `mesh` (parallel/mesh.py, the JAX runner's `mesh=`) the params and
the decode state are sharded once at construction: the slots over the
data (and dcn) shards, each shard's KV cache over its model shards.
Inserts, bursts, decode blocks, migrations, release and harvest act on
every shard through the same functions (a captured insert or migration
is keyed by the data shards its slots fall in); the status, the harvested
latents and the generator live on the mesh's first device, where the
vocoder reads them. On a mesh whose shards share one card the programs
capture and replay as above. Across cards they run eagerly: one CUDA graph
captures one device's stream.
"""
from __future__ import annotations

import asyncio
import contextvars
import dataclasses
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from ..common.logger import setup_logger
from ..common.tracing import TRACE_ID, count, device_span, interval, record, resolve
from ..models.xttsv2.config import XTTSGPTConfig
from ..models.xttsv2.gpt import READS_BY_LENGTH, decode_route
from .decode_loop import (
    PREFILL_BUCKETS,
    DecodeState,
    DataShardedState,
    decode_steps_status,
    harvest_latents_device,
    harvest_tokens_device,
    init_decode_state,
    insert_sequence,
    insert_sequence_tokens,
    insert_sequences,
    insert_sequences_tokens,
    migrate_slot,
    prefill_bucket,
    prompt_dtype,
    release_slots,
    unpack_status,
)
from .graphs import Program, ProgramCache, upload

logger = setup_logger("engine")

# The largest block (slot bound x length bound cells) whose W8A8 program
# runs the dense int8 body's bf16-probabilities variant (decode_attn_fp):
# the JAX runner's region, measured on a TPU, and the H100's, set by
# prod_step_torch.py's step matrix (PERF.md §5, "Serving defaults on the
# H100"), where the variant won in every cell up to 64 slots x 1280 rows
ATTN_FP_MAX_CELLS_TPU = 16 * 256
ATTN_FP_MAX_CELLS_CUDA = 64 * 1280


@dataclass
class TokenPrompt:
    """Device-resident voice conditioning [C, D] + host text token ids
    (bos/eos included); the prompt is assembled on the device at insert."""

    cond: torch.Tensor
    ids: np.ndarray

    @property
    def length(self) -> int:
        return int(self.cond.shape[0]) + len(self.ids) + 1  # + start-audio


@dataclass
class EmbedsPrompt:
    """A whole prompt as host embeddings [T, D] (the start-audio row
    included), uploaded at insert."""

    embeds: np.ndarray

    @property
    def length(self) -> int:
        return int(self.embeds.shape[0])


@dataclass
class SamplingOptions:
    temperature: float = 0.75
    top_p: float = 0.85
    top_k: int = 50
    repetition_penalty: float = 5.0
    do_sample: bool = True
    max_new_tokens: int = 0  # 0 = the model's max_audio_tokens


@dataclass(eq=False)  # identity: `_queue.remove` must not compare tensors
class _Pending:
    prompt: TokenPrompt | EmbedsPrompt
    options: SamplingOptions
    future: asyncio.Future
    # streaming: (latent_row, n, final) snapshots go here while the chunk
    # decodes (intra-chunk streaming)
    stream_queue: Optional[asyncio.Queue] = None
    # streaming: called on the event loop right after each block is issued,
    # before its status is read, with (latent_row, host token count); the
    # count is exact unless the slot stopped inside the block, so the caller
    # validates it against a snapshot's n. Returns True to stop being called.
    on_young_block: Optional[Callable[[torch.Tensor, int], bool]] = None
    # host-side token count: 1 at insert, + n_steps per issued block
    n_host: int = 1
    spec_done: bool = False
    enqueue_time: float = field(default_factory=time.perf_counter)
    # set when the awaiting consumer went away: the runner releases the slot
    # at its next pass instead of decoding the remaining dead steps
    cancelled: bool = False
    # the chunk id of the submitting context (tracing.TRACE_ID), which the
    # runner's spans carry: they run in the runner's own task
    trace_id: Optional[str] = None
    # (steps, rows read per step) of each block issued while it owned a
    # slot; rows None where they follow its length (the rows counters)
    block_rows: list = field(default_factory=list)


@dataclass
class _Status:
    """A dispatched block's packed status: the pinned host buffer it is
    being copied into and the event behind the copy (None on the CPU)."""

    host: torch.Tensor
    event: Optional[torch.cuda.Event]

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def wait(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class DecodeEngine:
    """Continuous-batching decode coordinator over one device. Drive it from
    a single asyncio loop."""

    # the length-bound buckets of the dense attention bodies, the JAX
    # runner's grid copied for parity: they were fitted on a TPU and are not
    # an H100 measurement (a benchmark of the port refits them)
    LEN_BUCKETS = (256, 512, 768, 1024)
    # young streaming blocks: while a streaming slot has run fewer than
    # STREAM_YOUNG_STEPS steps, blocks run `stream_block_steps` steps (at
    # most STREAM_BLOCK_STEPS unless the engine passes its own) and read
    # their own status, so the first segment can go out after one block
    STREAM_BLOCK_STEPS = 16
    STREAM_YOUNG_STEPS = 64
    # burst sizes of one batched prefill; a group is cut into exact buckets
    # (a padded lane costs a real prompt's prefill compute)
    _INSERT_K_BUCKETS = (2, 4, 8)

    def __init__(self, params: dict, cfg: XTTSGPTConfig, num_slots: int = 16,
                 cache_dtype=torch.bfloat16, steps_per_sync: int = 16, seed: int = 0,
                 slot_bucketing: bool = False,
                 w8a8_policy: Optional[Callable[[int, int], bool]] = None,
                 stream_block_steps: Optional[int] = None, device="cuda", mesh=None):
        self.mesh = mesh
        if mesh is not None:
            from ..parallel.mesh import shard_gpt_params

            params = shard_gpt_params(params, mesh)
            device = mesh.first_device
        self.params = params
        self.cfg = cfg
        # per-program int8 decode weights: the policy picks, from a block's
        # (length bound, slot bound), the W8A8 program or the bf16 one; it is
        # armed only where the int8 weights exist
        self._w8a8_policy = w8a8_policy if "blocks_q8" in params else None
        self._cfg_w8a8 = (dataclasses.replace(cfg, decode_w8a8=True)
                          if self._w8a8_policy is not None else cfg)
        self.device = torch.device(device)
        # the dense int8 body's bf16-probabilities variant for small blocks
        # (at most this many slot x row cells), where the policy steers: the
        # H100's region on the card, the JAX runner's elsewhere
        self._attn_fp_max_cells = (ATTN_FP_MAX_CELLS_CUDA if self.device.type == "cuda"
                                   else ATTN_FP_MAX_CELLS_TPU)
        self._cfg_w8a8_fp = (dataclasses.replace(self._cfg_w8a8, decode_attn_fp=True)
                             if self._w8a8_policy is not None and cfg.kv_int8
                             else self._cfg_w8a8)
        self.num_slots = num_slots
        self.steps_per_sync = steps_per_sync
        self.stream_block_steps = stream_block_steps or self.STREAM_BLOCK_STEPS
        self.slot_bucketing = slot_bucketing
        self.state: DecodeState = init_decode_state(
            cfg, num_slots, seed=seed, dtype=cache_dtype, device=self.device)
        # a graph captures one device's stream: a mesh over several cards
        # runs its programs eagerly
        self._capture = mesh is None or not mesh.multi_device
        if mesh is not None:
            from ..parallel.mesh import shard_decode_state

            self.state = shard_decode_state(self.state, mesh)
            if not self._capture and self.device.type == "cuda":
                logger.info("mesh over %d cards: decode and insert programs run eagerly "
                            "(multi-device graph capture is later work, ROADMAP.md)",
                            len(set(mesh.devices.flat)))
        # the worker thread mutates the state during a pass; the event-loop
        # side (release, harvest, compaction) takes this lock before touching it
        self._state_lock = threading.RLock()
        self._queue: deque[_Pending] = deque()
        self._slot_owner: dict[int, _Pending] = {}
        # per owned slot: its prompt length and the runner's step count at
        # its insert (the length bound's input)
        self._slot_meta: dict[int, dict] = {}
        self._steps_total = 0
        # per slot its cache length (seq_lens) as the host knows it: exact for
        # a free slot (its leftover length), assumed still generating for an
        # owned one until its status settles it (the rows counters' input)
        self._host_lens = np.zeros((num_slots,), np.int64)
        # K2/K4 ignore the length bound: it keys their blocks only for the W8A8 policy
        self._route = decode_route(cfg)
        self._len_buckets = (self.LEN_BUCKETS if self._route not in READS_BY_LENGTH
                             or self._w8a8_policy is not None else ())
        cache = (self.state.shards[0] if isinstance(self.state, DataShardedState)
                 else self.state).cache
        self._cache_len = cache.max_len
        # two pinned status buffers: block k's is read while block k+1's fills
        self._status_bufs = [self._host_buffer((num_slots,), torch.int32) for _ in range(2)]
        self._status_turn = 0
        self._harvest_tasks: set[asyncio.Task] = set()  # held until each resolves
        self.stats = {
            "blocks": 0, "dispatch_s": 0.0, "status_wait_s": 0.0, "insert_s": 0.0,
            "harvest_s": 0.0, "occupancy_sum": 0, "idle_waits": 0, "migrations": 0,
            "inserts": 0, "insert_upload_s": 0.0, "insert_dispatch_s": 0.0,
            # port additions: batched prefills run, and blocks stepped below
            # full width
            "insert_batches": 0, "slot_bound_blocks": 0,
        }
        # the captured decode blocks, whose static inputs are this state's
        # tensors (a new state gets a new cache)
        self._programs = ProgramCache(self.device, (self.state.generator,), self._capture)
        self._programs_state = self.state
        self._runner: Optional[asyncio.Task] = None
        self._wake = asyncio.Event()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._closed = False

    # ------------------------------------------------------------- public
    async def generate(self, prompt: TokenPrompt | np.ndarray,
                       options: SamplingOptions | None = None,
                       stream_queue: Optional[asyncio.Queue] = None,
                       on_young_block: Optional[Callable[[torch.Tensor, int], bool]] = None):
        """Submit a prompt, a TokenPrompt or a [T, D] embeddings array (the
        whole prompt, start-audio row included); resolves to (tokens,
        latent_row, n). With `stream_queue`, (latent_row, n, final)
        snapshots are pushed there while it decodes, the final one after
        the future resolves. The chunk's `decode.chunk` interval runs from
        here until the result (or failure) is back."""
        t_entry = time.perf_counter()
        self._closed = False  # shutdown() quiesces; a later submit reopens
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        # validate here so a malformed prompt fails only its own request
        if isinstance(prompt, TokenPrompt):
            if prompt.cond.ndim != 2 or prompt.cond.shape[1] != self.cfg.hidden_size:
                raise ValueError(
                    f"TokenPrompt.cond must be [C, {self.cfg.hidden_size}], got "
                    f"{tuple(prompt.cond.shape)}")
            if not 1 <= prompt.length <= self.cfg.max_seq_len:
                raise ValueError(
                    f"prompt length {prompt.length} outside [1, {self.cfg.max_seq_len}]")
        else:
            embeds = np.asarray(prompt)
            if embeds.ndim != 2 or embeds.shape[1] != self.cfg.hidden_size:
                raise ValueError(
                    f"embeds must be [T, {self.cfg.hidden_size}], got {embeds.shape}")
            max_prompt = self.cfg.max_seq_len - 1  # one position for start-audio
            if not 1 <= embeds.shape[0] <= max_prompt:
                raise ValueError(
                    f"prompt length {embeds.shape[0]} outside [1, {max_prompt}] "
                    f"(cfg.max_seq_len={self.cfg.max_seq_len})")
            prompt = EmbedsPrompt(embeds)
        pending = _Pending(prompt, options or SamplingOptions(), fut, stream_queue,
                           on_young_block, trace_id=TRACE_ID.get())
        self._queue.append(pending)
        self._ensure_runner()
        self._wake.set()
        try:
            return await fut
        except asyncio.CancelledError:
            # consumer went away: drop it from the queue, or flag it so the
            # runner releases its slot on the next pass
            pending.cancelled = True
            try:
                self._queue.remove(pending)
            except ValueError:
                pass
            self._wake.set()
            raise
        finally:
            interval("decode.chunk", t_entry, time.perf_counter(), pending.trace_id)

    async def shutdown(self) -> None:
        self._closed = True
        self._wake.set()
        if self._runner is not None:
            runner = self._runner
            runner.cancel()
            try:
                await runner
            except asyncio.CancelledError:
                if not runner.cancelled():
                    raise  # the caller was cancelled, not the runner
            except Exception:
                pass  # a crashed runner was logged by _on_runner_done
            self._runner = None
        for pending in list(self._queue) + list(self._slot_owner.values()):
            if not pending.future.done():
                pending.future.cancel()
            _poison(pending)
        self._queue.clear()
        if self._slot_owner:
            self._release(list(self._slot_owner))

    @property
    def num_active(self) -> int:
        return len(self._slot_owner)

    @property
    def steps_total(self) -> int:
        """Decode steps dispatched since construction (every slot of a block
        steps together)."""
        return self._steps_total

    def idle_rows(self) -> int:
        """KV rows still held by slots that are not decoding: a finished
        slot keeps its length until it is refilled, and a decode step
        attends over every stepped slot's rows up to its length, so a
        request's step time depends on what ran before it."""
        st = self.state
        if isinstance(st, DataShardedState):
            lens, active = st.field("seq_lens"), st.field("active")
        else:
            lens, active = st.seq_lens, st.active
        return int((lens * ~active).sum())

    def reset_stats(self) -> None:
        """Zero the runner telemetry in place (after a warm-up, so build and
        first-call costs stay out of a timed region)."""
        for k in self.stats:
            self.stats[k] = 0 if isinstance(self.stats[k], int) else 0.0

    # ------------------------------------------------------------ internals
    def _host_buffer(self, shape, dtype) -> torch.Tensor:
        return torch.empty(shape, dtype=dtype, pin_memory=self.device.type == "cuda")

    def _ensure_runner(self) -> None:
        loop = asyncio.get_running_loop()
        if loop is not self._loop:
            # the engine outlives individual asyncio.run loops (the sync API
            # runs one loop per call): rebind the wake event and the runner
            if self._runner is not None and not self._runner.done():
                try:
                    self._runner.cancel()
                except RuntimeError:
                    pass  # previous loop already closed
            self._runner = None
            self._wake = asyncio.Event()
            self._loop = loop
        if self._runner is None or self._runner.done():
            # a context of its own: the runner serves every chunk, not the
            # one whose generate() started it (tracing.TRACE_ID)
            self._runner = loop.create_task(self._run(), context=contextvars.Context())
            self._runner.add_done_callback(self._on_runner_done)

    def _on_runner_done(self, task: asyncio.Task) -> None:
        if task.cancelled() or task.exception() is None:
            return
        exc = task.exception()
        logger.error("decode runner crashed: %r", exc, exc_info=exc)
        for pending in list(self._slot_owner.values()) + list(self._queue):
            try:
                if not pending.future.done():
                    pending.future.set_exception(exc)
            except RuntimeError:
                pass  # stale future from a closed event loop
            _poison(pending)
        self._slot_owner.clear()
        self._slot_meta.clear()
        self._queue.clear()

    def _release(self, slots: list[int]) -> None:
        with self._state_lock:
            self._release_state(slots)
        for s in slots:
            self._slot_owner.pop(s, None)
            self._slot_meta.pop(s, None)

    def _free_slots(self) -> list[int]:
        # slot ownership is host-authoritative: a slot is free once harvested
        return [i for i in range(self.num_slots) if i not in self._slot_owner]

    def _block_steps(self) -> int:
        """Steps of the next block: `stream_block_steps` (capped at
        `steps_per_sync`) while any streaming slot is younger than
        STREAM_YOUNG_STEPS, else `steps_per_sync`."""
        for slot, pending in self._slot_owner.items():
            if pending.stream_queue is not None:
                meta = self._slot_meta.get(slot)
                if meta is not None and (
                        self._steps_total - meta["steps_at_insert"]) < self.STREAM_YOUNG_STEPS:
                    return min(self.stream_block_steps, self.steps_per_sync)
        return self.steps_per_sync

    def _slot_buckets(self) -> tuple[int, ...]:
        """Ascending slot-bound buckets below full width: a quarter and a
        half of the slots, each at least 2."""
        q, h = self.num_slots // 4, self.num_slots // 2
        return tuple(b for b in (q, h) if b >= 2 and b < self.num_slots)

    def _slot_bucket(self) -> int | None:
        """Bound on the live slot indices for the next block: the smallest
        bucket above every owned slot (free slots are filled lowest-first,
        and _compact_slots re-clusters drain stragglers), or None for full
        width. Sampled trajectories depend on the bound in effect (the noise
        is drawn for [bound, V]); greedy ones do not."""
        if not self.slot_bucketing or not self._slot_owner:
            return None
        worst = max(self._slot_owner) + 1
        for b in self._slot_buckets():
            if worst <= b:
                return b
        return None  # full width

    def _compact_slots(self) -> bool:
        """Migrate live slots stranded above the smallest slot bucket that
        fits the live count into free low slots (decode_loop.migrate_slot),
        so _slot_bucket can narrow during drains. Runs only when the queue
        is empty (occupancy is not about to rise); every move is
        device-local. Returns True if anything moved: a status vector read
        before the moves indexes pre-move slots."""
        if not self.slot_bucketing or not self._slot_owner or self._queue:
            return False
        live = len(self._slot_owner)
        target = next((b for b in self._slot_buckets() if live <= b), None)
        if target is None:
            return False
        moved = False
        with self._state_lock:
            while True:
                worst = max(self._slot_owner)
                if worst < target:
                    break
                dst = next(i for i in range(self.num_slots) if i not in self._slot_owner)
                if dst >= worst:
                    break
                self._migrate(worst, dst)
                self._slot_owner[dst] = self._slot_owner.pop(worst)
                self._slot_meta[dst] = self._slot_meta.pop(worst)
                self.stats["migrations"] += 1
                moved = True
        return moved

    def _cfg_for(self, len_bound: int | None, slot_bound: int | None) -> XTTSGPTConfig:
        """The config of one decode block: with the W8A8 policy armed, the
        block's read extent (len_bound x slot_bound, full length and width
        when None) decides whether the int8 decode weights run, and in the
        dense int8 body small blocks take the bf16-probabilities variant."""
        if self._w8a8_policy is None:
            return self.cfg
        lb = len_bound if len_bound is not None else self.cfg.max_seq_len
        sb = slot_bound if slot_bound is not None else self.num_slots
        if not self._w8a8_policy(lb, sb):
            return self.cfg
        if sb * lb <= self._attn_fp_max_cells:
            return self._cfg_w8a8_fp
        return self._cfg_w8a8

    def _len_bucket(self) -> int | None:
        """Attention-read bound of the next block: the smallest of `_len_buckets`
        above every owned slot's possible length after it, or None (full length)."""
        if not self._slot_owner:
            return self._len_buckets[0] if self._len_buckets else None
        worst = max(
            info["prompt_len"] + (self._steps_total - info["steps_at_insert"])
            for info in self._slot_meta.values()
        ) + self.steps_per_sync + 1
        for b in self._len_buckets:
            if worst < b:
                return b
        return None  # full length

    def precompile_keys(self) -> list[tuple]:
        """(n_steps, slot_bound, len_bound) of every decode block the runner
        can dispatch, the JAX `DecodeEngine.precompile` set: the young and
        steady block lengths x (full width and, bucketing, the slot buckets)
        x (every one of `_len_buckets` and full length)."""
        step_set = sorted({min(self.stream_block_steps, self.steps_per_sync),
                           self.steps_per_sync})
        slot_set = [None] + (list(self._slot_buckets()) if self.slot_bucketing else [])
        len_set = list(self._len_buckets) + [None]
        return [(n, sb, lb) for n in step_set for sb in slot_set for lb in len_set]

    def precompile(self) -> None:
        """Capture every decode block of `precompile_keys()` (the config of
        each is `_cfg_for` of its bounds) before serving, so none is
        captured mid-serving. Each key's first block runs eagerly over the
        idle slots, which moves the counters of no slot (the KV row at each
        idle slot's write position is rewritten, as by any block over idle
        slots); the generator's state is restored afterwards, so sampled
        trajectories do not shift. On the CPU nothing is captured."""
        if self._slot_owner or self._queue:
            raise RuntimeError("precompile must run before serving: it steps every slot")
        if not self._programs.captures:
            return
        t0 = time.perf_counter()
        with self._state_lock:
            rng = self.state.generator.get_state()
            keys = self.precompile_keys()
            for n_steps, slot_bound, len_bound in keys:
                self._decode_block(n_steps, len_bound, slot_bound, self._status_bufs[0])
            self.state.generator.set_state(rng)
        logger.info("decode blocks captured: %d in %.1f s", len(keys), time.perf_counter() - t0)

    def _decode_block(self, n_steps: int, len_bound: int | None, slot_bound: int | None,
                      host: torch.Tensor) -> None:
        """Issue one decode block and the non-blocking copy of its packed
        status into `host`: on the card the captured program of (n_steps,
        len_bound or None without `_len_buckets`, slot_bound), held under its
        lock until the copy is issued; on the CPU `decode_steps_status`."""
        len_bound = len_bound if self._len_buckets else None
        cfg, state = self._cfg_for(len_bound, slot_bound), self.state

        def block():
            return decode_steps_status(self.params, cfg, state, n_steps, len_bound, slot_bound)

        if not self._programs.captures:
            host.copy_(block(), non_blocking=True)
            return
        prog = self._program((n_steps, len_bound, slot_bound), lambda: (block, {}))
        with prog.lock:
            host.copy_(prog(), non_blocking=True)

    def _program(self, key, build) -> Program:
        """The captured program of `key` on the current decode state (a new
        state gets a new cache: the programs' static inputs are its
        tensors)."""
        if self._programs_state is not self.state:
            self._programs = ProgramCache(self.device, (self.state.generator,), self._capture)
            self._programs_state = self.state
        return self._programs.get(key, build)

    def precompile_inserts(self, cond_len: int) -> None:
        """Capture every insert program and `migrate_slot` before serving,
        the JAX `precompile_inserts`: per prefill bucket that holds
        `cond_len` latents and the start token, largest bucket and burst
        first, the single insert (into
        slot 0) and each burst of `_INSERT_K_BUCKETS` (into slots 0..K-1; a
        burst wider than the slot count is never formed and is skipped),
        each slot released after; then the migration (slot 0 onto itself). Each key's
        first call runs eagerly on zero prompts and is captured after it;
        the generator's state is restored, so sampled trajectories do not
        shift. Before serving only: it fills and releases slots. On the CPU
        nothing is captured."""
        if self._slot_owner or self._queue:
            raise RuntimeError("precompile_inserts must run before serving: it fills slots")
        if not self._programs.captures:
            return
        t0 = time.perf_counter()
        buckets = [b for b in PREFILL_BUCKETS if b <= self.cfg.max_seq_len] or [
            self.cfg.max_seq_len]
        cond = torch.zeros((cond_len, self.cfg.hidden_size), dtype=torch.float32,
                           device=self.device)
        greedy = SamplingOptions(temperature=1.0, top_p=1.0, top_k=1, repetition_penalty=1.0,
                                 do_sample=False)
        n = 0
        with self._state_lock:
            rng = self.state.generator.get_state()
            # largest first: later, smaller programs reuse the blocks that
            # the earlier ones freed in the shared pool
            for b in reversed(buckets):
                tb = b - cond_len
                if tb < 1:
                    continue  # the bucket cannot hold the cond and the start token
                n_ids = min(1, tb - 1)
                for k in reversed((1, *self._INSERT_K_BUCKETS)):
                    if k > self.num_slots:
                        continue
                    self._insert_tokens([cond] * k, np.zeros((k, tb), np.int64), [n_ids] * k,
                                        list(range(k)), [greedy] * k)
                    self._release_state(list(range(k)))
                    n += 1
            self._migrate(0, 0)
            self.state.generator.set_state(rng)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        logger.info("insert and migrate programs captured: %d in %.1f s", n + 1,
                    time.perf_counter() - t0)

    def _release_state(self, slots: list[int]) -> None:
        """Free `slots` in the decode state (the caller holds _state_lock)."""
        mask = torch.zeros((self.num_slots,), dtype=torch.bool)
        mask[slots] = True
        release_slots(self.state, mask.to(self.device))

    def _own(self, pending: _Pending, slot: int) -> None:
        self._slot_owner[slot] = pending
        self._slot_meta[slot] = {"prompt_len": pending.prompt.length,
                                 "steps_at_insert": self._steps_total}

    def _token_args(self, tp: TokenPrompt) -> tuple[np.ndarray, int]:
        """(padded ids, n_ids): the ids pad to the prefill bucket minus the
        cond width, so the assembled prompt has the bucket's length."""
        tb = prefill_bucket(tp.length, self.cfg.max_seq_len) - int(tp.cond.shape[0])
        ids = np.zeros((tb,), np.int64)
        ids[: len(tp.ids)] = tp.ids
        return ids, len(tp.ids)

    def _insert(self, pending: _Pending, slot: int) -> None:
        """Prefill one prompt into `slot` (worker thread)."""
        if isinstance(pending.prompt, EmbedsPrompt):
            self._insert_embeds([pending], [slot])
        else:
            ids, n_ids = self._token_args(pending.prompt)
            self._insert_tokens([pending.prompt.cond], ids[None], [n_ids], [slot],
                                [pending.options])
        self.stats["inserts"] += 1

    def _insert_batch(self, pairs: list[tuple[_Pending, int]]) -> None:
        """Burst insert (worker thread): one batched prefill for all `pairs`
        (one prefill bucket, one kind of prompt and cond width, K in
        _INSERT_K_BUCKETS: every lane real), so the GPT weights stream once
        for the burst."""
        if isinstance(pairs[0][0].prompt, EmbedsPrompt):
            self._insert_embeds([p for p, _ in pairs], [s for _, s in pairs])
        else:
            args = [self._token_args(p.prompt) for p, _ in pairs]
            self._insert_tokens([p.prompt.cond for p, _ in pairs],
                                np.stack([a[0] for a in args]), [a[1] for a in args],
                                [s for _, s in pairs], [p.options for p, _ in pairs])
        self.stats["inserts"] += len(pairs)
        self.stats["insert_batches"] += 1

    def _insert_embeds(self, pendings: list[_Pending], slots: list[int]) -> None:
        """Embeds prompts (one bucket) into `slots`, eagerly through the
        module functions: each padded to its prefill bucket and uploaded,
        one `insert_sequence` or one `insert_sequences` burst."""
        t_up = time.perf_counter()
        bucket = prefill_bucket(pendings[0].prompt.length, self.cfg.max_seq_len)
        rows = np.zeros((len(pendings), bucket, self.cfg.hidden_size), np.float32)
        for row, p in zip(rows, pendings):
            row[:p.prompt.length] = p.prompt.embeds
        embeds = torch.from_numpy(rows).to(self.device).to(prompt_dtype(self.cfg, self.state))
        lengths = [p.prompt.length for p in pendings]
        opts = [p.options for p in pendings]
        self._host_lens[slots] = lengths  # the insert's first token advances it
        t_disp = time.perf_counter()
        if len(pendings) == 1:
            o = opts[0]
            insert_sequence(self.params, self.cfg, self.state, embeds[0], lengths[0], slots[0],
                            o.temperature, o.top_p, o.top_k, o.repetition_penalty, o.do_sample,
                            o.max_new_tokens)
        else:
            insert_sequences(self.params, self.cfg, self.state, embeds, lengths, slots,
                             [o.temperature for o in opts], [o.top_p for o in opts],
                             [o.top_k for o in opts], [o.repetition_penalty for o in opts],
                             [o.do_sample for o in opts], [o.max_new_tokens for o in opts])
        self.stats["insert_upload_s"] += t_disp - t_up
        self.stats["insert_dispatch_s"] += time.perf_counter() - t_disp

    def _insert_tokens(self, conds: list, ids: np.ndarray, n_ids: list, slots: list,
                       opts: list) -> None:
        """K prompts (conds [C, D] each, padded ids [K, Tb]) into K distinct
        slots: one prompt is a single insert (kernel K1), more a burst (one
        batched prefill). On the card the program ("insert", bucket) or
        ("burst", bucket, K), with the lanes per data shard on a
        data-sharded state, its inputs staged under its lock (the ids and
        one int64 and one f32 block of the per-call values through pinned
        memory, each cond by a device copy); on the CPU the module
        function."""
        t_up = time.perf_counter()
        kb, c = len(slots), int(conds[0].shape[0])
        split = self._shard_lanes(slots)
        ints = np.asarray([slots, n_ids, [o.top_k for o in opts], [o.do_sample for o in opts],
                           [o.max_new_tokens for o in opts]], np.int64)
        floats = np.asarray([[o.temperature for o in opts], [o.top_p for o in opts],
                             [o.repetition_penalty for o in opts]], np.float32)
        # the prompt is cond + ids + start-audio; the insert's first token
        # advances the length past it
        self._host_lens[slots] = c + np.asarray(n_ids) + 1
        if not self._programs.captures:
            ids_dev = torch.from_numpy(ids).to(self.device)
            t_disp = time.perf_counter()
            if kb == 1:
                o = opts[0]
                insert_sequence_tokens(self.params, self.cfg, self.state, conds[0], ids_dev[0],
                                       n_ids[0], slots[0], o.temperature, o.top_p, o.top_k,
                                       o.repetition_penalty, o.do_sample, o.max_new_tokens)
            else:
                ints_dev = torch.from_numpy(ints).to(self.device)
                floats_dev = torch.from_numpy(floats).to(self.device)
                insert_sequences_tokens(
                    self.params, self.cfg, self.state, torch.stack(conds), ids_dev, ints_dev[1],
                    slots, floats_dev[0], floats_dev[1], ints_dev[2], floats_dev[2],
                    ints_dev[3].bool(), ints_dev[4])
        else:
            # the cond width joins the key only where it is not the config's
            # latent count (the JAX runner's programs are keyed by bucket)
            width = () if c == self.cfg.num_cond_latents else (c,)
            bucket = c + ids.shape[1]
            key = ("insert", bucket, *width) if kb == 1 else ("burst", bucket, kb, *width)
            if split is not None:
                key += (split,)
            prog = self._program(key, lambda: self._insert_fn(c, ids.shape[1], kb, split))
            with prog.lock:
                inp = prog.inputs
                for lane, cond in zip(inp["cond"].view(kb, c, -1), conds):
                    lane.copy_(cond)
                for name, values in (("ids", ids), ("ints", ints), ("floats", floats)):
                    upload(inp[name], values.reshape(inp[name].shape))
                t_disp = time.perf_counter()
                prog()
        self.stats["insert_upload_s"] += t_disp - t_up
        self.stats["insert_dispatch_s"] += time.perf_counter() - t_disp

    def _shard_lanes(self, slots: list) -> tuple | None:
        """On a data-sharded state, the number of `slots` in each data shard
        (a captured insert's key; the runner fills free slots lowest first,
        so a burst's lanes come in slot order, as the key needs), else
        None."""
        if not isinstance(self.state, DataShardedState):
            return None
        if list(slots) != sorted(slots):
            raise ValueError(f"a burst's slots must ascend on a data-sharded state: {slots}")
        per = self.state.per_shard
        return tuple(sum(lo <= s < lo + per for s in slots)
                     for lo in range(0, self.num_slots, per))

    def _insert_fn(self, c: int, tb: int, kb: int, split: tuple | None = None) -> tuple:
        """(function, static inputs) of an insert program: the single insert
        (kb 1) or the burst of kb real lanes, whose lanes fall `split` per
        data shard on a data-sharded state. Inputs: cond [(K,) C, D] f32,
        ids [(K,) Tb] int64, ints [5(, K)] (slot(s), n_ids, top_k,
        do_sample, max_new) int64, floats [3(, K)] (temperature, top_p,
        repetition_penalty) f32."""
        dev, lead = self.device, (() if kb == 1 else (kb,))
        inp = {"cond": torch.zeros((*lead, c, self.cfg.hidden_size), dtype=torch.float32,
                                   device=dev),
               "ids": torch.zeros((*lead, tb), dtype=torch.int64, device=dev),
               "ints": torch.zeros((5, *lead), dtype=torch.int64, device=dev),
               "floats": torch.ones((3, *lead), dtype=torch.float32, device=dev)}
        insert = insert_sequence_tokens if kb == 1 else insert_sequences_tokens
        state, i, f = self.state, inp["ints"], inp["floats"]

        def fn():
            insert(self.params, self.cfg, state, inp["cond"], inp["ids"], i[1], i[0], f[0], f[1],
                   i[2], f[2], i[3], i[4], shard_lanes=split)

        return fn, inp

    def _migrate(self, src: int, dst: int) -> None:
        """migrate_slot(src -> dst): on the card the program ("migrate",),
        keyed by the two slots' data shards on a data-sharded state, src/dst
        staged under its lock; on the CPU the function itself."""
        self._host_lens[dst] = self._host_lens[src]  # src keeps its rows
        if not self._programs.captures:
            migrate_slot(self.state, src, dst)
            return
        shards = None
        if isinstance(self.state, DataShardedState):
            shards = (self.state.locate(src)[0], self.state.locate(dst)[0])

        def build():
            inp = {"pair": torch.zeros((2,), dtype=torch.int64, device=self.device)}
            state, pair = self.state, inp["pair"]
            return (lambda: migrate_slot(state, pair[0], pair[1], shards)), inp

        prog = self._program(("migrate",) + (() if shards is None else shards), build)
        with prog.lock:
            upload(prog.inputs["pair"], np.asarray([src, dst], np.int64))
            prog()

    def _group_inserts(self, to_insert: list[tuple[_Pending, int]]) -> list[list]:
        """The pass's inserts grouped by (prefill bucket, cond width, or
        embeds) and cut into exact K buckets, largest first; the remainder
        one by one."""
        by_bucket: dict[tuple, list] = {}
        for pending, slot in to_insert:
            tp = pending.prompt
            kind = "embeds" if isinstance(tp, EmbedsPrompt) else int(tp.cond.shape[0])
            key = (prefill_bucket(tp.length, self.cfg.max_seq_len), kind)
            by_bucket.setdefault(key, []).append((pending, slot))
        chunks = []
        for pairs in by_bucket.values():
            while pairs:
                k = next((b for b in reversed(self._INSERT_K_BUCKETS) if b <= len(pairs)), 1)
                chunks.append(pairs[:k])
                pairs = pairs[k:]
        return chunks

    def _device_pass(self, chunks: list[list], n_steps: int) -> _Status:
        """Worker-thread body of one runner pass: the inserts, the
        compaction, and one decode block whose packed status is copied
        (non-blocking) into a pinned host buffer behind an event."""
        st = self.stats
        with self._state_lock:
            t0 = time.perf_counter()
            if chunks or self.slot_bucketing:
                with device_span("decode.insert_device", self.device,
                                 trace_ids=[p.trace_id for chunk in chunks for p, _ in chunk]):
                    for chunk in chunks:
                        if len(chunk) == 1:
                            self._insert(*chunk[0])
                        else:
                            self._insert_batch(chunk)
                    self._compact_slots()
            t1 = time.perf_counter()
            st["insert_s"] += t1 - t0
            slot_bound, len_bound = self._slot_bucket(), self._len_bucket()
            host = self._status_bufs[self._status_turn]
            self._status_turn ^= 1
            self._count_rows(n_steps, slot_bound, len_bound)
            cfg = self._cfg_for(len_bound, slot_bound)
            with device_span("decode.block_device", self.device,
                             counts={"decode.block_steps": n_steps}, steps=n_steps,
                             slot_bound=slot_bound, len_bound=len_bound,
                             program=self._program_name(cfg),
                             trace_ids=[p.trace_id for p in self._slot_owner.values()]):
                self._decode_block(n_steps, len_bound, slot_bound, host)
            event = None
            if self.device.type == "cuda":
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(self.device))
            t2 = time.perf_counter()
            st["dispatch_s"] += t2 - t1
        st["slot_bound_blocks"] += slot_bound is not None
        interval("decode.dispatch", t0, t2)
        return _Status(host, event)

    def _program_name(self, cfg: XTTSGPTConfig) -> str:
        """A block's program, of `_cfg_for`'s `cfg`, as its span names it: the
        weights ("w8a8" or "bf16"), the decode attention ("_k2", "_k4", or
        none for the dense bodies) and the int8 body's bf16 probabilities."""
        route = "_" + self._route if self._route in READS_BY_LENGTH else ""
        return (("w8a8" if cfg.decode_w8a8 else "bf16") + route
                + ("_fp" if cfg.decode_attn_fp else ""))

    def _count_rows(self, n_steps: int, slot_bound: int | None, len_bound: int | None) -> None:
        """Count the K/V rows the next block's program reads, summed over its
        steps (`decode.rows_read`), and those of slots still generating
        (`decode.rows_live`), from host state alone. The dense bodies read
        every stepped slot's rows up to the block's length bound (the
        cache's length when None); K2 and K4 read each stepped slot's rows
        up to its length, an idle slot's leftover length too. Every owned
        slot counts as generating through the block; one that stopped
        earlier is settled when its status is read at harvest
        (`_settle_rows`)."""
        stepped = slot_bound or self.num_slots
        owned = list(self._slot_owner)  # all below the slot bound
        n, tri = n_steps, n_steps * (n_steps - 1) // 2
        if self._route in READS_BY_LENGTH:
            lens = self._host_lens
            read = n * int(lens[:stepped].sum() + stepped) + tri * len(owned)
            live = n * int(lens[owned].sum() + len(owned)) + tri * len(owned)
            lens[owned] += n
            per_step = None
        else:
            per_step = min(len_bound or self._cache_len, self._cache_len)
            read, live = n * stepped * per_step, n * per_step * len(owned)
        for p in self._slot_owner.values():
            p.block_rows.append((n, per_step))
        count("decode.rows_read", read)
        count("decode.rows_live", live)

    def _settle_rows(self, slot: int, pending: _Pending, n: int) -> None:
        """A harvested slot's steps after its stop (the host counted every
        issued step as generating; `n` is its status's n_generated) are not
        live, and under K2/K4 each read its final length's rows."""
        extra = pending.n_host - n
        if extra <= 0:
            return
        if self._route in READS_BY_LENGTH:
            final = int(self._host_lens[slot]) - extra
            self._host_lens[slot] = final
            tri = extra * (extra - 1) // 2
            count("decode.rows_read", -tri)
            count("decode.rows_live", -(extra * (final + 1) + tri))
            return
        dead, left = 0, extra
        for n_steps, per_step in reversed(pending.block_rows):
            k = min(left, n_steps)
            dead, left = dead + k * per_step, left - k
            if not left:
                break
        count("decode.rows_live", -dead)

    def _push_stream_snapshots(self, done: np.ndarray, n_generated: np.ndarray) -> None:
        """Give every still-running streaming slot a fresh (latent_row, n,
        False) snapshot: the row an independent device copy taken under the
        state lock (a release or refill of the slot after it cannot reach
        it), n from the status just read, which never overstates what the
        row holds. Mailbox semantics: only the newest snapshot waits."""
        for slot, pending in self._slot_owner.items():
            if pending.stream_queue is None or done[slot] or pending.cancelled:
                continue  # a finished slot's final snapshot carries the exact n
            n = int(n_generated[slot])
            if n <= 0:
                continue
            with self._state_lock:
                row = harvest_latents_device(self.state, slot)
            _put_snapshot(pending.stream_queue, (row, n, False), newest_only=True)

    def _fire_young_hooks(self, n_steps: int) -> None:
        """After a block is issued (event loop): advance every owned slot's
        host token count and hand each streaming slot with a live hook a
        copy of its latent row, queued behind that block on the stream."""
        for slot, p in self._slot_owner.items():
            p.n_host += n_steps
            if (p.on_young_block is None or p.spec_done or p.cancelled
                    or p.stream_queue is None):
                continue
            try:
                with self._state_lock:
                    row = harvest_latents_device(self.state, slot)
                if p.on_young_block(row, p.n_host):
                    p.spec_done = True
            except Exception:
                logger.exception("speculative hook failed; disabled for this chunk")
                p.spec_done = True

    def _harvest_done(self, done: np.ndarray, n_generated: np.ndarray) -> None:
        """Free the finished slots at once. Their token rows are gathered on
        the device and copied to the host as one non-blocking copy, their
        latent rows cloned on the device; a spawned task resolves the
        futures when the copy lands, so the runner goes on at once."""
        slots, owners = [], []
        for slot in np.nonzero(done)[0].tolist():
            pending = self._slot_owner.pop(slot, None)
            self._slot_meta.pop(slot, None)
            if pending is not None:
                slots.append(slot)
                owners.append(pending)
                self._settle_rows(slot, pending, int(n_generated[slot]))
        if not slots:
            return
        with self._state_lock:
            tokens = self._host_buffer((len(slots), self.cfg.max_audio_tokens), torch.int32)
            tokens.copy_(harvest_tokens_device(self.state, slots), non_blocking=True)
            rows = [harvest_latents_device(self.state, s) for s in slots]
            status = _Status(tokens, None)
            if self.device.type == "cuda":
                status.event = torch.cuda.Event()
                status.event.record(torch.cuda.current_stream(self.device))
            self._release_state(slots)
        ns = [int(n_generated[s]) for s in slots]
        task = asyncio.get_running_loop().create_task(
            self._resolve_harvest(owners, status, rows, ns))
        self._harvest_tasks.add(task)
        task.add_done_callback(self._harvest_tasks.discard)

    async def _resolve_harvest(self, owners: list, status: _Status, rows: list,
                               ns: list) -> None:
        all_tokens = status.wait() if status.ready() else await asyncio.to_thread(status.wait)
        for i, (pending, row, n) in enumerate(zip(owners, rows, ns)):
            tokens = all_tokens[i, :n]
            # drop a trailing stop token; latents keep the step that predicted it
            if len(tokens) and tokens[-1] == self.cfg.stop_audio_token:
                tokens = tokens[:-1]
            if not pending.future.done():
                try:
                    pending.future.set_result((tokens, row, n))
                except RuntimeError:
                    pass  # the future's loop already closed
            if pending.stream_queue is not None:
                # the final snapshot, right after the future resolves with
                # no await between: a consumer that sees the future done
                # finds it queued
                _put_snapshot(pending.stream_queue, (row, n, True), newest_only=False)

    async def _run(self) -> None:
        """Pipelined decode loop: dispatch block k+1, then read block k's
        status, so the status read overlaps the block just dispatched.
        Done-detection lags one block; a finished slot's extra masked steps
        are no-ops. The pending status is dropped after any insert or
        migration (it indexes the slots as they were)."""
        pending_status: Optional[_Status] = None
        st = self.stats
        while not self._closed:
            dead = [s for s, p in self._slot_owner.items() if p.cancelled]
            if dead:
                self._release(dead)
            free = self._free_slots()
            to_insert = []
            while free and self._queue:
                head = self._queue.popleft()
                if head.cancelled or head.future.done():
                    continue  # cancelled between enqueue and insert
                slot = free.pop(0)
                record("decode.queue_wait", time.perf_counter() - head.enqueue_time,
                       head.trace_id)
                to_insert.append((head, slot))
                self._own(head, slot)
            if not self._slot_owner:
                pending_status = None
                st["idle_waits"] += 1
                self._wake.clear()
                t_idle = time.perf_counter()
                try:
                    await asyncio.wait_for(self._wake.wait(), timeout=5.0)
                except asyncio.TimeoutError:
                    pass
                interval("decode.idle_wait", t_idle, time.perf_counter())
                continue
            migrations = st["migrations"]
            n_steps = self._block_steps()
            owned = len(self._slot_owner)
            t_block = time.perf_counter()
            status = await asyncio.to_thread(self._device_pass, self._group_inserts(to_insert),
                                             n_steps)
            # the pass's counters, at one point with no await between
            st["blocks"] += 1
            st["occupancy_sum"] += owned
            self._steps_total += n_steps
            t_back = time.perf_counter()
            interval("decode.handoff", t_block, t_back)
            # hooks run here, on the event loop (they create tasks), before
            # any status read
            self._fire_young_hooks(n_steps)
            interval("decode.hooks", t_back, time.perf_counter())
            if to_insert or st["migrations"] != migrations:
                pending_status = None  # it indexes the slots before this pass
            young = n_steps < self.steps_per_sync
            if young:
                # a young block reads its own status at once; it supersedes
                # the lagged one, which is dropped
                pending_status, read = None, status
            else:
                pending_status, read = status, pending_status
            if read is not None:
                t0 = time.perf_counter()
                packed = read.wait() if read.ready() else await asyncio.to_thread(read.wait)
                t1 = time.perf_counter()
                st["status_wait_s"] += t1 - t0
                interval("decode.status_wait", t0, t1)
                resolve()  # the device spans of the blocks this status covers
                if young:
                    record("decode.young_block", t1 - t_block)
                _, done, n_gen = unpack_status(packed)
                self._push_stream_snapshots(done, n_gen)
                t2 = time.perf_counter()
                interval("decode.snapshots", t1, t2)
                if done.any():
                    self._harvest_done(done, n_gen)
                    t3 = time.perf_counter()
                    st["harvest_s"] += t3 - t2
                    interval("decode.harvest", t2, t3)
            await asyncio.sleep(0)  # let producers/consumers run between blocks


def _put_snapshot(queue: asyncio.Queue, item: tuple, newest_only: bool) -> None:
    """Queue a snapshot. With `newest_only` (mailbox semantics) whatever waits
    unconsumed is dropped first; otherwise only when a bounded queue is full.
    Only non-final snapshots are ever dropped, since nothing follows a final
    one; a zero-capacity queue gets nothing (its future still resolves)."""
    for attempt in range(2):
        if newest_only or attempt:
            while not queue.empty():
                try:
                    queue.get_nowait()
                except asyncio.QueueEmpty:
                    break
        try:
            queue.put_nowait(item)
            return
        except asyncio.QueueFull:
            pass


def _poison(pending: _Pending) -> None:
    """Send a streaming consumer the sentinel (None, 0, True), which sends it
    to the (cancelled or failed) future."""
    if pending.stream_queue is not None:
        try:
            pending.stream_queue.put_nowait((None, 0, True))
        except asyncio.QueueFull:
            pass  # a bounded caller queue: the consumer still fails via the future
