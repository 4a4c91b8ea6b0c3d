"""Async host coordinator for the decode loop.

Counterpart of the `DecodeEngine` runner in auralis_tpu/runtime/engine_core.py:
callers submit prompts, the runner inserts each into a free decode slot
(continuous batching), steps fixed-size decode blocks, and resolves
per-sequence futures with (tokens, latent_row, n): latent_row is a device
copy of the slot's full [T_audio, D] latent row, of which the first n rows
are live, so the vocoder reads it without a host round trip.

What the port runs: a FIFO queue of TokenPrompts; one insert per free slot (every insert is
one prefill, through kernel K1 under `prefill_flash`); decode blocks of
`steps_per_sync` steps with ONE host sync per block (the packed status
vector); harvest of finished slots; cancellation that releases the slot.
Device work runs in a worker thread (`asyncio.to_thread`), so the event loop
keeps serving other coroutines while a block is on the card. Not ported yet:
burst inserts, slot compaction/bucketing, young/steady block sizes, the
per-program W8A8 policy (`w8a8_policy`: it keys on the length and slot
bounds that slot bucketing brings), stream snapshots and precompile.
"""
from __future__ import annotations

import asyncio
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..common.logger import setup_logger
from ..common.tracing import record
from ..models.xttsv2.config import XTTSGPTConfig
from .decode_loop import (
    DecodeState,
    decode_steps,
    harvest_latents_device,
    init_decode_state,
    insert_sequence_tokens,
    pack_status,
    prefill_bucket,
    release_slots,
    unpack_status,
)

logger = setup_logger("engine")


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
class SamplingOptions:
    temperature: float = 0.75
    top_p: float = 0.85
    top_k: int = 50
    repetition_penalty: float = 5.0
    do_sample: bool = True
    max_new_tokens: int = 0  # 0 = the model's max_audio_tokens


@dataclass
class _Pending:
    prompt: TokenPrompt
    options: SamplingOptions
    future: asyncio.Future
    enqueue_time: float = field(default_factory=time.perf_counter)
    # set when the awaiting consumer went away: the runner releases the slot
    # at its next pass instead of decoding the remaining dead steps
    cancelled: bool = False


class DecodeEngine:
    """Continuous-batching decode coordinator over one device. Drive it from
    a single asyncio loop."""

    def __init__(self, params: dict, cfg: XTTSGPTConfig, num_slots: int = 16,
                 cache_dtype=torch.bfloat16, steps_per_sync: int = 16, seed: int = 0,
                 device="cuda"):
        self.params = params
        self.cfg = cfg
        self.num_slots = num_slots
        self.steps_per_sync = steps_per_sync
        self.device = torch.device(device)
        self.state: DecodeState = init_decode_state(
            cfg, num_slots, seed=seed, dtype=cache_dtype, device=self.device)
        # the worker thread mutates the state during a block; the event-loop
        # side (release, harvest) takes this lock before touching it
        self._state_lock = threading.Lock()
        self._queue: deque[_Pending] = deque()
        self._slot_owner: dict[int, _Pending] = {}
        self.stats = {"blocks": 0, "block_s": 0.0, "insert_s": 0.0, "inserts": 0,
                      "occupancy_sum": 0, "idle_waits": 0}
        self._runner: Optional[asyncio.Task] = None
        self._wake = asyncio.Event()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._closed = False

    # ------------------------------------------------------------- public
    async def generate(self, prompt: TokenPrompt, options: SamplingOptions | None = None):
        """Submit a prompt; resolves to (tokens, latent_row, n)."""
        self._closed = False  # shutdown() quiesces; a later submit reopens
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        # validate here so a malformed prompt fails only its own request
        if prompt.cond.ndim != 2 or prompt.cond.shape[1] != self.cfg.hidden_size:
            raise ValueError(
                f"TokenPrompt.cond must be [C, {self.cfg.hidden_size}], got "
                f"{tuple(prompt.cond.shape)}")
        if not 1 <= prompt.length <= self.cfg.max_seq_len:
            raise ValueError(
                f"prompt length {prompt.length} outside [1, {self.cfg.max_seq_len}]")
        pending = _Pending(prompt, options or SamplingOptions(), fut)
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
        self._queue.clear()
        if self._slot_owner:
            self._release(list(self._slot_owner))

    @property
    def num_active(self) -> int:
        return len(self._slot_owner)

    # ------------------------------------------------------------ internals
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
            self._runner = loop.create_task(self._run())
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
        self._slot_owner.clear()
        self._queue.clear()

    def _release(self, slots: list[int]) -> None:
        mask = torch.zeros((self.num_slots,), dtype=torch.bool)
        mask[slots] = True
        with self._state_lock:
            release_slots(self.state, mask.to(self.device))
        for s in slots:
            self._slot_owner.pop(s, None)

    def _insert(self, pending: _Pending, slot: int) -> None:
        """Prefill one prompt into `slot` (runs in the worker thread). The
        text ids pad to the prefill bucket minus the cond width."""
        opts, tp = pending.options, pending.prompt
        tb = prefill_bucket(tp.length, self.cfg.max_seq_len) - int(tp.cond.shape[0])
        ids = np.zeros((tb,), np.int64)
        ids[: len(tp.ids)] = tp.ids
        insert_sequence_tokens(
            self.params, self.cfg, self.state, tp.cond, torch.from_numpy(ids).to(self.device),
            len(tp.ids), slot, opts.temperature, opts.top_p, opts.top_k,
            opts.repetition_penalty, opts.do_sample, opts.max_new_tokens)

    def _inserts_and_block(self, to_insert: list, n_steps: int) -> np.ndarray:
        """Worker-thread body of one runner pass: the inserts, one decode
        block, and the block's single host sync (the packed status)."""
        with self._state_lock:
            t0 = time.perf_counter()
            for pending, slot in to_insert:
                self._insert(pending, slot)
            t1 = time.perf_counter()
            decode_steps(self.params, self.cfg, self.state, n_steps)
            packed = pack_status(self.state).cpu().numpy()
        self.stats["insert_s"] += t1 - t0
        self.stats["block_s"] += time.perf_counter() - t1
        return packed

    def _harvest(self, done: np.ndarray, n_generated: np.ndarray) -> None:
        """Resolve every finished slot's future and free the slot."""
        finished = [s for s in np.nonzero(done)[0].tolist() if s in self._slot_owner]
        if not finished:
            return
        with self._state_lock:
            tokens_host = self.state.tokens_buf[finished].cpu().numpy()
            rows = [harvest_latents_device(self.state, s) for s in finished]
        for i, slot in enumerate(finished):
            pending = self._slot_owner[slot]
            n = int(n_generated[slot])
            tokens = tokens_host[i, :n]
            # drop a trailing stop token; latents keep the step that predicted it
            if len(tokens) and tokens[-1] == self.cfg.stop_audio_token:
                tokens = tokens[:-1]
            if not pending.future.done():
                try:
                    pending.future.set_result((tokens, rows[i], n))
                except RuntimeError:
                    pass  # the future's loop already closed
        self._release(finished)

    async def _run(self) -> None:
        while not self._closed:
            dead = [s for s, p in self._slot_owner.items() if p.cancelled]
            if dead:
                self._release(dead)
            free = [i for i in range(self.num_slots) if i not in self._slot_owner]
            to_insert = []
            while free and self._queue:
                head = self._queue.popleft()
                if head.cancelled or head.future.done():
                    continue
                slot = free.pop(0)
                record("decode.queue_wait", time.perf_counter() - head.enqueue_time)
                to_insert.append((head, slot))
                self._slot_owner[slot] = head
            if not self._slot_owner:
                self.stats["idle_waits"] += 1
                self._wake.clear()
                try:
                    await asyncio.wait_for(self._wake.wait(), timeout=5.0)
                except asyncio.TimeoutError:
                    pass
                continue
            self.stats["inserts"] += len(to_insert)
            self.stats["blocks"] += 1
            self.stats["occupancy_sum"] += len(self._slot_owner)
            packed = await asyncio.to_thread(self._inserts_and_block, to_insert,
                                             self.steps_per_sync)
            _, done, n_gen = unpack_status(packed)
            if done.any():
                self._harvest(done, n_gen)
            await asyncio.sleep(0)  # let producers/consumers run between blocks
