"""Data-parallel replica serving: N independent engines (one per device)
behind least-loaded request routing.

Counterpart of auralis_tpu/parallel/replica.py. The whole model fits one
card, so replication scales throughput with no collectives: each replica
owns its decode state, its captured programs (each `ProgramCache` its own
memory pool) and its conditioning cache. Routing is in-process and
voice-affine (repeat voices land on the replica that already holds their
conditioning). Replicas may share a device, as two engines on one card.

Replicas on one card issue to the one CUDA stream every thread of the
process uses, so the split workspaces that kernels K2, K4 and K5 keep per
(device, shape) are never used by two launches at once.
"""
from __future__ import annotations

import asyncio
from typing import List, Optional

import torch

from ..common.logger import setup_logger
from ..models.base import BaseAsyncTTSEngine, ConditioningConfig
from ..common.requests import TTSRequest

logger = setup_logger("replica")


class ReplicatedTTSEngine(BaseAsyncTTSEngine):
    """Routes requests across independent per-device engine replicas."""

    model_type = "replicated"

    def __init__(self, engines: List[BaseAsyncTTSEngine]):
        if not engines:
            raise ValueError("need at least one engine replica")
        self.engines = engines
        # requests routed here but whose chunks haven't reached the replica's
        # decode queue yet (phase-1 conditioning in flight) — without this,
        # a burst of same-voice requests all sees load 0 and the affinity
        # tiebreak piles them onto one replica
        self._inflight = [0] * len(engines)

    # ------------------------------------------------------------- factory
    @classmethod
    def from_engine(
        cls, engine, devices: Optional[list] = None, n_replicas: Optional[int] = None
    ) -> "ReplicatedTTSEngine":
        """Clone a built XTTSv2Engine across devices (the donor is replica
        0). `devices` defaults to every visible GPU, or to the donor's
        device for a CPU engine; `n_replicas` truncates the list, so asking
        for more replicas than devices gives fewer (logged). A replica on
        the donor's device shares the donor's weight tensors; on another
        device it takes a copy. Configs and tokenizer are shared (read-only
        host state)."""
        from ..models.xttsv2.engine import XTTSv2Engine

        if devices is None:
            n = torch.cuda.device_count()
            devices = ([torch.device("cuda", i) for i in range(n)]
                       if engine.device.type == "cuda" and n else [engine.device])
        devices = [torch.device(d) for d in devices]
        if n_replicas is not None:
            if n_replicas > len(devices):
                logger.warning("data_parallel_replicas=%d asked for, but %d device(s) are "
                               "available: serving %d replica(s)", n_replicas, len(devices),
                               len(devices))
            devices = devices[:n_replicas]
        if not devices:
            raise ValueError("no devices for replication")

        replicas: List[BaseAsyncTTSEngine] = [engine]
        for dev in devices[1:]:
            same = _same_device(dev, engine.device)
            params = engine.params if same else _to(engine.params, dev)
            core = engine.core if same else _to(engine.core, dev)
            replicas.append(
                XTTSv2Engine(
                    engine.hifi_config,
                    engine.gpt_config,
                    params=params,
                    core=core,
                    tokenizer=engine.tokenizer,
                    max_concurrency=engine.max_concurrency,
                    decode_slots=engine.decode_slots,
                    steps_per_sync=engine.decode_engine.steps_per_sync,
                    # JAX passes the donor cache's element type, which is
                    # int8 under kv_int8 (its engine then rebuilds an int8
                    # cache from the config): here the int8 cache follows
                    # the config too, so the donor's cache_dtype (the bf16/
                    # f32 cache and activation dtype) makes the replica
                    # equal the donor
                    cache_dtype=engine.cache_dtype,
                    vocoder_dtype=None,  # core was already cast by the donor
                    # the donor's resolved flags, W8A8 policy and slot
                    # bucketing as they are (blocks_q8 comes in the params)
                    serving=engine.serving,
                    device=dev,
                )
            )
        logger.info("replicated engine across %d device(s): %s", len(replicas),
                    ", ".join(str(d) for d in devices))
        return cls(replicas)

    # -------------------------------------------------------------- routing
    def _load(self, idx: int) -> int:
        de = getattr(self.engines[idx], "decode_engine", None)
        queued = de.num_active + len(de._queue) if de is not None else 0
        return queued + self._inflight[idx]

    def _route(self, request: TTSRequest) -> int:
        """Least-loaded; voice-affinity tiebreak so a repeated voice hits the
        replica that already holds its conditioning cache."""
        loads = [self._load(i) for i in range(len(self.engines))]
        best = min(loads)
        candidates = [i for i, l in enumerate(loads) if l == best]
        if len(candidates) == 1:
            return candidates[0]
        key = hash(tuple(str(f) for f in (request.speaker_files or [])))
        return candidates[key % len(candidates)]

    # -------------------------------------------------- engine ABC surface
    @property
    def conditioning_config(self) -> ConditioningConfig:
        return self.engines[0].conditioning_config

    def get_memory_usage_curve(self) -> float:
        return sum(e.get_memory_usage_curve() for e in self.engines)

    def precompile_decode_programs(self) -> None:
        for e in self.engines:
            fn = getattr(e, "precompile_decode_programs", None)
            if fn is not None:
                fn()

    def precompile_vocoder_buckets(self) -> None:
        """Forward warmup precompiles to every replica (each owns its own
        device programs)."""
        for e in self.engines:
            fn = getattr(e, "precompile_vocoder_buckets", None)
            if fn is not None:
                fn()

    @classmethod
    def from_pretrained(cls, *args, n_replicas: Optional[int] = None, **kwargs):
        from ..models.xttsv2.engine import XTTSv2Engine

        donor = XTTSv2Engine.from_pretrained(*args, **kwargs)
        return cls.from_engine(donor, n_replicas=n_replicas)

    async def get_audio_conditioning(self, *args, **kwargs):
        """Voice pre-caching (prepare_for_streaming_generation) runs on
        replica 0; results are host numpy, usable by any replica (each
        replica's own conditioning cache fills lazily on first use)."""
        return await self.engines[0].get_audio_conditioning(*args, **kwargs)

    async def get_generation_context(self, request: TTSRequest, **kwargs):
        idx = self._route(request)
        self._inflight[idx] += 1
        try:
            handles, ids, spk, cond = await self.engines[idx].get_generation_context(
                request, **kwargs
            )
            # the chunks' decode submissions are tasks that reach the
            # replica's queue on their first step: let them run before the
            # count drops, or a request whose conditioning was a cache hit
            # (no await in phase 1) leaves its replica looking idle to the
            # next one (the JAX engine decrements here at once)
            await asyncio.sleep(0)
        finally:
            # the chunks are now in the replica's decode queue (or the
            # request failed) — either way the decode-side load is visible
            self._inflight[idx] -= 1
        # tag every handle with its replica so phase 2 vocodes on the same
        # device that owns the latents
        tagged = [(idx, h) for h in handles]
        return tagged, ids, spk, cond

    def cancel_generation_handle(self, handle) -> None:
        idx, inner = handle
        self.engines[idx].cancel_generation_handle(inner)

    async def process_tokens_to_speech(
        self,
        generator,
        speaker_embeddings=None,
        multimodal_data=None,
        request: TTSRequest = None,
    ):
        idx, handle = generator
        async for out in self.engines[idx].process_tokens_to_speech(
            handle, speaker_embeddings, multimodal_data, request
        ):
            yield out

    async def shutdown(self) -> None:
        await asyncio.gather(*(e.shutdown() for e in self.engines))


def _same_device(a: torch.device, b: torch.device) -> bool:
    """One device, `cuda` and `cuda:0` alike."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    current = torch.cuda.current_device()
    return (a.index if a.index is not None else current) == (
        b.index if b.index is not None else current)


def _to(tree, device):
    """A copy of a tree of tensors on `device`."""
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    return tree.to(device) if torch.is_tensor(tree) else tree
