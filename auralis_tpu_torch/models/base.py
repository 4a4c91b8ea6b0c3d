"""Abstract TTS engine contract (reference capability: models/base.py).

Engines expose a two-phase API consumed by the scheduler/orchestrator:
phase 1 `get_generation_context` prepares conditioning and launches token
generation; phase 2 `process_tokens_to_speech` turns each generation handle
into streamed `TTSOutput` chunks.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import Any, AsyncGenerator, List, Optional, Tuple

from ..common.output import TTSOutput
from ..common.requests import TTSRequest

# (generation handles, request ids, speaker embeddings, gpt conditioning)
TokenGeneratorsAndPossiblyConditioning = Tuple[List[Any], List[str], Any, Any]
AudioOutputGenerator = AsyncGenerator[TTSOutput, None]


@dataclass
class ConditioningConfig:
    """Which conditioning signals the model consumes."""

    speaker_embeddings: bool = False
    gpt_like_decoder_conditioning: bool = False


class BaseAsyncTTSEngine(ABC):
    """Contract for asynchronous TTS engines."""

    @property
    @abstractmethod
    def conditioning_config(self) -> ConditioningConfig:
        ...

    @abstractmethod
    async def get_generation_context(
        self,
        request: TTSRequest,
        gpt_cond_latent: Optional[Any] = None,
        speaker_embeddings: Optional[Any] = None,
    ) -> TokenGeneratorsAndPossiblyConditioning:
        ...

    @abstractmethod
    async def process_tokens_to_speech(
        self,
        generator: Any,
        speaker_embeddings: Optional[Any] = None,
        multimodal_data: Optional[Any] = None,
        request: TTSRequest = None,
    ) -> AudioOutputGenerator:
        ...

    async def get_audio_conditioning(self, speaker_files, *args, **kwargs):
        raise NotImplementedError

    def cancel_generation_handle(self, handle: Any) -> None:
        """Abort the in-flight token generation behind one phase-1 handle.

        Called by the orchestrator when a request is abandoned before (or
        while) its phase-2 generator runs, so engines can stop paying for
        decode work nobody will consume. Default: no-op (engines whose
        handles are plain awaitables may ignore cancellation)."""
        return None

    async def shutdown(self) -> None:  # pragma: no cover - default no-op
        return None

    @classmethod
    @abstractmethod
    def from_pretrained(cls, pretrained_model_name_or_path: str, **kwargs):
        ...

    def get_memory_usage_curve(self) -> float:
        """HBM accounting hook; engines override with their own model."""
        raise NotImplementedError
