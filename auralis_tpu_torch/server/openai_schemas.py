"""OpenAI-compatible request schemas (capability parity with reference
common/definitions/openai.py): speech generation and voice chat-completions,
both converting to TTSRequest with base64-decoded speaker audio."""
from __future__ import annotations

import base64
from dataclasses import fields as dc_fields
from typing import Any, Dict, List, Literal, Optional, Union

from pydantic import BaseModel, Field, field_validator

from ..common.requests import TTSRequest

_tts_defaults = {
    f.name: f.default for f in dc_fields(TTSRequest) if not callable(f.default)
}


class ChatCompletionMessage(BaseModel):
    role: Literal["system", "user", "assistant"]
    content: str


class _TTSParamsMixin(BaseModel):
    enhance_speech: bool = Field(default=_tts_defaults["enhance_speech"])
    language: str = Field(default=_tts_defaults["language"])
    max_ref_length: int = Field(default=_tts_defaults["max_ref_length"])
    gpt_cond_len: int = Field(default=_tts_defaults["gpt_cond_len"])
    gpt_cond_chunk_len: int = Field(default=_tts_defaults["gpt_cond_chunk_len"])
    temperature: float = Field(default=_tts_defaults["temperature"])
    top_p: float = Field(default=_tts_defaults["top_p"])
    top_k: int = Field(default=_tts_defaults["top_k"])
    repetition_penalty: float = Field(default=_tts_defaults["repetition_penalty"])
    length_penalty: float = Field(default=_tts_defaults["length_penalty"])
    do_sample: bool = Field(default=_tts_defaults["do_sample"])
    max_new_tokens: Optional[int] = Field(
        default=None, ge=1,
        description="Per-chunk cap on generated mel tokens (~86 ms of audio "
        "each); default = the model's max (605)",
    )

    def _tts_kwargs(self) -> Dict[str, Any]:
        return dict(
            enhance_speech=self.enhance_speech,
            language=self.language,
            max_ref_length=self.max_ref_length,
            gpt_cond_len=self.gpt_cond_len,
            gpt_cond_chunk_len=self.gpt_cond_chunk_len,
            temperature=self.temperature,
            top_p=self.top_p,
            top_k=self.top_k,
            repetition_penalty=self.repetition_penalty,
            length_penalty=self.length_penalty,
            do_sample=self.do_sample,
            max_new_tokens=self.max_new_tokens,
        )


class AudioSpeechGenerationRequest(_TTSParamsMixin):
    """POST /v1/audio/speech body (OpenAI `audio.speech` compatible)."""

    input: str = Field(..., description="Text to synthesize")
    model: str = Field(..., description="Model name (informational)")
    voice: Union[str, List[str]] = Field(
        ...,
        description="Base64-encoded reference audio files, or names of "
        "voices registered server-side via --voices_dir (OpenAI-style "
        "'voice': 'alloy'); a plain string means one voice",
    )
    response_format: Literal["mp3", "opus", "aac", "flac", "wav", "pcm"] = Field(default="wav")
    speed: float = Field(default=1.0)
    stream_format: Optional[Literal["sse", "audio"]] = Field(
        default=None,
        description="Stream the synthesis instead of buffering it: 'sse' "
        "emits speech.audio.delta/done events (base64 PCM chunks), 'audio' "
        "emits chunked raw bytes (wav/pcm only). Audio starts flowing at "
        "the first synthesized chunk instead of after the whole request.",
    )

    @field_validator("voice")
    @classmethod
    def _check_voice(cls, v):
        # normalize to a list; items may be base64 payloads OR registered
        # voice names — which is which is only known server-side (the
        # --voices_dir registry), so per-item validation happens at
        # resolution time in the handler
        v = [v] if isinstance(v, str) else v
        if not v:
            raise ValueError("At least one voice file is required")
        return v

    def to_tts_request(self, speaker_files: Optional[list] = None) -> TTSRequest:
        """`speaker_files` carries name-resolved references (paths/bytes)
        from the server's voice registry; without it every voice item must
        be base64 audio."""
        return TTSRequest(
            text=self.input,
            stream=self.stream_format is not None,
            speaker_files=(
                speaker_files
                if speaker_files is not None
                else [base64.b64decode(f, validate=True) for f in self.voice]
            ),
            **self._tts_kwargs(),
        )


class VoiceChatCompletionRequest(_TTSParamsMixin):
    """POST /v1/chat/completions body: proxied LLM chat with interleaved
    audio vocalization every N words."""

    model: str
    messages: List[ChatCompletionMessage]
    speaker_files: List[str] = Field(..., description="Base64-encoded reference audio")
    modalities: List[Literal["text", "audio"]] = Field(default=["text", "audio"])
    openai_api_url: Optional[str] = Field(default=None, validate_default=True)
    openai_api_key: Optional[str] = Field(default=None)
    vocalize_at_every_n_words: int = Field(default=100, ge=1)
    stream: bool = Field(default=True)

    @field_validator("openai_api_url")
    @classmethod
    def _check_url(cls, v):
        if v is None:
            raise ValueError("You should always give a url for the text generation")
        return v

    @field_validator("stream")
    @classmethod
    def _check_stream(cls, v):
        if not v:
            raise ValueError(
                "Streaming should be enabled! For non-streaming conversion use the audio endpoint"
            )
        return v

    @field_validator("speaker_files")
    @classmethod
    def _check_speakers(cls, v):
        # items may be base64 audio OR --voices_dir names (resolved
        # server-side); only non-emptiness is checkable here
        if not v:
            raise ValueError("At least one speaker file is required")
        return v

    def to_tts_request(
        self, text: str = "", speaker_files: Optional[list] = None
    ) -> TTSRequest:
        return TTSRequest(
            text=text,
            stream=False,
            speaker_files=(
                speaker_files
                if speaker_files is not None
                else [base64.b64decode(f, validate=True) for f in self.speaker_files]
            ),
            **self._tts_kwargs(),
        )

    def to_openai_request(self) -> Dict[str, Any]:
        """Strip the voice-specific fields for the upstream LLM call."""
        skip = set(_tts_defaults) | {
            "speaker_files", "openai_api_url", "openai_api_key",
            "vocalize_at_every_n_words", "modalities",
        }
        out = {k: v for k, v in self.model_dump().items() if k not in skip}
        out["stream"] = True
        return out
