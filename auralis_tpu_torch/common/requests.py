"""TTSRequest — the per-request public API type.

Field names, defaults and behavior mirror the reference
(common/definitions/requests.py:134-277): auto language detection, language
validation, cached speaker-file enhancement, `copy()`.
"""
from __future__ import annotations

import hashlib
import io
import json
import uuid
from collections import OrderedDict
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import AsyncGenerator, Callable, List, Literal, Optional, Union, get_args

import numpy as np

from . import audio_io
from .enhancer import AudioPreprocessingConfig, EnhancedAudioProcessor
from .logger import setup_logger
from ..frontend.langid import detect_language

logger = setup_logger(__name__)

SupportedLanguages = Literal[
    "en", "es", "fr", "de", "it", "pt", "pl", "tr", "ru", "nl", "cs", "ar",
    "zh-cn", "hu", "ko", "ja", "hi", "auto", "",
]


def validate_language(language: str) -> str:
    supported = get_args(SupportedLanguages)
    if language not in supported:
        raise ValueError(f"Language {language} not supported. Must be one of {supported}")
    return language


def hash_params(*args, **kwargs) -> str:
    """MD5 hash of stringified parameters, for caching keys (reference:
    common/definitions/requests.py:21-32)."""
    params_str = json.dumps(
        [str(a) for a in args] + [f"{k}={v}" for k, v in sorted(kwargs.items())],
        sort_keys=True,
    )
    return hashlib.md5(params_str.encode()).hexdigest()


def get_language(text: str) -> str:
    """Detect the language of `text` (reference API name,
    common/definitions/requests.py:97-113). Delegates to the first-party
    classifier in frontend.langid, which already lru-caches and returns
    serving codes (zh-cn, never bare zh)."""
    return detect_language(text)


class _LRU(OrderedDict):
    def __init__(self, maxsize: int = 128):
        super().__init__()
        self.maxsize = maxsize

    def get_or(self, key, compute):
        if key in self:
            self.move_to_end(key)
            return self[key]
        value = compute()
        self[key] = value
        if len(self) > self.maxsize:
            self.popitem(last=False)
        return value


_enhance_cache = _LRU(maxsize=128)


@dataclass
class TTSRequest:
    """Container for TTS inference request data (public API type)."""

    # Request payload
    text: Union[AsyncGenerator[str, None], str, List[str]]
    speaker_files: Union[str, List[str], bytes, List[bytes]]
    context_partial_function: Optional[Callable] = None

    start_time: Optional[float] = None
    enhance_speech: bool = False
    audio_config: AudioPreprocessingConfig = field(default_factory=AudioPreprocessingConfig)
    language: str = "auto"
    request_id: str = field(default_factory=lambda: uuid.uuid4().hex)
    load_sample_rate: int = 22050
    sound_norm_refs: bool = False

    # Voice conditioning parameters
    max_ref_length: int = 60
    gpt_cond_len: int = 30
    gpt_cond_chunk_len: int = 4

    # Generation parameters
    stream: bool = False
    temperature: float = 0.75
    top_p: float = 0.85
    top_k: int = 50
    repetition_penalty: float = 5.0
    length_penalty: float = 1.0
    do_sample: bool = True
    # Optional per-chunk cap on generated mel tokens (None = the model's
    # max_audio_tokens, 605). The reference hardcodes its per-chunk cap
    # (XTTSv2.py:744) but its vLLM backend exposes max_tokens — this is
    # that knob surfaced on the request
    max_new_tokens: Optional[int] = None

    def __post_init__(self):
        self.infer_language()
        validate_language(self.language)
        self.processor = EnhancedAudioProcessor(self.audio_config)
        if self.enhance_speech:
            files = self.speaker_files
            if not isinstance(files, list):
                files = [files]
            self.speaker_files = [self.preprocess_audio(f, self.audio_config) for f in files]

    def infer_language(self) -> None:
        """Resolve language="auto" by detection. Generator texts stay "auto"
        until the facade materializes them (core/tts.py); list texts detect
        on their joined contents."""
        if self.language != "auto":
            return
        text = self.text
        if isinstance(text, list):
            text = " ".join(t for t in text if isinstance(t, str))
        if isinstance(text, str) and text:
            self.language = detect_language(text)

    def preprocess_audio(
        self, audio_source: Union[str, bytes], audio_config: AudioPreprocessingConfig
    ) -> Union[str, bytes]:
        """Enhance a speaker reference file; results are LRU-cached by
        (source, config) and written under /tmp/auralis_tpu."""
        key_src = audio_source if isinstance(audio_source, str) else hashlib.md5(audio_source).hexdigest()
        cache_key = hashlib.md5(
            json.dumps([key_src, asdict(audio_config)], sort_keys=True).encode()
        ).hexdigest()

        def compute():
            from .tracing import span

            with span("request.enhance_miss"):
                temp_dir = Path("/tmp/auralis_tpu")
                temp_dir.mkdir(exist_ok=True)
                src = audio_source if isinstance(audio_source, (str, Path)) else io.BytesIO(audio_source)
                audio = audio_io.load_audio(src, audio_config.sample_rate)[0]
                processed = self.processor.process(np.asarray(audio))
                stem = Path(audio_source).stem if isinstance(audio_source, str) else cache_key[:8]
                out_path = temp_dir / f"{stem}_{uuid.uuid4().hex}.wav"
                audio_io.write_wav(out_path, processed, audio_config.sample_rate)
                return str(out_path)

        try:
            return _enhance_cache.get_or(cache_key, compute)
        except Exception as e:
            # fall back to the raw reference WITHOUT caching the fallback:
            # a transient failure (tmp full, decode hiccup) must not pin
            # "unenhanced" for this voice for the process lifetime
            logger.warning("Error processing audio: %s. Using original file.", e)
            return audio_source

    def copy(self) -> "TTSRequest":
        new = TTSRequest(
            text=self.text,
            speaker_files=self.speaker_files,
            # NOT self.enhance_speech: __post_init__ already replaced this
            # request's speaker_files with enhanced temp wavs, so re-running
            # the chain would double-filter the references (the reference's
            # copy() has this bug, requests.py:250). The flag is restored
            # below so downstream checks still see the caller's intent.
            enhance_speech=False,
            audio_config=self.audio_config,
            language=self.language,
            request_id=self.request_id,
            load_sample_rate=self.load_sample_rate,
            sound_norm_refs=self.sound_norm_refs,
            max_ref_length=self.max_ref_length,
            gpt_cond_len=self.gpt_cond_len,
            gpt_cond_chunk_len=self.gpt_cond_chunk_len,
            stream=self.stream,
            temperature=self.temperature,
            top_p=self.top_p,
            top_k=self.top_k,
            repetition_penalty=self.repetition_penalty,
            length_penalty=self.length_penalty,
            do_sample=self.do_sample,
            max_new_tokens=self.max_new_tokens,
        )
        new.enhance_speech = self.enhance_speech
        # a prepared voice (prepare_for_streaming_generation) must survive
        # request splitting
        new.context_partial_function = self.context_partial_function
        return new
