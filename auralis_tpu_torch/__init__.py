"""auralis_tpu_torch: the XTTSv2 voice-cloning TTS engine in PyTorch, with
hand-written CUDA kernels for the NVIDIA H100 (sm_90a).

A port of the JAX package `auralis_tpu`, which stays the reference. The
public API surface is the same: TTS, TTSRequest, TTSOutput,
AudioPreprocessingConfig, setup_logger, set_vllm_logging_level.
"""

from .common.enhancer import AudioPreprocessingConfig
from .common.logger import set_backend_logging_level, set_vllm_logging_level, setup_logger
from .common.output import TTSOutput
from .common.requests import TTSRequest
from .core.tts import TTS

__version__ = "0.1.0"

__all__ = [
    "TTS",
    "TTSRequest",
    "TTSOutput",
    "AudioPreprocessingConfig",
    "setup_logger",
    "set_vllm_logging_level",
    "set_backend_logging_level",
]
