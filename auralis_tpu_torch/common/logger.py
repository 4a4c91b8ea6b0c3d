"""Structured colored logging (reference capability: common/logging/logger.py).

Provides `setup_logger` with level icons, colors and file:line origin, plus
`set_backend_logging_level` to tame the JAX/XLA backend loggers (the analogue
of the reference's vLLM log overrider — we own the decode loop, so there is no
foreign engine log stream to rewrite, only backend libraries to quiet).
"""
from __future__ import annotations

import logging
import os
import sys
from datetime import datetime

_RESET = "\033[0m"
_COLORS = {
    logging.DEBUG: "\033[36m",  # cyan
    logging.INFO: "\033[32m",  # green
    logging.WARNING: "\033[33m",  # yellow
    logging.ERROR: "\033[31m",  # red
    logging.CRITICAL: "\033[35m",  # magenta
}
_ICONS = {
    logging.DEBUG: "🔍",
    logging.INFO: "🚀",
    logging.WARNING: "⚠️",
    logging.ERROR: "❌",
    logging.CRITICAL: "💥",
}

_BACKEND_LOGGERS = ("jax", "jax._src", "jaxlib", "absl")


class ColoredFormatter(logging.Formatter):
    """Formatter with ANSI colors, level icons and short origin info."""

    def __init__(self, use_color: bool | None = None):
        super().__init__()
        if use_color is None:
            use_color = sys.stderr.isatty() and os.environ.get("NO_COLOR") is None
        self.use_color = use_color

    def format(self, record: logging.LogRecord) -> str:
        ts = datetime.fromtimestamp(record.created).strftime("%H:%M:%S.%f")[:-3]
        origin = f"{os.path.basename(record.pathname)}:{record.lineno}"
        icon = _ICONS.get(record.levelno, "")
        msg = record.getMessage()
        if record.exc_info:
            msg += "\n" + self.formatException(record.exc_info)
        if self.use_color:
            color = _COLORS.get(record.levelno, "")
            return (
                f"{color}{icon} {ts} | {record.levelname:<8}{_RESET} "
                f"| \033[2m{origin}\033[0m | {msg}"
            )
        return f"{icon} {ts} | {record.levelname:<8} | {origin} | {msg}"


def setup_logger(name: str | None = None, level: int = logging.INFO) -> logging.Logger:
    """Create (or fetch) a logger with the auralis formatter attached."""
    if name and (name.endswith(".py") or os.sep in name):
        name = os.path.splitext(os.path.basename(name))[0]
    logger = logging.getLogger(f"auralis.{name}" if name else "auralis")
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(ColoredFormatter())
        logger.addHandler(handler)
        logger.propagate = False
    logger.setLevel(level)
    return logger


def set_backend_logging_level(level: int = logging.WARNING) -> None:
    """Quiet (or un-quiet) the JAX/XLA backend library loggers."""
    for name in _BACKEND_LOGGERS:
        logging.getLogger(name).setLevel(level)


# API-compat alias with the reference public surface
# (reference: common/logging/logger.py:271-287 set_vllm_logging_level).
set_vllm_logging_level = set_backend_logging_level
