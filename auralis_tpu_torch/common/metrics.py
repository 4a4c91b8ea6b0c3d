"""Throughput / latency metrics (reference capability: common/metrics/performance.py).

`TTSMetricsTracker` keeps windowed counters (requests/s, tokens/s, ms per second
of generated audio) and logs a summary every few seconds. `track_generation`
wraps the phase-2 async generator and feeds the tracker from each yielded
`TTSOutput` (using its `start_time` / `token_length` stamps).
"""
from __future__ import annotations

import functools
import time
from typing import AsyncGenerator

from .logger import setup_logger

logger = setup_logger("metrics")


class TTSMetricsTracker:
    """Windowed throughput tracker, logged every `log_interval` seconds."""

    def __init__(self, log_interval: float = 5.0):
        self.log_interval = log_interval
        self.window_start = time.time()
        self.last_log = self.window_start
        self.started_at = self.window_start
        # cumulative (never reset): the windowed counters drive the periodic
        # log line; these drive the /metrics scrape endpoint, where the
        # scraper computes its own rates from monotonic totals
        self.total_requests = 0
        self.total_tokens = 0
        self.total_audio_seconds = 0.0
        self.total_latency_sum = 0.0
        self.reset_window()

    def reset_window(self) -> None:
        self.window_requests = 0
        self.window_tokens = 0
        self.window_audio_seconds = 0.0
        self.window_latency_sum = 0.0
        self.window_start = time.time()

    @property
    def requests_per_second(self) -> float:
        dt = max(time.time() - self.window_start, 1e-6)
        return self.window_requests / dt

    @property
    def tokens_per_second(self) -> float:
        dt = max(time.time() - self.window_start, 1e-6)
        return self.window_tokens / dt

    @property
    def ms_per_second_of_audio(self) -> float:
        if self.window_audio_seconds <= 0:
            return 0.0
        return (self.window_latency_sum * 1000.0) / self.window_audio_seconds

    def track(self, *, tokens: int, audio_seconds: float, latency: float) -> None:
        self.total_requests += 1
        self.total_tokens += tokens
        self.total_audio_seconds += audio_seconds
        self.total_latency_sum += latency
        self.window_requests += 1
        self.window_tokens += tokens
        self.window_audio_seconds += audio_seconds
        self.window_latency_sum += latency
        now = time.time()
        if now - self.last_log >= self.log_interval:
            logger.info(
                "Generation metrics | throughput: %.2f req/s, %.1f tok/s | "
                "latency: %.1f ms per second of audio generated",
                self.requests_per_second,
                self.tokens_per_second,
                self.ms_per_second_of_audio,
            )
            self.last_log = now
            self.reset_window()


metrics = TTSMetricsTracker()


def track_generation(fn):
    """Decorator for an async generator of TTSOutput chunks; updates `metrics`
    per yielded chunk (reference: performance.py:105-151)."""

    @functools.wraps(fn)
    async def wrapper(*args, **kwargs) -> AsyncGenerator:
        async for chunk in fn(*args, **kwargs):
            try:
                n = len(chunk.array) if chunk.array is not None else 0
                audio_s = n / float(chunk.sample_rate or 24000)
                latency = time.time() - (chunk.start_time or time.time())
                metrics.track(
                    tokens=chunk.token_length or 0, audio_seconds=audio_s, latency=latency
                )
            except Exception:  # metrics must never break generation
                pass
            yield chunk

    return wrapper
