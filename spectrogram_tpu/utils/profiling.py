"""Profiling and latency instrumentation.

Fills the observability gap called out in SURVEY.md §5: the reference has no
tracing at all (a captured-but-unused Instant, simple_spectrogram.rs:126).
Here: latency percentile trackers for the push loop (timers wait for the
device with `jax.block_until_ready`), and a `jax.profiler` trace context for
kernel-level inspection.
"""

from __future__ import annotations

import contextlib
import statistics
import time
from typing import Optional

import numpy as np


class LatencyTracker:
    """Rolling latency stats for the push loop (p50 target < 16 ms)."""

    def __init__(self, window: int = 512):
        self.window = window
        self.samples: list[float] = []

    @contextlib.contextmanager
    def measure(self, result_tree=None):
        t0 = time.perf_counter()
        yield
        if result_tree is not None:
            import jax

            jax.block_until_ready(result_tree)
        self.samples.append(time.perf_counter() - t0)
        if len(self.samples) > self.window:
            del self.samples[: -self.window]

    def record(self, seconds: float) -> None:
        self.samples.append(seconds)
        if len(self.samples) > self.window:
            del self.samples[: -self.window]

    def percentile(self, q: float) -> Optional[float]:
        if not self.samples:
            return None
        return float(np.percentile(self.samples, q))

    @property
    def p50_ms(self) -> Optional[float]:
        p = self.percentile(50)
        return None if p is None else p * 1e3

    @property
    def p99_ms(self) -> Optional[float]:
        p = self.percentile(99)
        return None if p is None else p * 1e3

    def summary(self) -> dict:
        if not self.samples:
            return {"count": 0}
        return {
            "count": len(self.samples),
            "p50_ms": round(self.p50_ms, 3),
            "p99_ms": round(self.p99_ms, 3),
            "mean_ms": round(statistics.mean(self.samples) * 1e3, 3),
        }


@contextlib.contextmanager
def device_trace(log_dir: str):
    """jax.profiler trace context (view with TensorBoard/XProf)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()
