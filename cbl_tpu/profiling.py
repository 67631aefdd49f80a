"""Profiling & observability.

The reference has no in-library tracing (SURVEY.md §5.1 — the author
profiled with cargo-flamegraph; the only instrument is a ns/necklace
microbenchmark).  The equivalents here: `jax.profiler` trace capture
around any region, and a lightweight k-mers/s throughput meter used by the
CLI and bench.
"""

from __future__ import annotations

import contextlib
import sys
import time


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a jax.profiler trace (view with TensorBoard / xprof)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class ThroughputMeter:
    """Wall-clock k-mers/s counter (stderr report)."""

    def __init__(self, label: str = "throughput"):
        self.label = label
        self.t0 = time.time()
        self.items = 0

    def add(self, n: int) -> None:
        self.items += n

    def report(self, file=sys.stderr) -> float:
        dt = max(time.time() - self.t0, 1e-9)
        rate = self.items / dt
        print(f"{self.label}: {self.items} k-mers in {dt:.2f}s = {rate:,.0f}/s",
              file=file)
        return rate
