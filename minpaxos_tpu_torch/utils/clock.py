"""High-resolution timestamps for RTT estimation and latency probes."""

from __future__ import annotations

import time


def monotonic_ns() -> int:
    """Monotonic wall time in nanoseconds."""
    return time.perf_counter_ns()


def cputicks() -> int:
    """A fine-grained monotonic tick count for beacon RTTs
    (``time.perf_counter_ns``)."""
    return time.perf_counter_ns()
