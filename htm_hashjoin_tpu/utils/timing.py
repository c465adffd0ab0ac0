"""Phase timers.

The reference brackets phases with gettimeofday (HTMHashBuild.hpp:93-94,310)
and rdtsc cycle counters (mc/src/rdtsc.h:35-57).  JAX dispatch is async: a
phase timer must block on device results (``jax.block_until_ready``) to
measure real device time.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict

import jax


class PhaseTimer:
    """Collects per-phase wall times in microseconds (the reference's
    reporting unit).  When the global counter session is enabled
    (profiler.enable_counters — the --counters flag), each jitted phase
    also records its PCM-analog counter events, mirroring the reference's
    PCM start/stop hooks around build and probe
    (mc/src/no_partitioning_join.c:458-527)."""

    def __init__(self) -> None:
        self.micros: Dict[str, float] = {}
        self.counters: Dict[str, Dict[str, float]] = {}

    @contextmanager
    def phase(self, name: str, *results):
        start = time.perf_counter()
        try:
            yield
        finally:
            self.micros[name] = self.micros.get(name, 0.0) + (
                time.perf_counter() - start) * 1e6

    def timed(self, name: str, fn, *args, **kwargs):
        """Run fn, fence all jax outputs, record elapsed µs (+counters)."""
        start = time.perf_counter()
        out = jax.block_until_ready(fn(*args, **kwargs))
        micros = (time.perf_counter() - start) * 1e6
        self.micros[name] = self.micros.get(name, 0.0) + micros
        from .profiler import active_counters, phase_counters_from_fn
        if active_counters() is not None:
            c = phase_counters_from_fn(fn, args, kwargs, micros)
            if c:
                self.counters[name] = c
        return out

    def total(self) -> float:
        return sum(self.micros.values())
