"""Observability: the reference's profiling tiers, re-expressed for a JAX
device (SURVEY.md §5 "Tracing / profiling").

Reference tier → equivalent here:

  1. gettimeofday phase spans (HTMHashBuild.hpp:93-94,310)
       → PhaseTimer (timing.py), blocking on device results.
  2. rdtsc cycles + cycles-per-tuple (mc/src/rdtsc.h:35-57; print_timing
     mc/src/no_partitioning_join.c:313-333)
       → ``throughput_report``: ns/tuple and tuples/s (the compiled
         program's wall time is ground truth; rdtsc has no device analog).
  3. Intel PCM hardware counters, 4 events programmed from pcm.cfg
     (mc/src/perf_counters.c:60-107, mc/pcm.cfg)
       → ``PerfCounters``: named events selected from XLA's per-program
         cost analysis (flops, bytes accessed, memory traffic split by
         operand/output) plus derived bandwidth/intensity — programmed
         from the same name=expr config-file shape.
  4. --enable-syncstats per-thread barrier wait times
     (mc/src/parallel_radix_join.c:81-106,1256-1277)
       → ``sync_stats``: per-shard work from a partition histogram gives
         the predicted barrier wait per device (SPMD lockstep makes the
         *max* shard the barrier; everyone else's gap is the wait).

``trace()`` wraps jax.profiler for full XLA traces (the "dump everything"
tier the reference reaches with PCM's per-phase dumps).
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List, Optional, Sequence

import jax
import numpy as np


# ---------------------------------------------------------------------------
# Tier 2: throughput reporting
# ---------------------------------------------------------------------------

def throughput_report(num_tuples: int, micros: float) -> Dict[str, float]:
    """print_timing analog (mc/src/no_partitioning_join.c:313-333): total
    time, ns/tuple, tuples/s."""
    return {
        "numTuples": num_tuples,
        "totalTimeUsecs": micros,
        "nsPerTuple": (micros * 1e3 / num_tuples) if num_tuples else 0.0,
        "tuplesPerSecond": (num_tuples / (micros * 1e-6)) if micros else 0.0,
    }


# ---------------------------------------------------------------------------
# Tier 3: PCM-analog hardware counters from XLA cost analysis
# ---------------------------------------------------------------------------

def cost_analysis(fn: Callable, *args, **kwargs) -> Dict[str, float]:
    """Compile ``fn`` for the default device and return XLA's cost model
    for the whole program: flops, bytes accessed (total and per
    operand/output), and any backend-specific keys.  Lowers over abstract
    avals, so no argument is copied or computed."""
    jitted = fn if hasattr(fn, "lower") else jax.jit(fn)

    def aval(a):
        return (jax.ShapeDtypeStruct(np.shape(a), a.dtype)
                if hasattr(a, "dtype") else a)

    avals = tuple(aval(a) for a in args)
    kwavals = {k: aval(v) for k, v in kwargs.items()}
    ca = jitted.lower(*avals, **kwavals).compile().cost_analysis()
    if isinstance(ca, (list, tuple)):  # older jax returns [dict]
        ca = ca[0] if ca else {}
    return dict(ca or {})


class PerfCounters:
    """Programmable counter set (perf_counters.c:78-104 analog).

    Events are ``name=key`` lines naming cost-analysis entries, with two
    derived keys: ``arithmetic_intensity`` (flops / bytes accessed) and
    ``hbm_gbps`` (bytes accessed / measured seconds — requires a measured
    time via ``measure(..., micros=...)``).  Like the reference's 4-event
    limit, unknown keys simply read 0.
    """

    #: mc/pcm.cfg ships DTLB/L3 miss events; the device-meaningful defaults:
    DEFAULT_EVENTS = {
        "flops": "flops",
        "bytes": "bytes accessed",
        "intensity": "arithmetic_intensity",
        "bandwidth": "hbm_gbps",
    }

    def __init__(self, events: Optional[Dict[str, str]] = None):
        self.events = dict(events or self.DEFAULT_EVENTS)

    @classmethod
    def from_config(cls, path: str) -> "PerfCounters":
        """Load ``name=key`` lines (the pcm.cfg shape: one event per line,
        '#' comments)."""
        events: Dict[str, str] = {}
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                name, _, key = line.partition("=")
                events[name.strip()] = key.strip()
        return cls(events)

    def measure(self, fn: Callable, *args, micros: Optional[float] = None,
                **kwargs) -> Dict[str, float]:
        ca = cost_analysis(fn, *args, **kwargs)
        flops = float(ca.get("flops", 0.0))
        byts = float(ca.get("bytes accessed", 0.0))
        derived = {
            "arithmetic_intensity": flops / byts if byts else 0.0,
            "hbm_gbps": (byts / (micros * 1e-6) / 1e9) if (micros and byts)
                        else 0.0,
        }
        out: Dict[str, float] = {}
        for name, key in self.events.items():
            out[name] = derived.get(key, float(ca.get(key, 0.0)))
        return out


# ---------------------------------------------------------------------------
# Per-phase counter session (the PCM start/stop-around-each-phase hooks,
# mc/src/no_partitioning_join.c:458-527: PCM_start before build_hashtable_mt,
# PCM_stop + dump after, again around the probe).  Enabled globally by the
# CLI/harness --counters flag; PhaseTimer.timed records into it whenever a
# phase's fn is a lowerable jit (cost-analysis events).
# ---------------------------------------------------------------------------

_ACTIVE: Optional["PerfCounters"] = None
_CA_CACHE: Dict[Any, Dict[str, float]] = {}


def enable_counters(pc: Optional["PerfCounters"] = None) -> None:
    global _ACTIVE
    _ACTIVE = pc or PerfCounters()


def disable_counters() -> None:
    global _ACTIVE
    _ACTIVE = None


def active_counters() -> Optional["PerfCounters"]:
    return _ACTIVE


def phase_counters_from_fn(fn: Callable, args, kwargs,
                           micros: float) -> Optional[Dict[str, float]]:
    """Cost-analysis counters for a jitted phase fn (cached per (fn, arg
    shapes) — lowering is not free).  Returns None when fn is not
    lowerable or the backend reports no cost model."""
    pc = _ACTIVE
    if pc is None or not hasattr(fn, "lower"):
        return None
    try:
        key = (id(fn), tuple((a.shape, str(a.dtype)) for a in args
                             if hasattr(a, "shape")))
        if key not in _CA_CACHE:
            _CA_CACHE[key] = cost_analysis(fn, *args, **kwargs)
        ca = _CA_CACHE[key]
    except Exception:
        return None
    if not ca:
        return None
    flops = float(ca.get("flops", 0.0))
    byts = float(ca.get("bytes accessed", 0.0))
    derived = {
        "arithmetic_intensity": flops / byts if byts else 0.0,
        "hbm_gbps": (byts / (micros * 1e-6) / 1e9) if (micros and byts)
                    else 0.0,
    }
    return {name: derived.get(key_, float(ca.get(key_, 0.0)))
            for name, key_ in pc.events.items()}


# ---------------------------------------------------------------------------
# Tier 4: syncstats — barrier wait breakdown
# ---------------------------------------------------------------------------

def sync_stats(work_per_shard: Sequence[float]) -> Dict[str, Any]:
    """Predicted per-shard barrier waits under SPMD lockstep
    (--enable-syncstats analog, parallel_radix_join.c:81-106).

    The reference measures actual pthread barrier wait times; on an SPMD
    machine the wait is determined by load imbalance: the max-work shard
    sets the barrier, every other shard waits (max - own).  Returns the
    per-shard waits plus the imbalance fraction (wasted device-time share).
    """
    w = np.asarray(work_per_shard, dtype=np.float64)
    if w.size == 0 or w.max() == 0:
        return {"waits": w.tolist(), "imbalance": 0.0, "criticalShard": -1}
    waits = (w.max() - w)
    return {
        "waits": waits.tolist(),
        "imbalance": float(waits.sum() / (w.max() * w.size)),
        "criticalShard": int(np.argmax(w)),
    }


def shard_work_from_histogram(hist: np.ndarray, n_shards: int) -> np.ndarray:
    """Fold a partition histogram onto shards (partition p → shard
    p % n_shards, the static assignment of SURVEY.md §2.4 P8)."""
    h = np.asarray(hist, dtype=np.float64)
    pad = (-h.size) % n_shards
    h = np.pad(h, (0, pad))
    return h.reshape(-1, n_shards).sum(axis=0)


# ---------------------------------------------------------------------------
# Full traces
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def trace(logdir: str):
    """jax.profiler trace context — the full-dump tier (PCM per-phase dumps;
    view with TensorBoard or xprof)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
