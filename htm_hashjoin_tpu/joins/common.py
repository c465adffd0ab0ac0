"""Shared join-phase machinery.

Every join runs the reference's phase protocol (mc/wisconsin-src/main.cpp:97-167:
barrier → build → barrier → probe → barrier) as host-orchestrated jitted
phases: XLA provides the intra-phase parallelism, the host boundary is the
barrier, and materialized scalars (conflict counts, sniff statistics) drive
host-side branching exactly where the reference branched between phases.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..config import Distribution, JoinConfig
from ..relation import Relation, next_pow2
from ..ops import insert, probe
from ..utils.metrics import JoinMetrics
from ..utils.timing import PhaseTimer

# Distributions whose keys are an exact permutation of 1..N (unique):
# the claim-free fast insert path is valid for these.
_UNIQUE_DISTS = frozenset({
    Distribution.SORTED, Distribution.SHUFFLE, Distribution.LOCAL_SHUFFLE,
    Distribution.PK, Distribution.PK_LSHUFFLE,
})


def keys_are_unique(cfg: JoinConfig) -> bool:
    return cfg.data_distr in _UNIQUE_DISTS


def table_size_for(cfg: JoinConfig) -> int:
    """Flat-table size: scaleOutput × rSize rounded to a power of two
    (AtomicHashBuild.hpp:21-25)."""
    return next_pow2(max(2, cfg.scale_output * cfg.r_size))


def htm_num_buckets(r_size: int) -> int:
    """numBuckets = next_pow2(rSize/3 + 1) (HTMHashBuild.hpp:61-62)."""
    return next_pow2(r_size // 3 + 1)


@functools.partial(jax.jit, static_argnums=())
def _spill_compact(keys: jax.Array, pending: jax.Array) -> jax.Array:
    return insert.spill_sorted(keys, pending)[0]


@jax.jit
def _pending_stats(keys: jax.Array, pending: jax.Array):
    return (jnp.sum(pending, dtype=jnp.int64), probe.masked_sum(keys, pending))


@jax.jit
def _spill_probe(spill: jax.Array, skeys: jax.Array) -> jax.Array:
    return probe.probe_sorted(spill, skeys)


class SpillState:
    """Residual tuples that did not fit the table — the conflicts-array
    analog (HTMHashBuild.hpp:79-83, AtomicHashBuild.hpp:62-63), kept
    binary-searchable so the probe phase still sees every build tuple
    (the engineered improvement over the reference, whose probe ignored
    conflict arrays)."""

    def __init__(self, keys: jax.Array, pending: jax.Array, timer: PhaseTimer):
        cc, cs = _pending_stats(keys, pending)
        self.count = int(cc)
        self.key_sum = int(cs)
        self._spill: Optional[jax.Array] = None
        if self.count > 0:
            self._spill = timer.timed("spill", _spill_compact, keys, pending)

    def probe_count(self, skeys: jax.Array, timer: PhaseTimer) -> int:
        if self._spill is None:
            return 0
        return int(timer.timed("probe_spill", _spill_probe, self._spill, skeys))


def finish_metrics(m: JoinMetrics, timer: PhaseTimer,
                   total_matches: Optional[int],
                   retry: bool = False) -> JoinMetrics:
    if timer.counters:
        # per-phase PCM-analog dumps in the JSON line (the reference wraps
        # build and probe in PCM start/stop+dump, no_partitioning_join.c:
        # 458-527; events programmed from the pcm.cfg-shaped --counters file)
        m.extra["counters"] = timer.counters
    m.hashBuildTimeInMicroseconds = (
        timer.micros.get("build", 0.0) + timer.micros.get("spill", 0.0))
    if "probe" in timer.micros or "probe_spill" in timer.micros:
        m.probeTimeInMicroseconds = (
            timer.micros.get("probe", 0.0) + timer.micros.get("probe_spill", 0.0))
    if total_matches is not None:
        m.totalMatches = total_matches
    if m.rSize:
        # FRACTIONS despite the names — the reference's own convention
        # (HTMHashBuild.hpp:410-415, log values like 2.03848e-05); under
        # TM_RETRY totalFailedPercentage counts only the residual conflicts
        m.failedTransactionPercentage = m.failedTransactions / m.rSize
        m.totalFailedPercentage = (m.conflictCount / m.rSize if retry else
                                   (m.failedTransactions + m.conflictCount)
                                   / m.rSize)
    return m


def resolve_relations(r: Relation, s: Optional[Relation],
                      cfg: JoinConfig) -> Tuple[jax.Array, Optional[jax.Array]]:
    skeys = s.keys if (s is not None and cfg.enable_probe) else None
    return r.keys, skeys


def max_key_bound(cfg: JoinConfig) -> int:
    """Conservative upper bound on key values from the generator contract
    (SURVEY.md §2.1 DataGen semantics).  RANDOM draws the full int32 range."""
    if cfg.data_distr == Distribution.RANDOM:
        return jnp.iinfo(jnp.int32).max
    return max(cfg.r_size, cfg.s_size or 0, cfg.distinct_keys or 0)
