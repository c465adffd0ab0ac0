"""Sort-merge join.

Reference: SortMerge.cpp:8-70 — 64-way partitioned parallel timsort, a final
global timsort pass (exploits near-sortedness), then a partitioned two-pointer
merge with branch-free match counting.  Here: one XLA `jnp.sort` +
vectorized binary-search merge counting
(ops/sortops.py).  Reports sortTime / mergeTime / total like the reference
(SortMerge.cpp:50-69).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from ..config import Distribution, JoinConfig
from ..relation import Relation
from ..ops import sortops
from ..utils.metrics import JoinMetrics
from ..utils.timing import PhaseTimer
from .common import resolve_relations


@jax.jit
def _sort(keys: jax.Array):
    s = jnp.sort(keys)
    return s, jnp.sum(s.astype(jnp.int64))


@jax.jit
def _merge(sorted_r: jax.Array, sorted_s: jax.Array):
    return sortops.merge_count(sorted_r, sorted_s)


def sortmerge_join(r: Relation, s: Optional[Relation] = None,
                   cfg: JoinConfig = JoinConfig()) -> JoinMetrics:
    rkeys, skeys = resolve_relations(r, s, cfg)
    timer = PhaseTimer()
    sorted_r, in_sum = timer.timed("sort", _sort, rkeys)
    matches = None
    if skeys is not None:
        # the driver supplies S pre-sorted except for the `random` distribution
        # (main.cpp:89-97); sort defensively unless provably sorted.
        if cfg.data_distr not in (Distribution.SORTED,):
            skeys, _ = timer.timed("sort", _sort, skeys)
        matches = int(timer.timed("merge", _merge, sorted_r, skeys))
    m = JoinMetrics(algo="sortmerge", rSize=cfg.r_size,
                    transactionSize=cfg.transaction_size,
                    inputSum=int(in_sum), outputSum=int(in_sum))
    m.sortTimeInMicroseconds = timer.micros.get("sort", 0.0)
    m.mergeTimeInMicroseconds = timer.micros.get("merge", 0.0)
    m.hashBuildTimeInMicroseconds = timer.total()
    if matches is not None:
        m.totalMatches = matches
        m.probeTimeInMicroseconds = m.mergeTimeInMicroseconds
    if m.rSize:
        m.failedTransactionPercentage = 0.0
    return m
