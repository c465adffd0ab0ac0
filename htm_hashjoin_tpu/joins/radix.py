"""Parallel radix join — the PRO / PRJ equivalent.

Reference: mc/src/parallel_radix_join.c:231-1309 — 2-pass radix partitioning
(histogram → barrier → cross-thread prefix sum → scatter with padding,
:559-627), task-queue load balancing of pass-2 and join tasks (:946-1089),
bucket-chaining per-partition build (:231-283), optional skew handling
(:958-1055).

Data-parallel re-expression (SURVEY.md §2.4 P7/P8/P9):
  * the multi-pass histogram/prefix-sum/scatter collapses to one segment-sum
    + cumsum + stable reorder, realized as a fused XLA sort by
    (digit, key) — sorting within partitions *is* the per-partition
    bucket-chaining build, probed with vectorized binary search;
  * the dynamic task queue disappears: SPMD execution is statically
    balanced because the sort-based reorder has no per-partition cost
    variance (SURVEY.md P8);
  * skew handling is subsumed: oversized partitions cost nothing extra in
    the composite-sort formulation; the histogram still reports heavy
    hitters for the distributed engine's splitting decisions
    (parallel/dist_join.py heavy-hitter handling).

Note the reference fork's PRO measures partition+build only (the probe loop
is commented out, parallel_radix_join.c:262-276); we implement and time the
full probe, and report partition/build/probe phases separately.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp

from ..config import JoinConfig
from ..relation import Relation
from ..ops import partition, probe
from ..utils.metrics import JoinMetrics
from ..utils.timing import PhaseTimer
from .common import finish_metrics, resolve_relations


_sort = jax.jit(jnp.sort)


@functools.partial(jax.jit, static_argnums=(1,))
def _msb_stats(sorted_keys: jax.Array, bits: int):
    res, _shift = partition.radix_partition_msb(sorted_keys, bits,
                                                sorter=lambda k: k)
    return (res.hist, jnp.sum(sorted_keys.astype(jnp.int64)),
            jnp.max(res.hist))


def _partition_build(keys: jax.Array, bits: int):
    """MSB radix partition+build: one int32 key sort (see
    radix_partition_msb).  The sorted array is both the partitioned layout
    and the per-partition search structure."""
    sorted_r = _sort(keys)
    hist, ksum, max_part = _msb_stats(sorted_r, bits)
    return sorted_r, hist, ksum, max_part


@jax.jit
def _probe(sorted_r: jax.Array, skeys: jax.Array):
    # equal keys ⇔ equal partitions+slots under MSB digits, so the count
    # runs on raw keys — no (digit << 32 | key) composite needed
    return probe.probe_sorted(sorted_r, skeys)


def radix_join(r: Relation, s: Optional[Relation] = None,
               cfg: JoinConfig = JoinConfig()) -> JoinMetrics:
    """Radix join with cfg.radix_bits total fanout bits (NUM_RADIX_BITS=14,
    mc/src/prj_params.h:15-22), MSB digit convention (Wisconsin's
    RadixPartitioner, partitioner.cpp:443-520).  Hash-bit partitioning for
    placement lives in the distributed engine (murmur32 all_to_all routing).
    Partitioning is subsumed by one global key sort."""
    rkeys, skeys = resolve_relations(r, s, cfg)
    timer = PhaseTimer()
    sorted_r, hist, in_sum, max_part = timer.timed(
        "build", _partition_build, rkeys, cfg.radix_bits)
    matches = None
    if skeys is not None:
        matches = int(timer.timed("probe", _probe, sorted_r, skeys))
    m = JoinMetrics(algo="radix", rSize=cfg.r_size,
                    transactionSize=cfg.transaction_size,
                    probeLength=cfg.probe_length,
                    inputSum=int(in_sum), outputSum=int(in_sum))
    m.partitionTimeInMicroseconds = timer.micros.get("build", 0.0)
    m.extra["radixBits"] = cfg.radix_bits
    m.extra["numPasses"] = cfg.radix_passes
    m.extra["fanout"] = 1 << cfg.radix_bits
    m.extra["maxPartitionSize"] = int(max_part)
    avg = max(1, cfg.r_size >> cfg.radix_bits)
    m.extra["skewedPartitions"] = int(jnp.sum(hist > 4 * avg))
    return finish_metrics(m, timer, matches)
