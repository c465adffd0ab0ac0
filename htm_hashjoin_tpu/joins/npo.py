"""NPO: no-partitioning join over a shared chained-bucket table.

Reference: mc/src/no_partitioning_join.c:174-612 — global table of 2-tuple
buckets (npj_types.h:31-37, BUCKET_SIZE=2, nbuckets = |R|/2 next-pow-2),
per-bucket test-and-set latches around insert-with-overflow-chain
(build_hashtable_mt :383-439), latch-free chain-walking probe (:270-310),
SPMD pthreads with three barrier phases (:536-612).

Here: a 2-slot bucket_build (latches unnecessary — claim rounds are the
deterministic arbiter, SURVEY.md P6), overflow chains replaced by a sorted
spill array that the probe binary-searches.  The three pthread barriers are
the three host-dispatched XLA phases.  Software prefetching (PREFETCH_NPJ,
:278-292) has no analog: gathers are already pipelined by hardware.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp

from ..config import JoinConfig
from ..relation import Relation, next_pow2
from ..ops import insert, probe
from ..ops.hashing import identity_hash
from ..utils.metrics import JoinMetrics
from ..utils.timing import PhaseTimer
from .common import (SpillState, finish_metrics, keys_are_unique,
                     resolve_relations)

BUCKET_SIZE = 2  # npj_params.h:18-20


@functools.partial(jax.jit, static_argnums=(1, 2))
def _build(keys: jax.Array, num_buckets: int, unique: bool):
    table, pending = insert.bucket_build(keys, num_buckets, BUCKET_SIZE,
                                         identity_hash, unique_keys=unique)
    return (table, pending, probe.table_sum(table),
            jnp.sum(keys.astype(jnp.int64)))


@jax.jit
def _probe(table: jax.Array, skeys: jax.Array):
    return probe.probe_buckets(table, skeys, BUCKET_SIZE, identity_hash)


def npo_st_join(r: Relation, s: Optional[Relation] = None,
                cfg: JoinConfig = JoinConfig()) -> JoinMetrics:
    """NPO_st — the reference's single-threaded NPO (mc/src/
    no_partitioning_join.c:336-373): identical table layout and probe, no
    SPMD phases.  The analog here is the same build/probe issued as plain
    single-program XLA (no mesh), i.e. the
    semantic baseline the multi-pipeline paths are checked against."""
    st_cfg = dataclasses.replace(cfg, mesh_shape=())
    m = npo_join(r, s, st_cfg)
    m.algo = "npo_st"
    return m


def npo_join(r: Relation, s: Optional[Relation] = None,
             cfg: JoinConfig = JoinConfig()) -> JoinMetrics:
    rkeys, skeys = resolve_relations(r, s, cfg)
    timer = PhaseTimer()
    num_buckets = next_pow2(max(2, cfg.r_size // BUCKET_SIZE))
    table, pending, table_sum, in_sum = timer.timed(
        "build", _build, rkeys, num_buckets, keys_are_unique(cfg))
    spill = SpillState(rkeys, pending, timer)
    matches = None
    if skeys is not None:
        matches = int(timer.timed("probe", _probe, table, skeys))
        matches += spill.probe_count(skeys, timer)
    m = JoinMetrics(algo="npo", rSize=cfg.r_size,
                    transactionSize=cfg.transaction_size,
                    probeLength=cfg.probe_length,
                    conflictCount=spill.count,
                    totalOverflows=spill.count,
                    inputSum=int(in_sum),
                    outputSum=int(table_sum) + spill.key_sum)
    return finish_metrics(m, timer, matches)
