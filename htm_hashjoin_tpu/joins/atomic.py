"""Atomic join: linear-probing build with a probe budget.

Reference: AtomicHashBuild.hpp:14-157 — open-addressing table of
std::atomic<uint64_t>, insert via compare_exchange_strong with budget
`probeLength`, exhausted budget spills to a conflicts array.  Here:
`probe_length` claim-table rounds (ops/insert.py claim_insert_round) — every
round is one CAS step for *all* pending tuples at once; spills become a
sorted, probe-able array so no matches are lost (the reference probe ignored
its conflict array).  Conservation holds: outputSum = Σtable + Σconflicts
(AtomicHashBuild.hpp:90-152).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp

from ..config import JoinConfig
from ..relation import Relation
from ..ops import insert, probe
from ..ops.hashing import identity_hash
from ..utils.metrics import JoinMetrics
from ..utils.timing import PhaseTimer
from .common import (SpillState, finish_metrics, keys_are_unique,
                     resolve_relations, table_size_for)


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _build(keys: jax.Array, table_size: int, probe_length: int, unique: bool):
    table, pending = insert.open_addressing_build(
        keys, table_size, probe_length, identity_hash, unique_keys=unique)
    return (table, pending, probe.table_sum(table),
            jnp.sum(keys.astype(jnp.int64)))


@functools.partial(jax.jit, static_argnums=(2,))
def _probe(table: jax.Array, skeys: jax.Array, probe_length: int):
    return probe.probe_open_addressing(table, skeys, probe_length, identity_hash)


def atomic_join(r: Relation, s: Optional[Relation] = None,
                cfg: JoinConfig = JoinConfig()) -> JoinMetrics:
    rkeys, skeys = resolve_relations(r, s, cfg)
    timer = PhaseTimer()
    table, pending, table_sum, in_sum = timer.timed(
        "build", _build, rkeys, table_size_for(cfg), cfg.probe_length,
        keys_are_unique(cfg))
    spill = SpillState(rkeys, pending, timer)
    matches = None
    if skeys is not None:
        matches = int(timer.timed("probe", _probe, table, skeys, cfg.probe_length))
        matches += spill.probe_count(skeys, timer)
    m = JoinMetrics(algo="atomic", rSize=cfg.r_size,
                    transactionSize=cfg.transaction_size,
                    probeLength=cfg.probe_length,
                    conflictCount=spill.count,
                    inputSum=int(in_sum),
                    outputSum=int(table_sum) + spill.key_sum)
    return finish_metrics(m, timer, matches)
