"""NoCC join: unsynchronized last-writer-wins build.

Reference: NoCCHashBuild.hpp:13-151 — the upper-bound-throughput baseline
whose races silently lose tuples (observable as outputSum < inputSum,
experiments/new_backup/AtomicsVsHTMVsNoCC_log1:1).  Like the reference it
linear-probes with a probeLength budget and spills budget-exhausted tuples
to a conflicts set counted into outputSum (NoCCHashBuild.hpp:43-63,103-146);
the races live in each round's unsynchronized read-then-scatter — XLA
last-writer-wins IS the lost-update semantics (SURVEY.md §2.4 P5).

Probe semantics follow the reference exactly: the probe scans ONLY the
table (NoCCHashBuild.hpp:65-80) — conflicts feed outputSum, never
totalMatches.  (htm/atomic keep the engineered spill-probe improvement;
nocc is the deliberately-lossy baseline, so its losses must stay visible.)
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
from .common import (SpillState, finish_metrics, resolve_relations,
                     table_size_for)


@functools.partial(jax.jit, static_argnums=(1, 2))
def _build(keys: jax.Array, table_size: int, probe_length: int):
    table, pending = insert.nocc_build(keys, table_size, probe_length,
                                       identity_hash)
    return (table, pending, probe.table_sum(table),
            jnp.sum(keys.astype(jnp.int64)))


@functools.partial(jax.jit, static_argnums=(2,))
def _probe(table: jax.Array, skeys: jax.Array, probe_length: int):
    return probe.probe_open_addressing(table, skeys, probe_length, identity_hash)


def nocc_join(r: Relation, s: Optional[Relation] = None,
              cfg: JoinConfig = JoinConfig()) -> JoinMetrics:
    rkeys, skeys = resolve_relations(r, s, cfg)
    timer = PhaseTimer()
    table, pending, table_sum, in_sum = timer.timed(
        "build", _build, rkeys, table_size_for(cfg), cfg.probe_length)
    spill = SpillState(rkeys, pending, timer)
    matches = None
    if skeys is not None:
        # table-only scan (NoCCHashBuild.hpp:65-80): spilled conflicts are
        # NOT probed — they contribute to outputSum only
        matches = int(timer.timed("probe", _probe, table, skeys, cfg.probe_length))
    m = JoinMetrics(algo="nocc", rSize=cfg.r_size,
                    transactionSize=cfg.transaction_size,
                    probeLength=cfg.probe_length,
                    conflictCount=spill.count,
                    inputSum=int(in_sum),
                    outputSum=int(table_sum) + spill.key_sum)
    return finish_metrics(m, timer, matches)
