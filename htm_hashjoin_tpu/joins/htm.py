"""HTM join: the headline locality-exploiting bucketed build.

Reference: HTMHashBuild.hpp:54-464 — 3-slot buckets, locality hash
(key/3) & mask, tSize inserts per hardware transaction, aborted ranges
retried sequentially with overflow chains (TM_RETRY), per-chunk failure
fractions driving adaptive transaction sizing (HTM_ADAPT).

Data-parallel re-expression (SURVEY.md §2.4 P3/P11):
  * the transaction = one optimistic scatter over the whole relation —
    conflict-free (and exact) whenever keys are dense, which is precisely the
    locality regime where the paper's HTM wins;
  * the abort = gather-back detection; failedTransactions = #keys whose
    optimistic slot was taken;
  * the retry + overflow chain = claim rounds into remaining bucket slots,
    residue spilled to a sorted probe-able conflicts array;
  * adaptive transaction sizing has no cost dial here (scatter cost does not
    depend on a chunk size), but the per-16384-chunk failure statistic that
    drove it (HTMHashBuild.hpp:196-211) is still computed and reported, and
    feeds the adaptive planner's HTM↔radix switch (joins/adaptive.py).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp

from ..config import JoinConfig
from ..relation import Relation
from ..ops import insert, probe
from ..utils.metrics import JoinMetrics
from ..utils.timing import PhaseTimer
from .common import (SpillState, finish_metrics, htm_num_buckets,
                     keys_are_unique, resolve_relations)


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _build(keys: jax.Array, num_buckets: int, retry: bool, unique: bool,
           chunk: int):
    res = insert.htm_optimistic_build(keys, num_buckets, retry=retry,
                                      unique_keys=unique)
    chunk_fail = insert.chunk_failure_fractions(res.failed_optimistic, chunk)
    return (res.table, res.pending,
            jnp.sum(res.failed_optimistic, dtype=jnp.int64),
            chunk_fail,
            probe.table_sum(res.table),
            jnp.sum(keys.astype(jnp.int64)))


@jax.jit
def _probe(table: jax.Array, skeys: jax.Array):
    return probe.probe_buckets(table, skeys, 3, lambda k, m: (k // 3) & m)


def simulate_adaptive_tsize(chunk_fail, t0: int) -> list[int]:
    """Replay of the HTM_ADAPT controller (HTMHashBuild.hpp:204-211):
    failure fraction < 0.004 ⇒ tSize *= 2 (cap 4096); > 0.02 ⇒ tSize /= 2
    (floor 1).  Reported for stats parity; a device scatter's cost has no tSize."""
    t, out = t0, []
    for f in chunk_fail:
        if f < 0.004:
            t = min(t * 2, 4096)
        elif f > 0.020:
            t = max(t // 2, 1)
        out.append(t)
    return out


def htm_join(r: Relation, s: Optional[Relation] = None,
             cfg: JoinConfig = JoinConfig()) -> JoinMetrics:
    if cfg.switch_sniff:
        return _htm_switch_join(r, s, cfg)
    rkeys, skeys = resolve_relations(r, s, cfg)
    timer = PhaseTimer()
    num_buckets = htm_num_buckets(cfg.r_size)
    table, pending, failed, chunk_fail, table_sum, in_sum = timer.timed(
        "build", _build, rkeys, num_buckets, cfg.retry, keys_are_unique(cfg),
        cfg.chunk_size)
    spill = SpillState(rkeys, pending, timer)
    matches = None
    if skeys is not None:
        matches = int(timer.timed("probe", _probe, table, skeys))
        matches += spill.probe_count(skeys, timer)
    m = JoinMetrics(algo="htm", rSize=cfg.r_size,
                    transactionSize=cfg.transaction_size,
                    probeLength=cfg.probe_length,
                    conflictCount=spill.count,
                    failedTransactions=int(failed),
                    inputSum=int(in_sum),
                    outputSum=int(table_sum) + spill.key_sum)
    if cfg.track:
        cf = [float(x) for x in chunk_fail]
        m.extra["chunkFailureFractions"] = cf[:64]
        m.extra["maxChunkFailureFraction"] = max(cf) if cf else 0.0
        # TM_TRACK cause decomposition (HTMHashBuild.hpp:134-142) on the XLA
        # scatter build: an optimistic-slot loss is a duplicate/bucket alias
        # (the _XABORT_CONFLICT analog), a claim-round residue that spilled
        # is capacity exhaustion (_XABORT_CAPACITY); there is no bounded-
        # displacement assumption on this path, so displacement = 0
        m.extra["failureCauseDisplacement"] = 0
        m.extra["failureCauseDuplicateAlias"] = int(failed)
        m.extra["failureCauseBandOverflow"] = spill.count
    if cfg.adaptive:
        trace = simulate_adaptive_tsize(
            [float(x) for x in chunk_fail], cfg.transaction_size)
        m.extra["adaptiveTransactionSizeFinal"] = trace[-1] if trace else cfg.transaction_size
    return finish_metrics(m, timer, matches, retry=cfg.retry)


def _htm_switch_join(r: Relation, s: Optional[Relation],
                     cfg: JoinConfig) -> JoinMetrics:
    """HTM_SWITCH (config.h:16-17): phase 0 samples K rounds of 16384 tuples
    per partition and measures firstRoundFailureFraction
    (HTMHashBuild.hpp:100-154); a high failure rate means no locality and the
    driver switches the build to the radix path — the paper's low-overhead
    switch (README.md:6).  The sniff fields ride the JSON line exactly like
    the reference's (HTMHashBuild.hpp:425-430)."""
    import dataclasses

    from ..utils.timing import PhaseTimer as _PT
    from .adaptive import sniff_statistics
    from .common import htm_num_buckets as _nb

    timer = _PT()
    dup_frac, max_key = sniff_statistics(r.keys, cfg, timer)
    use_htm = dup_frac < 0.004 and max_key <= 3 * _nb(cfg.r_size)
    inner = dataclasses.replace(cfg, switch_sniff=False)
    if use_htm:
        m = htm_join(r, s, inner)
    else:
        from .radix import radix_join
        m = radix_join(r, s, inner)
        m.algo = "htm"
        m.extra["switchedToRadix"] = True
    m.firstRoundTime = timer.micros.get("sniff", 0.0)
    m.firstRoundFailureFraction = float(dup_frac)
    return m
