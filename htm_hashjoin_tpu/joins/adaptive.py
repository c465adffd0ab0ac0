"""Locality-adaptive planner: the HTM_SWITCH equivalent.

Reference: with HTM_SWITCH (config.h:16-17), a pre-pass inserts K=5 rounds of
16384 tuples per partition under HTM and measures firstRoundFailureFraction
(HTMHashBuild.hpp:47-52,100-154); a high abort rate means no locality, and
the driver switches from the HTM build to radix join — the paper's headline
mechanism (README.md:6).

On a device the failure mode that makes direct bucketed scatter inexact is not
cache-line conflict aborts but (a) duplicate keys and (b) non-dense key
universes (bucket wrap-around).  The sniff therefore samples strided chunks
across the relation (the partition-spread sampling of the reference pre-pass)
and measures exactly those two statistics; the decision thresholds reuse the
reference's adaptive thresholds (HTMHashBuild.hpp:204-211).

  dup_fraction < 0.004 and max_key ≤ 3·numBuckets  →  HTM direct-scatter path
  otherwise                                         →  radix-partitioned path
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp

from ..config import JoinConfig
from ..relation import Relation
from ..utils.metrics import JoinMetrics
from ..utils.timing import PhaseTimer
from .common import htm_num_buckets
from .htm import htm_join
from .radix import radix_join

SNIFF_TARGET = 1 << 20  # total sniff sample size cap


@functools.partial(jax.jit, static_argnums=(1, 2))
def _sniff(keys: jax.Array, num_partitions: int, chunk: int):
    """Strided sample (first `chunk` keys of each of num_partitions static
    ranges — HTMHashBuild.hpp:100-148 sampling shape) → duplicate fraction
    and max key."""
    n = keys.shape[0]
    part = max(1, n // num_partitions)
    starts = jnp.arange(num_partitions, dtype=jnp.int32) * part
    offs = jnp.arange(min(chunk, part), dtype=jnp.int32)
    idx = (starts[:, None] + offs[None, :]).reshape(-1)
    sample = keys[jnp.clip(idx, 0, n - 1)]
    s = jnp.sort(sample)
    dup_frac = jnp.mean((s[1:] == s[:-1]).astype(jnp.float32))
    return dup_frac, jnp.max(sample)


def sniff_statistics(keys: jax.Array, cfg: JoinConfig, timer: PhaseTimer):
    chunk = min(cfg.sniff_rounds * cfg.sniff_chunk,
                max(1, SNIFF_TARGET // max(1, cfg.num_partitions)))
    dup_frac, max_key = timer.timed(
        "sniff", _sniff, keys, cfg.num_partitions, chunk)
    return float(dup_frac), int(max_key)


def adaptive_join(r: Relation, s: Optional[Relation] = None,
                  cfg: JoinConfig = JoinConfig()) -> JoinMetrics:
    timer = PhaseTimer()
    dup_frac, max_key = sniff_statistics(r.keys, cfg, timer)
    dense = max_key <= 3 * htm_num_buckets(cfg.r_size)
    use_htm = dup_frac < 0.004 and dense
    m = (htm_join if use_htm else radix_join)(r, s, cfg)
    m.algo = "adaptive"
    m.firstRoundTime = timer.micros.get("sniff", 0.0)
    m.firstRoundFailureFraction = dup_frac
    m.extra["chosenPath"] = "htm" if use_htm else "radix"
    m.extra["sniffMaxKey"] = max_key
    m.extra["sniffDense"] = bool(dense)
    return m
