"""Conflict-free hash-table construction primitives.

These replace every concurrency-control mechanism in the reference
(SURVEY.md §2.4 P3-P6) with data-parallel equivalents:

  * `nocc_scatter`      — plain last-writer-wins scatter.  Semantics of the
                          unsynchronized NoCC build (NoCCHashBuild.hpp:43-59):
                          colliding tuples are silently lost, observable as
                          outputSum < inputSum.
  * `claim_insert_round`— one "CAS round": losers detected via a claim table
                          (scatter row index, gather back, compare).  Exact
                          semantics of one linear-probe step of
                          AtomicHashBuild.hpp:43-64.
  * `open_addressing_build` — `probe_length` claim rounds over a flat table
                          (the Atomic build).
  * `bucket_build`      — S-slot bucket table filled one intra-slot per round
                          (the HTM 3-slot bucket table HTMHashBuild.hpp:41-45
                          and NPO's 2-tuple buckets mc/src/npj_types.h:31-37).
  * `htm_optimistic_build` — the headline path: one optimistic scatter at
                          bucket*3 + key%3 (exact for dense unique keys — the
                          "transaction succeeds" case), gather-back failure
                          detection (the abort analog), then claim-round
                          repair of the failures (the TM_RETRY analog,
                          HTMHashBuild.hpp:219-278).

All builders return the residual `pending` mask — tuples that did not land in
the table.  The caller spills them (`spill_sorted`) exactly like the
reference's per-partition `conflicts` arrays (HTMHashBuild.hpp:79-83).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..relation import EMPTY, KEY_DTYPE

HashFn = Callable[[jax.Array, int], jax.Array]


def nocc_scatter(keys: jax.Array, table_size: int, hash_fn: HashFn) -> jax.Array:
    """Racy single-slot build: last writer wins (the degenerate
    probeLength=1 case of nocc_build)."""
    mask = table_size - 1
    slot = hash_fn(keys, mask)
    return jnp.zeros((table_size,), KEY_DTYPE).at[slot].set(keys)


def nocc_build(keys: jax.Array, table_size: int, probe_length: int,
               hash_fn: HashFn) -> Tuple[jax.Array, jax.Array]:
    """The full NoCC build (NoCCHashBuild.hpp:43-63): UNSYNCHRONIZED linear
    probing with a probe budget.  Round j: every pending tuple whose slot
    (h+j) & mask LOOKED empty writes it — concurrent attempts race and the
    losers' tuples are silently lost (last writer wins), exactly the
    reference's lost-update semantics; winners and losers alike believe they
    placed.  Tuples that exhaust the budget spill to the conflicts set
    (``pending``), whose key sum the caller adds to outputSum
    (NoCCHashBuild.hpp:103-146)."""
    n = keys.shape[0]
    mask = table_size - 1
    h = hash_fn(keys, mask)
    table = jnp.zeros((table_size,), KEY_DTYPE)
    pending = jnp.ones((n,), jnp.bool_)

    def body(j, carry):
        table, pending = carry
        slot = (h + j) & mask
        attempt = pending & (table[slot] == EMPTY)   # racy read
        table = table.at[jnp.where(attempt, slot, table_size)].set(
            keys, mode="drop")                        # racy write, last wins
        return table, pending & ~attempt              # losers believe placed

    return jax.lax.fori_loop(0, min(probe_length, table_size), body,
                             (table, pending))


def claim_insert_round(table: jax.Array, claim: jax.Array, keys: jax.Array,
                       slot: jax.Array, pending: jax.Array,
                       idx: jax.Array) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """One atomic-CAS-equivalent insertion round.

    Every pending key attempts its `slot` if that slot is empty; a claim table
    of row indices arbitrates concurrent attempts deterministically (lowest
    scatter order wins — XLA scatter is last-writer-wins, so the *last* index
    written wins; determinism is what matters, reference winners were
    arbitrary thread interleavings).  Returns (table, claim, new_pending).
    """
    table_size = table.shape[0]
    occupied = table[slot] != EMPTY
    attempt = pending & ~occupied
    tgt = jnp.where(attempt, slot, table_size)  # out-of-bounds => dropped
    claim = claim.at[tgt].set(idx, mode="drop")
    won = attempt & (claim[slot] == idx)
    table = table.at[jnp.where(won, slot, table_size)].set(keys, mode="drop")
    return table, claim, pending & ~won


def _fast_insert_round(table, keys, slot, pending):
    """Claim-free round, valid only when keys are distinct: winner detection
    is a direct gather-back compare."""
    table_size = table.shape[0]
    occupied = table[slot] != EMPTY
    attempt = pending & ~occupied
    table = table.at[jnp.where(attempt, slot, table_size)].set(keys, mode="drop")
    won = attempt & (table[slot] == keys)
    return table, pending & ~won


def open_addressing_build(keys: jax.Array, table_size: int, probe_length: int,
                          hash_fn: HashFn, *, unique_keys: bool = False
                          ) -> Tuple[jax.Array, jax.Array]:
    """Linear-probing build with a probe budget (AtomicHashBuild.hpp:37-67).

    Round j tries slot (h+j) & mask.  After `probe_length` rounds the residual
    `pending` mask is the conflicts set (AtomicHashBuild.hpp:62-63).
    """
    n = keys.shape[0]
    mask = table_size - 1
    h = hash_fn(keys, mask)
    table = jnp.zeros((table_size,), KEY_DTYPE)
    pending = jnp.ones((n,), jnp.bool_)
    probe_length = min(probe_length, table_size)  # >table_size would rescan slots
    if unique_keys:
        def body(j, carry):
            table, pending = carry
            return _fast_insert_round(table, keys, (h + j) & mask, pending)
        table, pending = jax.lax.fori_loop(0, probe_length, body, (table, pending))
    else:
        idx = jnp.arange(n, dtype=jnp.int32)
        claim = jnp.full((table_size,), -1, jnp.int32)
        def body(j, carry):
            table, claim, pending = carry
            table, claim, pending = claim_insert_round(
                table, claim, keys, (h + j) & mask, pending, idx)
            return table, claim, pending
        table, claim, pending = jax.lax.fori_loop(
            0, probe_length, body, (table, claim, pending))
    return table, pending


def bucket_build(keys: jax.Array, num_buckets: int, slots: int,
                 hash_fn: HashFn, *, unique_keys: bool = False,
                 pending: jax.Array | None = None,
                 table: jax.Array | None = None
                 ) -> Tuple[jax.Array, jax.Array]:
    """S-slot bucketed build: round r fills intra-slot r of each bucket.

    HTM's Bucket{tuples[3]} (HTMHashBuild.hpp:41-45) with S=3; NPO's 2-tuple
    buckets (mc/src/npj_types.h:31-37) with S=2.  Overflow (``pending`` after
    S rounds) is the overflow-chain / conflicts analog.
    """
    n = keys.shape[0]
    mask = num_buckets - 1
    bucket = hash_fn(keys, mask)
    if table is None:
        table = jnp.zeros((num_buckets * slots,), KEY_DTYPE)
    if pending is None:
        pending = jnp.ones((n,), jnp.bool_)
    if unique_keys:
        for r in range(slots):
            table, pending = _fast_insert_round(
                table, keys, bucket * slots + r, pending)
    else:
        idx = jnp.arange(n, dtype=jnp.int32)
        claim = jnp.full((num_buckets * slots,), -1, jnp.int32)
        for r in range(slots):
            table, claim, pending = claim_insert_round(
                table, claim, keys, bucket * slots + r, pending, idx)
    return table, pending


class OptimisticBuildResult(NamedTuple):
    table: jax.Array            # (num_buckets * 3,) int32
    pending: jax.Array          # (n,) bool — spilled tuples (conflicts)
    failed_optimistic: jax.Array  # (n,) bool — "aborted transaction" analog


def htm_optimistic_build(keys: jax.Array, num_buckets: int, *,
                         retry: bool = True, unique_keys: bool = False
                         ) -> OptimisticBuildResult:
    """The HTM-equivalent build (HTMHashBuild.hpp:157-278), data-parallel.

    Phase 1 (optimistic, the transaction analog): scatter every key directly
    at bucket*3 + key%3 where bucket = (key/3) & mask.  For the dense 1..N key
    universes of every reference distribution this mapping is *injective* when
    3*num_buckets > max(key) — the whole insert completes in one conflict-free
    device-memory-bandwidth scatter.  That is the data-parallel re-expression of "with locality,
    HTM transactions almost never abort" (README.md:6).

    Phase 2 (failure detection, the abort analog): gather back; a key whose
    slot holds a different value lost a collision (duplicate keys or bucket
    wrap).  `failed_optimistic` is the failedTransactions statistic
    (HTMHashBuild.hpp:188-191).

    Phase 3 (retry, the TM_RETRY analog, HTMHashBuild.hpp:219-278): claim
    rounds place failures into any free slot of their bucket; residual
    `pending` spills to the conflicts array.
    """
    n = keys.shape[0]
    mask = num_buckets - 1
    bucket = (keys // 3) & mask
    slot = bucket * 3 + keys % 3
    if unique_keys:
        table = jnp.zeros((num_buckets * 3,), KEY_DTYPE).at[slot].set(keys)
        failed = table[slot] != keys
    else:
        # duplicate keys would alias on gather-back compare; claim FIRST and
        # let only claim winners write the table — two independent scatters
        # (table + claim) may pick different duplicate-index winners (XLA
        # leaves the order unspecified), which would lose one tuple and
        # double-place another
        idx = jnp.arange(n, dtype=jnp.int32)
        claim = jnp.full((num_buckets * 3,), -1, jnp.int32).at[slot].set(idx)
        failed = claim[slot] != idx
        table = jnp.zeros((num_buckets * 3,), KEY_DTYPE).at[
            jnp.where(failed, num_buckets * 3, slot)].set(keys, mode="drop")
    if not retry:
        return OptimisticBuildResult(table, failed, failed)
    table, pending = bucket_build(keys, num_buckets, 3,
                                  lambda k, m: (k // 3) & m,
                                  unique_keys=unique_keys,
                                  pending=failed, table=table)
    return OptimisticBuildResult(table, pending, failed)


def spill_sorted(keys: jax.Array, pending: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Compact the spilled tuples into an ascending array (sentinel-padded
    with INT32_MAX) — the conflicts-array analog (HTMHashBuild.hpp:79-83),
    made binary-searchable for the probe phase.

    Returns (sorted_spill, conflict_count).
    """
    sentinel = jnp.iinfo(jnp.int32).max
    vals = jnp.where(pending, keys, sentinel)
    return jnp.sort(vals), jnp.sum(pending, dtype=jnp.int64)


def chunk_failure_fractions(failed: jax.Array, chunk: int) -> jax.Array:
    """Per-chunk failure fractions — the per-16384-tuple abort-rate statistic
    that drives HTM_ADAPT chunk resizing (HTMHashBuild.hpp:196-211)."""
    n = failed.shape[0]
    pad = (-n) % chunk
    f = jnp.pad(failed.astype(jnp.float32), (0, pad))
    return f.reshape(-1, chunk).mean(axis=1)
