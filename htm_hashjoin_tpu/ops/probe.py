"""Probe-phase primitives: vectorized gathers and sorted binary search.

The reference probes are serial loops per probe tuple — linear scans over
open-addressing slots (AtomicHashBuild.hpp:69-86), bucket-chain walks
(HTMHashBuild.hpp:288-308, mc/src/no_partitioning_join.c:270-310).  Here a
probe is a batch of gathers: locality in the probe keys (the sorted S side of
main.cpp:93) turns these into near-sequential device-memory reads, which is
the same locality dividend the paper exploits.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

HashFn = Callable[[jax.Array, int], jax.Array]


def probe_open_addressing(table: jax.Array, skeys: jax.Array,
                          probe_length: int, hash_fn: HashFn) -> jax.Array:
    """Count matches by scanning `probe_length` slots from h
    (AtomicHashBuild.hpp:69-86).  Returns int64 total match count.

    Device loop, not a Python unroll: probeLength is a user knob that can be
    thousands — unrolling would emit one gather per round into the traced
    graph and blow up compile time."""
    table_size = table.shape[0]
    mask = table_size - 1
    h = hash_fn(skeys, mask)

    def body(j, total):
        return total + jnp.sum(table[(h + j) & mask] == skeys,
                               dtype=jnp.int64)

    # never revisit a slot: scanning more than table_size slots would wrap
    return jax.lax.fori_loop(0, min(probe_length, table_size), body,
                             jnp.zeros((), jnp.int64))


def probe_buckets(table: jax.Array, skeys: jax.Array, slots: int,
                  hash_fn: HashFn) -> jax.Array:
    """Count matches against an S-slot bucket table (HTMHashBuild.hpp:288-308
    without the overflow chain — spilled tuples live in a sorted spill array,
    see probe_sorted)."""
    num_buckets = table.shape[0] // slots
    mask = num_buckets - 1
    bucket = hash_fn(skeys, mask)
    total = jnp.zeros((), jnp.int64)
    for r in range(slots):
        total += jnp.sum(table[bucket * slots + r] == skeys, dtype=jnp.int64)
    return total


def probe_sorted(build_keys: jax.Array, skeys: jax.Array,
                 i32_keys: bool = False) -> jax.Array:
    """Count equi-join matches, multiset-correct (duplicates on both sides
    multiply).  Implemented as ONE sort of a tagged composite plus two
    cumulative scans, in place of two searchsorted(method='sort') calls,
    each of which re-sorts the concatenated arrays.  Neither input needs to be pre-sorted; the name is
    kept for the call sites that pass the sorted build artifact.

    ``i32_keys``: the caller certifies 0 <= key < 2^30, so the tagged
    composite fits int32, whose sort moves half the bytes of the int64
    one."""
    comp_dtype = jnp.int32 if i32_keys else jnp.int64
    comp = jnp.concatenate([
        build_keys.astype(comp_dtype) * 2,
        skeys.astype(comp_dtype) * 2 + 1,
    ])
    s = jnp.sort(comp)
    tag = (s & 1).astype(jnp.int32)
    bcnt = 1 - tag                      # 1 on build elements
    a = jax.lax.cumsum(bcnt)            # build elements seen so far
    key = s >> 1
    run_start = jnp.concatenate([jnp.ones((1,), jnp.bool_),
                                 key[1:] != key[:-1]])
    # a at the end of the previous key run, filled forward
    prev_a = jax.lax.cummax(jnp.where(run_start, a - bcnt, -1))
    contrib = jnp.where(tag == 1, a - prev_a, 0)
    return jnp.sum(contrib.astype(jnp.int64))


@jax.jit
def count_in_sorted(r_keys: jax.Array, s_sorted: jax.Array) -> jax.Array:
    """Multiset match count of r_keys against an ALREADY-SORTED s_sorted
    via two binary-search scans — O(|R| log |S|) instead of probe_sorted's
    O((|R|+|S|) log) full tagged re-sort (which ignores pre-sortedness).
    R-side MAXI32 padding is excluded, so s_sorted may be MAXI32-padded
    (keeps it sorted); R duplicates multiply correctly (each R element
    contributes its own count_S).  Right choice when |R| << |S| — e.g.
    one build tile against a band segment; for |R| ~ |S| the 27 serial
    gather rounds lose to the single fused sort."""
    lo = jnp.searchsorted(s_sorted, r_keys, side="left", method="scan")
    hi = jnp.searchsorted(s_sorted, r_keys, side="right", method="scan")
    valid = r_keys != jnp.iinfo(jnp.int32).max
    return jnp.sum(jnp.where(valid, (hi - lo).astype(jnp.int64), 0))


def table_sum(table: jax.Array) -> jax.Array:
    """Σ of keys present in a table (empty slots are 0) — half of the
    outputSum conservation oracle (HTMHashBuild.hpp:322-401)."""
    return jnp.sum(table.astype(jnp.int64))


def masked_sum(keys: jax.Array, mask: jax.Array) -> jax.Array:
    """Σ keys[mask] — conflict/failed-range sum accounting."""
    return jnp.sum(jnp.where(mask, keys, 0).astype(jnp.int64))
