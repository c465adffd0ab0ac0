"""Sort-merge primitives.

The reference sort-merge (SortMerge.cpp:8-70) does a 64-way partitioned
parallel timsort, a final single-thread timsort pass, then a partitioned
two-pointer merge with branch-free match counting.  Both phases are serial
loops; here the sort is one XLA device sort (fully parallel) and the
merge-count becomes binary-search bounds — a vectorized,
multiset-correct equivalent of the two-pointer count (SortMerge.cpp:22-36).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from .probe import probe_sorted


def partitioned_sort(keys: jax.Array, num_partitions: int = 64) -> jax.Array:
    """Full ascending sort.  The reference's two-phase (partitioned timsort
    then global pass, SortMerge.cpp:11-18) exists to exploit multicore +
    near-sortedness; XLA's single device sort needs neither.  The
    num_partitions argument is accepted for API parity and ignored."""
    del num_partitions
    return jnp.sort(keys)


def merge_count(sorted_build: jax.Array, sorted_probe: jax.Array) -> jax.Array:
    """Count equi-join matches of two ascending arrays
    (SortMerge.cpp:22-36 semantics, duplicates multiply).  One fused
    tagged sort + scans (see probe.probe_sorted)."""
    return probe_sorted(sorted_build, sorted_probe)


def sort_and_count(build: jax.Array, probe: jax.Array,
                   probe_is_sorted: bool = False) -> Tuple[jax.Array, jax.Array]:
    """Sort both sides (S assumed pre-sorted by the driver per main.cpp:93
    when probe_is_sorted) and count matches."""
    sb = jnp.sort(build)
    sp = probe if probe_is_sorted else jnp.sort(probe)
    return sb, merge_count(sb, sp)
