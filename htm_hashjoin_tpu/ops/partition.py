"""Radix partitioning: histogram → exclusive scan → stable reorder.

The data-parallel re-expression of parallel_radix_partition
(mc/src/parallel_radix_join.c:559-627: per-thread histogram, barrier,
cross-thread prefix sum, scatter) and Wisconsin's RadixPartitioner
(mc/wisconsin-src/partitioner.cpp:336-520).  The thread histograms + barrier
+ prefix sum collapse into a single segment-sum and cumsum; the scatter
becomes a stable sort by digit, which XLA executes as one device sort —
no write-combining buffers or non-temporal stores needed
(the SWWC path mc/src/parallel_radix_join.c:655-795 is a CPU cache artifact).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .hashing import radix_digit


class PartitionResult(NamedTuple):
    keys: jax.Array      # input reordered so partitions are contiguous
    digits: jax.Array    # digit of each reordered key
    hist: jax.Array      # (fanout,) int32 partition sizes
    offsets: jax.Array   # (fanout,) int32 exclusive prefix sums


def histogram(digits: jax.Array, fanout: int) -> jax.Array:
    """Partition-size histogram (parallel_radix_join.c:571-585 analog)."""
    return jnp.zeros((fanout,), jnp.int32).at[digits].add(1)


def exclusive_scan(hist: jax.Array) -> jax.Array:
    """Output offsets (parallel_radix_join.c:588-598 prefix sum analog)."""
    return jnp.concatenate([jnp.zeros((1,), hist.dtype), jnp.cumsum(hist)[:-1]])


def radix_partition(keys: jax.Array, bits: int, shift: int = 0, *,
                    hashed: bool = False, sort_within: bool = True
                    ) -> PartitionResult:
    """Partition keys by their radix digit.

    With ``sort_within=True`` the keys inside each partition come out
    ascending (sort by (digit, key) jointly) — this subsumes the reference's
    per-partition bucket-chaining build (parallel_radix_join.c:231-283): a
    sorted partition *is* the search structure, probed by binary search.
    """
    fanout = 1 << bits
    digits = radix_digit(keys, shift, bits, hashed=hashed)
    if sort_within:
        composite = digits.astype(jnp.int64) << 32 | keys.astype(jnp.int64)
        composite = jnp.sort(composite)
        out_keys = (composite & 0xFFFFFFFF).astype(keys.dtype)
        out_digits = (composite >> 32).astype(jnp.int32)
    else:
        out_digits, out_keys = jax.lax.sort_key_val(digits, keys, is_stable=True)
    # the histogram falls out of the SORTED digits with one searchsorted —
    # no scatter-add of every row into its digit's counter
    bounds = jnp.searchsorted(out_digits, jnp.arange(fanout + 1, dtype=out_digits.dtype),
                              side="left", method="scan")
    hist = jnp.diff(bounds).astype(jnp.int32)
    return PartitionResult(out_keys, out_digits, hist, exclusive_scan(hist))


def bit_length(x: jax.Array) -> jax.Array:
    """Traced integer bit length of a non-negative int32 scalar (exact —
    no float log2 rounding at powers of two)."""
    x = x.astype(jnp.int32)
    bl = jnp.zeros((), jnp.int32)
    for s in (16, 8, 4, 2, 1):
        hi = x >> s
        take = hi > 0
        bl = bl + jnp.where(take, s, 0)
        x = jnp.where(take, hi, x)
    return bl + (x > 0).astype(jnp.int32)


def radix_partition_msb(keys: jax.Array, bits: int, *, sorter=jnp.sort):
    """MSB radix partition via a plain key sort.

    The reference's Wisconsin partitioner is MSB multi-pass radix
    (mc/wisconsin-src/partitioner.cpp:443-520).  With digits taken from the
    key's top `bits` (shift = bit_length(max key) - bits), ascending key
    order IS partition-contiguous order with keys ascending within every
    partition — so the histogram → prefix-sum → scatter pipeline PLUS the
    per-partition bucket-chaining build (parallel_radix_join.c:559-627,
    :231-283) collapse into one int32 key sort.  That keeps the hot loop in
    the 32-bit sort instead of a twice-the-bandwidth int64 composite sort.

    Returns (PartitionResult, shift): shift is traced (derived from the data
    maximum), digits/hist describe the MSB partitions.
    """
    fanout = 1 << bits
    n = keys.shape[0]
    out_keys = sorter(keys)
    shift = jnp.maximum(bit_length(jnp.max(out_keys[-1:])) - bits, 0)
    digits = ((out_keys >> shift) & (fanout - 1)).astype(jnp.int32)
    # sorted keys ⇒ the histogram is searchsorted diffs at digit boundaries
    # (O(fanout·log n)), not a scatter-add of every row.  The last boundary fanout<<shift
    # can overflow int32, so it is replaced by n.
    bounds = (jnp.arange(1, fanout, dtype=jnp.int32) << shift).astype(jnp.int32)
    cum = jnp.searchsorted(out_keys, bounds, side="left").astype(jnp.int32)
    hist = jnp.diff(jnp.concatenate([jnp.zeros((1,), jnp.int32), cum,
                                     jnp.full((1,), n, jnp.int32)]))
    return PartitionResult(out_keys, digits, hist, exclusive_scan(hist)), shift


def partition_composite(keys: jax.Array, bits: int, shift: int = 0, *,
                        hashed: bool = False) -> jax.Array:
    """(digit << 32 | key) composite for probing a sorted-within partitioned
    relation: equal composites ⇔ same partition and same key."""
    digits = radix_digit(keys, shift, bits, hashed=hashed)
    return digits.astype(jnp.int64) << 32 | keys.astype(jnp.int64)


def heavy_hitters(hist: jax.Array, threshold: int) -> jax.Array:
    """Skew detection: partitions larger than threshold
    (SKEW_HANDLING, mc/src/parallel_radix_join.c:900-912; THRESHOLD1
    mc/src/prj_params.h:59-64)."""
    return hist > threshold
