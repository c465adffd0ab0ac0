"""Partitioner family — mc/wisconsin-src/partitioner.cpp:69-757 re-designed
for SPMD vector execution.

The reference's partitioners move tuples between page chains under various
concurrency disciplines:

  * Partitioner           — no-op single split            (:69-114)
  * ParallelPartitioner   — shared output partitions, atomic appends (:117-180)
  * IndependentPartitioner— thread-private partitions, concatenated  (:183-263)
  * DerekPartitioner      — contiguous (non-round-robin) split       (:266-268)
  * RadixPartitioner      — multi-pass MSB radix: per-thread histograms,
                            prefix-sum combine, scatter passes        (:336-520)

As whole-array device programs there are no threads to isolate, so every
variant reduces to one conflict-free plan: histogram (segment-sum) → exclusive scan → stable
reorder, executed as a fused sort.  The variants are kept because their
*outputs* differ — which rows land in which partition, and in what order —
and the joiner policies depend on that:

  * Parallel: partitions ordered by input position (stable by arrival).
  * Independent: partitions ordered by (source shard, position) — each
    shard's contribution is contiguous inside a partition.
  * Radix: recursive digit decomposition using ModuloHash.generate(passes),
    final histogram exposed for FlatMemoryJoiner's range probe.

All return a ``PartitionedTable``: the reordered table + per-partition
offset/size arrays (the SplitResult analog, partitioner.h:29).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .hashfn import HashFunction, ModuloHash, hash_factory
from .table import Table


@dataclasses.dataclass
class PartitionedTable:
    """SplitResult analog: table rows grouped so partition p occupies rows
    [offsets[p], offsets[p] + sizes[p])."""

    table: Table
    sizes: np.ndarray      # (nparts,) int64
    offsets: np.ndarray    # (nparts,) int64 exclusive prefix sums
    part_hash: Optional[HashFunction] = None  # the hash fn that assigned
                           # rows to partitions (None for no-op/derek
                           # splits).  Lets the joiner certify that build
                           # and probe sides are CO-PARTITIONED (same
                           # fingerprint on the same attribute) and probe
                           # each unit against only its matching build
                           # partition (probe.inl:18-36 locality).
    part_attr: int = 1     # the partitioned attribute (conf 'attribute')
    _perm: "np.ndarray | jax.Array | None" = None  # original row index of
                           # each reordered row — device-resident from the
                           # hash partitioners (never copied to the host);
                           # None = identity (the no-op split),
                           # materialized lazily: a host np.arange at the
                           # 256M-row reference scale costs ~10 s and the
                           # join never reads it

    @property
    def perm(self):
        if callable(self._perm):       # deferred recompute (packed reorder)
            self._perm = self._perm()
        if self._perm is None:
            self._perm = np.arange(self.table.num_rows)
        return self._perm

    @property
    def nparts(self) -> int:
        return int(self.sizes.shape[0])

    def partition_rows(self, p: int) -> np.ndarray:
        s, e = int(self.offsets[p]), int(self.offsets[p] + self.sizes[p])
        return np.arange(s, e)


@functools.partial(jax.jit, static_argnums=(2, 3))
def _reorder_device_packed2(cols, rank, nparts: int, stride: int):
    """Two-int32-column fast path of _reorder_device: both columns ride
    the sort as ONE packed int64 value, so the permutation is applied by
    the sort itself — no per-column gathers."""
    n = rank.shape[0]
    a, b = cols
    packed = (a.astype(jnp.int64) << 32) | (b.astype(jnp.int64)
                                            & 0xFFFFFFFF)
    rank_s, packed_s = jax.lax.sort_key_val(rank, packed, is_stable=True)
    out_a = (packed_s >> 32).astype(jnp.int32)
    out_b = packed_s.astype(jnp.int32)
    bounds = jnp.searchsorted(
        rank_s, (jnp.arange(nparts, dtype=rank.dtype) * rank.dtype.type(
            stride)), side="left", method="scan").astype(jnp.int64)
    ends = jnp.concatenate([bounds[1:], jnp.full((1,), n, jnp.int64)])
    # the permutation itself is still occasionally read (StorePointer
    # bookkeeping, tests) — recovered lazily by the caller when needed
    return (out_a, out_b), jnp.stack([ends - bounds, bounds])


@functools.partial(jax.jit, static_argnums=(2, 3))
def _reorder_device(cols, rank, nparts: int, stride: int):
    """The fused partition program: ONE stable key-value sort of (rank,
    iota) gives both the permutation and the sorted ranks; partition
    offsets fall out of 8K binary searches on the sorted ranks (partition
    p covers ranks [p·stride, (p+1)·stride)).  Fusing into one XLA
    computation matters at reference scale: dispatched eagerly, every
    1 GB temporary is pinned by a live Python reference until GC.  The
    histogram comes from binary searches on the sorted ranks, not from a
    duplicate-heavy scatter-add of every row into its bucket."""
    n = cols[0].shape[0] if cols else rank.shape[0]
    iota = jnp.arange(n, dtype=jnp.int32)
    rank_s, perm = jax.lax.sort_key_val(rank, iota, is_stable=True)
    bounds = jnp.searchsorted(
        rank_s, (jnp.arange(nparts, dtype=rank.dtype) * rank.dtype.type(
            stride)), side="left", method="scan").astype(jnp.int64)
    ends = jnp.concatenate([bounds[1:], jnp.full((1,), n, jnp.int64)])
    hist = ends - bounds
    outs = tuple(c[perm] for c in cols)
    return outs, perm, jnp.stack([hist, bounds])


def _reorder(table: Table, jattr: int, buckets: jax.Array, nparts: int,
             rank_bias: Optional[jax.Array] = None,
             bias_bound: int = 0, part_hash: Optional[HashFunction] = None,
             part_attr: int = 1) -> PartitionedTable:
    """One conflict-free partitioning pass: stable sort rows by bucket id
    (optionally biased by a secondary rank in [0, bias_bound)) and gather
    every column.

    This single fused program subsumes the reference's histogram + barrier +
    prefix-sum + scatter pipeline (partitioner.cpp:336-520) — the histogram
    and offsets fall out of a bincount, and the scatter is the sort's gather.
    """
    # int32 composite rank whenever it fits (bias values are shard ids
    # < bias_bound): an int64 sort moves twice the bytes of the int32 one
    if rank_bias is None:
        rank = buckets.astype(jnp.int32)
    elif nparts * bias_bound < (1 << 31):
        rank = (buckets.astype(jnp.int32) * jnp.int32(bias_bound)
                + rank_bias.astype(jnp.int32))
    else:
        rank = (buckets.astype(jnp.int64) * jnp.int64(bias_bound)
                + rank_bias.astype(jnp.int64))
    num_cols = [c for c in table.columns
                if not (isinstance(c, np.ndarray) and c.dtype == object)]
    stride = bias_bound if rank_bias is not None else 1
    if (len(num_cols) == 2 and len(table.columns) == 2
            and all(jnp.asarray(c).dtype == jnp.int32 for c in num_cols)):
        outs2, so_dev = _reorder_device_packed2(
            tuple(jnp.asarray(c) for c in num_cols), rank, nparts, stride)
        sizes_offsets = np.asarray(so_dev)
        out = Table(table.schema, list(outs2), table.page_size)
        # same stable order as argsort(rank); materialized only if read
        # (holds rank — the same 1 GB the eager perm used to occupy)
        return PartitionedTable(out, sizes_offsets[0], sizes_offsets[1],
                                part_hash, part_attr,
                                lambda: jnp.argsort(rank, stable=True))
    outs, perm, sizes_offsets_dev = _reorder_device(
        tuple(jnp.asarray(c) for c in num_cols), rank, nparts, stride)
    sizes_offsets = np.asarray(sizes_offsets_dev)
    # numeric columns gather AND STAY on device; string columns gather
    # host-side
    outs = list(outs)
    out_cols = []
    perm_np = None
    for c in table.columns:
        if isinstance(c, np.ndarray) and c.dtype == object:
            if perm_np is None:
                perm_np = np.asarray(perm)
            out_cols.append(c[perm_np])
        else:
            out_cols.append(outs.pop(0))
    out = Table(table.schema, out_cols, table.page_size)
    return PartitionedTable(out, sizes_offsets[0], sizes_offsets[1],
                            part_hash, part_attr, perm)


class NoPartitioner:
    """'algorithm: "no"' — a single partition containing the whole input
    (Partitioner::split, partitioner.cpp:69-114)."""

    def __init__(self, hashfn: Optional[HashFunction] = None,
                 page_size: int = 1 << 20, attribute: int = 1,
                 nthreads: int = 1):
        self.hashfn = hashfn
        self.attribute = attribute

    def split(self, table: Table) -> PartitionedTable:
        n = table.num_rows
        return PartitionedTable(table, np.array([n], np.int64),
                                np.array([0], np.int64))


class ParallelPartitioner(NoPartitioner):
    """'algorithm: "parallel"' — all workers append to shared output
    partitions (partitioner.cpp:117-180).  Here: one stable reorder; stability
    gives the same arrival-order-within-partition observable."""

    def __init__(self, hashfn: HashFunction, page_size: int = 1 << 20,
                 attribute: int = 1, nthreads: int = 1):
        super().__init__(hashfn, page_size, attribute, nthreads)

    def split(self, table: Table) -> PartitionedTable:
        keys = jnp.asarray(table.key_column(self.attribute))
        buckets = self.hashfn.hash(keys)
        return _reorder(table, self.attribute, buckets, self.hashfn.buckets,
                        part_hash=self.hashfn, part_attr=self.attribute)


class IndependentPartitioner(ParallelPartitioner):
    """'algorithm: "independent"' — thread-private partitions concatenated
    per bucket (partitioner.cpp:183-263).  Here: same reorder with a
    (shard, position) secondary rank so each of ``nthreads`` logical shards
    is contiguous within a partition, matching the reference's layout."""

    def __init__(self, hashfn: HashFunction, page_size: int = 1 << 20,
                 attribute: int = 1, nthreads: int = 8):
        super().__init__(hashfn, page_size, attribute, nthreads)
        self.nthreads = nthreads

    def split(self, table: Table) -> PartitionedTable:
        n = table.num_rows
        keys = jnp.asarray(table.key_column(self.attribute))
        buckets = self.hashfn.hash(keys)
        # logical shard of each row under the reference's round-robin page
        # split (table.cpp:238-272)
        page = jnp.arange(n, dtype=jnp.int32) // jnp.int32(table.page_size)
        shard = page % jnp.int32(self.nthreads)
        # rank bias orders rows by shard within a bucket; sort stability
        # keeps original position within (bucket, shard)
        return _reorder(table, self.attribute, buckets, self.hashfn.buckets,
                        rank_bias=shard, bias_bound=self.nthreads,
                        part_hash=self.hashfn, part_attr=self.attribute)


class DerekPartitioner(NoPartitioner):
    """'algorithm: "derek"' — contiguous equal split without hashing
    (partitioner.cpp:266-268: overrides split only)."""

    def __init__(self, hashfn: Optional[HashFunction] = None,
                 page_size: int = 1 << 20, attribute: int = 1,
                 nthreads: int = 8):
        super().__init__(hashfn, page_size, attribute, nthreads)
        self.nthreads = nthreads

    def split(self, table: Table) -> PartitionedTable:
        n = table.num_rows
        base, rem = divmod(n, self.nthreads)
        sizes = np.full((self.nthreads,), base, np.int64)
        sizes[:rem] += 1
        offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        return PartitionedTable(table, sizes, offsets)


class RadixPartitioner(ParallelPartitioner):
    """'algorithm: "radix"' — multi-pass MSB radix partitioning
    (partitioner.cpp:336-520: createhistogram / combinehistogram /
    realsplit loop over passes).

    Because every pass here is a stable sort on disjoint digit masks
    (hash.cpp generate()), the composition over passes equals one stable
    sort on the full bucket id — so we execute the passes in one fused
    reorder and keep the per-pass functions only to honor the configured
    decomposition (and for the multi-pass tiling story, SURVEY.md §5
    long-context analog)."""

    def __init__(self, hashfn: ModuloHash, page_size: int = 1 << 20,
                 attribute: int = 1, nthreads: int = 1, passes: int = 1):
        super().__init__(hashfn, page_size, attribute, nthreads)
        self.passes = passes
        self.pass_fns = (hashfn.generate(passes)
                         if isinstance(hashfn, ModuloHash) and passes > 1
                         else [hashfn])
        self.histogram: Optional[np.ndarray] = None  # FlatMemoryJoiner hook

    def split(self, table: Table) -> PartitionedTable:
        res = super().split(table)
        # inclusive histogram, as FlatMemoryJoiner::probe consumes it
        # (flatmem.cpp: bstart = histogram[curbuc-1], bitems = hist[b]-bstart)
        self.histogram = np.cumsum(res.sizes)
        return res


_PARTITIONERS = {
    "no": NoPartitioner,
    "parallel": ParallelPartitioner,
    "independent": IndependentPartitioner,
    "derek": DerekPartitioner,
    "radix": RadixPartitioner,
}


def partitioner_factory(node: dict, hash_node: dict, nthreads: int):
    """PartitionerFactory (partitionerfactory.cpp:23-42) from parsed conf:
    node = partitioner.build / partitioner.probe, hash_node =
    partitioner.hash."""
    algo = node["algorithm"]
    if algo not in _PARTITIONERS:
        raise ValueError(f"unknown partitioner {algo!r}")
    hashfn = hash_factory(hash_node) if algo != "no" else None
    kwargs = dict(page_size=node.get("pagesize", 1 << 20),
                  attribute=node.get("attribute", 1), nthreads=nthreads)
    if algo == "radix":
        kwargs["passes"] = node.get("passes", 1)
    if algo == "no":
        return NoPartitioner(hashfn, **kwargs)
    return _PARTITIONERS[algo](hashfn, **kwargs)
