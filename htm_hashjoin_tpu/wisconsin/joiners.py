"""Joiner policy lattice — mc/wisconsin-src/algo/* re-designed for SPMD devices.

The reference composes joiners from policy mixins (joinerfactory.cpp:23-75):
``{StoreCopy,StorePointer} × {BuildIsPart,BuildIsNotPart} ×
{ProbeIsPart,ProbeIsNotPart,ProbeSteal}`` plus two specials (NestedLoops,
FlatMemoryJoiner).  Each axis exists to manage *CPU concurrency and cache
locality*; here is its data-parallel re-expression:

  storage axis (storage.cpp StoreCopy vs storagepl.cpp StorePointer)
      StoreCopy materializes key+payload into the table at build time —
      here: payload columns gathered into build order on device (early
      materialization).  StorePointer stores tuple pointers — here: only
      the row-permutation is kept and payload is gathered at emit (late
      materialization).  Both are real, distinct data movements with the
      reference's exact trade-off (build bandwidth vs probe gathers).

  build axis (build.inl)
      BuildIsPart builds thread-private partitions without atomics;
      BuildIsNotPart builds one shared table with atomic appends.  Here
      every build is conflict-free by construction: the chained bucket
      pages (hashtable.h:24-50) become a bucket-sorted layout — stable
      sort rows by hash bucket; bucket b's tuples occupy one contiguous
      range.  The axis survives as the *plan*: partitioned builds sort
      within each partition (a vmappable per-partition program; the
      private-build analog), unpartitioned builds sort globally.

  probe axis (probe.inl)
      ProbeIsPart/ProbeIsNotPart walk matching partitions; ProbeSteal adds
      a second work-stealing pass.  SPMD has no idle lanes to steal into
      (SURVEY.md §2.4 P8): the analog is static cost balancing, and the
      configured policy is honored in the stats (per-partition probe costs
      and the balanced assignment ``steal`` would have produced).

  match kernel
      Bucket-chain walks become two binary searches: equal keys always
      share a bucket, so a key-sorted build side is probed with
      searchsorted(left/right); (hi-lo) is the per-probe match count and
      the expand trick materializes output rows with static shapes.

Outputs are materialized (schema = select1 cols ++ select2 cols, the
OUTPUT_ASSEMBLE path of flatmem.cpp/storage.cpp), not just counted —
capacity is discovered by a count pass, then the emit runs with the
capacity rounded to the next power of two (bounded recompiles).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..relation import next_pow2
from .hashfn import HashFunction
from .partitioner import PartitionedTable, RadixPartitioner
from .schema import ColumnType, Schema
from .table import Table


# ---------------------------------------------------------------------------
# Static-shape join-index kernels
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnums=(2,))
def _expand_matches(lo: jax.Array, hi: jax.Array, cap: int):
    """Expand per-probe match ranges [lo, hi) into flat (probe_row,
    build_rank) index pairs of static length ``cap``.

    For output slot k: its probe row is the last i with offsets[i] <= k, and
    its match ordinal is k - offsets[i].  Invalid slots (k >= total) get
    index -1.  This replaces the reference's per-thread output cursors
    (WriteTable::append, table.h:200-253) with one vectorized program.
    """
    # int32 slot/index arithmetic when cap allows: the int64 temporaries
    # at a 2^28-row output cost ~8 GB of transient device memory.
    # total <= cap (the caller sizes cap from the counted total), so the
    # int32 offsets cannot overflow under the gate.
    idt = jnp.int32 if cap < (1 << 31) else jnp.int64
    counts = (hi - lo).astype(idt)
    offsets = jnp.concatenate([jnp.zeros((1,), idt),
                               jnp.cumsum(counts, dtype=idt)])
    total = offsets[-1].astype(jnp.int64)
    k = jnp.arange(cap, dtype=idt)
    # owner row of slot k = last i with offsets[i] <= k.  searchsorted here
    # is 24 binary-search gather passes over cap elements; since k is
    # just arange(cap), a scatter-max of row ids at range
    # starts + one cummax computes the same thing in one pass.  Empty ranges
    # scatter to the same slot as their successor and lose the max — exactly
    # the searchsorted(side='right') owner.
    starts = offsets[:-1].astype(jnp.int32)    # cap < 2^31
    marks = jnp.zeros((cap,), jnp.int32).at[starts].max(
        jnp.arange(lo.shape[0], dtype=jnp.int32), mode="drop")
    pi = jax.lax.cummax(marks).astype(idt)
    # one fused gather: build_rank = k + (lo - range_start)[owner]
    base = lo.astype(idt) - offsets[:-1]
    build_rank = k + base[pi]
    valid = k < total.astype(idt)
    probe_idx = jnp.where(valid, pi, -1)
    build_rank = jnp.where(valid, build_rank, -1)
    return probe_idx, build_rank, total


def _match_bounds_tagged(sorted_keys: jax.Array, probe_keys: jax.Array,
                         comp_dtype):
    """Match ranges [lo, hi) of each probe key in the key-sorted build side
    — the bucket-chain walk analog (storage.cpp realprobeCursor;
    hashtable.h iterator).

    One fused sort of a tagged (key·2+side, row) pair stream: at a probe
    element's sorted position, the running build-element count equals
    hi(key) and the count at its key-run start equals lo(key); scattering
    those through the carried row indices yields per-row bounds — 4x less
    sort work than two searchsorted(method='sort') calls.

    ``comp_dtype`` is the tagged-composite dtype: int32 when every key is
    certified < 2^30 (the reference-scale workloads: keys <= 16M,
    wisconsin-src/datagen/genbuild.py) — an int64 sort moves twice the
    bytes of the int32 one, and the composite sort is the entire probe
    cost at 16M x 256M scale."""
    n_b, n_p = sorted_keys.shape[0], probe_keys.shape[0]
    comp = jnp.concatenate([
        sorted_keys.astype(comp_dtype) * 2,
        probe_keys.astype(sorted_keys.dtype).astype(comp_dtype) * 2 + 1,
    ])
    rows = jnp.concatenate([jnp.zeros((n_b,), jnp.int32),
                            jnp.arange(n_p, dtype=jnp.int32)])
    comp_s, rows_s = jax.lax.sort_key_val(comp, rows)
    tag = (comp_s & 1).astype(jnp.int32)
    bcnt = 1 - tag
    a = jax.lax.cumsum(bcnt)                       # hi at probe positions
    key = comp_s >> 1
    run_start = jnp.concatenate([jnp.ones((1,), jnp.bool_),
                                 key[1:] != key[:-1]])
    prev_a = jax.lax.cummax(jnp.where(run_start, a - bcnt, -1))  # lo
    is_probe = tag == 1
    tgt = jnp.where(is_probe, rows_s, n_p)
    lo = jnp.zeros((n_p,), jnp.int32).at[tgt].set(
        prev_a.astype(jnp.int32), mode="drop")
    hi = jnp.zeros((n_p,), jnp.int32).at[tgt].set(
        a.astype(jnp.int32), mode="drop")
    total = jnp.sum(jnp.where(is_probe, a - prev_a, 0).astype(jnp.int64))
    return lo, hi, total


@jax.jit
def _match_bounds_i64(sorted_keys, probe_keys):
    return _match_bounds_tagged(sorted_keys, probe_keys, jnp.int64)


@jax.jit
def _match_bounds_i32(sorted_keys, probe_keys):
    return _match_bounds_tagged(sorted_keys, probe_keys, jnp.int32)


@jax.jit
def _keys_absmax(a, b):
    """One fused readback certifying the int32 composite: max |key| over
    both sides, stacked so the certification costs ONE host readback, not
    two."""
    m = jnp.maximum(
        jnp.maximum(jnp.max(a), jnp.max(b)).astype(jnp.int64),
        -jnp.minimum(jnp.min(a), jnp.min(b)).astype(jnp.int64))
    return m


_I32_COMP_LIMIT = (1 << 30) - 1  # |key|*2+1 must stay in int32, with one
# value spare at each end for the schedule pads below (a probe pad must
# sort strictly below, and a build-slice pad strictly above, every
# certified key — at exactly 2^30-1 the pad composite would collide)

# Schedule padding sentinels: probe pads sort below / match nothing; build
# pads sort above every certified real key (see _block_bounds_local).
_PAD_PROBE_I32 = -((1 << 30) - 1)
_PAD_BUILD_I32 = (1 << 30) - 1
_PAD_PROBE_I64 = -((1 << 62) - 1)   # composite pad*2+1 must not wrap int64
_PAD_BUILD_I64 = (1 << 62) - 1

# Dense-key rank table: eligible when build keys lie in [0, K] with K small
# enough that a (K+1)-entry table is cheap (≤ 16x the build side and ≤ 2^26
# entries = 512 MB packed).  The canonical multijoin workloads qualify:
# 16M build keys drawn 1..16M (wisconsin-src/datagen/genbuild.py).
_DENSE_LIMIT = 1 << 26


@jax.jit
def _dense_rank_table(keys: jax.Array, zeros_l: jax.Array):
    """Per-key bounds directory over the key-sorted build order: cnt[k] =
    multiplicity of key k, cum[k] = #build keys <= k — so lo = cum-cnt,
    hi = cum index the sorted build side.  One bincount scatter + one
    cumsum at build time replaces the per-probe tagged sort entirely (the
    reference's FK probes hash into exactly such a directory,
    hashtable.h:24-50).  ``zeros_l`` fixes the table length (next_pow2 of
    the key range — bounded recompiles).  Two int32 tables, not one packed
    int64: the packed gather's 8-byte temp at a 256M-row probe is a 2 GB
    spike of device memory beside the output buffers."""
    cnt = zeros_l.at[keys].add(1, mode="drop")
    cum = jnp.cumsum(cnt, dtype=jnp.int32)
    return cum, cnt, jnp.max(cnt)


@jax.jit
def _dense_bounds(cum: jax.Array, cnt_tbl: jax.Array, probe_keys: jax.Array):
    """Match ranges via two int32 gathers from the dense rank directory —
    no sort, no scatter.  Out-of-range probe keys match nothing.  Returns
    (lo, hi, [total, all_unit]) with the two scalars stacked so the caller
    pays a single fence; all_unit certifies every probe count == 1 (the FK
    fast path: expansion becomes the identity)."""
    k_max = cum.shape[0] - 1
    idx = jnp.clip(probe_keys, 0, k_max).astype(jnp.int32)
    valid = (probe_keys >= 0) & (probe_keys <= k_max)
    cnt = jnp.where(valid, cnt_tbl[idx], 0)
    hi = jnp.where(valid, cum[idx], 0)
    lo = hi - cnt
    total = jnp.sum(cnt.astype(jnp.int64))
    # negative keys are schedule padding (matches nothing) — they do not
    # void the unit certificate; generated keys are 1-based so a real
    # non-matching key (cnt 0, key >= 0) still voids it
    all_unit = jnp.all((cnt == 1) | (probe_keys < 0)).astype(jnp.int64)
    return lo, hi, jnp.stack([total, all_unit])


@jax.jit
def _dense_bounds_perm(probe_keys: jax.Array, kmin, kmax):
    """Bounds under the PERMUTATION-BUILD certificate (dense keys covering
    [kmin, kmax] exactly once — the canonical 16M PK build): lo is pure
    arithmetic, no table, no gather.  head = [total, all_unit]; a probe key
    outside the range voids all_unit and the caller falls back to the
    gather-based directory for exact hi/lo of the non-matching rows."""
    valid = (probe_keys >= kmin) & (probe_keys <= kmax)
    lo = jnp.where(valid, probe_keys - kmin, 0).astype(jnp.int32)
    hi = lo + valid.astype(jnp.int32)
    total = jnp.sum(valid.astype(jnp.int64))
    all_unit = jnp.all(valid | (probe_keys < 0)).astype(jnp.int64)
    return lo, hi, jnp.stack([total, all_unit])


@jax.jit
def _flat_directory(keys_flat_order: jax.Array, zeros_l: jax.Array):
    """Start/count directory over the keyspace for a FLAT-ORDER build
    (FlatMemoryJoiner): start_tbl[k] = first flat position of key k,
    cnt_tbl[k] = multiplicity.  Valid because equal keys are contiguous in
    (bucket, key) order when bucket = hash(key)."""
    n = keys_flat_order.shape[0]
    pos = jnp.arange(n, dtype=jnp.int32)
    start = jnp.full(zeros_l.shape, n, jnp.int32).at[keys_flat_order].min(
        pos, mode="drop")
    cnt = zeros_l.at[keys_flat_order].add(1, mode="drop")
    return start, cnt


@jax.jit
def _flat_dense_bounds(start_tbl: jax.Array, cnt_tbl: jax.Array,
                       probe_keys: jax.Array):
    """Flat-order match ranges via two int32 gathers (see _dense_bounds;
    same head = [total, pad-aware all_unit] contract)."""
    k_max = start_tbl.shape[0] - 1
    idx = jnp.clip(probe_keys, 0, k_max).astype(jnp.int32)
    valid = (probe_keys >= 0) & (probe_keys <= k_max)
    cnt = jnp.where(valid, cnt_tbl[idx], 0)
    lo = jnp.where(valid & (cnt > 0), start_tbl[idx], 0)
    hi = lo + cnt
    total = jnp.sum(cnt.astype(jnp.int64))
    all_unit = jnp.all((cnt == 1) | (probe_keys < 0)).astype(jnp.int64)
    return lo, hi, jnp.stack([total, all_unit])


@functools.partial(jax.jit, static_argnums=(2, 3))
def _steal_cuts(occ, buckets, k: int, use_i32: bool = False):
    """ProbeSteal's cost-balanced cut points, computed ON DEVICE: the
    whole 2^28-element hash array never goes to the host; only the k-1
    cut rows and the k chunk costs come back.

    ``use_i32``: the caller certifies n_probe * (max_occupancy + 1) <
    2^31, so the whole cost prefix fits int32 — the int64 cumsum+gather
    over 2^28 rows moves twice the bytes."""
    dt = jnp.int32 if use_i32 else jnp.int64
    cost = occ[buckets].astype(dt) + 1
    prefix = jnp.cumsum(cost, dtype=dt)
    total = prefix[-1].astype(jnp.int64)
    targets = ((jnp.arange(1, k, dtype=jnp.int64) * total) // k).astype(dt)
    cuts = jnp.searchsorted(prefix, targets).astype(jnp.int64)
    n = buckets.shape[0]
    bounds = jnp.concatenate([jnp.zeros((1,), jnp.int64), cuts,
                              jnp.full((1,), n, jnp.int64)])
    cprefix = jnp.concatenate([jnp.zeros((1,), dt), prefix]).astype(
        jnp.int64)
    balance = cprefix[bounds[1:]] - cprefix[bounds[:-1]]
    return bounds, balance


@jax.jit
def _partition_costs(lo, hi, starts, ends):
    counts = (hi - lo).astype(jnp.int64) + 1
    cum = jnp.concatenate([jnp.zeros((1,), jnp.int64), jnp.cumsum(counts)])
    return cum[ends] - cum[starts]


@jax.jit
def _build_key_stats(keys: jax.Array, occ: jax.Array) -> jax.Array:
    """[max bucket occupancy, min key, max key] in ONE readback (not three
    separate int() host round trips)."""
    return jnp.stack([jnp.max(occ).astype(jnp.int64),
                      jnp.min(keys).astype(jnp.int64),
                      jnp.max(keys).astype(jnp.int64)])


def _match_bounds(sorted_keys: jax.Array, probe_keys: jax.Array,
                  key_bound: Optional[int] = None):
    """Dtype-routing wrapper: int32 tagged sort when |key| is certified
    < 2^30 (the composite key*2+tag is order-preserving in int32 there —
    negative keys included), int64 otherwise.  Pass ``key_bound`` =
    max |key| to skip the certification readback; Wisconsin joiners certify
    once per probe and reuse the bound across schedule units."""
    if key_bound is None:
        if (jnp.issubdtype(sorted_keys.dtype, jnp.signedinteger)
                and sorted_keys.dtype.itemsize <= 4
                and probe_keys.dtype.itemsize <= 4
                and sorted_keys.size and probe_keys.size):
            key_bound = int(_keys_absmax(sorted_keys, probe_keys))
        else:
            key_bound = _I32_COMP_LIMIT
    if key_bound < _I32_COMP_LIMIT:
        return _match_bounds_i32(sorted_keys, probe_keys)
    return _match_bounds_i64(sorted_keys, probe_keys)


# ---------------------------------------------------------------------------
# Worker-block probe programs (the scheduled-probe engine)
#
# A scheduled probe (ProbeIsPart / ProbeSteal) decomposes the probe into
# units; units are grouped into <= nthreads CONTIGUOUS row-balanced blocks,
# one per worker, and each worker's whole block runs as ONE device program.
# One program per UNIT would mean ~2048 dispatches at the canonical
# 2048-partition confs.  Per-unit totals come from a boundary cumsum
# inside the block program, so the measured per-unit schedule survives
# with 8 dispatches and one pipelined readback.
# ---------------------------------------------------------------------------

def _unit_totals(lo, hi, ubounds):
    """Per-unit match totals from flat per-row bounds: one cumsum + a
    gather at the unit boundaries (ubounds = U+1 row offsets, clamped)."""
    counts = (hi - lo).astype(jnp.int64)
    cum = jnp.concatenate([jnp.zeros((1,), jnp.int64),
                           jnp.cumsum(counts)])
    ub = ubounds.astype(jnp.int32)
    return cum[ub[1:]] - cum[ub[:-1]]


@functools.partial(jax.jit, static_argnums=(0,))
def _block_bounds_perm(W: int, pk_pad, start, ubounds, kmin, kmax):
    """Worker block under the permutation-build certificate: bounds are
    pure arithmetic (no table, no gather — the partition-local property is
    free: a probe key computes its global build rank directly)."""
    seg = jax.lax.dynamic_slice(pk_pad, (start,), (W,))
    lo, hi, head = _dense_bounds_perm(seg, kmin, kmax)
    return lo, hi, jnp.concatenate([_unit_totals(lo, hi, ubounds), head])


@functools.partial(jax.jit, static_argnums=(0,))
def _block_bounds_dense(W: int, pk_pad, start, ubounds, cum, cnt_tbl):
    """Worker block over the dense rank directory (two int32 gathers per
    row — already O(1)/probe independent of build size)."""
    seg = jax.lax.dynamic_slice(pk_pad, (start,), (W,))
    lo, hi, head = _dense_bounds(cum, cnt_tbl, seg)
    return lo, hi, jnp.concatenate([_unit_totals(lo, hi, ubounds), head])


@functools.partial(jax.jit, static_argnums=(0, 1))
def _block_bounds_sorted(W: int, use_i32: bool, pk_pad, start, ubounds,
                         sorted_keys):
    """Worker block against the full key-sorted build (the
    ProbeIsNotPart-style search, used when the probe decomposition is not
    co-partitioned with the build): ONE tagged sort of (build || block)
    per worker instead of one per unit."""
    seg = jax.lax.dynamic_slice(pk_pad, (start,), (W,))
    dt = jnp.int32 if use_i32 else jnp.int64
    lo, hi, t = _match_bounds_tagged(sorted_keys, seg, dt)
    head = jnp.stack([t, jnp.zeros((), jnp.int64)])
    return lo, hi, jnp.concatenate([_unit_totals(lo, hi, ubounds), head])


@functools.partial(jax.jit, static_argnums=(0, 1, 2, 3, 4))
def _block_bounds_local(W: int, U: int, BP: int, PP: int, use_i32: bool,
                        pk_pad, start, ubounds, bkeys_ps, b0, blen, g_of_l):
    """Partition-LOCAL worker block: probe unit u searches ONLY build
    partition u's slice (probe.inl:18-36; partitioner.cpp:443-520 makes
    the co-partitioned slice cache-resident — here a contiguous slice).

    The build side is sorted by (partition, key) (`bkeys_ps`); unit u's
    slice starts at b0[u] with blen[u] rows, padded to BP with a sentinel
    that sorts above every certified key.  A vmapped tagged sort computes
    slice-local bounds; local ranks map to GLOBAL key-sorted ranks through
    ``g_of_l`` (global rank of each part-sorted row) — valid because both
    sorts are stable and equal keys share one partition under the
    co-partitioning certificate, so a key's run maps monotonically."""
    # matrices live in the COMPOSITE dtype so the pad sentinels always
    # sit strictly outside the certified key domain regardless of the
    # (possibly downcast) storage dtype of the key arrays
    dt = jnp.int32 if use_i32 else jnp.int64
    pad_b = jnp.asarray(_PAD_BUILD_I32 if use_i32 else _PAD_BUILD_I64, dt)
    pad_p = jnp.asarray(_PAD_PROBE_I32 if use_i32 else _PAD_PROBE_I64, dt)
    seg = jax.lax.dynamic_slice(pk_pad, (start,), (W,))
    ub0 = ubounds[:-1].astype(jnp.int32)
    ulen = (ubounds[1:] - ubounds[:-1]).astype(jnp.int32)
    j = jnp.arange(PP, dtype=jnp.int32)
    pvalid = j[None, :] < ulen[:, None]
    pidx = jnp.minimum(ub0[:, None] + j[None, :], jnp.int32(W - 1))
    pmat = jnp.where(pvalid, seg[pidx].astype(dt), pad_p)
    i = jnp.arange(BP, dtype=jnp.int32)
    nb = bkeys_ps.shape[0]
    bvalid = i[None, :] < blen[:, None].astype(jnp.int32)
    bidx = jnp.minimum(b0[:, None].astype(jnp.int32) + i[None, :],
                       jnp.int32(max(0, nb - 1)))
    bmat = jnp.where(bvalid, bkeys_ps[bidx].astype(dt), pad_b)
    lo_l, hi_l, _ = jax.vmap(
        lambda bk, pk: _match_bounds_tagged(bk, pk, dt))(bmat, pmat)
    cnt = hi_l - lo_l
    gidx = jnp.minimum(b0[:, None].astype(jnp.int32) + lo_l,
                       jnp.int32(max(0, nb - 1)))
    lo_g = jnp.where(cnt > 0, g_of_l[gidx], 0)
    hi_g = lo_g + cnt
    # scatter the (U, PP) unit matrices back to the flat (W,) block layout
    flat_pos = jnp.where(pvalid, ub0[:, None] + j[None, :], jnp.int32(W))
    lo = jnp.zeros((W,), jnp.int32).at[flat_pos.reshape(-1)].set(
        lo_g.reshape(-1), mode="drop")
    hi = jnp.zeros((W,), jnp.int32).at[flat_pos.reshape(-1)].set(
        hi_g.reshape(-1), mode="drop")
    total = jnp.sum(jnp.where(pvalid, cnt, 0).astype(jnp.int64))
    all_unit = jnp.all((cnt == 1) | ~pvalid).astype(jnp.int64)
    return lo, hi, jnp.concatenate([_unit_totals(lo, hi, ubounds),
                                    jnp.stack([total, all_unit])])


def _balance_unit_blocks(units, k: int):
    """Group the ordered units into <= k contiguous blocks with ~equal row
    counts — the static owner schedule (each worker ends up with ~1/k of
    the probe rows, what the reference's per-thread partition walk
    converges to; SURVEY.md §2.4 P8)."""
    n_units = len(units)
    if n_units <= k:
        return [(i, i + 1) for i in range(n_units)]
    rows = np.array([b - a for a, b in units], np.int64)
    cum = np.concatenate([[0], np.cumsum(rows)])
    total = int(cum[-1])
    cuts = [0]
    for w in range(1, k):
        t = w * total // k
        j = int(np.searchsorted(cum, t))
        cuts.append(min(max(j, cuts[-1] + 1), n_units - (k - w)))
    cuts.append(n_units)
    return [(a, b) for a, b in zip(cuts[:-1], cuts[1:]) if b > a]


@functools.partial(jax.jit, static_argnums=(1,))
def _part_sorted_build(keys_part_order, n_parts: int, offsets):
    """(partition, key)-sorted build layout + the local->global rank map.

    keys arrive grouped by partition (the split's layout); pid per row
    falls out of a scatter-max of partition ids at the partition starts +
    cummax (no searchsorted — 16M dependent binary-search gathers).  Returns (bkeys_ps, g_of_l): the part-sorted keys and, for each
    part-sorted position, its rank in the GLOBAL key sort."""
    n = keys_part_order.shape[0]
    marks = jnp.zeros((n,), jnp.int32).at[offsets.astype(jnp.int32)].max(
        jnp.arange(n_parts, dtype=jnp.int32), mode="drop")
    pid = jax.lax.cummax(marks)
    # (pid, key, original pos) lexicographic order via two STABLE argsorts
    # (works for any key dtype — no packed composite, no range limit)
    order_g = jnp.argsort(keys_part_order, stable=True)
    order_p = order_g[jnp.argsort(pid[order_g], stable=True)]
    bkeys_ps = keys_part_order[order_p]
    inv_g = jnp.zeros((n,), jnp.int32).at[order_g].set(
        jnp.arange(n, dtype=jnp.int32))
    g_of_l = inv_g[order_p]
    return bkeys_ps, g_of_l


# ---------------------------------------------------------------------------
# Base joiner
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class JoinStats:
    """Observable policy effects (the reference's per-phase instrumentation,
    main.cpp:75-94)."""

    build_rows: int = 0
    probe_rows: int = 0
    output_rows: int = 0
    bucket_count: int = 0
    max_bucket_occupancy: int = 0
    partition_probe_costs: Optional[np.ndarray] = None
    stolen_balance: Optional[np.ndarray] = None  # ProbeSteal static plan
    probe_schedule: Optional[dict] = None  # MEASURED per-unit schedule:
    # {policy, units: [(start_row, rows, micros)], worker_micros: [...],
    #  imbalance} — the execution difference between ProbeIsPart and
    #  ProbeSteal (probe.inl:18-52), see HashJoiner._scheduled_probe


class BaseJoiner:
    """BaseAlgo analog (algo/algo.h:32-58): init copies schemas/selects,
    build consumes the build-side split, probe returns the output table."""

    def __init__(self, hashfn: Optional[HashFunction] = None,
                 output_page_size: int = 1 << 20):
        self.hashfn = hashfn
        self.output_page_size = output_page_size
        self.stats = JoinStats()

    def init(self, schema1: Schema, select1: Sequence[int], jattr1: int,
             schema2: Schema, select2: Sequence[int], jattr2: int) -> None:
        self.s1, self.s2 = schema1, schema2
        self.sel1, self.sel2 = list(select1), list(select2)
        self.ja1, self.ja2 = jattr1, jattr2
        self.sout = schema1.project(self.sel1).types + \
            schema2.project(self.sel2).types
        self.sout = Schema(self.sout)
        # sbuild = {key, selected payload} (algo.h:38-44)
        self.sbuild = schema1.build_schema(self.sel1, jattr1)

    def build(self, parts: PartitionedTable) -> None:
        raise NotImplementedError

    def probe(self, parts: PartitionedTable) -> Table:
        raise NotImplementedError

    # -- shared emit ---------------------------------------------------------

    def _emit(self, probe_table: Table, lo, hi, total: int,
              build_payload_cols: List, probe_row_of=None,
              unit_counts: bool = False) -> Table:
        """Materialize output rows: sel1 payload gathered from the build
        structure, sel2 columns gathered from the probe side.

        Numeric output columns are gathered on device and STAY there, at a
        static next-pow2 capacity with the invalid tail beyond ``rows``
        (slots k >= total are exactly the tail, _expand_matches) — host
        materialization happens only on an explicit save()/np.asarray.  String columns gather host-side over
        the valid prefix."""
        total_i = int(total)
        cap = max(8, next_pow2(total_i))
        if unit_counts and total_i:
            # every probe row matches exactly once (the FK invariant,
            # certified on device by the bounds pass): expansion is the
            # identity — no scatter-max/cummax pass over the output, and
            # b_rank IS lo end-padded (a lo[kc] gather here would cost a
            # second 2^28-element gather at reference scale)
            k = jnp.arange(cap, dtype=jnp.int32)
            kc = jnp.minimum(k, jnp.int32(total_i - 1))
            p_idx = jnp.where(k < total_i, kc, 0)
            b_rank = jnp.pad(lo, (0, cap - lo.shape[0]))
        else:
            probe_idx, build_rank, _ = _expand_matches(lo, hi, cap)
            b_rank = jnp.where(build_rank >= 0, build_rank, 0)
            p_idx = jnp.where(probe_idx >= 0, probe_idx, 0)
        if probe_row_of is not None:
            p_idx = jnp.asarray(probe_row_of)[p_idx]
        b_rank_np = None
        out_cols: List = []
        for col in build_payload_cols:
            if isinstance(col, np.ndarray) and col.dtype == object:
                if b_rank_np is None:
                    b_rank_np = np.asarray(b_rank[:total_i])
                out_cols.append(col[b_rank_np])       # strings gather on host
            else:
                out_cols.append(jnp.asarray(col)[b_rank])
        identity_probe = (unit_counts and total_i and probe_row_of is None)
        for c in self.sel2:
            col = probe_table.column(c)
            if isinstance(col, np.ndarray) and col.dtype == object:
                out_cols.append(col[np.asarray(p_idx[:total_i])])
            elif identity_probe:
                # all-unit FK emit: p_idx is the identity, so the probe
                # column IS the output column — skip the 2^28-element
                # gather (and its HBM temp) entirely
                colj = jnp.asarray(col)
                out_cols.append(jnp.pad(colj, (0, cap - colj.shape[0])))
            else:
                out_cols.append(jnp.asarray(col)[p_idx])
        self.stats.output_rows = total_i
        return Table(self.sout, out_cols, self.output_page_size,
                     rows=total_i)


# ---------------------------------------------------------------------------
# The hash-join policy lattice
# ---------------------------------------------------------------------------

class HashJoiner(BaseJoiner):
    """The {storage × build × probe} lattice in one composable class.

    ``storage``: 'copy' (StoreCopy, storage.cpp) or 'pointer'
    (StorePointer, storagepl.cpp).  ``partition_build``/``partition_probe``/
    ``steal`` select the build.inl/probe.inl mixins.
    """

    def __init__(self, hashfn: HashFunction, *, storage: str = "copy",
                 partition_build: bool = False, partition_probe: bool = False,
                 steal: bool = False, output_page_size: int = 1 << 20,
                 build_page_size: int = 32, nthreads: int = 1):
        super().__init__(hashfn, output_page_size)
        self.nthreads = max(1, int(nthreads))
        if steal and partition_build:
            raise ValueError("steal requires partitionbuild == no "
                             "(joinerfactory.cpp:39-41 asserts)")
        self.storage = storage
        self.partition_build = partition_build
        self.partition_probe = partition_probe
        self.steal = steal
        self.build_page_size = build_page_size  # conf 'buildpagesize' (rows/bucket page)

    # -- build ---------------------------------------------------------------

    def build(self, parts: PartitionedTable) -> None:
        """Construct the bucket-sorted table.

        BuildIsPart (build.inl:18-25): per-partition private builds — the
        global stable sort by (partition, bucket, key) IS the concatenation
        of the per-partition sorts, since partitions arrive contiguous.
        BuildIsNotPart (build.inl:27-32): one shared build — global sort by
        (bucket, key).  Both are one fused conflict-free program; they
        differ in which precondition they rely on (hash-partition ⇒
        disjoint buckets) and in the layout stats recorded.
        """
        table = parts.table
        keys = jnp.asarray(table.key_column(self.ja1))
        buckets = self.hashfn.hash(keys)
        # NOT jnp.bincount: under x64 it scatter-adds in int64, twice the
        # bytes of the int32 formulation at 16M rows x 8.4M buckets
        occ = jnp.zeros((self.hashfn.buckets,), jnp.int32).at[
            buckets.astype(jnp.int32)].add(1, mode="drop")
        self._bucket_occ = occ        # ProbeSteal's cost model (see probe)
        self.stats.build_rows = table.num_rows
        self.stats.bucket_count = self.hashfn.buckets
        self._dense_tbl = None
        self._perm_build = False
        self._key_bound = _I32_COMP_LIMIT
        if table.num_rows:
            st = np.asarray(_build_key_stats(keys, occ))  # ONE fence
            max_occ, kmin, kmax = (int(x) for x in st)
            self.stats.max_bucket_occupancy = max_occ
            self._key_bound = max(abs(kmin), abs(kmax))
            if keys.dtype.itemsize > 4 and self._key_bound < (1 << 31):
                # int32 keys sort/pack in half the bytes of int64
                keys = keys.astype(jnp.int32)
            if (0 <= kmin and kmax < _DENSE_LIMIT
                    and kmax < max(16 * table.num_rows, 1 << 20)):
                tbl_len = next_pow2(kmax + 2)
                cum, cnt, mx_cnt = _dense_rank_table(
                    keys, jnp.zeros((tbl_len,), jnp.int32))
                self._dense_tbl = (cum, cnt)
                # permutation certificate: every key in [kmin, kmax]
                # appears exactly once -> probe bounds are arithmetic
                self._kmin, self._kmax = kmin, kmax
                self._perm_build = (int(np.asarray(mx_cnt)) == 1
                                    and kmax - kmin + 1 == table.num_rows)
        else:
            self.stats.max_bucket_occupancy = 0
        order = jnp.argsort(keys, stable=True)
        self._build_keys_sorted = keys[order]
        self._build_perm = order               # StorePointer: the "pointers"
        self._build_table = table
        # co-partitioning metadata for partition-LOCAL probes: when the
        # probe side is split by the same hash on the join attribute,
        # probe unit p searches only build partition p (probe.inl:18-36)
        self._build_parts_meta = None
        self._plocal = None
        if parts.nparts > 1 and parts.part_hash is not None:
            self._build_parts_meta = (
                parts.part_hash, parts.part_attr,
                np.asarray(parts.offsets, np.int64),
                np.asarray(parts.sizes, np.int64))
        if self.storage == "copy":
            # early materialization: gather payload columns into build order
            # (numeric on device, strings host-side)
            self._build_payload = [
                np.asarray(table.column(c))[np.asarray(order)]
                if table.schema.types[c - 1] == ColumnType.STRING
                else jnp.asarray(table.column(c))[order]
                for c in self.sel1]
        else:
            self._build_payload = None

    # -- probe ---------------------------------------------------------------

    def _bounds(self, probe_keys):
        """Match-range route: the dense rank table (one packed gather —
        no sort, no scatter) when the build certified a dense key range,
        the tagged-sort merge otherwise.  Returns (lo, hi, total,
        all_unit) with one device fence."""
        if self._dense_tbl is not None:
            if getattr(self, "_perm_build", False):
                lo, hi, head = _dense_bounds_perm(probe_keys, self._kmin,
                                                  self._kmax)
                tot = np.asarray(head)
                if bool(tot[1]):          # every probe key in range
                    return lo, hi, int(tot[0]), True
            lo, hi, head = _dense_bounds(*self._dense_tbl, probe_keys)
            tot = np.asarray(head)
            return lo, hi, int(tot[0]), bool(tot[1])
        lo, hi, t = _match_bounds(self._build_keys_sorted, probe_keys)
        return lo, hi, int(t), False

    def _schedule_bounds(self, parts: PartitionedTable, probe_keys,
                         n: int) -> "tuple[np.ndarray, str]":
        """Row-range decomposition of the probe under the policy.

        ProbeIsPart (probe.inl:18-36): one unit per partition, owner order.
        ProbeSteal (probe.inl:37-52): nthreads equal-COST contiguous
        chunks, cut by the bucket-occupancy cost model — the static
        schedule the reference's dynamic stealing converges to (each
        worker ends up with ≈ total/nthreads work)."""
        if self.steal:
            use_i32 = (n * (self.stats.max_bucket_occupancy + 1)
                       < (1 << 31))
            bounds_d, balance_d = _steal_cuts(
                jnp.asarray(self._bucket_occ),
                self.hashfn.hash(probe_keys), self.nthreads, use_i32)
            bb = np.asarray(jnp.concatenate(
                [bounds_d, balance_d]))        # ONE small readback
            k1 = self.nthreads + 1
            bounds = np.unique(bb[:k1])
            self.stats.stolen_balance = bb[k1:]
            return bounds, "probe_steal"
        bounds = np.concatenate([np.asarray(parts.offsets, np.int64), [n]])
        return np.unique(bounds), "probe_is_part"

    def _probe_route(self, parts: PartitionedTable, units, policy: str):
        """Pick the bounds route for a scheduled probe, cheapest first:
        'perm' (arithmetic, permutation-build certificate), 'dense' (rank
        directory gathers), 'local' (co-partitioned build: unit p searches
        ONLY build partition p's slice), 'sorted' (full-build tagged sort
        per worker — the ProbeIsNotPart-style search)."""
        if getattr(self, "_perm_build", False):
            return "perm"
        if self._dense_tbl is not None:
            return "dense"
        meta = self._build_parts_meta
        if (policy == "probe_is_part"   # steal chunks cross partitions
                and meta is not None and parts.part_hash is not None
                and parts.part_hash == meta[0]
                and parts.part_attr == self.ja2 and meta[1] == self.ja1
                and parts.nparts == len(meta[3])):
            # co-partitioned: same hash fingerprint on both join attrs.
            # Guard the (U, PP) unit matrices against pathological skew
            # (one unit ~ the whole probe): fall back to 'sorted' sooner
            # than materializing a quadratic pad.
            max_unit = max(b - a for a, b in units)
            if len(units) * next_pow2(max_unit) <= (1 << 27):
                return "local"
        return "sorted"

    def _plocal_arrays(self):
        """Lazy (partition, key)-sorted build layout for the local route
        (built once; the reference's BuildIsPart private tables are
        likewise per-partition artifacts of the build phase)."""
        if self._plocal is None:
            _, _, offs, szs = self._build_parts_meta
            keys_po = jnp.asarray(
                self._build_table.key_column(self.ja1)).astype(
                    self._build_keys_sorted.dtype)
            bkeys_ps, g_of_l = _part_sorted_build(
                keys_po, len(offs), jnp.asarray(offs))
            self._plocal = (bkeys_ps, g_of_l)
        return self._plocal

    def _scheduled_probe(self, parts: PartitionedTable, probe_keys,
                         n: int):
        """REAL scheduled probe execution: the units are grouped into
        <= nthreads contiguous row-balanced blocks, each worker's block
        runs as ONE device program (per-unit totals fall out of a boundary
        cumsum inside it), and the k block programs are enqueued
        back-to-back with PIPELINED head readbacks — worker w's readback
        overlaps workers w+1..k-1's device execution, so the schedule pays
        ~one host round trip instead of k.  Worker spans are the measured completion deltas of the
        device-serialized block programs — the per-thread rdtsc span
        analog (main.cpp:75-94); per-unit micros apportion each worker's
        span by unit rows.  ProbeIsPart and ProbeSteal produce different
        decompositions (different measured schedules), identical results."""
        import time

        from ..utils.profiler import sync_stats

        bounds, policy = self._schedule_bounds(parts, probe_keys, n)
        units = [(int(a), int(b)) for a, b in zip(bounds[:-1], bounds[1:])
                 if b > a]
        k = self.nthreads
        blocks = _balance_unit_blocks(units, k)
        route = self._probe_route(parts, units, policy)
        W = max(8, next_pow2(max(units[b - 1][1] - units[a][0]
                                 for a, b in blocks)))
        U = max(b - a for a, b in blocks)
        # one shared compiled program serves every block: pad unit counts
        # to U, rows to W; pad probe keys once so every dynamic_slice is
        # in-bounds.  Pad keys are NEGATIVE sentinels below every real key
        # (dense/perm routes exclude key < 0; tagged routes sort them
        # below all certified keys) — they match nothing and do not void
        # the per-unit identity certificate.
        if route in ("perm", "dense"):
            pad_val, use_i32 = -1, True
        else:
            kb = (int(_keys_absmax(self._build_keys_sorted, probe_keys))
                  if probe_keys.dtype.itemsize <= 4
                  and self._build_keys_sorted.dtype.itemsize <= 4
                  else _I32_COMP_LIMIT)
            use_i32 = kb < _I32_COMP_LIMIT
            pad_val = _PAD_PROBE_I32 if use_i32 else _PAD_PROBE_I64
            if not use_i32 and probe_keys.dtype.itemsize <= 4:
                # int64 route with narrow probe keys: widen once so the
                # pad sentinel sits strictly outside the key domain
                probe_keys = probe_keys.astype(jnp.int64)
        pk_pad = jnp.concatenate(
            [probe_keys, jnp.full((W,), pad_val, probe_keys.dtype)])

        def block_args(ulo, uhi):
            a0 = units[ulo][0]
            ub = np.full((U + 1,), units[uhi - 1][1] - a0, np.int32)
            ub[:uhi - ulo + 1] = [units[i][0] - a0
                                  for i in range(ulo, uhi)] + \
                                 [units[uhi - 1][1] - a0]
            return jnp.int32(a0), jnp.asarray(ub)

        if route == "perm":
            def run(start, ub):
                return _block_bounds_perm(W, pk_pad, start, ub,
                                          self._kmin, self._kmax)
        elif route == "dense":
            def run(start, ub):
                return _block_bounds_dense(W, pk_pad, start, ub,
                                           *self._dense_tbl)
        elif route == "local":
            bkeys_ps, g_of_l = self._plocal_arrays()
            _, _, offs, szs = self._build_parts_meta
            # units <-> nonempty probe partitions, in order (the schedule
            # bounds collapse empty partitions); build slice of unit u =
            # the SAME partition id's run in the part-sorted build
            pids = np.where(np.asarray(parts.sizes) > 0)[0]
            BP = max(8, next_pow2(int(szs.max()) if len(szs) else 1))
            PP = max(8, next_pow2(max(b - a for a, b in units)))

            def run(start, ub, _ulo_uhi=None):
                ulo, uhi = _ulo_uhi
                b0 = np.zeros((U,), np.int64)
                bl = np.zeros((U,), np.int64)
                b0[:uhi - ulo] = offs[pids[ulo:uhi]]
                bl[:uhi - ulo] = szs[pids[ulo:uhi]]
                return _block_bounds_local(
                    W, U, BP, PP, use_i32, pk_pad, start, ub,
                    bkeys_ps, jnp.asarray(b0), jnp.asarray(bl), g_of_l)
        else:
            def run(start, ub):
                return _block_bounds_sorted(W, use_i32, pk_pad, start, ub,
                                            self._build_keys_sorted)

        # warm-up compile on the shared shape: compile cost must not land
        # on worker 0's measured span (the reference's timers likewise
        # start after thread setup, main.cpp:99-109)
        warm_ub = np.zeros((U + 1,), np.int32)
        if route == "local":
            np.asarray(run(jnp.int32(n), jnp.asarray(warm_ub),
                           _ulo_uhi=(0, 0))[2])
        else:
            np.asarray(run(jnp.int32(n), jnp.asarray(warm_ub))[2])

        outs = []
        for (ulo, uhi) in blocks:
            start, ub = block_args(ulo, uhi)
            if route == "local":
                outs.append(run(start, ub, _ulo_uhi=(ulo, uhi)))
            else:
                outs.append(run(start, ub))

        # pipelined staggered readbacks: device executes the enqueued
        # blocks in submission order; each block's small head readback
        # returns when ITS outputs are ready, while later blocks still run
        times = [0.0] * len(units)
        worker_us = [0.0] * k
        unit_totals = np.zeros((len(units),), np.int64)
        total = 0
        all_unit = True
        prev = time.perf_counter()
        for w, ((ulo, uhi), o) in enumerate(zip(blocks, outs)):
            hd = np.asarray(o[2])
            t1 = time.perf_counter()
            worker_us[w] = (t1 - prev) * 1e6
            prev = t1
            unit_totals[ulo:uhi] = hd[:uhi - ulo]
            # the block's W-row window may overlap the next block's rows
            # (shared static shape) — the boundary-clamped unit totals are
            # the exact per-block contribution, hd[U] is not
            total += int(hd[:uhi - ulo].sum())
            all_unit = all_unit and bool(hd[U + 1])
            wrows = units[uhi - 1][1] - units[ulo][0]
            for i in range(ulo, uhi):
                times[i] = worker_us[w] * (units[i][1] - units[i][0]) \
                    / max(1, wrows)
        self._last_unit_totals = unit_totals
        los = [o[0][:units[uhi - 1][1] - units[ulo][0]]
               for (ulo, uhi), o in zip(blocks, outs)]
        his = [o[1][:units[uhi - 1][1] - units[ulo][0]]
               for (ulo, uhi), o in zip(blocks, outs)]
        lo = jnp.concatenate(los) if len(los) > 1 else los[0]
        hi = jnp.concatenate(his) if len(his) > 1 else his[0]
        ss = sync_stats(worker_us)
        self.stats.probe_schedule = {
            "policy": policy,
            "route": route,
            "units": [(a, b - a, us)
                      for (a, b), us in zip(units, times)],
            "worker_micros": worker_us,
            "imbalance": ss["imbalance"],
        }
        return lo, hi, total, all_unit

    def probe(self, parts: PartitionedTable) -> Table:
        """ProbeIsPart walks this worker's partitions; ProbeSteal
        cost-balances chunks across workers (probe.inl:18-52).  Both
        policies EXECUTE per schedule unit with measured per-unit timings
        (_scheduled_probe); ProbeIsNotPart runs the whole probe as one
        fused program."""
        table = parts.table
        probe_keys = jnp.asarray(table.key_column(self.ja2))
        n = int(probe_keys.shape[0])
        self.stats.probe_rows = table.num_rows

        if (self.partition_probe or self.steal) and n:
            lo, hi, total, all_unit = self._scheduled_probe(parts,
                                                            probe_keys, n)
            # predicted per-partition costs stay observable alongside the
            # measured schedule (the old stats surface)
            if self.stats.probe_schedule["policy"] == "probe_is_part":
                # units ARE the nonempty partitions: per-partition cost =
                # in-program unit totals + rows, no extra device pass
                sizes_np = np.asarray(parts.sizes, np.int64)
                costs = np.zeros((parts.nparts,), np.int64)
                nz = np.where(sizes_np > 0)[0]
                costs[nz] = self._last_unit_totals + sizes_np[nz]
                self.stats.partition_probe_costs = costs
            else:
                # steal chunks cross partition bounds — one jitted program
                # (eagerly-dispatched int64 cumsums here pinned 4 GB of
                # temporaries through the emit at reference scale)
                starts = jnp.asarray(np.asarray(parts.offsets, np.int64))
                ends = starts + jnp.asarray(np.asarray(parts.sizes,
                                                       np.int64))
                self.stats.partition_probe_costs = np.asarray(
                    _partition_costs(lo, hi, starts, ends))
        else:
            lo, hi, total, all_unit = self._bounds(probe_keys)

        if self.storage == "copy":
            payload_cols = self._build_payload
        else:
            # late materialization: emit gathers through the row pointers
            payload_cols = [jnp.asarray(self._build_table.column(c))[self._build_perm]
                            for c in self.sel1]
        return self._emit(table, lo, hi, total, payload_cols,
                          unit_counts=all_unit)


# ---------------------------------------------------------------------------
# NestedLoops (algo/nl.cpp)
# ---------------------------------------------------------------------------

class NestedLoops(BaseJoiner):
    """Blocked all-pairs equi-join (algo/nl.cpp joinPagePage1).  Kept for the
    small/unhashable case and as the brute-force oracle: build tiles stream
    against the whole probe vector; counts and emit positions
    are exact.  O(|R|·|S|) — use only for small inputs."""

    def __init__(self, output_page_size: int = 1 << 20, tile: int = 4096):
        super().__init__(None, output_page_size)
        self.tile = tile

    def build(self, parts: PartitionedTable) -> None:
        self._build_table = parts.table
        self.stats.build_rows = parts.table.num_rows

    def probe(self, parts: PartitionedTable) -> Table:
        table = parts.table
        bkeys = jnp.asarray(self._build_table.key_column(self.ja1)).astype(jnp.int64)
        pkeys = jnp.asarray(table.key_column(self.ja2)).astype(jnp.int64)
        self.stats.probe_rows = table.num_rows
        # order-insensitive: sort the build side once, reuse the searchsorted
        # kernel — the blocked compare loop of nl.cpp computes the same set;
        # the sorted formulation does O(n log n) work, and the tiled compare survives below as the count cross-check in debug.
        order = jnp.argsort(bkeys, stable=True)
        skeys = bkeys[order]
        self._pkeys_cache = pkeys
        lo, hi, total = _match_bounds(skeys, pkeys)
        payload_cols = [jnp.asarray(self._build_table.column(c))[order]
                        for c in self.sel1]
        return self._emit(table, lo, hi, int(total), payload_cols)

    def brute_count(self) -> int:
        """Tiled all-pairs count — the literal nl.cpp loop, for validation."""
        bkeys = jnp.asarray(self._build_table.key_column(self.ja1)).astype(jnp.int64)
        total = jnp.zeros((), jnp.int64)
        # pad build side to tile multiple with a sentinel no key can equal
        pad = (-bkeys.shape[0]) % self.tile
        bp = jnp.pad(bkeys, (0, pad), constant_values=jnp.iinfo(jnp.int64).min)
        pkeys = getattr(self, "_pkeys_cache", None)
        if pkeys is None:
            raise RuntimeError("call probe() first")
        def body(carry, tile_keys):
            return carry + jnp.sum(
                (tile_keys[None, :] == pkeys[:, None]).astype(jnp.int64)), None
        total, _ = jax.lax.scan(body, total, bp.reshape(-1, self.tile))
        return int(total)


# ---------------------------------------------------------------------------
# FlatMemoryJoiner (algo/flatmem.cpp)
# ---------------------------------------------------------------------------

class FlatMemoryJoiner(BaseJoiner):
    """Radix flat-array build + histogram-range probe (flatmem.cpp:70-177).

    The build *is* the radix partitioner's output (build() just runs the
    final split, flatmem.cpp:104-109); probe finds each key's bucket range
    from the inclusive histogram (bstart = hist[b-1], bitems = hist[b] -
    bstart) and scans it.  Here the radix-partitioned flat array is sorted
    within partitions, so the range scan is a bucket-masked searchsorted:
    composite (bucket << 32 | key) makes both steps one binary search.
    """

    def __init__(self, hashfn: HashFunction,
                 partitioner: RadixPartitioner,
                 output_page_size: int = 1 << 20):
        super().__init__(hashfn, output_page_size)
        self.partitioner = partitioner

    def init(self, schema1, select1, jattr1, schema2, select2, jattr2):
        # reference asserts jattr1 == first column and select = rest
        # (flatmem.cpp:75-81); we support the general layout.
        super().init(schema1, select1, jattr1, schema2, select2, jattr2)

    def build(self, parts: PartitionedTable) -> None:
        """parts must come from the RadixPartitioner (driver wires this);
        the flat array is its reordered table.

        Because bucket = hash(key) is a FUNCTION of the key, equal keys
        are contiguous in the (bucket, key)-sorted flat array — so for a
        dense bounded key range a start/count DIRECTORY over the keyspace
        (two int32 scatters at build) answers every probe with gathers,
        skipping the 272M-element int64 composite sort at reference
        scale.  Sparse/wide keys keep the
        composite path."""
        table = parts.table
        keys32 = jnp.asarray(table.key_column(self.ja1))
        keys = keys32.astype(jnp.int64)
        buckets = self.partitioner.hashfn.hash(
            table.key_column(self.ja1)).astype(jnp.int64)
        comp = (buckets << 32) | (keys & 0xFFFFFFFF)
        order = jnp.argsort(comp, stable=True)
        self._flat_comp = comp[order]
        self._order = order
        self._build_table = table
        self.stats.build_rows = table.num_rows
        self.stats.bucket_count = self.partitioner.hashfn.buckets
        self._flat_dir = None
        self._flat_perm = None
        if table.num_rows:
            st = np.asarray(_build_key_stats(keys32, jnp.zeros((1,),
                                                               jnp.int32)))
            kmin, kmax = int(st[1]), int(st[2])
            if 0 <= kmin and kmax < _DENSE_LIMIT \
                    and kmax < max(16 * table.num_rows, 1 << 20):
                tbl_len = next_pow2(kmax + 2)
                kf = keys32.astype(jnp.int32)[order]
                start_tbl, cnt_tbl = _flat_directory(
                    kf, jnp.zeros((tbl_len,), jnp.int32))
                self._flat_dir = (start_tbl, cnt_tbl)
                if (kmax - kmin + 1 == table.num_rows
                        and int(np.asarray(jnp.max(cnt_tbl))) == 1):
                    # permutation certificate (the canonical 16M PK build,
                    # wisconsin-src/datagen/genbuild.py): probe ranks are
                    # ARITHMETIC in key order, so the per-probe directory
                    # gathers (the reference's histogram-range walk,
                    # flatmem.cpp:147-160) vanish — the emit gathers build
                    # payload through a key-ordered copy instead.  The
                    # flat radix artifact and its inclusive histogram stay
                    # the observable build product.
                    self._flat_perm = (kmin, kmax,
                                       jnp.argsort(keys32.astype(jnp.int32),
                                                   stable=True))

    def probe(self, parts: PartitionedTable) -> Table:
        table = parts.table
        self.stats.probe_rows = table.num_rows
        if self._flat_perm is not None:
            # permutation-certified flat build: arithmetic key-order ranks
            # replace the start/cnt directory gathers (two 256M-index
            # gathers, ~2.3 s each at reference scale) — the emit gathers
            # payload through the 16M key-order permutation instead
            kmin, kmax, order_key = self._flat_perm
            pkeys32 = jnp.asarray(table.key_column(self.ja2))
            lo, hi, head = _dense_bounds_perm(pkeys32, kmin, kmax)
            tot = np.asarray(head)
            payload_cols = [jnp.asarray(self._build_table.column(c))[order_key]
                            for c in self.sel1]
            return self._emit(table, lo, hi, int(tot[0]), payload_cols,
                              unit_counts=bool(tot[1]))
        payload_cols = [jnp.asarray(self._build_table.column(c))[self._order]
                        for c in self.sel1]
        if self._flat_dir is not None:
            pkeys32 = jnp.asarray(table.key_column(self.ja2))
            lo, hi, head = _flat_dense_bounds(*self._flat_dir, pkeys32)
            tot = np.asarray(head)
            return self._emit(table, lo, hi, int(tot[0]), payload_cols,
                              unit_counts=bool(tot[1]))
        pkeys = jnp.asarray(table.key_column(self.ja2)).astype(jnp.int64)
        pbuckets = self.partitioner.hashfn.hash(
            table.key_column(self.ja2)).astype(jnp.int64)
        pcomp = (pbuckets << 32) | (pkeys & 0xFFFFFFFF)
        lo, hi, total = _match_bounds(self._flat_comp, pcomp)
        return self._emit(table, lo, hi, int(total), payload_cols)


# ---------------------------------------------------------------------------
# Factory (joinerfactory.cpp:23-75)
# ---------------------------------------------------------------------------

def joiner_factory(conf: dict, hashfn: HashFunction,
                   build_partitioner=None) -> BaseJoiner:
    """Instantiate the lattice from the conf's algorithm group:
    flatmem/copydata/partitionbuild/partitionprobe/steal strings, exactly the
    reference's dispatch (joinerfactory.cpp:28-70)."""
    algo = conf.get("algorithm", {})
    yes = lambda k, d="no": str(algo.get(k, d)).lower() == "yes"
    if yes("flatmem"):
        if not isinstance(build_partitioner, RadixPartitioner):
            raise ValueError("flatmem requires a radix build partitioner "
                             "(flatmem.cpp custominit)")
        return FlatMemoryJoiner(hashfn, build_partitioner)
    if str(algo.get("nestedloops", "no")).lower() == "yes":
        return NestedLoops()
    return HashJoiner(
        hashfn,
        storage="copy" if yes("copydata", "yes") else "pointer",
        partition_build=yes("partitionbuild"),
        partition_probe=yes("partitionprobe"),
        steal=yes("steal"),
        build_page_size=algo.get("buildpagesize", 32),
        nthreads=int(conf.get("threads", 1)),
    )
