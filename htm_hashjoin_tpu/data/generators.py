"""Synthetic relation generators.

Re-expresses the reference's three generator stacks —
`generate_data` (include/DataGen.hpp:26-122), the mc generator
(mc/src/generator.c:240-538 + genzipf.c:97-158) and Wisconsin's
`WriteTable::generate` (mc/wisconsin-src/table.cpp:206-233) — as seeded JAX
programs.  The reference used libc `rand()` with `srand(0)`
(DataGen.hpp:27); bit-exact replication of libc streams is explicitly NOT a
goal (SURVEY.md §7 hard part (c)).  Instead we fix the *invariants* the
reference's validation relies on:

  * pk/sorted/shuffle/local_shuffle relations are exact permutations of 1..N
    (so inputSum == N(N+1)/2 and PK⋈self match count == N),
  * local_shuffle displaces each element at most `window` positions
    (the locality knob — DataGen.hpp:96-115, generator.c:95-110),
  * fk_from_pk emits every PK key floor(S/R) or ceil(S/R) times
    (generator.c:458-491), so match count == s_size exactly,
  * zipf draws from a permuted alphabet via CDF inversion (genzipf.c:97-158),
  * determinism under a fixed integer seed (jax.random, threefry).

All generators are jittable and produce int32 keys >= 1.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp

from ..config import Distribution, JoinConfig
from ..relation import KEY_DTYPE, Relation


def _key(seed, *salts: int) -> jax.Array:
    """PRNG key from a (possibly traced) seed — traced seeds keep grid
    sweeps on one compiled program per shape."""
    k = jax.random.PRNGKey(seed)
    for s in salts:
        k = jax.random.fold_in(k, s)
    return k


# ---------------------------------------------------------------------------
# Core distributions (DataGen.hpp dispatch table, :30-115)
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnums=(0,))
def sorted_keys(n: int) -> jax.Array:
    """1..N in order (DataGen.hpp:78-85)."""
    return jnp.arange(1, n + 1, dtype=KEY_DTYPE)


@functools.partial(jax.jit, static_argnums=(0,))
def shuffled_keys(n: int, seed: int = 0) -> jax.Array:
    """1..N globally permuted (DataGen.hpp:86-95: random_shuffle)."""
    return jax.random.permutation(_key(seed, 1), sorted_keys(n))


# Quantized block sizes for the two-phase blocked stable sort below: only a
# handful of distinct jit programs exist per shape, no matter how many window
# values a grid sweeps.
_JITTER_BLOCKS = (256, 2048, 16384)


def _jitter_block(window: int, n: int) -> Optional[int]:
    for c in _JITTER_BLOCKS:
        if 2 * window <= c < n:
            return c
    return None


@functools.partial(jax.jit, static_argnames=("salt", "block"))
def _jitter_sort(vals: jax.Array, window, seed, *, salt: int,
                 block: Optional[int]) -> jax.Array:
    """Stably sort vals by rank = position + U[0, window) — the bounded-window
    local shuffle (displacement ≤ window).  window and seed are traced, so one
    compile covers a whole window sweep.

    When ``block`` is set, the global stable sort is computed as two batched
    size-`block` stable sorts at offset block/2 — exact (bit-identical to the
    global sort) because every element's displacement from its final position
    is < window ≤ block/2, and does less work than a full-length
    sort_key_val."""
    n = vals.shape[0]
    jitter = jax.random.randint(_key(seed, salt), (n,), 0,
                                jnp.asarray(window, jnp.int32),
                                dtype=jnp.int32)
    rank = jnp.arange(n, dtype=jnp.int32) + jitter
    if block is None:
        return jax.lax.sort_key_val(rank, vals, is_stable=True)[1]

    hi = jnp.iinfo(jnp.int32).max

    def phase(r, v, off):
        if off:
            r = jnp.concatenate([jnp.full((off,), jnp.int32(-1)), r])
            v = jnp.concatenate([jnp.zeros((off,), v.dtype), v])
        pad = (-r.shape[0]) % block
        if pad:
            r = jnp.concatenate([r, jnp.full((pad,), hi, jnp.int32)])
            v = jnp.concatenate([v, jnp.zeros((pad,), v.dtype)])
        r2, v2 = jax.lax.sort_key_val(r.reshape(-1, block),
                                      v.reshape(-1, block),
                                      dimension=1, is_stable=True)
        return r2.reshape(-1), v2.reshape(-1)

    r1, v1 = phase(rank, vals, 0)
    _, v2 = phase(r1, v1, block // 2)
    return v2[block // 2: block // 2 + n]


def local_shuffled_keys(n: int, window: int, seed: int) -> jax.Array:
    """1..N with bounded-window displacement — the locality axis of the whole
    study (DataGen.hpp:96-115: per-position swap within `local_shuffle_range`).

    Data-parallel formulation: sort positions by `i + U[0, window)` jitter.  Each
    element moves at most `window` slots, preserving the reference's locality
    radius while remaining a fused (blocked) sort instead of a serial swap
    loop."""
    keys = sorted_keys(n)
    if window <= 1:
        return keys
    return _jitter_sort(keys, window, seed, salt=2,
                        block=_jitter_block(window, n))


@functools.partial(jax.jit, static_argnums=(0,))
def _uniform_vals(n: int, distinct, seed) -> jax.Array:
    vals = jax.random.randint(_key(seed, 3), (n,), 1,
                              jnp.asarray(distinct, KEY_DTYPE) + 1,
                              dtype=KEY_DTYPE)
    return jnp.sort(vals)


def uniform_keys(n: int, distinct: int, window: int, seed: int) -> jax.Array:
    """rand into [1, distinct], sorted, then local-window shuffle
    (DataGen.hpp:30-54)."""
    vals = _uniform_vals(n, distinct, seed)
    if window <= 1:
        return vals
    return _jitter_sort(vals, window, seed, salt=4,
                        block=_jitter_block(window, n))


@functools.partial(jax.jit, static_argnums=(0,))
def _random_vals(n: int, seed) -> jax.Array:
    vals = jax.random.randint(_key(seed, 5), (n,), 1,
                              jnp.iinfo(jnp.int32).max, dtype=KEY_DTYPE)
    return jnp.sort(vals)


def random_keys(n: int, window: int, seed: int) -> jax.Array:
    """Full-positive-range rand, sorted, local shuffle (DataGen.hpp:55-71)."""
    vals = _random_vals(n, seed)
    if window <= 1:
        return vals
    return _jitter_sort(vals, window, seed, salt=6,
                        block=_jitter_block(window, n))


# ---------------------------------------------------------------------------
# mc-generator relations (mc/src/generator.c)
# ---------------------------------------------------------------------------

def pk_keys(n: int, seed: int) -> jax.Array:
    """Primary-key relation: 1..N Knuth-shuffled (generator.c:240-260)."""
    return shuffled_keys(n, seed)


def pk_lshuffle_keys(n: int, window: int, seed: int) -> jax.Array:
    """This fork's addition: PK with windowed local shuffle
    (generator.c:262-282)."""
    return local_shuffled_keys(n, window, seed)


@functools.partial(jax.jit, static_argnums=(1,))
def fk_from_relation(r_keys: jax.Array, s_size: int, seed) -> jax.Array:
    """Foreign keys drawn from an ACTUAL build relation's keys
    (create_relation_fk_from_pk, mc/src/generator.c:458-491): every R tuple's
    key appears floor or ceil of s_size/|R| times, shuffled.  Required when R
    is not a 1..N permutation (mc --full-range builds, main.c:393-395)."""
    reps = -(-s_size // r_keys.shape[0])
    tiled = jnp.tile(r_keys, reps)[:s_size]
    return jax.random.permutation(_key(seed, 7), tiled)


@functools.partial(jax.jit, static_argnums=(0, 1))
def fk_from_pk_keys(s_size: int, r_size: int, seed: int) -> jax.Array:
    """Foreign keys drawn by tiling the PK domain then shuffling
    (generator.c:458-491): every key 1..r_size appears floor or ceil of
    s_size/r_size times → PK⋈FK match count is exactly s_size."""
    reps = -(-s_size // r_size)  # ceil
    tiled = jnp.tile(jnp.arange(1, r_size + 1, dtype=KEY_DTYPE), reps)[:s_size]
    return jax.random.permutation(_key(seed, 7), tiled)


@functools.partial(jax.jit, static_argnums=(0,))
def nonunique_keys(n: int, max_key: int, seed: int) -> jax.Array:
    """Random keys with duplicates (generator.c:493-509)."""
    return jax.random.randint(_key(seed, 8), (n,), 1, max_key + 1, dtype=KEY_DTYPE)


@functools.lru_cache(maxsize=64)
def _zipf_constants(alphabet_size: int, theta: float):
    """Host-side f64 normalization scalars for the closed-form inversion.
    Partial zeta computed in chunks (no 1 GB temporary)."""
    import numpy as np
    zeta_n = 0.0
    step = 1 << 22
    for lo in range(1, alphabet_size + 1, step):
        r = np.arange(lo, min(lo + step, alphabet_size + 1), dtype=np.float64)
        zeta_n += float(np.sum(r ** -theta))
    zeta2 = 1.0 + 0.5 ** theta
    alpha = 1.0 / (1.0 - theta) if theta != 1.0 else 0.0
    eta = ((1.0 - (2.0 / alphabet_size) ** (1.0 - theta)) /
           (1.0 - zeta2 / zeta_n)) if theta != 1.0 else 0.0
    return zeta_n, zeta2, alpha, eta


@functools.partial(jax.jit, static_argnums=(0, 1, 2))
def _zipf_ranks(n: int, alphabet_size: int, theta: float,
                seed: int) -> jax.Array:
    """Zipf(theta) rank draws via the closed-form CDF inversion (the
    Gray/Jim-Gray SetQueryGen formula also used by YCSB's
    ZipfianGenerator) — all-f32 elementwise on device.  The exact
    table-lookup inversion of genzipf.c:97-158 needs an f64 2^27-entry
    CDF + per-draw binary search, slow in f64 on a device; the closed form matches it to ~1e-3 relative
    frequency, which the join-side oracles never observe (every draw
    is in the alphabet, so match counts are identical)."""
    zeta_n, zeta2, alpha, eta = _zipf_constants(alphabet_size, theta)
    u = jax.random.uniform(_key(seed, 9), (n,), dtype=jnp.float32)
    u = jnp.clip(u, 1e-7, 1.0 - 1e-7)
    uz = u * zeta_n
    cont = jnp.floor(alphabet_size *
                     (eta * u - eta + 1.0) ** alpha).astype(jnp.int32) + 1
    rank = jnp.where(uz < 1.0, 1, jnp.where(uz < zeta2, 2, cont))
    return jnp.clip(rank, 1, alphabet_size)


def zipf_keys(n: int, alphabet_size: int, theta: float, seed: int) -> jax.Array:
    """Zipf(theta) over a permuted alphabet (genzipf.c:97-158: the
    reference permutes its alphabet so hot keys are not the small ints).
    Ranks via closed-form inversion (_zipf_ranks), then one gather
    through a device-side random permutation of 1..alphabet_size."""
    ranks = _zipf_ranks(n, alphabet_size, float(theta), seed)
    alphabet = jax.random.permutation(
        _key(seed, 10), jnp.arange(1, alphabet_size + 1, dtype=KEY_DTYPE))
    return alphabet[ranks - 1]


# ---------------------------------------------------------------------------
# Dispatch (DataGen.hpp:26 generate_data / main.cpp:89-97 relation setup)
# ---------------------------------------------------------------------------

def generate_keys(dist: Distribution, n: int, *, distinct: Optional[int] = None,
                  window: int = 16, seed: int = 0, r_size: Optional[int] = None,
                  zipf_param: float = 0.75) -> jax.Array:
    """generate_data(dist, size, distinct_keys, local_shuffle_range) analog
    (DataGen.hpp:26)."""
    if dist == Distribution.SORTED:
        return sorted_keys(n)
    if dist == Distribution.SHUFFLE:
        return shuffled_keys(n, seed)
    if dist == Distribution.LOCAL_SHUFFLE:
        return local_shuffled_keys(n, window, seed)
    if dist == Distribution.UNIFORM:
        return uniform_keys(n, distinct or n, window, seed)
    if dist == Distribution.RANDOM:
        return random_keys(n, window, seed)
    if dist == Distribution.ZIPF:
        return zipf_keys(n, distinct or n, zipf_param, seed)
    if dist == Distribution.PK:
        return pk_keys(n, seed)
    if dist == Distribution.PK_LSHUFFLE:
        return pk_lshuffle_keys(n, window, seed)
    if dist == Distribution.FK:
        return fk_from_pk_keys(n, r_size or n, seed)
    if dist == Distribution.NONUNIQUE:
        return nonunique_keys(n, distinct or n, seed)
    raise ValueError(f"unknown distribution {dist}")


def build_relations(cfg: JoinConfig) -> tuple[Relation, Relation]:
    """Construct (R, S) per the driver's rules (main.cpp:89-97): S is `sorted`
    unless the distribution is `random`, in which case S is a copy of R.
    ``cfg.s_distr`` overrides the S side (the mc driver's -z zipf probe /
    --non-unique etc., mc/src/main.c:393-412), with the zipf/fk alphabet
    anchored to the R domain so PK ⋈ S match counts stay exact."""
    r = generate_keys(cfg.data_distr, cfg.r_size, distinct=cfg.distinct_keys,
                      window=cfg.shuffle_range, seed=cfg.seed,
                      zipf_param=cfg.zipf_param)
    s_seed = cfg.s_seed if cfg.s_seed is not None else cfg.seed + 1
    if cfg.s_distr is not None:
        if cfg.s_distr == Distribution.FK:
            # draw from R's ACTUAL keys (fk_from_pk, generator.c:458-491) —
            # required when R itself has duplicates (mc --full-range)
            s_keys = fk_from_relation(r, cfg.s_size, s_seed)
        elif cfg.s_distr == Distribution.NONUNIQUE:
            # mc --non-unique S: maxid anchored to r_size (main.c:398-401)
            s_keys = nonunique_keys(cfg.s_size, cfg.r_size, s_seed)
        else:
            s_keys = generate_keys(cfg.s_distr, cfg.s_size,
                                   distinct=cfg.distinct_keys or cfg.r_size,
                                   window=cfg.shuffle_range, seed=s_seed,
                                   r_size=cfg.r_size,
                                   zipf_param=cfg.zipf_param)
        return Relation(r), Relation(s_keys)
    if cfg.data_distr == Distribution.RANDOM:
        s_keys = r[: cfg.s_size] if cfg.s_size <= cfg.r_size else jnp.resize(r, (cfg.s_size,))
    elif cfg.data_distr in (Distribution.ZIPF, Distribution.FK):
        s_keys = fk_from_pk_keys(cfg.s_size, cfg.r_size, s_seed)
    else:
        s_keys = sorted_keys(cfg.s_size)
    return Relation(r), Relation(s_keys)
