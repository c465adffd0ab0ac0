"""Relation: the framework's table abstraction.

The reference's relations are flat `uint64_t*` key arrays (include/DataGen.hpp:26)
or `tuple_t {key, payload}` arrays (mc/src/types.h:30-46).  Here we keep a
structure-of-arrays layout — a key vector plus an optional payload vector —
because SoA is what coalesced device-memory streaming wants; the AoS tuple
layout of the reference exists for CPU cache-line locality.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

KEY_DTYPE = jnp.int32
EMPTY = jnp.int32(0)  # keys are always >= 1 (generators emit 1..N), 0 marks empty slots


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class Relation:
    """A join relation: int32 keys (values >= 1) and optional int32 payloads.

    mirrors relation_t (mc/src/types.h:41-46) with row ids implicit.
    """

    keys: jax.Array
    payloads: Optional[jax.Array] = None

    @property
    def num_tuples(self) -> int:
        return int(self.keys.shape[0])

    def key_sum(self) -> int:
        """Exact Σ keys — the `inputSum` conservation oracle
        (HTMHashBuild.hpp:312-320)."""
        return int(jnp.sum(self.keys.astype(jnp.int64)))

    def to_numpy(self) -> np.ndarray:
        return np.asarray(self.keys)

    def fence(self) -> "Relation":
        """Wait until the backing arrays are computed.  Drivers call this
        after generation so the timed join phases exclude generator
        compute, matching the reference's timer placement (gettimeofday
        AFTER generate_data, main.cpp:113-118 vs HTMHashBuild.hpp:93-94) —
        without it JAX async dispatch would bill generation to the build
        phase."""
        jax.block_until_ready((self.keys, self.payloads))
        return self

    def tree_flatten(self):
        return (self.keys, self.payloads), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


def next_pow2(v: int) -> int:
    """Smallest power of two >= v (HTMHashBuild.hpp:25-37 bit-twiddle analog)."""
    if v <= 1:
        return 1
    return 1 << (v - 1).bit_length()
