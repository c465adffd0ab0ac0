"""htm_hashjoin_tpu — an in-memory equi-join framework for GPUs, in JAX.

A from-scratch re-design of the capability surface of the reference
HTM-HashJoin testbed (anilshanbhag/HTM-HashJoin): four families of join
algorithms (optimistic direct-scatter "HTM" build, claim-based linear-probing
"atomic" build, racy last-writer-wins "NoCC" build, sort-merge), a parallel
radix join engine, a Wisconsin-style policy-lattice joiner, synthetic data
generators, a locality-adaptive planner, conservation-checksum validation and
JSON-line metrics — all expressed as conflict-free data-parallel JAX/XLA
programs instead of hardware-transactional-memory / atomics / latches.

Key idea: on a CPU the reference needs HTM transactions (HTMHashBuild.hpp:174-187),
CAS loops (AtomicHashBuild.hpp:43-64) and per-bucket latches
(mc/src/no_partitioning_join.c:383-439) purely to make concurrent scatter safe.
Expressed as whole-array XLA programs, with no shared mutable state between
threads, the same operator surface is reached with:

  * optimistic scatter + gather-back collision detection  (the HTM analog)
  * iterative claim-table insertion                       (the CAS analog)
  * plain last-writer-wins scatter                        (the NoCC analog)
  * radix histogram -> prefix scan -> stable reorder      (the PRJ analog)
  * sorted-merge / partitioned binary search              (probe / sort-merge)

int64 support is required for conservation checksums (sum of 2^27 keys
overflows int32); we enable jax x64 at import time.  All hot-path arrays are
explicitly int32.
"""

import os

import jax

jax.config.update("jax_enable_x64", True)

# Persistent compilation cache.  JAX reads JAX_COMPILATION_CACHE_DIR itself
# when it is set; otherwise the cache lives at a fixed directory of the
# checkout, listed in .gitignore, so that later runs from it find the cache.
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def compile_cache_dir(environ=os.environ):
    """The cache directory this package sets in code: None when
    JAX_COMPILATION_CACHE_DIR is set, else CACHE_DIR."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return CACHE_DIR


if compile_cache_dir() is not None:
    jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

from .version import __version__  # noqa: E402
from .relation import Relation  # noqa: E402
from .config import JoinConfig, Distribution, Algo  # noqa: E402
from .data import generators  # noqa: E402
from .joins import (  # noqa: E402
    nocc_join,
    atomic_join,
    htm_join,
    radix_join,
    sortmerge_join,
    npo_join,
    adaptive_join,
)

__all__ = [
    "__version__",
    "Relation",
    "JoinConfig",
    "Distribution",
    "Algo",
    "generators",
    "nocc_join",
    "atomic_join",
    "htm_join",
    "radix_join",
    "sortmerge_join",
    "npo_join",
    "adaptive_join",
]
