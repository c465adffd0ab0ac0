"""Unified configuration for the join framework.

The reference spreads configuration over four mechanisms: compile-time macros
(reference config.h:1-18 — ENABLE_PROBE / TM_TRACK / TM_RETRY / HTM_ADAPTIVE /
HTM_SWITCH), CLI flags (reference main.cpp:43-71, mc/src/main.c:492-608),
autotools --enable-* options (mc/configure.ac:43-114) and Wisconsin libconfig
.conf files (mc/wisconsin-src/joinerfactory.cpp:23-75).  Here the union is one
dataclass; every reference knob maps to a field below.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple


class Algo(str, enum.Enum):
    """Join algorithm families (reference main.cpp:99-108, mc/src/main.c:292-301)."""

    HTM = "htm"            # optimistic bucketed build  (HTMHashBuild.hpp:54)
    ATOMIC = "atomic"      # open-addressing linear probe (AtomicHashBuild.hpp:14)
    NOCC = "nocc"          # racy last-writer-wins       (NoCCHashBuild.hpp:13)
    SORTMERGE = "sortmerge"  # partitioned sort + merge  (SortMerge.hpp:5)
    RADIX = "radix"        # parallel radix join / PRO   (mc/src/parallel_radix_join.c:1305)
    NPO = "npo"            # no-partitioning chained-bucket join (mc/src/no_partitioning_join.c:536)
    NPO_ST = "npo_st"      # single-threaded NPO variant (mc/src/no_partitioning_join.c:336-373)
    ADAPTIVE = "adaptive"  # locality-sniffing planner   (HTMHashBuild.hpp:100-154 + config.h HTM_SWITCH)


class Distribution(str, enum.Enum):
    """Synthetic key distributions (reference include/DataGen.hpp:30-115,
    mc/src/generator.c:240-538)."""

    SORTED = "sorted"              # 1..N in order              (DataGen.hpp:78-85)
    SHUFFLE = "shuffle"            # 1..N globally shuffled     (DataGen.hpp:86-95)
    LOCAL_SHUFFLE = "local_shuffle"  # 1..N windowed shuffle    (DataGen.hpp:96-115)
    UNIFORM = "uniform"            # rand in [1,distinct], sorted, local shuffle (DataGen.hpp:30-54)
    RANDOM = "random"              # full-range rand, sorted, local shuffle (DataGen.hpp:55-71)
    ZIPF = "zipf"                  # zipf via permuted-alphabet CDF (mc/src/genzipf.c:97-158)
    PK = "pk"                      # 1..N Knuth-shuffled        (mc/src/generator.c:240-260)
    PK_LSHUFFLE = "pk_lshuffle"    # 1..N windowed local shuffle (mc/src/generator.c:262-282)
    FK = "fk"                      # foreign keys referencing a PK relation (mc/src/generator.c:408-445)
    NONUNIQUE = "nonunique"        # random with duplicates     (mc/src/generator.c:493-509)


@dataclasses.dataclass(frozen=True)
class JoinConfig:
    """One config covering the reference's full parameter surface.

    Defaults follow reference main.cpp:78-85 (algo=htm, rSize=2^28 there; we
    default smaller so CPU tests are fast — benchmarks pass explicit sizes).
    """

    algo: Algo = Algo.HTM
    r_size: int = 1 << 20
    s_size: Optional[int] = None          # defaults to r_size (main.cpp:96: relS mirrors relR)
    transaction_size: int = 16            # --transactionSize: optimistic chunk size analog
    probe_length: int = 4                 # --probeLength: linear-probe budget (AtomicHashBuild.hpp:46)
    data_distr: Distribution = Distribution.SORTED
    shuffle_range: int = 16               # --shuffleRange: locality window (DataGen.hpp:96-115)
    scale_output: int = 2                 # --scaleOutput: table size multiplier (AtomicHashBuild.hpp:21)
    num_partitions: int = 64              # --numPartitions: static parallel ranges (HTMHashBuild.hpp:157)
    distinct_keys: Optional[int] = None   # uniform distribution alphabet size
    seed: int = 0                         # srand(0) analog (DataGen.hpp:27)
    s_seed: Optional[int] = None          # mc --s-seed (mc/src/main.c:337-338; None = seed+1)
    s_distr: Optional[Distribution] = None  # probe-side distribution override
                                          # (mc -z builds a zipf S, main.c:393-412;
                                          #  None = driver rule: sorted / copy-of-R)
    enable_probe: bool = True             # ENABLE_PROBE macro (config.h)
    retry: bool = True                    # TM_RETRY macro: repair failed inserts (HTMHashBuild.hpp:219-238)
    track: bool = False                   # TM_TRACK macro: collision-cause stats (HTMHashBuild.hpp:134-142)
    adaptive: bool = False                # HTM_ADAPTIVE: chunk-size adaptation stats (HTMHashBuild.hpp:204-211)
    switch_sniff: bool = False            # HTM_SWITCH: locality pre-pass (HTMHashBuild.hpp:100-154)

    # Radix engine knobs (mc/src/prj_params.h:15-22,59-64)
    radix_bits: int = 14                  # NUM_RADIX_BITS
    radix_passes: int = 2                 # NUM_PASSES
    skew_handling: bool = False           # --enable-skewhandling
    partition_capacity_factor: float = 2.0  # padded per-partition capacity multiplier

    # Zipf knobs (mc/src/main.c -z flag; genzipf.c)
    zipf_param: float = 0.75

    # Sniff pre-pass shape (HTMHashBuild.hpp:47-52: K=5 rounds of 16384 tuples)
    sniff_rounds: int = 5
    sniff_chunk: int = 16384

    # Distributed execution
    mesh_shape: Tuple[int, ...] = ()      # empty = single device
    shuffle_capacity_factor: float = 2.0  # all_to_all padded bucket slack
    residual_repair: bool = True          # repair bucket overflow (SKEW_HANDLING
                                          # repartition analog, parallel_radix_join.c:958-1055)

    def __post_init__(self):
        if self.s_size is None:
            object.__setattr__(self, "s_size", self.r_size)

    @property
    def chunk_size(self) -> int:
        """Per-chunk failure accounting granularity (HTMHashBuild.hpp:167: 16384)."""
        return self.sniff_chunk
