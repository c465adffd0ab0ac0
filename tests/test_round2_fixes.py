"""Round-2 regression tests: advisor findings + housekeeping.

Covers the presorted+track crash (ADVICE r1 medium), the nocc table-only
probe semantics (NoCCHashBuild.hpp:65-80), the nocc/atomic output schema
gating (NoCCHashBuild.hpp:127-146), the mc -n exact mapping
(mc/src/main.c:512-515), the HTM_SWITCH wiring (config.h:16-17), and the
sort-merge phase split (SortMerge.cpp:50-69).
"""

import json

import numpy as np

from htm_hashjoin_tpu.cli import parse_args
from htm_hashjoin_tpu.config import Algo, Distribution, JoinConfig
from htm_hashjoin_tpu.data.generators import build_relations
from htm_hashjoin_tpu.joins import (htm_join, nocc_join, atomic_join,
                                    sortmerge_join)

N = 1 << 13


def test_presorted_track_build_only():
    """track + sorted + build-only: dense unique keys never abort, so every
    chunk's failure fraction is zero."""
    cfg = JoinConfig(algo=Algo.HTM, r_size=N, data_distr=Distribution.SORTED,
                     track=True, enable_probe=False)
    r, s = build_relations(cfg)
    m = htm_join(r, s, cfg)
    assert m.extra["maxChunkFailureFraction"] == 0.0
    assert m.inputSum == m.outputSum


def test_nocc_probe_scans_table_only():
    """NoCC probe counts only table hits (NoCCHashBuild.hpp:65-80): races
    lose tuples SILENTLY (the reference's own logs show conflicts: 0 with
    outputSum < inputSum, AtomicsVsHTMVsNoCC_log1:2) and lost tuples are
    missing from totalMatches."""
    cfg = JoinConfig(algo=Algo.NOCC, r_size=N, data_distr=Distribution.UNIFORM,
                     distinct_keys=N // 64, probe_length=4, scale_output=2)
    r, s = build_relations(cfg)
    m = nocc_join(r, s, cfg)
    # racy last-writer-wins: losses are silent, never spilled
    assert m.to_dict()["conflicts"] == 0
    assert m.outputSum < m.inputSum, "duplicates must race and lose"
    # exact full-join oracle: lost duplicates are missing from the scan count
    rk = np.asarray(r.keys)
    sk = np.asarray(s.keys)
    svals, scnt = np.unique(sk, return_counts=True)
    lookup = dict(zip(svals.tolist(), scnt.tolist()))
    full = sum(lookup.get(int(k), 0) for k in rk)
    assert m.totalMatches < full


def test_nocc_unique_keys_unaffected():
    cfg = JoinConfig(algo=Algo.NOCC, r_size=N, data_distr=Distribution.SHUFFLE)
    r, s = build_relations(cfg)
    m = nocc_join(r, s, cfg)
    assert m.totalMatches == N
    assert m.to_dict()["conflicts"] == 0


def test_schema_gating_nocc_atomic():
    """nocc/atomic emit exactly the reference's fields — no transactionSize,
    no failed-transaction fields (NoCCHashBuild.hpp:127-146)."""
    cfg = JoinConfig(r_size=N, data_distr=Distribution.SHUFFLE)
    r, s = build_relations(cfg)
    for fn, algo in ((nocc_join, "nocc"), (atomic_join, "atomic")):
        d = json.loads(fn(r, s, cfg).to_json_line())
        assert d["algo"] == algo
        for absent in ("transactionSize", "failedTransactions",
                       "failedTransactionPercentage",
                       "totalFailedPercentage", "conflictCount"):
            assert absent not in d, (algo, absent)
        for present in ("probeLength", "hashBuildTimeInMicroseconds",
                        "conflicts", "totalMatches", "inputSum", "outputSum"):
            assert present in d, (algo, present)
    # htm keeps the full surface (HTMHashBuild.hpp:417-449)
    d = json.loads(htm_join(r, s, cfg).to_json_line())
    assert "transactionSize" in d and "failedTransactionPercentage" in d


def test_mc_nthreads_sets_partitions_exactly():
    cfg, _ = parse_args(["-n", "8", "-r", "1024"])
    assert cfg.num_partitions == 8
    cfg, _ = parse_args(["-n", "8", "--numPartitions", "32", "-r", "1024"])
    assert cfg.num_partitions == 32          # explicit flag wins
    cfg, _ = parse_args(["--rSize", "1024"])
    assert cfg.num_partitions == 64          # main.cpp:81 default


def test_switch_sniff_keeps_htm_on_locality():
    cfg = JoinConfig(algo=Algo.HTM, r_size=N,
                     data_distr=Distribution.LOCAL_SHUFFLE, shuffle_range=16,
                     switch_sniff=True)
    r, s = build_relations(cfg)
    m = htm_join(r, s, cfg)
    assert m.algo == "htm"
    assert m.firstRoundFailureFraction is not None
    assert m.firstRoundFailureFraction < 0.004
    assert "switchedToRadix" not in m.extra
    assert m.totalMatches == N


def test_switch_sniff_switches_to_radix_on_duplicates():
    cfg = JoinConfig(algo=Algo.HTM, r_size=N, data_distr=Distribution.UNIFORM,
                     distinct_keys=N // 8, switch_sniff=True)
    r, s = build_relations(cfg)
    m = htm_join(r, s, cfg)
    assert m.algo == "htm"                   # reported as the htm binary
    assert m.extra.get("switchedToRadix") is True
    assert m.firstRoundFailureFraction > 0.004
    assert m.inputSum == m.outputSum


def test_sortmerge_phase_split():
    """sortTime and mergeTime are separate fenced phases that add up to the
    total (SortMerge.cpp:50-69)."""
    cfg = JoinConfig(algo=Algo.SORTMERGE, r_size=N,
                     data_distr=Distribution.SHUFFLE)
    r, s = build_relations(cfg)
    m = sortmerge_join(r, s, cfg)
    assert m.totalMatches == N
    assert m.sortTimeInMicroseconds > 0
    assert m.mergeTimeInMicroseconds > 0
    assert abs(m.hashBuildTimeInMicroseconds
               - m.sortTimeInMicroseconds - m.mergeTimeInMicroseconds) < 1.0
    cfg2 = JoinConfig(algo=Algo.SORTMERGE, r_size=N,
                      data_distr=Distribution.SORTED)
    r2, s2 = build_relations(cfg2)
    m2 = sortmerge_join(r2, s2, cfg2)
    assert m2.totalMatches == N
    assert m2.mergeTimeInMicroseconds > 0


def test_build_only_shuffle_conserves():
    cfg = JoinConfig(algo=Algo.HTM, r_size=N, data_distr=Distribution.SHUFFLE,
                     enable_probe=False)
    r, s = build_relations(cfg)
    m = htm_join(r, s, cfg)
    assert m.inputSum == m.outputSum == N * (N + 1) // 2
    assert m.failedTransactions == 0          # dense unique keys: no aborts
