"""TM_TRACK abort-cause decomposition (VERDICT r1 task 6).

The reference histograms aborts by _XABORT_* status bit
(HTMHashBuild.hpp:134-142) and prints them as "Conflict Reason: ..."
(experiments/old/track_log:2).  The scatter build classifies its failures
into displacement (none: no bounded-displacement assumption), duplicate-alias
(equal keys sharing an optimistic slot) and capacity (claim-round residue
spilled) and emits them alongside chunkFailureFractions.
"""

from htm_hashjoin_tpu.config import Algo, Distribution, JoinConfig
from htm_hashjoin_tpu.data.generators import build_relations
from htm_hashjoin_tpu.joins import htm_join

N = 1 << 13

CAUSES = ("failureCauseDisplacement", "failureCauseDuplicateAlias",
          "failureCauseBandOverflow")


def test_track_causes_unique_keys():
    """Unique local_shuffle keys: no aborts of any cause, and every cause
    field is present."""
    cfg = JoinConfig(algo=Algo.HTM, r_size=N,
                     data_distr=Distribution.LOCAL_SHUFFLE, shuffle_range=4,
                     track=True, enable_probe=False)
    r, s = build_relations(cfg)
    m = htm_join(r, s, cfg)
    for f in CAUSES:
        assert m.extra[f] == 0, f
    assert m.failedTransactions == 0 and m.conflictCount == 0
    assert m.inputSum == m.outputSum


def test_xla_track_causes_duplicates():
    """XLA scatter build on a duplicate-heavy distribution: slot losses are
    duplicate aliases, spilled residue is the capacity analog."""
    cfg = JoinConfig(algo=Algo.HTM, r_size=N, data_distr=Distribution.UNIFORM,
                     distinct_keys=N // 16, track=True)
    r, s = build_relations(cfg)
    m = htm_join(r, s, cfg)
    assert m.extra["failureCauseDisplacement"] == 0
    assert m.extra["failureCauseDuplicateAlias"] == m.failedTransactions
    assert m.extra["failureCauseDuplicateAlias"] > 0
    assert m.extra["failureCauseBandOverflow"] == m.conflictCount


def test_track_json_line_carries_causes():
    cfg = JoinConfig(algo=Algo.HTM, r_size=N, data_distr=Distribution.SORTED,
                     track=True, enable_probe=False)
    r, s = build_relations(cfg)
    import json
    d = json.loads(htm_join(r, s, cfg).to_json_line())
    for f in CAUSES:
        assert f in d
    assert "chunkFailureFractions" in d
