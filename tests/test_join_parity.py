"""Every algorithm against the host reference join.

One XLA formulation per algorithm serves every probe-side and locality shape
the drivers generate: unsorted and duplicate-heavy probe sides (the mc
driver's -z / --non-unique / fk relations), build-only runs, presorted
inputs, and locality windows on both sides of every size the planner used
to branch on.  Each result is held to utils/validate.reference_match_count
on the very arrays the join ran on, and to the conservation checksums.
"""

import json

import pytest

from htm_hashjoin_tpu.config import Algo, Distribution, JoinConfig
from htm_hashjoin_tpu.data.generators import build_relations
from htm_hashjoin_tpu.joins import DISPATCH
from htm_hashjoin_tpu.utils.validate import reference_match_count

N = 1 << 12
ALGOS = ["htm", "atomic", "nocc", "radix", "sortmerge", "npo", "npo_st",
         "adaptive"]

# name -> JoinConfig fields (R = build side, S = probe side)
SCENARIOS = {
    # mc -z: PK build probed by zipf foreign keys (unsorted, skewed S)
    "zipf_s": dict(data_distr=Distribution.PK, s_distr=Distribution.ZIPF,
                   zipf_param=1.0),
    # mc --non-unique probe side: duplicate-heavy, unsorted S
    "nonunique_s": dict(data_distr=Distribution.PK,
                        s_distr=Distribution.NONUNIQUE),
    # fk S four times larger than R: every key repeats in S
    "fk_s_larger": dict(data_distr=Distribution.PK, s_distr=Distribution.FK,
                        s_size=4 * N),
    # duplicate build keys against the sorted S
    "uniform_r": dict(data_distr=Distribution.UNIFORM, distinct_keys=N // 4),
    # presorted build side
    "sorted_r": dict(data_distr=Distribution.SORTED),
    # locality windows around the old optimistic-sorter reach (512) and
    # tile size (65536 > N: a global shuffle in effect)
    "window_512": dict(data_distr=Distribution.LOCAL_SHUFFLE,
                       shuffle_range=512),
    "window_1024": dict(data_distr=Distribution.LOCAL_SHUFFLE,
                        shuffle_range=1024),
    "window_65536": dict(data_distr=Distribution.LOCAL_SHUFFLE,
                         shuffle_range=65536),
}

BUILD_ONLY_DISTS = {
    "sorted": dict(data_distr=Distribution.SORTED),
    "local_shuffle": dict(data_distr=Distribution.LOCAL_SHUFFLE,
                          shuffle_range=16),
    "shuffle": dict(data_distr=Distribution.SHUFFLE),
    "uniform": dict(data_distr=Distribution.UNIFORM, distinct_keys=N // 4),
}

_UNIQUE_R = {Distribution.PK, Distribution.SORTED, Distribution.SHUFFLE,
             Distribution.LOCAL_SHUFFLE}


def _run(algo, **kw):
    cfg = JoinConfig(algo=Algo(algo), r_size=N, **kw)
    r, s = build_relations(cfg)
    return DISPATCH[algo](r, s, cfg), r, s, cfg


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize("algo", ALGOS)
def test_matches_reference(algo, scenario):
    m, r, s, cfg = _run(algo, **SCENARIOS[scenario])
    want = reference_match_count(r.keys, s.keys)
    if algo == "nocc" and cfg.data_distr not in _UNIQUE_R:
        # the racy build loses colliding duplicates by design; its probe
        # scans the table only, so lost tuples are missing from the count
        assert m.totalMatches <= want and m.outputSum < m.inputSum
        return
    assert m.totalMatches == want, (algo, scenario)
    assert m.inputSum == m.outputSum, (algo, scenario)


@pytest.mark.parametrize("dist", sorted(BUILD_ONLY_DISTS))
@pytest.mark.parametrize("algo", ALGOS)
def test_build_only_conserves(algo, dist):
    kw = BUILD_ONLY_DISTS[dist]
    m, r, _, cfg = _run(algo, enable_probe=False, **kw)
    assert m.totalMatches is None
    assert m.probeTimeInMicroseconds is None
    assert m.inputSum == int(r.keys.astype("int64").sum())
    if algo == "nocc" and cfg.data_distr not in _UNIQUE_R:
        assert m.outputSum < m.inputSum
    else:
        assert m.outputSum == m.inputSum, (algo, dist)


def test_cli_mc_algo_aliases(capsys):
    """mc driver names (PRO/RJ/PRH/PRHO/NPO/NPO_st, mc/src/main.c:292-301)
    are accepted and dispatch to the equivalent algorithm."""
    from htm_hashjoin_tpu.cli import main
    main(["--algo", "RJ", "--rSize", str(1 << 12), "--dataDistr", "shuffle"])
    d = json.loads(capsys.readouterr().out.strip().split("\n")[0])
    assert d["algo"] == "radix" and d["totalMatches"] == 1 << 12
