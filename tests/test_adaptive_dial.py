"""HTM_ADAPT transaction-size controller (HTMHashBuild.hpp:204-211): the
per-chunk failure fractions of the optimistic scatter drive the replayed
tSize trace reported as adaptiveTransactionSizeFinal."""

import pytest

from htm_hashjoin_tpu.config import Algo, Distribution, JoinConfig
from htm_hashjoin_tpu.data.generators import build_relations
from htm_hashjoin_tpu.joins.htm import htm_join, simulate_adaptive_tsize

N = 1 << 14


def _run(**kw):
    cfg = JoinConfig(algo=Algo.HTM, r_size=N, adaptive=True, **kw)
    r, s = build_relations(cfg)
    return htm_join(r, s, cfg)


def test_adaptive_grows_tsize_on_locality():
    """Dense unique keys never abort: every chunk doubles tSize."""
    m = _run(data_distr=Distribution.LOCAL_SHUFFLE, shuffle_range=8)
    assert m.totalMatches == N and m.inputSum == m.outputSum
    assert m.extra["adaptiveTransactionSizeFinal"] > 16


def test_adaptive_shrinks_tsize_on_duplicates():
    """Duplicate-heavy keys abort in every chunk: tSize halves."""
    m = _run(data_distr=Distribution.UNIFORM, distinct_keys=N // 16)
    assert m.inputSum == m.outputSum
    assert m.extra["adaptiveTransactionSizeFinal"] < 16


@pytest.mark.parametrize("fracs,t0,want", [
    ([0.0] * 12, 16, [32, 64, 128, 256, 512, 1024, 2048, 4096, 4096, 4096,
                      4096, 4096]),                      # capped at 4096
    ([0.5] * 6, 16, [8, 4, 2, 1, 1, 1]),                 # floored at 1
    ([0.01, 0.003, 0.021, 0.004, 0.020], 16, [16, 32, 16, 16, 16]),
])
def test_controller_thresholds(fracs, t0, want):
    """< 0.004 doubles (cap 4096), > 0.02 halves (floor 1), else holds."""
    assert simulate_adaptive_tsize(fracs, t0) == want


def test_adaptive_off_reports_no_trace():
    cfg = JoinConfig(algo=Algo.HTM, r_size=N,
                     data_distr=Distribution.SHUFFLE)
    r, s = build_relations(cfg)
    assert "adaptiveTransactionSizeFinal" not in htm_join(r, s, cfg).extra
