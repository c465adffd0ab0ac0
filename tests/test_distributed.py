"""Distributed-join tests on an 8-virtual-device CPU mesh — the multi-device
capability the single-node reference never had (SURVEY.md §2.5)."""

import jax
import pytest

from htm_hashjoin_tpu.config import Algo, Distribution, JoinConfig
from htm_hashjoin_tpu.data.generators import build_relations
from htm_hashjoin_tpu.joins import DISPATCH
from htm_hashjoin_tpu.parallel.dist_join import distributed_join
from htm_hashjoin_tpu.parallel.mesh import make_mesh
from htm_hashjoin_tpu.utils.validate import reference_match_count

N = 1 << 14

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")


def cfgs(**kw):
    base = dict(algo=Algo.RADIX, r_size=N, mesh_shape=(8,))
    base.update(kw)
    return JoinConfig(**base)


@pytest.mark.parametrize("dist", [Distribution.SORTED, Distribution.SHUFFLE,
                                  Distribution.LOCAL_SHUFFLE])
def test_dist_matches_pk(dist):
    cfg = cfgs(data_distr=dist)
    r, s = build_relations(cfg)
    m = distributed_join(r, s, cfg)
    assert m.totalMatches == N
    assert m.conserved
    assert m.extra["droppedR"] == 0 and m.extra["droppedS"] == 0


def test_dist_equals_single_device():
    """The distributed engine must reproduce the single-device result."""
    cfg = cfgs(data_distr=Distribution.UNIFORM, distinct_keys=N // 2)
    r, s = build_relations(cfg)
    single = DISPATCH["radix"](r, s, cfg)
    multi = distributed_join(r, s, cfg)
    assert multi.totalMatches == single.totalMatches


def test_skew_handling_exact_on_zipf():
    """Heavy hitters: without skew handling OR residual repair the hot
    partition overflows its all_to_all bucket (reported drops); with skew
    handling, counts are exact and no tuple even needs repair
    (BASELINE.json heavy-hitter splitting)."""
    base = dict(data_distr=Distribution.ZIPF, distinct_keys=N // 16,
                zipf_param=1.2)
    cfg_on = cfgs(**base, skew_handling=True)
    r, s = build_relations(cfg_on)
    oracle = reference_match_count(r.keys, s.keys)

    m_off = distributed_join(
        r, s, cfgs(**base, skew_handling=False, residual_repair=False))
    assert m_off.extra["droppedR"] > 0          # the motivating failure
    assert m_off.totalMatches < oracle

    m_on = distributed_join(r, s, cfg_on)
    assert m_on.totalMatches == oracle
    assert m_on.extra["droppedR"] == 0
    assert m_on.extra["hotKeys"] > 0
    assert m_on.conserved


@pytest.mark.parametrize("shape", [(8,), (2, 4)])
def test_residual_repair_exact_on_forced_overflow(shape):
    """Forced bucket overflow (capacity_factor=1.0 + zipf S) must be joined
    EXACTLY by the cooperative repair round — no skew handling, no drops
    (VERDICT r1 #4; mc/src/parallel_radix_join.c:958-1055)."""
    cfg = cfgs(data_distr=Distribution.ZIPF, distinct_keys=N // 16,
               zipf_param=1.2, mesh_shape=shape,
               shuffle_capacity_factor=1.0, skew_handling=False)
    r, s = build_relations(cfg)
    m = distributed_join(r, s, cfg)
    assert m.extra["repairedR"] + m.extra["repairedS"] > 0  # overflow happened
    assert m.extra["droppedR"] == 0 and m.extra["droppedS"] == 0
    assert m.totalMatches == reference_match_count(r.keys, s.keys)
    assert m.conserved


def test_residual_repair_idle_on_benign():
    """With ample capacity the repair round must not fire (repaired == 0)
    and counts stay exact."""
    cfg = cfgs(data_distr=Distribution.SHUFFLE)
    r, s = build_relations(cfg)
    m = distributed_join(r, s, cfg)
    assert m.extra["repairedR"] == 0 and m.extra["repairedS"] == 0
    assert m.totalMatches == N and m.conserved


def test_uneven_size_padding():
    """Relation size not divisible by mesh size: sentinel padding must not
    change counts."""
    cfg = JoinConfig(algo=Algo.RADIX, r_size=N + 13, s_size=N + 7,
                     data_distr=Distribution.SHUFFLE, mesh_shape=(8,))
    r, s = build_relations(cfg)
    m = distributed_join(r, s, cfg)
    assert m.totalMatches == N + 7  # S=1..N+7 all present in R=perm(1..N+13)


# ---------------------------------------------------------------------------
# Hierarchical 2-stage exchange over a ("host", "chip") mesh (SURVEY.md §5:
# host-level pass after the chip-level pass)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 4), (4, 2)])
def test_hierarchical_matches_flat(shape):
    """The two-stage exchange must reproduce the flat all_to_all result
    exactly on every distribution."""
    for dist, kw in [(Distribution.SHUFFLE, {}),
                     (Distribution.UNIFORM, dict(distinct_keys=N // 2))]:
        cfg2 = cfgs(data_distr=dist, mesh_shape=shape, **kw)
        r, s = build_relations(cfg2)
        flat = distributed_join(r, s, cfgs(data_distr=dist, **kw))
        hier = distributed_join(r, s, cfg2)
        assert hier.totalMatches == flat.totalMatches
        assert hier.extra["hierarchical"] and not flat.extra["hierarchical"]
        assert hier.extra["droppedR"] == 0 and hier.extra["droppedS"] == 0
        assert hier.conserved


def test_hierarchical_skew_handling():
    cfg = cfgs(data_distr=Distribution.ZIPF, distinct_keys=N // 16,
               zipf_param=1.2, mesh_shape=(2, 4), skew_handling=True)
    r, s = build_relations(cfg)
    m = distributed_join(r, s, cfg)
    assert m.totalMatches == reference_match_count(r.keys, s.keys)
    assert m.extra["droppedR"] == 0 and m.extra["hotKeys"] > 0


def test_mesh_construction():
    mesh = make_mesh((8,))
    assert mesh.devices.size == 8
    with pytest.raises(ValueError):
        make_mesh((1024,))


# ---------------------------------------------------------------------------
# Device mapping (the cpu-mapping.txt analog, SURVEY.md P12)
# ---------------------------------------------------------------------------

def test_device_mapping_file_controls_order(tmp_path, monkeypatch):
    from htm_hashjoin_tpu.parallel.mesh import (MAPPING_ENV,
                                                load_device_mapping,
                                                make_mesh)
    import jax
    n = len(jax.devices())
    ids = list(range(n))[::-1]  # reverse placement
    p = tmp_path / "device-mapping.txt"
    p.write_text(f"{n} " + " ".join(map(str, ids)) + "\n")
    monkeypatch.setenv(MAPPING_ENV, str(p))
    assert load_device_mapping() == ids
    mesh = make_mesh((n,))
    assert [d.id for d in mesh.devices.flat] == ids


def test_device_mapping_malformed_rejected(tmp_path):
    from htm_hashjoin_tpu.parallel.mesh import load_device_mapping
    p = tmp_path / "bad.txt"
    p.write_text("5 0 1\n")  # claims 5 ids, provides 2
    with pytest.raises(ValueError):
        load_device_mapping(str(p))


def test_no_mapping_default_order(monkeypatch):
    from htm_hashjoin_tpu.parallel.mesh import MAPPING_ENV, make_mesh
    import jax
    monkeypatch.delenv(MAPPING_ENV, raising=False)
    mesh = make_mesh()
    assert [d.id for d in mesh.devices.flat] == [d.id for d in jax.devices()]


def test_hierarchical_custom_axis_names():
    """Regression: the two-stage exchange hardcoded 'host'/'chip' axis
    names; a 2-D mesh with other names crashed at trace time."""
    import numpy as np
    from jax.sharding import Mesh
    devs = np.array(jax.devices()[:8]).reshape(2, 4)
    mesh = Mesh(devs, ("outer", "inner"))
    cfg = JoinConfig(algo=Algo.HTM, r_size=1 << 12,
                     data_distr=Distribution.SHUFFLE)
    r, s = build_relations(cfg)
    m = distributed_join(r, s, cfg, mesh=mesh)
    assert m.totalMatches == 1 << 12
    assert m.inputSum == m.outputSum


def test_hierarchical_repair_covers_stage2_bound():
    """Extreme skew on the 2-D mesh: stage 2's input can reach
    capacity_factor x the shard (the stage-1 receive buffer), so the
    repair buffer is sized from that bound (advisor r2 finding) — the
    repair must stay exact with zero drops even when nearly everything
    funnels to one destination."""
    cfg = cfgs(data_distr=Distribution.ZIPF, distinct_keys=4,  # 4 hot keys
               zipf_param=1.3, mesh_shape=(2, 4),
               shuffle_capacity_factor=1.0, skew_handling=False)
    r, s = build_relations(cfg)
    m = distributed_join(r, s, cfg)
    assert m.extra["repairedR"] + m.extra["repairedS"] > 0
    assert m.extra["droppedR"] == 0 and m.extra["droppedS"] == 0
    assert m.totalMatches == reference_match_count(r.keys, s.keys)
    assert m.conserved
