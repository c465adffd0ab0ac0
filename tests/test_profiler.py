"""Tests for the observability layer (SURVEY.md §5 profiling tiers)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from htm_hashjoin_tpu.utils.profiler import (
    PerfCounters, cost_analysis, shard_work_from_histogram, sync_stats,
    throughput_report, trace)


def test_throughput_report_fields():
    rep = throughput_report(1_000_000, 10_000.0)  # 1M tuples in 10ms
    assert rep["numTuples"] == 1_000_000
    assert rep["nsPerTuple"] == pytest.approx(10.0)
    assert rep["tuplesPerSecond"] == pytest.approx(1e8)


def test_cost_analysis_reports_flops():
    def f(a, b):
        return a @ b
    x = jnp.ones((128, 128), jnp.float32)
    ca = cost_analysis(f, x, x)
    assert ca.get("flops", 0) >= 2 * 128**3 * 0.9


def test_perf_counters_defaults_and_derived():
    def f(a):
        return jnp.sum(a * 2.0)
    x = jnp.ones((1 << 16,), jnp.float32)
    pc = PerfCounters()
    out = pc.measure(f, x, micros=100.0)
    assert set(out) == {"flops", "bytes", "intensity", "bandwidth"}
    assert out["bytes"] > 0
    assert out["bandwidth"] > 0  # bytes / 100µs


def test_perf_counters_from_config(tmp_path):
    cfg = tmp_path / "events.cfg"
    cfg.write_text("# comment\nmyflops=flops\nai=arithmetic_intensity\n")
    pc = PerfCounters.from_config(str(cfg))
    out = pc.measure(lambda a: a @ a, jnp.ones((64, 64)))
    assert set(out) == {"myflops", "ai"}
    assert out["myflops"] > 0


def test_shipped_profiler_cfg_loads():
    path = os.path.join(os.path.dirname(__file__), "..",
                        "htm_hashjoin_tpu", "utils", "profiler.cfg")
    pc = PerfCounters.from_config(path)
    assert set(pc.events) == {"flops", "bytes", "intensity", "bandwidth"}


def test_sync_stats_imbalance():
    # one hot shard: everyone else waits for it
    s = sync_stats([100, 10, 10, 10])
    assert s["criticalShard"] == 0
    assert s["waits"] == [0.0, 90.0, 90.0, 90.0]
    assert s["imbalance"] == pytest.approx(270 / 400)
    # perfectly balanced: zero waits
    s = sync_stats([50, 50])
    assert s["imbalance"] == 0.0
    assert sync_stats([])["imbalance"] == 0.0


def test_shard_work_from_histogram():
    hist = np.array([5, 1, 1, 1, 5, 1, 1, 1])  # partitions 0,4 heavy
    w = shard_work_from_histogram(hist, 4)
    assert list(w) == [10, 2, 2, 2]  # p%4 assignment folds both onto shard 0
    # non-divisible histogram pads with zeros
    w = shard_work_from_histogram(np.array([3, 3, 3]), 2)
    assert w.sum() == 9


def test_trace_writes_profile(tmp_path):
    d = str(tmp_path / "prof")
    with trace(d):
        jax.block_until_ready(jnp.arange(1024) * 2)
    found = []
    for root, _, files in os.walk(d):
        found += files
    assert found, "profiler trace produced no files"


def test_cli_throughput_flag(capsys):
    from htm_hashjoin_tpu.cli import main
    main(["--algo", "nocc", "--rSize", "4096", "--dataDistr", "sorted",
          "--throughput"])
    out = capsys.readouterr().out.strip().split("\n")
    assert len(out) == 2
    import json
    rep = json.loads(out[1])
    assert rep["numTuples"] == 8192  # build + probe tuples
    assert rep["tuplesPerSecond"] > 0


def test_cli_counters_flag(capsys):
    """--counters: per-phase PCM-analog dumps in the JSON line (the
    reference's PCM start/stop around build and probe,
    no_partitioning_join.c:458-527)."""
    import json

    from htm_hashjoin_tpu.cli import main
    from htm_hashjoin_tpu.utils.profiler import disable_counters

    try:
        main(["--algo", "nocc", "--rSize", "4096", "--dataDistr", "sorted",
              "--counters"])
        out = capsys.readouterr().out.strip().split("\n")
        line = json.loads(out[0])
        assert "counters" in line, line.keys()
        phases = line["counters"]
        assert "build" in phases
        for ph, ev in phases.items():
            assert set(ev) == {"flops", "bytes", "intensity", "bandwidth"}
            # plausibility: a 4096-tuple build touches at least its input
            assert ev["bytes"] >= 4096 * 4 or ev["flops"] > 0, (ph, ev)
    finally:
        disable_counters()


def test_counters_config_file(tmp_path, capsys):
    """pcm.cfg-shaped event files program the counter set
    (perf_counters.c:78-104)."""
    import json

    from htm_hashjoin_tpu.cli import main
    from htm_hashjoin_tpu.utils.profiler import disable_counters

    cfg = tmp_path / "pcm.cfg"
    cfg.write_text("# device events\nmem_bytes=bytes accessed\nai=arithmetic_intensity\n")
    try:
        main(["--algo", "atomic", "--rSize", "4096", "--dataDistr", "sorted",
              "--counters", str(cfg)])
        line = json.loads(capsys.readouterr().out.strip().split("\n")[0])
        assert "counters" in line
        for ev in line["counters"].values():
            assert set(ev) == {"mem_bytes", "ai"}
    finally:
        disable_counters()


def test_probing_join_counts_build_and_probe_phases():
    """A probing join records cost-analysis counters for both the build and
    the probe phase (PCM start/stop around each, no_partitioning_join.c:
    458-527)."""
    from htm_hashjoin_tpu.config import Algo, Distribution, JoinConfig
    from htm_hashjoin_tpu.data.generators import build_relations
    from htm_hashjoin_tpu.joins.atomic import atomic_join
    from htm_hashjoin_tpu.utils.profiler import disable_counters, enable_counters

    n = 1 << 13
    cfg = JoinConfig(algo=Algo.ATOMIC, r_size=n,
                     data_distr=Distribution.SHUFFLE)
    r, s = build_relations(cfg)
    try:
        enable_counters()
        m = atomic_join(r, s, cfg)
    finally:
        disable_counters()
    c = m.extra["counters"]
    assert set(c) >= {"build", "probe"}
    # the build reads R and writes a 2n-slot table; the probe reads S
    assert c["build"]["bytes"] >= 4 * n
    assert c["probe"]["bytes"] >= 4 * n
    assert c["build"]["bandwidth"] > 0


def test_build_only_counts_build_phase():
    from htm_hashjoin_tpu.config import Algo, Distribution, JoinConfig
    from htm_hashjoin_tpu.data.generators import build_relations
    from htm_hashjoin_tpu.joins.htm import htm_join
    from htm_hashjoin_tpu.utils.profiler import (disable_counters,
                                                 enable_counters)

    n = 1 << 13
    cfg = JoinConfig(algo=Algo.HTM, r_size=n,
                     data_distr=Distribution.SORTED, enable_probe=False)
    r, _ = build_relations(cfg)
    try:
        enable_counters()
        m = htm_join(r, None, cfg)
    finally:
        disable_counters()
    c = m.extra["counters"]
    assert "build" in c and "probe" not in c
    assert c["build"]["bytes"] >= 4 * n
