"""Tests for the Wisconsin multijoin subsystem (SURVEY.md §2.3).

Oracle strategy follows the reference's embedded validation (SURVEY.md §4):
PK⋈FK match counts equal the FK side size exactly, outputs are permutations
of expected rid sets, and every lattice point produces the identical join
result set.
"""

import os
import textwrap

import numpy as np
import pytest

from htm_hashjoin_tpu.wisconsin import (
    DerekPartitioner, FlatMemoryJoiner, HashJoiner, IndependentPartitioner,
    MagicHash, ModuloHash, NestedLoops, NoPartitioner, ParallelPartitioner,
    RadixPartitioner, RangePartitionHash, Schema, Table, WriteTable,
    hash_factory, joiner_factory, parse_conf, parse_conf_string,
    partitioner_factory, run_multijoin,
)

CONF_DIR = os.path.join(os.path.dirname(__file__), "..",
                        "htm_hashjoin_tpu", "wisconsin", "conf")


# ---------------------------------------------------------------------------
# conf parser
# ---------------------------------------------------------------------------

SAMPLE = textwrap.dedent("""
    # comment
    path: "/tmp/x";   // trailing comment
    bucksize: 1048576 ;
    group: {
        inner: { algorithm: "radix"; passes: 2; };
        arr: [1, 16777216];  /* block
                                comment */
        lst: ("long", "long");
        f: 0.75;
        flag: true;
    };
    threads: 8;
""")


def test_conf_parser_subset():
    c = parse_conf_string(SAMPLE)
    assert c["path"] == "/tmp/x"
    assert c["bucksize"] == 1048576
    assert c["group"]["inner"]["algorithm"] == "radix"
    assert c["group"]["inner"]["passes"] == 2
    assert c["group"]["arr"] == [1, 16777216]
    assert c["group"]["lst"] == ["long", "long"]
    assert c["group"]["f"] == 0.75
    assert c["group"]["flag"] is True
    assert c["threads"] == 8


@pytest.mark.parametrize("name", ["no_partition.conf", "radix1.conf",
                                  "steal.conf", "flatmem.conf",
                                  "independent.conf", "parallel.conf"])
def test_shipped_confs_parse(name):
    c = parse_conf(os.path.join(CONF_DIR, name))
    assert c["build"]["schema"] == ["long", "long"]
    assert c["partitioner"]["hash"]["fn"] == "modulo"
    assert c["threads"] == 8


def test_reference_conf_parses_if_available():
    ref = "/root/reference/mc/wisconsin-src/conf/002048_radix1.conf"
    if not os.path.exists(ref):
        pytest.skip("reference not mounted")
    c = parse_conf(ref)
    assert c["partitioner"]["build"]["algorithm"] == "radix"
    assert c["partitioner"]["hash"]["buckets"] == 2048
    assert c["algorithm"]["copydata"] == "yes"


# ---------------------------------------------------------------------------
# hash functions (hash.h:53-113 semantics)
# ---------------------------------------------------------------------------

def test_modulo_hash_semantics():
    h = ModuloHash(1, 16777216, 2048, skipbits=12)
    vals = np.array([1, 4097, 16777216, 12345678], np.int64)
    expect = (((vals - 1) & (2047 << 12)) >> 12)
    assert np.array_equal(np.asarray(h.hash(vals)), expect)
    assert h.buckets == 2048


def test_modulo_hash_rounds_to_pow2():
    assert ModuloHash(0, 100, 1000).buckets == 1024
    assert ModuloHash(0, 100, 1).buckets == 2  # reference: k<=1 -> _k=1


def test_range_hash_semantics():
    h = RangePartitionHash(1, 1024, 4)
    vals = np.arange(1, 1025)
    out = np.asarray(h.hash(vals))
    assert out.min() == 0 and out.max() == 3
    # equal-width ranges
    assert np.array_equal(np.bincount(out), np.full(4, 256))


def test_magic_hash_semantics():
    h = MagicHash(0, 1 << 20, 4096)
    vals = np.array([0b1011010, 12345], np.int64)
    expect = ((((vals >> 2) & ~np.int64(7)) | (vals & 7)) & (h.buckets - 1))
    assert np.array_equal(np.asarray(h.hash(vals)), expect)


def test_modulo_generate_multipass_disjoint_masks():
    """hash.cpp DEBUG assert: per-pass masks disjoint, union == full mask."""
    h = ModuloHash(0, 1 << 24, 1 << 12, skipbits=3)
    for passes in (1, 2, 3, 4):
        fns = h.generate(passes)
        masks = [f._mask for f in fns]
        union = 0
        for m in masks:
            assert union & m == 0
            union |= m
        assert union == h._mask


def test_hash_factory():
    node = {"fn": "modulo", "range": [1, 16777216], "buckets": 2048,
            "skipbits": 12}
    h = hash_factory(node)
    assert isinstance(h, ModuloHash) and h.buckets == 2048
    assert isinstance(hash_factory({"fn": "range", "range": [0, 100],
                                    "buckets": 8}), RangePartitionHash)
    assert isinstance(hash_factory({"fn": "magic", "range": [0, 100],
                                    "buckets": 8}), MagicHash)


# ---------------------------------------------------------------------------
# tables
# ---------------------------------------------------------------------------

def _pk_table(n, seed=1, page_size=256):
    s = Schema.create(("long", "long"))
    wt = WriteTable(s, page_size)
    wt.generate(n, n, 0.0, seed)
    return wt


def test_writetable_generate_pk():
    t = _pk_table(1000)
    keys = np.asarray(t.column(1))
    assert sorted(keys) == list(range(1, 1001))
    assert np.array_equal(np.asarray(t.column(2)), np.arange(1, 1001))


def test_writetable_generate_fk():
    s = Schema.create(("long", "long"))
    wt = WriteTable(s)
    wt.generate(4000, 1000, 0.0, 3)
    keys = np.asarray(wt.column(1))
    counts = np.bincount(keys, minlength=1001)[1:]
    assert counts.sum() == 4000 and counts.min() >= 3 and counts.max() <= 5


def test_writetable_generate_zipf():
    s = Schema.create(("long", "long"))
    wt = WriteTable(s)
    wt.generate(5000, 1000, 0.99, 7)
    keys = np.asarray(wt.column(1))
    assert keys.min() >= 1 and keys.max() <= 1000
    # skew: the hottest key much hotter than uniform expectation (5/key)
    assert np.bincount(keys).max() > 25


def test_table_tbl_roundtrip(tmp_path):
    t = _pk_table(100)
    p = str(tmp_path / "x.tbl")
    t.save(p)
    wt = WriteTable(t.schema)
    wt.load(p)
    assert np.array_equal(np.asarray(wt.column(1)), np.asarray(t.column(1)))
    assert np.array_equal(np.asarray(wt.column(2)), np.asarray(t.column(2)))


def test_table_npz_roundtrip(tmp_path):
    t = _pk_table(100)
    p = str(tmp_path / "x.npz")
    t.save(p)
    wt = WriteTable(t.schema)
    wt.load(p)
    assert np.array_equal(np.asarray(wt.column(1)), np.asarray(t.column(1)))


def test_table_split_round_robin():
    t = _pk_table(1000, page_size=100)  # 10 pages
    parts = t.split(3)
    # pages 0,3,6,9 -> part 0; 1,4,7 -> 1; 2,5,8 -> 2 (table.cpp:238-272)
    assert [len(p) for p in parts] == [400, 300, 300]
    assert parts[0][0] == 0 and parts[1][0] == 100 and parts[2][0] == 200
    assert sorted(np.concatenate(parts)) == list(range(1000))


# ---------------------------------------------------------------------------
# partitioners
# ---------------------------------------------------------------------------

def _check_partitioning(pt, table, hashfn, attribute=1):
    assert pt.sizes.sum() == table.num_rows
    keys = np.asarray(pt.table.column(attribute))
    for p in range(pt.nparts):
        rows = pt.partition_rows(p)
        if len(rows):
            assert np.all(np.asarray(hashfn.hash(keys[rows])) == p)


def test_parallel_partitioner():
    t = _pk_table(2000)
    h = ModuloHash(1, 2000, 16)
    pt = ParallelPartitioner(h).split(t)
    _check_partitioning(pt, t, h)
    # stability: original order preserved within a partition
    perm = pt.perm
    for p in range(pt.nparts):
        rows = pt.partition_rows(p)
        assert np.all(np.diff(perm[rows]) > 0)


def test_independent_partitioner_shard_contiguity():
    t = _pk_table(2000, page_size=250)  # 8 pages over 4 shards
    h = ModuloHash(1, 2000, 8)
    pp = IndependentPartitioner(h, page_size=250, nthreads=4)
    pt = pp.split(t)
    _check_partitioning(pt, t, h)
    # within a partition, source shards appear in order (partitioner.cpp:183-263)
    for p in range(pt.nparts):
        rows = pt.partition_rows(p)
        shards = (pt.perm[rows] // 250) % 4
        assert np.all(np.diff(shards) >= 0)


def test_derek_partitioner_contiguous():
    t = _pk_table(1003)
    pt = DerekPartitioner(nthreads=4).split(t)
    assert list(pt.sizes) == [251, 251, 251, 250]
    assert np.array_equal(pt.perm, np.arange(1003))


def test_radix_partitioner_histogram():
    t = _pk_table(4096)
    h = ModuloHash(1, 4096, 64)
    rp = RadixPartitioner(h, passes=2)
    pt = rp.split(t)
    _check_partitioning(pt, t, h)
    assert rp.histogram is not None
    assert rp.histogram[-1] == 4096  # inclusive histogram (flatmem.cpp probe)


def test_partitioner_factory():
    hash_node = {"fn": "modulo", "range": [1, 4096], "buckets": 64,
                 "skipbits": 0}
    p = partitioner_factory({"algorithm": "radix", "pagesize": 1024,
                             "attribute": 1, "passes": 2}, hash_node, 8)
    assert isinstance(p, RadixPartitioner) and p.passes == 2
    assert isinstance(partitioner_factory({"algorithm": "no"}, hash_node, 8),
                      NoPartitioner)


# ---------------------------------------------------------------------------
# joiner lattice
# ---------------------------------------------------------------------------

def _run_lattice_point(storage, pbuild, pprobe, steal=False, n_r=512, n_s=2048):
    tb = _pk_table(n_r, seed=11)
    s = Schema.create(("long", "long"))
    tp = WriteTable(s)
    tp.generate(n_s, n_r, 0.0, 22)  # FK side: every key appears n_s/n_r times
    h = ModuloHash(1, n_r, 64)
    part_h = ModuloHash(1, n_r, 16)
    joiner = HashJoiner(h, storage=storage, partition_build=pbuild,
                        partition_probe=pprobe, steal=steal)
    joiner.init(tb.schema, [2], 1, tp.schema, [2], 1)
    pb = (ParallelPartitioner(part_h) if pbuild else NoPartitioner()).split(tb)
    pp = (ParallelPartitioner(part_h) if (pprobe or steal)
          else NoPartitioner()).split(tp)
    joiner.build(pb)
    out = joiner.probe(pp)
    return out, joiner, tb, tp


LATTICE = [(s, b, p) for s in ("copy", "pointer")
           for b in (False, True) for p in (False, True)]


@pytest.mark.parametrize("storage,pbuild,pprobe", LATTICE)
def test_hash_joiner_lattice_exact(storage, pbuild, pprobe):
    out, joiner, tb, tp = _run_lattice_point(storage, pbuild, pprobe)
    assert out.num_rows == 2048          # PK⋈FK: |S| matches exactly
    # every output row joins matching rids: build payload rid r such that
    # build key[r-1]... verify via key reconstruction
    bkey_of_rid = np.empty(513, np.int64)
    bkey_of_rid[np.asarray(tb.column(2))] = np.asarray(tb.column(1))
    pkey_of_rid = np.empty(2049, np.int64)
    pkey_of_rid[np.asarray(tp.column(2))] = np.asarray(tp.column(1))
    joined_bkeys = bkey_of_rid[np.asarray(out.column(1))]
    joined_pkeys = pkey_of_rid[np.asarray(out.column(2))]
    assert np.array_equal(joined_bkeys, joined_pkeys)
    # every probe rid appears exactly once (PK build side)
    assert sorted(np.asarray(out.column(2))) == list(range(1, 2049))


def test_lattice_points_all_agree():
    results = []
    for storage, pbuild, pprobe in LATTICE:
        out, *_ = _run_lattice_point(storage, pbuild, pprobe)
        pairs = np.stack([np.asarray(out.column(1)),
                          np.asarray(out.column(2))])
        order = np.lexsort(pairs)
        results.append(pairs[:, order])
    for r in results[1:]:
        assert np.array_equal(results[0], r)


def test_probe_steal_stats_and_exactness():
    out, joiner, _, _ = _run_lattice_point("copy", False, True, steal=True)
    assert out.num_rows == 2048
    assert joiner.stats.partition_probe_costs is not None
    assert joiner.stats.partition_probe_costs.sum() >= 2048
    assert joiner.stats.stolen_balance is not None


def test_probe_policies_execute_different_measured_schedules():
    """VERDICT r2 task 3 done-criterion: ProbeIsPart and ProbeSteal are
    EXECUTION policies — different per-unit decompositions with measured
    (not predicted) timings — that produce identical results
    (probe.inl:18-52)."""
    import dataclasses as _dc

    tb = _pk_table(512, seed=11)
    s = Schema.create(("long", "long"))
    tp = WriteTable(s)
    # heavy skew: zipf FK probe side so partition costs are imbalanced
    tp.generate(4096, 512, 1.05, 22)
    h = ModuloHash(1, 512, 64)
    part_h = ModuloHash(1, 512, 8)

    outs, joiners = [], []
    for steal in (False, True):
        joiner = HashJoiner(h, partition_probe=not steal, steal=steal,
                            nthreads=4)
        joiner.init(tb.schema, [2], 1, tp.schema, [2], 1)
        pb = NoPartitioner().split(tb)
        pp = ParallelPartitioner(part_h).split(tp)
        joiner.build(pb)
        outs.append(joiner.probe(pp))
        joiners.append(joiner)

    sched_part = joiners[0].stats.probe_schedule
    sched_steal = joiners[1].stats.probe_schedule
    assert sched_part["policy"] == "probe_is_part"
    assert sched_steal["policy"] == "probe_steal"
    # different decompositions: unit row-boundaries differ
    units_p = [(a, r) for a, r, _ in sched_part["units"]]
    units_s = [(a, r) for a, r, _ in sched_steal["units"]]
    assert units_p != units_s
    # measured, not predicted: every unit carries a positive wall time
    assert all(us > 0 for _, _, us in sched_part["units"])
    assert all(us > 0 for _, _, us in sched_steal["units"])
    assert len(sched_part["worker_micros"]) == 4
    # steal's PREDICTED cost chunks are balanced (within 2x of each other,
    # row-granularity aside); the partition decomposition under zipf skew
    # is not required to be
    bal = joiners[1].stats.stolen_balance
    assert bal.max() <= 2 * max(1, bal.min()) or len(bal) == 1
    # identical results
    for col in (1, 2):
        a = np.sort(np.asarray(outs[0].column(col)))
        b = np.sort(np.asarray(outs[1].column(col)))
        assert np.array_equal(a, b)


def test_steal_with_partition_build_rejected():
    h = ModuloHash(1, 64, 8)
    with pytest.raises(ValueError):
        HashJoiner(h, partition_build=True, steal=True)


def test_duplicate_keys_multiset_semantics():
    """Duplicates on both sides multiply (m×n matches per key)."""
    s = Schema.create(("long", "long"))
    tb = WriteTable(s)
    tb.append_batch([np.array([5, 5, 7], np.int64),
                     np.array([1, 2, 3], np.int64)])
    tb.finalize()
    tp = WriteTable(s)
    tp.append_batch([np.array([5, 7, 7, 9], np.int64),
                     np.array([1, 2, 3, 4], np.int64)])
    tp.finalize()
    j = HashJoiner(ModuloHash(0, 16, 8))
    j.init(s, [2], 1, s, [2], 1)
    j.build(NoPartitioner().split(tb))
    out = j.probe(NoPartitioner().split(tp))
    assert out.num_rows == 2 * 1 + 1 * 2  # key5: 2x1, key7: 1x2
    assert j.stats.output_rows == 4


def test_nested_loops_matches_hash_join():
    out_nl_joiner = NestedLoops()
    tb = _pk_table(128, seed=5)
    s = Schema.create(("long", "long"))
    tp = WriteTable(s)
    tp.generate(512, 128, 0.0, 6)
    out_nl_joiner.init(tb.schema, [2], 1, tp.schema, [2], 1)
    out_nl_joiner.build(NoPartitioner().split(tb))
    out = out_nl_joiner.probe(NoPartitioner().split(tp))
    assert out.num_rows == 512
    assert out_nl_joiner.brute_count() == 512


def test_flatmem_joiner_matches():
    tb = _pk_table(1024, seed=8)
    s = Schema.create(("long", "long"))
    tp = WriteTable(s)
    tp.generate(4096, 1024, 0.0, 9)
    h = ModuloHash(1, 1024, 64)
    rp = RadixPartitioner(h, passes=2)
    j = FlatMemoryJoiner(h, rp)
    j.init(tb.schema, [2], 1, tp.schema, [2], 1)
    j.build(rp.split(tb))
    out = j.probe(NoPartitioner().split(tp))
    assert out.num_rows == 4096
    assert sorted(np.asarray(out.column(2))) == list(range(1, 4097))


def test_joiner_factory_lattice_dispatch():
    h = ModuloHash(1, 64, 8)
    j = joiner_factory({"algorithm": {"copydata": "yes",
                                      "partitionbuild": "no",
                                      "partitionprobe": "yes",
                                      "steal": "yes"}}, h)
    assert isinstance(j, HashJoiner) and j.steal and j.storage == "copy"
    j2 = joiner_factory({"algorithm": {"copydata": "no",
                                       "partitionbuild": "yes",
                                       "partitionprobe": "no"}}, h)
    assert j2.storage == "pointer" and j2.partition_build
    rp = RadixPartitioner(h, passes=1)
    j3 = joiner_factory({"algorithm": {"flatmem": "yes"}}, h,
                        build_partitioner=rp)
    assert isinstance(j3, FlatMemoryJoiner)
    with pytest.raises(ValueError):
        joiner_factory({"algorithm": {"flatmem": "yes"}}, h,
                       build_partitioner=NoPartitioner())


# ---------------------------------------------------------------------------
# end-to-end driver
# ---------------------------------------------------------------------------

SMALL_CONF = textwrap.dedent("""
    path: ".";
    bucksize: 65536;
    partitioner: {
        build: { algorithm: "radix"; pagesize: 1024; attribute: 1; passes: 1; };
        probe: { algorithm: "radix"; pagesize: 1024; attribute: 1; passes: 1; };
        hash:  { fn: "modulo"; range: [1, 4096]; buckets: 16; };
    };
    build: {
        file: "r.tbl"; schema: ("long", "long"); jattr: 1; select: (2);
        generate: true; relation-size: 4096; alphabet-size: 4096;
        zipf-param: 0.00; seed: 12345;
    };
    probe: {
        file: "s.tbl"; schema: ("long", "long"); jattr: 1; select: (2);
        generate: true; relation-size: 16384; alphabet-size: 4096;
        zipf-param: 0.00; seed: 54321;
    };
    output: "out.tbl";
    hash: { fn: "modulo"; range: [1, 4096]; buckets: 2048; };
    algorithm: {
        copydata: "yes"; partitionbuild: "yes";
        buildpagesize: 32; partitionprobe: "yes";
    };
    threads: 4;
""")


def test_run_multijoin_end_to_end(tmp_path):
    conf = parse_conf_string(SMALL_CONF)
    res = run_multijoin(conf, base_path=str(tmp_path))
    assert res.output_rows == 16384       # PK⋈FK exact
    assert set(res.timings_ns) >= {"generate", "split_build", "split_probe",
                                   "build", "probe"}
    line = res.to_json_line()
    assert '"outputRows": 16384' in line


def test_run_multijoin_from_file_with_output(tmp_path):
    p = tmp_path / "small.conf"
    p.write_text(SMALL_CONF)
    res = run_multijoin(str(p), write_output=True, base_path=str(tmp_path))
    assert res.output_rows == 16384
    out = tmp_path / "out.tbl"
    assert out.exists()
    first = out.read_text().splitlines()[0].split("|")
    assert len(first) == 2


# ---------------------------------------------------------------------------
# confgen (conf/gen m4 templates) + datagen (genbuild/genprobe)
# ---------------------------------------------------------------------------

def test_confgen_renders_gen_sh_parameters():
    """render_conf derives skipbits/pagesize exactly like conf/gen/gen.sh."""
    from htm_hashjoin_tpu.wisconsin import parse_conf_string, render_conf
    c = parse_conf_string(render_conf("parallel", 11, threads=12))
    assert c["partitioner"]["hash"]["buckets"] == 2048
    assert c["partitioner"]["hash"]["skipbits"] == 24 - 11 - 1
    assert c["partitioner"]["build"]["pagesize"] == 1 << (24 - 11 + 4)
    assert c["threads"] == 12
    c2 = parse_conf_string(render_conf("radix", 6, passes=2, steal=True))
    assert c2["partitioner"]["probe"]["passes"] == 2
    # steal = shared build (template.radixsteal.m4)
    assert c2["partitioner"]["build"]["algorithm"] == "no"
    assert c2["algorithm"]["partitionbuild"] == "no"
    assert c2["algorithm"]["steal"] == "yes"


def test_confgen_grid_files_run(tmp_path):
    """The generated grid follows the <buckets:06d>_<algo>.conf naming and
    every file parses and runs end to end (small sizes)."""
    from htm_hashjoin_tpu.wisconsin import generate_conf_grid
    paths = generate_conf_grid(str(tmp_path), threads=[4], exponents=[3],
                               passes=[1], log2_alphabet=12,
                               build_size=512, probe_size=2048)
    names = sorted(os.path.basename(p) for p in paths)
    assert names == ["000008_independent.conf", "000008_parallel.conf",
                     "000008_radix1.conf", "000008_radix1steal.conf"]
    for p in paths:
        res = run_multijoin(p, base_path=str(tmp_path))
        assert res.output_rows == 2048    # PK⋈FK exact on every lattice point


def test_datagen_canonical_tbl_files(tmp_path):
    """genbuild/genprobe semantics: build is i|i, probe is `copies` shuffled
    permutations, and the join cardinality equals the probe size."""
    from htm_hashjoin_tpu.wisconsin import build_rows, generate_tbl_files, probe_rows
    b = build_rows(64)
    assert np.array_equal(b[:, 0], b[:, 1])
    assert np.array_equal(b[:, 0], np.arange(1, 65))
    p = probe_rows(64, copies=4, seed=1)
    assert np.array_equal(p[:, 0], np.arange(1, 257))
    for c in range(4):
        assert sorted(p[c * 64:(c + 1) * 64, 1]) == list(range(1, 65))
    generate_tbl_files(str(tmp_path), max_key=1024 * 1024, copies=2)
    assert (tmp_path / "001M_build.tbl").exists()
    assert (tmp_path / "002M_probe.tbl").exists()
    first = (tmp_path / "001M_build.tbl").read_text(
    ).splitlines()[0].split("|")
    assert first == ["1", "1"]


def test_multijoin_zipf_skew_conf(tmp_path):
    conf = parse_conf_string(SMALL_CONF)
    conf["probe"]["zipf-param"] = 0.99
    conf["algorithm"]["partitionbuild"] = "no"
    conf["algorithm"]["steal"] = "yes"
    res = run_multijoin(conf, base_path=str(tmp_path))
    assert res.output_rows == 16384       # zipf FK still joins every tuple
    assert res.stats.stolen_balance is not None


def test_load_bz2(tmp_path):
    """Transparent bzip2 decompression (the reference vendors bzip2-1.0.5
    for compressed .tbl loads)."""
    import bz2
    from htm_hashjoin_tpu.wisconsin.schema import Schema
    from htm_hashjoin_tpu.wisconsin.table import WriteTable
    p = tmp_path / "t.tbl.bz2"
    with bz2.open(p, "wt") as f:
        for i in range(1, 101):
            f.write(f"{i}|{i * 10}\n")
    wt = WriteTable(Schema.create(["long", "long"]))
    wt.load(str(p))
    assert wt.num_rows == 100
    assert int(np.asarray(wt.column(2))[-1]) == 1000


def test_match_bounds_i32_fast_path_agrees_with_i64():
    """The int32 tagged-composite fast path (keys certified |k| < 2^30 —
    reference-scale multijoin keys are <= 16M, datagen/genbuild.py) must
    agree exactly with the general int64 path, including negative pad keys
    and duplicate-heavy probes."""
    import jax.numpy as jnp
    from htm_hashjoin_tpu.wisconsin.joiners import (_match_bounds,
                                                    _match_bounds_i32,
                                                    _match_bounds_i64)
    rng = np.random.default_rng(7)
    build = np.sort(rng.integers(0, 500, size=1024)).astype(np.int32)
    probe = rng.integers(-1, 600, size=2048).astype(np.int32)  # incl. pad -1
    b, p = jnp.asarray(build), jnp.asarray(probe)
    lo32, hi32, t32 = _match_bounds_i32(b, p)
    lo64, hi64, t64 = _match_bounds_i64(b, p)
    assert int(t32) == int(t64)
    assert np.array_equal(np.asarray(lo32), np.asarray(lo64))
    assert np.array_equal(np.asarray(hi32), np.asarray(hi64))
    # the router certifies and picks i32 here; bound pass-through matches
    lo, hi, t = _match_bounds(b, p)
    assert int(t) == int(t64)
    lo_b, hi_b, t_b = _match_bounds(b, p, key_bound=600)
    assert int(t_b) == int(t64)
    # wide keys force the i64 path and stay exact
    wide = jnp.asarray(probe.astype(np.int64) + (1 << 40))
    lo_w, hi_w, t_w = _match_bounds(jnp.asarray(build.astype(np.int64)),
                                    wide)
    assert int(t_w) == 0


def test_dense_bounds_route_matches_tagged_sort_route():
    """The dense rank-table route (one packed gather) and the tagged-sort
    route must produce identical bounds and outputs — including duplicate
    build keys and probe keys outside the build range."""
    import jax.numpy as jnp
    from htm_hashjoin_tpu.wisconsin.joiners import (_dense_bounds,
                                                    _dense_rank_table,
                                                    _match_bounds_i64)
    from htm_hashjoin_tpu.relation import next_pow2
    rng = np.random.default_rng(11)
    build = rng.integers(0, 300, size=512).astype(np.int32)
    probe = rng.integers(-5, 400, size=1024).astype(np.int32)
    cum, cnt, mx = _dense_rank_table(jnp.asarray(build),
                                     jnp.zeros((next_pow2(302),), np.int32))
    assert int(mx) > 1          # duplicate build keys: no perm certificate
    lo_d, hi_d, head = _dense_bounds(cum, cnt, jnp.asarray(probe))
    lo_t, hi_t, t_t = _match_bounds_i64(jnp.sort(jnp.asarray(build)),
                                        jnp.asarray(probe))
    assert int(np.asarray(head)[0]) == int(t_t)
    assert np.array_equal(np.asarray(lo_d), np.asarray(lo_t))
    assert np.array_equal(np.asarray(hi_d), np.asarray(hi_t))


def test_unit_count_emit_matches_general_expand(tmp_path):
    """A PK build ⋈ FK probe certifies all-unit counts on device; the
    identity expansion must produce the same output rows as the general
    scatter-based expansion (order included — both are probe-row order)."""
    conf = parse_conf_string(SMALL_CONF)
    conf["algorithm"]["partitionprobe"] = "no"
    conf["algorithm"]["steal"] = "no"
    res = run_multijoin(conf, base_path=str(tmp_path))
    assert res.output_rows == 16384
    # force the general path by disabling the dense table post-build
    from htm_hashjoin_tpu.wisconsin.driver import run_multijoin as _rm
    import htm_hashjoin_tpu.wisconsin.joiners as J
    try:
        # disable dense route: make build never certify density
        lim = J._DENSE_LIMIT
        J._DENSE_LIMIT = 0
        res2 = _rm(parse_conf_string(SMALL_CONF), base_path=str(tmp_path))
    finally:
        J._DENSE_LIMIT = lim
    assert res2.output_rows == res.output_rows


def test_perm_build_certificate_bounds():
    """Permutation-build certificate: a dense unique full-coverage build
    makes probe bounds pure arithmetic; results must equal the directory
    route, and an out-of-range probe key voids all_unit."""
    import jax.numpy as jnp
    from htm_hashjoin_tpu.wisconsin.joiners import (_dense_bounds,
                                                    _dense_bounds_perm,
                                                    _dense_rank_table)
    from htm_hashjoin_tpu.relation import next_pow2
    rng = np.random.default_rng(3)
    build = rng.permutation(np.arange(5, 517)).astype(np.int32)  # 512 keys
    probe = rng.integers(5, 517, size=777).astype(np.int32)
    lo_p, hi_p, head = _dense_bounds_perm(jnp.asarray(probe), 5, 516)
    assert int(np.asarray(head)[0]) == 777 and int(np.asarray(head)[1]) == 1
    cum, cnt, mx = _dense_rank_table(jnp.asarray(build),
                                     jnp.zeros((next_pow2(518),), np.int32))
    assert int(mx) == 1
    lo_d, hi_d, head_d = _dense_bounds(cum, cnt, jnp.asarray(probe))
    # arithmetic lo indexes the key-sorted build identically: key k sits
    # at rank k - kmin = cum[k] - cnt[k]
    assert np.array_equal(np.asarray(lo_p), np.asarray(lo_d))
    assert np.array_equal(np.asarray(hi_p), np.asarray(hi_d))
    assert np.array_equal(np.asarray(hi_d), np.asarray(lo_d) + 1)
    # out-of-range probe key -> all_unit voided
    probe2 = np.concatenate([probe, [9999]]).astype(np.int32)
    _, _, head2 = _dense_bounds_perm(jnp.asarray(probe2), 5, 516)
    assert int(np.asarray(head2)[1]) == 0
    assert int(np.asarray(head2)[0]) == 777


def test_flatmem_directory_route_matches_composite(tmp_path):
    """FlatMemoryJoiner's dense start/count directory (two gathers) and
    the (bucket<<32|key) composite sort must produce identical outputs —
    including duplicate build keys, which void the unit certificate."""
    import htm_hashjoin_tpu.wisconsin.joiners as J
    conf = parse_conf_string(SMALL_CONF)
    conf["algorithm"]["flatmem"] = "yes"
    conf["partitioner"]["build"]["algorithm"] = "radix"
    res = run_multijoin(conf, base_path=str(tmp_path))
    assert res.output_rows == 16384
    lim = J._DENSE_LIMIT
    try:
        J._DENSE_LIMIT = 0        # force the composite fallback
        conf2 = parse_conf_string(SMALL_CONF)
        conf2["algorithm"]["flatmem"] = "yes"
        conf2["partitioner"]["build"]["algorithm"] = "radix"
        res2 = run_multijoin(conf2, base_path=str(tmp_path))
    finally:
        J._DENSE_LIMIT = lim
    assert res2.output_rows == res.output_rows
    for col in (1, 2):
        a = np.sort(np.asarray(res.output.column(col)[:res.output_rows]))
        b = np.sort(np.asarray(res2.output.column(col)[:res2.output_rows]))
        assert np.array_equal(a, b)


# ---------------------------------------------------------------------------
# Scheduled-probe routes (round 5): partition-local vs full-build search
# ---------------------------------------------------------------------------

def _wide_key_tables(base, dup_build=True):
    """Tables whose keys exceed _DENSE_LIMIT so neither the dense directory
    nor the permutation certificate applies (forces the tagged-sort
    routes), with duplicate keys on both sides."""
    rng = np.random.default_rng(42)
    bkeys = base + rng.integers(0, 4096, size=2000) * 37
    if dup_build:
        bkeys[:100] = bkeys[100:200]       # extra duplicates
    pkeys = base + rng.integers(0, 4096, size=6000) * 37
    s = Schema.create(("long", "long"))
    tb = WriteTable(s)
    tb.append_batch([bkeys.astype(np.int64),
                     np.arange(2000, dtype=np.int64)])
    tb.finalize()
    tp = WriteTable(s)
    tp.append_batch([pkeys.astype(np.int64),
                     np.arange(6000, dtype=np.int64)])
    tp.finalize()
    return s, tb, tp


def _oracle_pairs(s, tb, tp, h):
    j = HashJoiner(h)
    j.init(s, [2], 1, s, [2], 1)
    j.build(NoPartitioner().split(tb))
    out = j.probe(NoPartitioner().split(tp))
    pairs = np.stack([np.asarray(out.column(1))[:out.num_rows],
                      np.asarray(out.column(2))[:out.num_rows]])
    return pairs[:, np.lexsort(pairs)], out.num_rows


@pytest.mark.parametrize("base", [1 << 26, 1 << 30])
def test_partition_local_route_wide_keys(base):
    """Co-partitioned build+probe with wide (non-dense) keys: the
    scheduled probe takes the partition-LOCAL route — unit p searches ONLY
    build partition p's slice (probe.inl:18-36) — and matches the
    unscheduled full-sort probe exactly.  base=2^30 exercises the int64
    tagged composite (keys beyond the int32 certificate)."""
    s, tb, tp = _wide_key_tables(base)
    h = ModuloHash(1, 1 << 32, 4096)
    part_h1 = ModuloHash(1, 1 << 32, 16)
    part_h2 = ModuloHash(1, 1 << 32, 16)   # distinct object, == fingerprint
    assert part_h1 == part_h2
    j = HashJoiner(h, partition_build=True, partition_probe=True,
                   nthreads=4)
    j.init(s, [2], 1, s, [2], 1)
    j.build(ParallelPartitioner(part_h1).split(tb))
    out = j.probe(ParallelPartitioner(part_h2).split(tp))
    assert j.stats.probe_schedule["route"] == "local"
    assert j.stats.probe_schedule["policy"] == "probe_is_part"
    oracle, n_rows = _oracle_pairs(s, tb, tp, h)
    assert out.num_rows == n_rows
    pairs = np.stack([np.asarray(out.column(1))[:out.num_rows],
                      np.asarray(out.column(2))[:out.num_rows]])
    assert np.array_equal(pairs[:, np.lexsort(pairs)], oracle)


def test_sorted_route_when_not_copartitioned():
    """Probe split by a DIFFERENT hash than the build: the co-partitioning
    certificate fails and the scheduled probe falls back to the full-build
    tagged search per worker — results still exact."""
    s, tb, tp = _wide_key_tables(1 << 26)
    h = ModuloHash(1, 1 << 32, 4096)
    j = HashJoiner(h, partition_build=True, partition_probe=True,
                   nthreads=4)
    j.init(s, [2], 1, s, [2], 1)
    j.build(ParallelPartitioner(ModuloHash(1, 1 << 32, 16)).split(tb))
    out = j.probe(ParallelPartitioner(ModuloHash(1, 1 << 32, 8)).split(tp))
    assert j.stats.probe_schedule["route"] == "sorted"
    oracle, n_rows = _oracle_pairs(s, tb, tp, h)
    assert out.num_rows == n_rows
    pairs = np.stack([np.asarray(out.column(1))[:out.num_rows],
                      np.asarray(out.column(2))[:out.num_rows]])
    assert np.array_equal(pairs[:, np.lexsort(pairs)], oracle)


def test_perm_route_reported_on_canonical_schedule():
    """The canonical dense-PK build reports the arithmetic 'perm' route in
    its measured schedule (the reference-scale fast path)."""
    tb = _pk_table(512, seed=11)
    s = Schema.create(("long", "long"))
    tp = WriteTable(s)
    tp.generate(4096, 512, 0.0, 22)
    h = ModuloHash(1, 512, 64)
    part_h = ModuloHash(1, 512, 8)
    j = HashJoiner(h, partition_build=True, partition_probe=True,
                   nthreads=4)
    j.init(tb.schema, [2], 1, tp.schema, [2], 1)
    j.build(ParallelPartitioner(part_h).split(tb))
    out = j.probe(ParallelPartitioner(part_h).split(tp))
    assert out.num_rows == 4096
    assert j.stats.probe_schedule["route"] == "perm"
    assert len(j.stats.probe_schedule["worker_micros"]) == 4


def test_steal_cuts_int32_matches_int64():
    """The certified int32 steal-cost formulation (used when
    n * (max_occupancy + 1) < 2^31) must produce identical cut points and
    chunk balances to the general int64 path."""
    import jax.numpy as jnp

    from htm_hashjoin_tpu.wisconsin.joiners import _steal_cuts
    rng = np.random.default_rng(5)
    occ = jnp.asarray(rng.integers(0, 7, 1 << 12).astype(np.int32))
    buckets = jnp.asarray(rng.integers(0, 1 << 12, 20000).astype(np.int32))
    b64, bal64 = _steal_cuts(occ, buckets, 8, False)
    b32, bal32 = _steal_cuts(occ, buckets, 8, True)
    assert np.array_equal(np.asarray(b64), np.asarray(b32))
    assert np.array_equal(np.asarray(bal64), np.asarray(bal32))
