#!/usr/bin/env python3
"""Smoke run of the join engine on the GPU, through the entry points a user
calls, at the reference's own scales.

    python chip_smoke.py               # one card: phases 1-5 below
    python chip_smoke.py --four-cards  # four cards: the distributed phase only

Set-up builds the native libraries (``make -C native``).  Each phase goes
through the CLI's own functions (``parse_args`` → ``build_relations`` →
``DISPATCH`` / ``distributed_join``) or ``wisconsin.driver.run_multijoin``
and is checked against a reference computed independently of the code
under test.  Each phase prints one JSON record (argv, result, reference,
seconds); then each card's peak memory, the ``nvidia-smi`` name and power
limit, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.

Exits non-zero, printing no result, when JAX finds no GPU, or when any
phase raises or disagrees with its reference.  It never falls back to the
CPU and never catches a phase error.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
N27 = 1 << 27
N28 = 1 << 28
SHUFFLE_ALGOS = ("htm", "atomic", "nocc", "sortmerge", "npo")
WISCONSIN_CONFS = ("no_partition.conf", "radix1.conf")
FOUR_CARD_MESHES = ("4", "2,2")


class PhaseMismatch(AssertionError):
    """A phase's result disagrees with its reference."""


def expect(phase: str, what: str, got, want) -> None:
    if got != want:
        raise PhaseMismatch(f"{phase}: {what} = {got!r}, expected {want!r}")


def run_cli(argv, relations=None):
    """One join through the CLI's own functions.  Returns the JSON-line
    dict, the relations it ran on and the join's wall seconds (generation
    excluded, as in ``cli.main``)."""
    from htm_hashjoin_tpu.cli import parse_args
    from htm_hashjoin_tpu.data.generators import build_relations
    from htm_hashjoin_tpu.joins import DISPATCH
    from htm_hashjoin_tpu.parallel.dist_join import distributed_join

    cfg, _ = parse_args([str(a) for a in argv])
    r, s = relations if relations is not None else build_relations(cfg)
    r.fence(), s.fence()
    t0 = time.perf_counter()
    if cfg.mesh_shape:
        m = distributed_join(r, s, cfg)
    else:
        m = DISPATCH[cfg.algo.value](r, s, cfg)
    return json.loads(m.to_json_line()), (r, s), time.perf_counter() - t0


def host_matches(rel) -> int:
    """Host reference join count on the very arrays the device generated
    (device-side zipf draws use float32, so keys made again elsewhere may
    differ)."""
    from htm_hashjoin_tpu.utils.validate import reference_match_count
    r, s = rel
    return reference_match_count(r.keys, s.keys)


def record(phase, argv, result, reference, seconds):
    keys = ("algo", "totalMatches", "inputSum", "outputSum", "chosenPath",
            "outputRows", "droppedR", "droppedS", "repairedR", "repairedS",
            "hotKeys", "nDevices")
    rec = {"phase": phase, "argv": [str(a) for a in argv],
           "result": {k: result[k] for k in keys if k in result},
           "reference": reference, "seconds": seconds}
    print(json.dumps(rec), flush=True)
    return rec


def phase_adaptive_local_shuffle(n: int = N27, window: int = 16):
    """The headline: adaptive on local_shuffle keys ⋈ sorted 1..n."""
    argv = ["--algo", "adaptive", "--rSize", n, "--dataDistr",
            "local_shuffle", "--shuffleRange", window]
    d, _, sec = run_cli(argv)
    ref = {"chosenPath": "htm", "totalMatches": n,
           "inputSum": n * (n + 1) // 2, "outputSum": n * (n + 1) // 2}
    for k, v in ref.items():
        expect("adaptive_local_shuffle", k, d.get(k), v)
    return record("adaptive_local_shuffle", argv, d, ref, sec)


def phase_adaptive_zipf(n: int = N27, distinct: int = 1 << 24):
    """Duplicate-heavy zipf build: the planner must switch to radix."""
    argv = ["--algo", "adaptive", "--rSize", n, "--dataDistr", "zipf",
            "--distinctKeys", distinct]
    d, rel, sec = run_cli(argv)
    ref = {"chosenPath": "radix", "totalMatches": host_matches(rel),
           "outputSum": d["inputSum"]}
    for k, v in ref.items():
        expect("adaptive_zipf", k, d.get(k), v)
    return record("adaptive_zipf", argv, d, ref, sec)


def phase_radix_zipf_probe(n: int = N27, theta: float = 1.0):
    """The mc driver's PK ⋈ zipf-FK shape: every probe key finds its one
    PK, so matches = |S|."""
    argv = ["--algo", "radix", "-r", n, "-s", n, "-z", theta]
    d, rel, sec = run_cli(argv)
    ref = {"totalMatches": n, "hostMatches": host_matches(rel),
           "outputSum": d["inputSum"]}
    expect("radix_zipf_probe", "totalMatches", d["totalMatches"], n)
    expect("radix_zipf_probe", "host reference", ref["hostMatches"], n)
    expect("radix_zipf_probe", "outputSum", d["outputSum"], d["inputSum"])
    return record("radix_zipf_probe", argv, d, ref, sec)


def phase_algos_shuffle(n: int = N27, algos=SHUFFLE_ALGOS):
    """Each hash and sort algorithm on shuffle keys ⋈ sorted 1..n.  Scatter
    winners differ between runs on the GPU, so only the counts and sums
    that are exact by construction are compared."""
    recs = []
    for algo in algos:
        argv = ["--algo", algo, "--rSize", n, "--dataDistr", "shuffle"]
        d, _, sec = run_cli(argv)
        ref = {"totalMatches": n, "inputSum": n * (n + 1) // 2,
               "outputSum": n * (n + 1) // 2}
        for k, v in ref.items():
            expect(f"shuffle_{algo}", k, d.get(k), v)
        recs.append(record(f"shuffle_{algo}", argv, d, ref, sec))
    return recs


def phase_wisconsin(conf_name: str, shift: int = 0):
    """A shipped Wisconsin conf (16M PK build ⋈ 256M FK probe) through
    run_multijoin; ``shift`` divides both relations by 2^shift."""
    from htm_hashjoin_tpu.wisconsin.conf import parse_conf
    from htm_hashjoin_tpu.wisconsin.driver import run_multijoin

    path = os.path.join(ROOT, "htm_hashjoin_tpu", "wisconsin", "conf",
                        conf_name)
    conf = parse_conf(path)
    for side in ("build", "probe"):
        conf[side]["relation-size"] >>= shift
        conf[side]["alphabet-size"] >>= shift
    t0 = time.perf_counter()
    res = run_multijoin(conf, base_path=os.path.dirname(path))
    sec = time.perf_counter() - t0
    want = conf["probe"]["relation-size"]     # PK ⋈ FK: one row per probe
    expect(f"wisconsin_{conf_name}", "outputRows", res.output_rows, want)
    return record(f"wisconsin_{conf_name}", [conf_name, f"shift={shift}"],
                  json.loads(res.to_json_line()), {"outputRows": want}, sec)


def phase_distributed(n: int = N28, meshes=FOUR_CARD_MESHES,
                      theta: float = 1.0):
    """Zipf-probe join with heavy-hitter handling over each mesh, compared
    with the host reference and a one-card run of the same arrays.  The
    one-card run goes first, so that device 0's peak memory is the
    one-card peak and the other devices' peaks are the mesh runs' own."""
    base = ["--algo", "radix", "-r", n, "-s", n, "-z", theta,
            "--skewHandling"]
    from htm_hashjoin_tpu.cli import parse_args
    from htm_hashjoin_tpu.data.generators import build_relations
    rel = build_relations(parse_args([str(a) for a in base])[0])
    want = host_matches(rel)
    d, _, sec = run_cli(base, relations=rel)
    expect("one_card", "totalMatches", d["totalMatches"], want)
    recs = [record("one_card", base, d, {"totalMatches": want}, sec)]
    peak_memory("after the one-card run")
    for mesh in meshes:
        argv = base + ["--meshShape", mesh]
        d, _, sec = run_cli(argv, relations=rel)
        phase = f"distributed_{mesh}"
        expect(phase, "totalMatches", d["totalMatches"], want)
        expect(phase, "outputSum", d["outputSum"], d["inputSum"])
        expect(phase, "dropped", (d["droppedR"], d["droppedS"]), (0, 0))
        recs.append(record(phase, argv, d, {"totalMatches": want}, sec))
    return recs


def peak_memory(label: str) -> None:
    import jax
    for dev in jax.devices():
        stats = dev.memory_stats() or {}
        print(json.dumps({"peakMemory": label, "device": dev.id,
                          "peak_bytes_in_use":
                              stats.get("peak_bytes_in_use")}), flush=True)


def build_native() -> None:
    subprocess.run(["make", "-s", "-C", os.path.join(ROOT, "native")],
                   check=True, stdout=sys.stderr)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the distributed phase, on four cards")
    a = p.parse_args(argv)

    import jax
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU found (JAX's default platform is "
              f"{devices[0].platform!r})", file=sys.stderr)
        return 1
    want_cards = 4 if a.four_cards else 1
    if len(devices) < want_cards:
        print(f"chip_smoke: {want_cards} GPUs needed, JAX found "
              f"{len(devices)}", file=sys.stderr)
        return 1

    build_native()
    import htm_hashjoin_tpu  # noqa: F401  (x64, compile cache)

    t0 = time.perf_counter()
    if a.four_cards:
        phase_distributed()
        peak_memory("after the distributed runs")
    else:
        phase_adaptive_local_shuffle()
        phase_adaptive_zipf()
        phase_radix_zipf_probe()
        phase_algos_shuffle()
        for conf_name in WISCONSIN_CONFS:
            phase_wisconsin(conf_name)
        peak_memory("after all phases")
    print(json.dumps({"totalSeconds": time.perf_counter() - t0}), flush=True)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout
    for line in smi.strip().splitlines()[:want_cards]:
        print(line.strip(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
