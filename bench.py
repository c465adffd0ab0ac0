"""Headline benchmark: adaptive (HTM-equivalent) build+probe on locality data.

Workload mirrors the reference's headline configuration (BASELINE.md):
rSize = 2^27 keys with local_shuffle locality, window 16 (the paper's
central axis, README.md:6), probed by a sorted 2^27 relation — full
build+probe, through the CLI's own functions (``parse_args`` →
``build_relations`` → ``DISPATCH["adaptive"]``).

Every run is checked: matches = 2^27 and inputSum = outputSum = n(n+1)/2.
Fails, printing no result, when JAX finds no GPU.

Prints ONE JSON line: the median join time over BENCH_REPS timed runs (after
one warm-up run that compiles), its throughput counting both sides, every
run's time, the device as JAX reports it and the card's power limit.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import jax

LOG2_N = int(os.environ.get("BENCH_LOG2_N", "27"))
REPS = int(os.environ.get("BENCH_REPS", "5"))
WINDOW = 16


def _power_limit() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout
    return out.strip().splitlines()[0]


def main() -> int:
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: no GPU found (JAX's default platform is "
              f"{dev.platform!r})", file=sys.stderr)
        return 1
    from htm_hashjoin_tpu.cli import parse_args
    from htm_hashjoin_tpu.data.generators import build_relations
    from htm_hashjoin_tpu.joins import DISPATCH

    n = 1 << LOG2_N
    cfg, _ = parse_args(["--algo", "adaptive", "--rSize", str(n),
                         "--dataDistr", "local_shuffle",
                         "--shuffleRange", str(WINDOW)])
    r, s = build_relations(cfg)
    r.fence(), s.fence()
    want_sum = n * (n + 1) // 2
    times = []
    for rep in range(REPS + 1):            # rep 0 compiles: not timed
        t0 = time.perf_counter()
        m = DISPATCH["adaptive"](r, s, cfg)
        elapsed = time.perf_counter() - t0
        if m.totalMatches != n:
            raise AssertionError(f"expected {n} matches, got {m.totalMatches}")
        if not m.inputSum == m.outputSum == want_sum:
            raise AssertionError(f"conservation violated: inputSum="
                                 f"{m.inputSum} outputSum={m.outputSum}")
        if rep:
            times.append(elapsed)
    med = statistics.median(times)
    print(json.dumps({
        "metric": f"adaptive_build_probe_local_shuffle_2^{LOG2_N}",
        "value": 2 * n / med / 1e6,
        "unit": "Mtuples/s",
        "seconds": med,
        "run_seconds": times,
        "matches": m.totalMatches,
        "chosenPath": m.extra.get("chosenPath"),
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "power_limit": _power_limit(),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
