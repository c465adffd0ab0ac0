"""CLI: ``python -m htm_hashjoin_tpu.harness <grid>|all [options]`` — the
experiments/*.sh + runner.sh equivalent."""

import argparse
import sys

from .grids import GRIDS
from .runner import run_all, run_grid


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("grid", choices=sorted(GRIDS) + ["all"],
                   help="experiment grid to run ('all' = runner.sh)")
    p.add_argument("--scale", type=int, default=20,
                   help="log2 rSize (reference scale: 27)")
    p.add_argument("--reps", type=int, default=5,
                   help="repetitions per grid (runner.sh N=5)")
    p.add_argument("--outDir", default=None,
                   help="write <grid>_log<i> files here")
    p.add_argument("--counters", nargs="?", const="default", default=None,
                   metavar="CFG",
                   help="per-phase PCM-analog counter dumps in every grid "
                        "JSON line (pcm.cfg analog; see cli --counters)")
    a = p.parse_args(argv)
    if a.counters:
        from ..utils.profiler import PerfCounters, enable_counters
        enable_counters(None if a.counters == "default"
                        else PerfCounters.from_config(a.counters))
    if a.grid == "all":
        run_all(scale=a.scale, reps=a.reps,
                out_dir=a.outDir or "experiments/logs")
    else:
        run_grid(a.grid, scale=a.scale, reps=a.reps, out_dir=a.outDir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
