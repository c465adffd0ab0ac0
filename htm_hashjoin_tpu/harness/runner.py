"""Grid runner — experiments/runner.sh re-designed as one process.

The reference runs each grid script N=5 times, one *process per grid point*
(runner.sh:3-41), paying full binary startup and data regeneration each
point.  Here a whole grid runs in one process: jitted programs are reused
across points that share shapes (XLA compile cache), and each repetition
appends one JSON line to ``<name>_log<rep>`` — the same log-file convention
the reference keeps in experiments/new_backup/*_log{1..5}, so downstream
diffing works the same way.
"""

from __future__ import annotations

import os
import sys
import time
from typing import List, Optional

import jax

from ..config import JoinConfig
from ..data.generators import build_relations
from .grids import GRIDS, RUNNER_ORDER


# Generated relations reused across CONSECUTIVE grid points sharing
# generator inputs (a tSize sweep regenerates nothing; window-inner sweeps
# still regenerate per point — cross-algo reuse would need a window-sweep-
# sized cache, ~28 GB at 2^27).  Two entries ≈ 2 GB of device memory.
_GEN_CACHE: "dict[tuple, tuple]" = {}
_GEN_CACHE_CAP = 2


def _relations_for(cfg: JoinConfig):
    key = (cfg.data_distr, cfg.r_size, cfg.s_size, cfg.distinct_keys,
           cfg.shuffle_range, cfg.seed, cfg.zipf_param, cfg.s_seed,
           cfg.s_distr)
    if key not in _GEN_CACHE:
        if len(_GEN_CACHE) >= _GEN_CACHE_CAP:
            _GEN_CACHE.pop(next(iter(_GEN_CACHE)))
        r, s = build_relations(cfg)
        # generation is NOT part of the timed phases
        jax.block_until_ready((r.keys, r.payloads, s.keys, s.payloads))
        _GEN_CACHE[key] = (r, s)
    return _GEN_CACHE[key]


def run_config(cfg: JoinConfig) -> str:
    """One grid point → one JSON metrics line (the reference binaries' stdout
    contract, HTMHashBuild.hpp:417-449)."""
    from ..joins import DISPATCH
    r, s = _relations_for(cfg)
    if cfg.mesh_shape:
        from ..parallel.dist_join import distributed_join
        metrics = distributed_join(r, s, cfg)
    else:
        metrics = DISPATCH[cfg.algo.value](r, s, cfg)
    if cfg.s_distr is not None:
        # self-describing rows for the S-side sweeps (skewprobe): without
        # these the zipf points are indistinguishable in the log
        metrics.extra.setdefault("sDistr", cfg.s_distr.value)
        if cfg.zipf_param is not None:
            metrics.extra.setdefault("zipfParam", cfg.zipf_param)
    return metrics.to_json_line()


def run_grid(name: str, *, scale: int = 20, reps: int = 5,
             out_dir: Optional[str] = None, echo: bool = True) -> List[str]:
    """Run grid ``name`` ``reps`` times; write <name>_log<i> files when
    out_dir is given.  Returns the last repetition's lines."""
    if name not in GRIDS:
        raise ValueError(f"unknown grid {name!r}; have {sorted(GRIDS)}")
    lines: List[str] = []
    for rep in range(1, reps + 1):
        lines = []
        t0 = time.time()
        for cfg in GRIDS[name](scale):
            line = run_config(cfg)
            lines.append(line)
            if echo:
                print(line, flush=True)
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            with open(os.path.join(out_dir, f"{name}_log{rep}"), "w") as f:
                f.write("\n".join(lines) + "\n")
        if echo:
            print(f"# {name} rep {rep}/{reps}: {len(lines)} points in "
                  f"{time.time() - t0:.1f}s", file=sys.stderr, flush=True)
    return lines


def run_all(*, scale: int = 20, reps: int = 5,
            out_dir: str = "experiments/logs") -> None:
    """runner.sh: every grid, N repetitions, logs on disk."""
    for name in RUNNER_ORDER:
        run_grid(name, scale=scale, reps=reps, out_dir=out_dir)
