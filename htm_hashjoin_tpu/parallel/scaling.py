"""Scaling-efficiency harness: weak + strong scaling over device meshes
with a per-phase timing split (exchange vs local join vs repair).

The reference is single-node shared-memory (SURVEY.md §2.5 — no
distributed layer to compare against); the scaling evidence base this
module produces backs BASELINE.json's ">=80% scaling efficiency" north
star.  Runs on the virtual CPU mesh (XLA_FLAGS
--xla_force_host_platform_device_count=N) or on the GPUs of one host.

Unlike the production distributed join (dist_join.py — ONE fused program,
one host fence), each phase here is its own shard_map program with a
fenced timing readback, so the log decomposes wall time into:

  exchange  — bucketize + all_to_all (flat) or the two-stage hierarchical
              (intra-host then inter-host) exchange, both sides,
  join      — local sorted-merge count + psum,
  repair    — the cooperative residual round (only when a bucket
              overflowed; its cost appears only in runs that repair).

Usage:
  JAX_PLATFORM_NAME=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python -m htm_hashjoin_tpu.parallel.scaling --outDir experiments/results_scaling
"""

from __future__ import annotations

import functools
import json
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..utils.timing import PhaseTimer
from .dist_join import (R_PAD, S_PAD, _bucketize, _count_sorted,
                        _exchange_hier, _is_dev0, _residual_matches)
from .mesh import make_mesh


def _phase_fns(mesh: Mesh, n_r: int, n_s: int, *,
               capacity_factor: float = 2.0, residual_repair: bool = True,
               i32_keys: bool = False):
    """Three phase programs sharing dist_join's exchange/count/repair
    machinery, each independently jitted so the harness can fence between
    them."""
    ndev = mesh.devices.size
    cap_r = max(8, int(capacity_factor * n_r / (ndev * ndev)) + 8)
    cap_s = max(8, int(capacity_factor * n_s / (ndev * ndev)) + 8)
    shard = max(n_r, n_s) // ndev
    hier = mesh.devices.ndim == 2
    res_cap = shard if residual_repair else 0
    if hier:
        axis = tuple(mesh.axis_names)
        hosts, chips = mesh.devices.shape
    else:
        axis = mesh.axis_names[0]
    spec = P(axis if not hier else tuple(mesh.axis_names))

    def exchange_body(rk, sk):
        r_active = rk != R_PAD
        s_active = sk != S_PAD
        if hier:
            r_recv, r_res, r_ovf = _exchange_hier(
                rk, r_active, ndev, hosts, chips, cap_r, R_PAD,
                host_axis=axis[0], chip_axis=axis[1], res_cap=res_cap)
            s_recv, s_res, s_ovf = _exchange_hier(
                sk, s_active, ndev, hosts, chips, cap_s, S_PAD,
                host_axis=axis[0], chip_axis=axis[1], res_cap=res_cap)
        else:
            rbuf, r_res, r_ovf, _ = _bucketize(rk, r_active, ndev, cap_r,
                                               R_PAD, res_cap=res_cap)
            sbuf, s_res, s_ovf, _ = _bucketize(sk, s_active, ndev, cap_s,
                                               S_PAD, res_cap=res_cap)
            r_recv = lax.all_to_all(rbuf, axis, split_axis=0,
                                    concat_axis=0).reshape(-1)
            s_recv = lax.all_to_all(sbuf, axis, split_axis=0,
                                    concat_axis=0).reshape(-1)
        n_res = lax.psum(jnp.sum(r_res != R_PAD, dtype=jnp.int64) +
                         jnp.sum(s_res != S_PAD, dtype=jnp.int64), axis)
        return (r_recv, s_recv, r_res, s_res,
                lax.psum(r_ovf, axis), lax.psum(s_ovf, axis), n_res)

    def join_body(r_recv, s_recv):
        return lax.psum(_count_sorted(r_recv, s_recv, i32_keys), axis)

    def repair_body(r_res, s_res, r_recv, s_recv):
        return lax.psum(
            _residual_matches(r_res, s_res, r_recv, s_recv, axis, i32_keys),
            axis)

    sm = functools.partial(shard_map, mesh=mesh)
    ex = jax.jit(sm(exchange_body, in_specs=(spec, spec),
                    out_specs=(spec, spec, spec, spec, P(), P(), P())))
    jo = jax.jit(sm(join_body, in_specs=(spec, spec), out_specs=P()))
    rp = jax.jit(sm(repair_body, in_specs=(spec,) * 4, out_specs=P()))
    return ex, jo, rp


def _pad_to(keys: jnp.ndarray, multiple: int, pad_value):
    n = keys.shape[0]
    pad = (-n) % multiple
    if pad:
        keys = jnp.concatenate(
            [keys, jnp.full((pad,), pad_value, keys.dtype)])
    return keys


def scaling_point(mesh_shape, n_r: int, n_s: int, *, data: str = "uniform",
                  zipf_theta: float = 1.1, seed: int = 0,
                  reps: int = 2, skew_handling: bool = False) -> dict:
    """One scaling measurement: phase-split distributed join on a mesh of
    prod(mesh_shape) devices.  Returns the best-of-reps phase times.

    ``skew_handling`` runs the production skew plan (hot keys never move:
    dist_join's sampled heavy-hitter path) as ONE fused program — the
    per-phase split does not apply, so phase columns read 0 and the total
    is the fused program's time.  This is the plan the engine actually
    picks for zipf data; the skew-off zipf rows exist to show what the
    repair path costs without it."""
    from ..data.generators import pk_keys, sorted_keys, zipf_keys

    names = ("host", "chip") if len(mesh_shape) == 2 else ("x",)
    mesh = make_mesh(tuple(mesh_shape), names)
    ndev = mesh.devices.size
    rk = _pad_to(pk_keys(n_r, seed), ndev, R_PAD)
    if data.startswith("zipf"):
        sk = _pad_to(zipf_keys(n_s, n_r, zipf_theta, seed + 1), ndev, S_PAD)
    else:
        sk = _pad_to(sorted_keys(n_s), ndev, S_PAD)
    jax.block_until_ready((rk, sk))
    if skew_handling:
        from jax.sharding import NamedSharding, PartitionSpec as P
        from .dist_join import build_dist_join_fn
        spec = P(tuple(mesh.axis_names)) if mesh.devices.ndim == 2 \
            else P(mesh.axis_names[0])
        rk = jax.device_put(rk, NamedSharding(mesh, spec))
        sk = jax.device_put(sk, NamedSharding(mesh, spec))
        fn = build_dist_join_fn(mesh, rk.shape[0], sk.shape[0],
                                skew_handling=True,
                                i32_keys=max(n_r, n_s) < (1 << 30))
        best = None
        for _ in range(max(1, reps)):
            timer = PhaseTimer()
            res = timer.timed("total", fn, rk, sk)
            point = {
                "mesh": list(mesh_shape), "ndev": ndev, "nR": n_r,
                "nS": n_s, "data": data, "exchangeTimeUs": 0.0,
                "joinTimeUs": 0.0, "repairTimeUs": 0.0,
                "totalTimeUs": timer.total(),
                "matches": int(res.matches), "repairFired": False,
                "overflowR": int(res.dropped_r + res.repaired_r),
                "overflowS": int(res.dropped_s + res.repaired_s),
                "skewHandling": True, "hotKeys": int(res.num_hot),
            }
            if best is None or point["totalTimeUs"] < best["totalTimeUs"]:
                best = point
        best["matchesExpected"] = n_s
        best["exact"] = best["matches"] == n_s
        return best
    # generator keys are 1..max(n_r, n_s): certify the int32 tagged
    # composite for the count/repair sorts whenever that bound allows
    ex, jo, rp = _phase_fns(mesh, n_r, n_s,
                            i32_keys=max(n_r, n_s) < (1 << 30))

    best = None
    for _ in range(max(1, reps)):
        timer = PhaseTimer()
        r_recv, s_recv, r_res, s_res, rov, sov, n_res = timer.timed(
            "exchange", ex, rk, sk)
        matches = int(timer.timed("join", jo, r_recv, s_recv))
        repaired = 0
        if int(n_res) > 0:
            repaired = int(timer.timed("repair", rp, r_res, s_res,
                                       r_recv, s_recv))
            matches += repaired
        point = {
            "mesh": list(mesh_shape), "ndev": ndev, "nR": n_r, "nS": n_s,
            "data": data,
            "exchangeTimeUs": timer.micros.get("exchange", 0.0),
            "joinTimeUs": timer.micros.get("join", 0.0),
            "repairTimeUs": timer.micros.get("repair", 0.0),
            "totalTimeUs": timer.total(),
            "matches": matches, "repairFired": int(n_res) > 0,
            "overflowR": int(rov), "overflowS": int(sov),
        }
        if best is None or point["totalTimeUs"] < best["totalTimeUs"]:
            best = point
    # PK ⋈ (sorted|zipf-FK): every S tuple matches exactly once
    best["matchesExpected"] = n_s
    best["exact"] = best["matches"] == n_s
    return best


def scaling_sweep(out_path: str, *, per_dev_log2: int = 17,
                  strong_log2: int = 20, reps: int = 2,
                  meshes=((1,), (2,), (4,), (8,), (2, 2), (2, 4)),
                  echo: bool = True) -> list:
    """Weak + strong scaling × flat/hierarchical × uniform/zipf sweep.
    Writes one JSON line per point to out_path (the scaling_log) and a
    summary block with efficiencies vs the 1-device baseline."""
    lines = []
    ndevs_avail = len(jax.devices())
    for mode in ("weak", "strong"):
        for mesh_shape in meshes:
            ndev = int(np.prod(mesh_shape))
            if ndev > ndevs_avail:
                continue
            n = (1 << per_dev_log2) * ndev if mode == "weak" \
                else (1 << strong_log2)
            for data, skew in (("uniform", False), ("zipf", False),
                               ("zipf+skew", True)):
                pt = scaling_point(mesh_shape, n, n, data=data, reps=reps,
                                   skew_handling=skew)
                pt["mode"] = mode
                lines.append(pt)
                if echo:
                    print(json.dumps(pt), flush=True)
    # efficiency vs the 1-device flat baseline of the same (mode, data).
    # Two normalizations: `efficiency` assumes every device is real
    # hardware (the number that matters on an actual slice); on a VIRTUAL
    # mesh all N devices share one host's cores, so `efficiencyShared`
    # normalizes against perfectly serialized single-host execution of the
    # same total work — the sharding-overhead metric the virtual mesh can
    # honestly measure.
    shared = len(jax.devices()) > 1 and jax.default_backend() == "cpu"
    base = {(p["mode"], p["data"]): p for p in lines if p["ndev"] == 1}
    for p in lines:
        b = base.get((p["mode"], p["data"]))
        if not b or p["ndev"] == 1:
            p["efficiency"] = p["efficiencyShared"] = 1.0
            continue
        if p["mode"] == "weak":       # real ideal: constant time
            p["efficiency"] = b["totalTimeUs"] / p["totalTimeUs"]
            # shared-core ideal: N x the 1-dev time (N x the work)
            p["efficiencyShared"] = (p["ndev"] * b["totalTimeUs"] /
                                     p["totalTimeUs"])
        else:                         # real ideal: time / ndev
            p["efficiency"] = b["totalTimeUs"] / (p["ndev"] *
                                                  p["totalTimeUs"])
            # shared-core ideal: same work, same cores -> the 1-dev time
            p["efficiencyShared"] = b["totalTimeUs"] / p["totalTimeUs"]
    del shared
    with open(out_path, "w") as f:
        for p in lines:
            f.write(json.dumps(p) + "\n")
    return lines


def main(argv=None) -> int:
    import argparse
    import os

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--outDir", default="experiments/results_scaling")
    p.add_argument("--perDevLog2", type=int, default=17)
    p.add_argument("--strongLog2", type=int, default=20)
    p.add_argument("--reps", type=int, default=2)
    a = p.parse_args(argv)
    os.makedirs(a.outDir, exist_ok=True)
    out = os.path.join(a.outDir, "scaling_log")
    lines = scaling_sweep(out, per_dev_log2=a.perDevLog2,
                          strong_log2=a.strongLog2, reps=a.reps)
    # summary table
    virt = jax.default_backend() == "cpu" and len(jax.devices()) > 1
    md = [
        "# Scaling efficiency (virtual mesh)", "",
        f"Backend: {jax.default_backend()}, {len(jax.devices())} devices.",
        "Weak: n/device constant (ideal = flat time).  Strong: total n "
        "constant (ideal = 1/ndev time).  Phase split: exchange "
        "(bucketize+all_to_all) / local join / repair.", "",
    ]
    if virt:
        md += [
            "**Virtual-mesh caveat**: all devices here are one host's CPU "
            "cores, so wall-clock `eff(hw)` conflates scaling with core "
            "oversubscription and is a LOWER BOUND on real-slice "
            "efficiency.  `eff(shared)` normalizes against perfectly "
            "serialized single-host execution of the same total work — "
            "values near/above 100% mean the sharded program adds no "
            "overhead beyond the work itself (the claim the virtual mesh "
            "can actually test; real-slice numbers require real chips).",
            "",
        ]
    md += [
        "| mode | mesh | data | exchange ms | join ms | repair ms | "
        "total ms | matches exact | eff(hw) | eff(shared) |",
        "| --- | --- | --- | --- | --- | --- | --- | --- | --- | --- |",
    ]
    for p_ in lines:
        md.append("| {} | {} | {} | {:.1f} | {:.1f} | {:.1f} | {:.1f} | "
                  "{} | {:.0%} | {:.0%} |".format(
                      p_["mode"], "x".join(map(str, p_["mesh"])), p_["data"],
                      p_["exchangeTimeUs"] / 1e3, p_["joinTimeUs"] / 1e3,
                      p_["repairTimeUs"] / 1e3, p_["totalTimeUs"] / 1e3,
                      p_["exact"], p_["efficiency"], p_["efficiencyShared"]))
    md += [
        "",
        "## Reading the rows (round-4 structure)",
        "",
        "* **uniform / zipf rows** run the phase-split pipeline: one fused "
        "bucketize (stable sort by destination) + all_to_all exchange "
        "(flat) or the FUSED hierarchical variant (2x2/2x4: the same "
        "single bucketize + chip-level all_to_all + transpose + "
        "host-level all_to_all — no stage-2 re-sort), then the local "
        "tagged-sort count, then the cooperative residual repair iff any "
        "send bucket overflowed.",
        "* **hierarchical ≈ flat** is the round-4 claim to check: at "
        "equal device count the 2xN exchange column should sit within "
        "~1.5x of the flat-N row (round 3 measured 2.9-6.7 s vs "
        "1.1-1.9 s; the fused exchange removed the stage-2 "
        "re-hash/re-sort).",
        "* **zipf (skew off) rows at 8 devices** overflow the hot "
        "destinations' send buckets, so the repair round fires and "
        "dominates — that is the measured cost of NOT using the skew "
        "plan, kept as the ablation.",
        "* **zipf+skew rows** run the production plan for skewed data "
        "(dist_join skew_handling: sampled heavy hitters never move; "
        "hot matches come from two HOT_CAP-sized psums).  One fused "
        "program — no phase split — and no repair: this is the row "
        "family the ≥80% shared-efficiency target applies to.",
        "* eff(shared) above 100% is real on a virtual mesh: sharded "
        "sorts are O(n log n) on 1/N of the data per device, so N shards "
        "do LESS total comparison work than the 1-device sort.",
    ]
    with open(os.path.join(a.outDir, "SCALING.md"), "w") as f:
        f.write("\n".join(md) + "\n")
    print("\n".join(md))
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
