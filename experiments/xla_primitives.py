"""Time the XLA primitives the join paths are built from, at 2^27 int32 keys.

    python experiments/xla_primitives.py [log2_n]

Prints one JSON line per primitive: the median of 5 timed calls (after one
compiling call), and the implied rate of the bytes each call must at least
read and write (its inputs plus its outputs) against the H100's published
3.35 TB/s.  A real sort moves more than that floor (several passes), so
the implied rate is a lower bound on the traffic, not a measurement of it.
Fails when JAX finds no GPU.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import htm_hashjoin_tpu  # noqa: E402,F401  (x64)
from htm_hashjoin_tpu.ops import probe  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet


def _time(fn, *args, reps: int = 5):
    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times), times


def main() -> int:
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU found (platform {dev.platform!r})", file=sys.stderr)
        return 1
    n = 1 << (int(sys.argv[1]) if len(sys.argv) > 1 else 27)
    key = jax.random.PRNGKey(0)
    perm = jax.random.permutation(key, jnp.arange(1, n + 1, dtype=jnp.int32))
    pay = jnp.arange(n, dtype=jnp.int32)
    srt = jnp.arange(1, n + 1, dtype=jnp.int32)
    cases = {
        # name: (fn, args, bytes read + written at the least)
        "jnp.sort int32": (jax.jit(jnp.sort), (perm,), 8 * n),
        "lax.sort_key_val int32/int32": (
            jax.jit(lambda k, v: jax.lax.sort_key_val(k, v)), (perm, pay),
            16 * n),
        "probe.probe_sorted 2^k vs 2^k": (
            jax.jit(probe.probe_sorted), (srt, perm), 8 * n),
        "probe.probe_sorted i32_keys": (
            jax.jit(lambda r, s: probe.probe_sorted(r, s, i32_keys=True)),
            (srt, perm), 8 * n),
        "probe.count_in_sorted 2^k vs sorted 2^k": (
            probe.count_in_sorted, (perm, srt), 8 * n),
    }
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    for name, (fn, args, byts) in cases.items():
        med, times = _time(fn, *args)
        print(json.dumps({
            "primitive": name, "n": n, "median_s": med, "run_s": times,
            "implied_bytes_per_s": byts / med,
            "share_of_3.35TB/s": byts / med / HBM_BYTES_PER_S,
            "device_kind": dev.device_kind, "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
