"""Device-memory bandwidth microbench — TestBed.cpp:10-38 re-done for device memory.

The reference times a TBB-parallel memcpy of 2^27 × 8 B to sanity-check the
machine's DRAM bandwidth (the roofline every build phase is judged
against).  Here the same fixture is a jitted device-to-device copy: an
elementwise identity forces a full device-memory read + write of the buffer, so
GB/s ≈ 2 × bytes / time — the number to compare kernel throughput against.
"""

from __future__ import annotations

import json
import time
from typing import Dict

import jax
import jax.numpy as jnp


def memory_bandwidth(log2_elems: int = 27, reps: int = 5,
                     chain: int = 16) -> Dict[str, float]:
    """Copy 2^log2_elems elements on device; report GB/s (read+write).

    Two figures: ``gbps`` from ONE program running a CHAIN of ``chain``
    dependent copies (amortizes the per-dispatch overhead), and
    ``gbpsSingleFenced`` from the naive single-copy timing (the
    reference's TestBed.cpp:10-38 shape, kept for comparability)."""
    n = 1 << log2_elems
    src = jnp.arange(n, dtype=jnp.int32)
    copy = jax.jit(lambda a: a + 0)
    chained = jax.jit(lambda a: jax.lax.fori_loop(
        0, chain, lambda i, x: x + 1, a))

    def best_of(fn):
        jax.block_until_ready(fn(src))          # compile + warm
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(src))
            best = min(best, time.perf_counter() - t0)
        return best

    best = best_of(copy)
    per_copy = best_of(chained) / chain
    nbytes = n * src.dtype.itemsize
    return {
        "benchmark": "testbed_memcpy",
        "elems": n,
        "bytes": nbytes,
        "chain": chain,
        "bestTimeUsecs": per_copy * 1e6,
        "gbps": 2 * nbytes / per_copy / 1e9,   # read + write traffic
        "singleFencedTimeUsecs": best * 1e6,
        "gbpsSingleFenced": 2 * nbytes / best / 1e9,
    }


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--log2Elems", type=int, default=27)
    p.add_argument("--reps", type=int, default=5)
    a = p.parse_args(argv)
    print(json.dumps(memory_bandwidth(a.log2Elems, a.reps)))
    return 0
