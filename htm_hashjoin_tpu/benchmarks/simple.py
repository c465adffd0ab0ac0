"""Chunk-size sweep — simple.cpp:18-110 re-done for the optimistic build.

The reference's single-thread microbench sweeps transaction size and
reports abort rates and per-transaction overhead (isolating HTM capacity
aborts from concurrency).  The analog here: sweep the optimistic-build
chunk granularity and report the per-chunk failure fraction (the abort-rate
statistic that drives HTM_ADAPT, HTMHashBuild.hpp:196-211) and build time —
on locality data the failure fraction stays ~0 like low-tSize HTM, on
shuffled data it rises with window size.
"""

from __future__ import annotations

import json
import time
from typing import Dict, List

import jax
import jax.numpy as jnp

from ..data.generators import local_shuffled_keys
from ..joins.common import htm_num_buckets
from ..ops import insert


def chunk_sweep(log2_n: int = 20, max_log2_chunk: int = 12,
                shuffle_window: int = 16, seed: int = 0) -> List[Dict]:
    """For each chunk size 2^0..2^max: build optimistically, report the mean
    and max per-chunk failure fraction plus build time."""
    n = 1 << log2_n
    keys = jax.block_until_ready(local_shuffled_keys(n, shuffle_window, seed))
    num_buckets = htm_num_buckets(n)

    @jax.jit
    def build(k):
        res = insert.htm_optimistic_build(k, num_buckets, retry=False,
                                          unique_keys=True)
        return res.failed_optimistic

    failed = jax.block_until_ready(build(keys))
    t0 = time.perf_counter()
    failed = jax.block_until_ready(build(keys))
    build_us = (time.perf_counter() - t0) * 1e6

    rows = []
    for i in range(max_log2_chunk + 1):
        chunk = 1 << i
        fracs = insert.chunk_failure_fractions(failed, chunk)
        rows.append({
            "benchmark": "simple_chunk_sweep",
            "chunkSize": chunk,
            "meanFailureFraction": float(jnp.mean(fracs)),
            "maxFailureFraction": float(jnp.max(fracs)),
            "buildTimeUsecs": build_us,
            "rSize": n,
            "shuffleWindow": shuffle_window,
        })
    return rows


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--log2N", type=int, default=20)
    p.add_argument("--maxLog2Chunk", type=int, default=12)
    p.add_argument("--shuffleWindow", type=int, default=16)
    a = p.parse_args(argv)
    for row in chunk_sweep(a.log2N, a.maxLog2Chunk, a.shuffleWindow):
        print(json.dumps(row))
    return 0
