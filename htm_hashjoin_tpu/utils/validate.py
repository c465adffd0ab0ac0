"""Correctness oracles (SURVEY.md §4).

The reference has no unit tests; its correctness methodology is embedded in
the benchmark outputs: conservation checksums (inputSum == outputSum,
HTMHashBuild.hpp:312-401), known-cardinality match counts (PK ⋈ sorted ⇒
matches == rSize, experiments/alt/probe_log1:1) and fixed-seed determinism.
This module makes those oracles first-class so both tests and production runs
can assert them.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def key_sum(keys) -> int:
    """Exact Σ keys in int64 (inputSum)."""
    return int(jnp.sum(jnp.asarray(keys).astype(jnp.int64)))


def reference_match_count(r_keys, s_keys) -> int:
    """Oracle join cardinality computed on host with numpy (multiset
    semantics) — the ground truth for totalMatches.  Small non-negative
    key domains count through bincount (linear time, so relations of
    2^28 rows check in seconds); others through sorted unique counts."""
    r = np.asarray(r_keys).ravel()
    s = np.asarray(s_keys).ravel()
    if r.size == 0 or s.size == 0:
        return 0
    lo = min(int(r.min()), int(s.min()))
    hi = max(int(r.max()), int(s.max()))
    if lo >= 0 and hi <= 4 * (r.size + s.size):
        cr = np.bincount(r, minlength=hi + 1).astype(np.int64)
        cs = np.bincount(s, minlength=hi + 1).astype(np.int64)
        return int(np.dot(cr, cs))
    r_vals, r_counts = np.unique(r, return_counts=True)
    s_vals, s_counts = np.unique(s, return_counts=True)
    idx = np.searchsorted(r_vals, s_vals)
    idx = np.clip(idx, 0, len(r_vals) - 1)
    hit = r_vals[idx] == s_vals
    return int(np.sum(r_counts[idx][hit].astype(np.int64) *
                      s_counts[hit].astype(np.int64)))


def assert_conserved(input_sum: int, output_sum: int, context: str = "") -> None:
    if input_sum != output_sum:
        raise AssertionError(
            f"conservation violated{': ' + context if context else ''}: "
            f"inputSum={input_sum} outputSum={output_sum} "
            f"(lost {input_sum - output_sum})")
