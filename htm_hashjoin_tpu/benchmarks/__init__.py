"""Sanity-fixture microbenchmarks (SURVEY.md §4 item 6).

  testbed  — device-memory copy bandwidth (TestBed.cpp:10-38: 2^27×8B parallel
             memcpy timing; here a device-to-device array copy).
  simple   — chunk-size overhead sweep (simple.cpp:18-110: single-thread
             transaction overhead/capacity aborts per tSize; here the
             optimistic-scatter failure fraction and per-chunk cost).
"""

from .testbed import memory_bandwidth
from .simple import chunk_sweep

__all__ = ["memory_bandwidth", "chunk_sweep"]
