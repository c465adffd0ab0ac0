"""Device mesh construction.

The reference's parallel substrate is pinned pthreads + NUMA first-touch
(mc/src/cpu_mapping.c:54-81, generator.c:353-405 — SURVEY.md P12).  The
equivalent here is a jax.sharding.Mesh over the devices (one host's GPUs,
joined all to all); `cpu-mapping.txt` becomes the mesh axis layout.
Several hosts extend the same mesh (jax.distributed.initialize +
jax.devices()), which the single-node reference
never had (SURVEY.md §2.5).
"""

from __future__ import annotations

import math
import os
from typing import List, Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

#: the cpu-mapping.txt analog (mc/src/cpu_mapping.c:54-81, documented in
#: mc/src/cpu-mapping.txt.README): an optional file whose first number is a
#: count followed by that many device ids, fixing mesh placement order.
#: Looked up in $HTM_DEVICE_MAPPING, else ./device-mapping.txt.
MAPPING_ENV = "HTM_DEVICE_MAPPING"
MAPPING_FILE = "device-mapping.txt"


def load_device_mapping(path: Optional[str] = None) -> Optional[List[int]]:
    """Parse the mapping file (format: ``N id0 id1 ... idN-1`` over any
    whitespace — exactly cpu-mapping.txt's).  Returns None when no file is
    configured; raises on a malformed one (the reference silently falls back,
    but a typo silently changing placement is worth surfacing)."""
    path = path or os.environ.get(MAPPING_ENV) or (
        MAPPING_FILE if os.path.exists(MAPPING_FILE) else None)
    if path is None:
        return None
    with open(path) as f:
        nums = [int(t) for t in f.read().split()]
    if not nums or len(nums) < 1 + nums[0]:
        raise ValueError(f"malformed device mapping {path!r}: "
                         f"expected count then that many ids")
    return nums[1:1 + nums[0]]


def _ordered_devices(mapping: Optional[List[int]]):
    """Devices in mapping order (by device id), round-robin wrapped like
    get_cpu_id (cpu_mapping.c:54-81); default order otherwise."""
    devices = jax.devices()
    if not mapping:
        return devices
    by_id = {d.id: d for d in devices}
    try:
        return [by_id[i % len(devices)] if i not in by_id else by_id[i]
                for i in mapping]
    except KeyError as e:
        raise ValueError(f"device mapping names unknown device id {e}")


def make_mesh(shape: Tuple[int, ...] = (), axis_names: Sequence[str] = ("x",),
              mapping: Optional[List[int]] = None) -> Mesh:
    """Build a mesh of the requested shape; () means all available devices
    on one axis.  Placement order honors the device-mapping file when one is
    configured (the thread-pinning analog, SURVEY.md P12)."""
    devices = _ordered_devices(mapping if mapping is not None
                               else load_device_mapping())
    if not shape:
        shape = (len(devices),)
    n = math.prod(shape)
    if n > len(devices):
        raise ValueError(f"mesh {shape} needs {n} devices, have {len(devices)}")
    arr = np.array(devices[:n]).reshape(shape)
    return Mesh(arr, axis_names[: len(shape)])


def shard_relation(keys: jax.Array, mesh: Mesh, axis: str = "x") -> jax.Array:
    """Place a key array row-sharded over the mesh axis (the distributed
    analog of the reference's static per-thread chunking,
    mc/src/no_partitioning_join.c:563-593)."""
    return jax.device_put(keys, NamedSharding(mesh, P(axis)))
