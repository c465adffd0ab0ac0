"""Test configuration: run on CPU with a virtual 8-device mesh.

The reference had no tests at all (SURVEY.md §4); this suite implements its
embedded correctness methodology (conservation checksums, known-cardinality
match counts, fixed-seed determinism) as a real pytest suite, runnable
without a GPU.  Multi-device sharding tests use XLA's host-platform
device-count override.  JAX_PLATFORMS defaults to cpu, which keeps every
test worker off the card (a JAX process reserves most of a GPU's memory when
it first uses it); the ``gpu``-marked tests run on the card in one process
with ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.

The native libraries are built from source (``make -C native``) before any
test module imports them; the build is a no-op when they are up to date.
"""

import os
import subprocess
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                           " --xla_force_host_platform_device_count=8")

_NATIVE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")
_build = subprocess.run(["make", "-s", "-C", _NATIVE], capture_output=True,
                        text=True)
if _build.returncode:
    sys.stderr.write(f"make -C native failed:\n{_build.stderr}")

