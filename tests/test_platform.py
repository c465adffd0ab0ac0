"""What the package asks of its platform: no Pallas module written for
another accelerator, no interpret-mode kernel, and the compile cache where JAX_COMPILATION_CACHE_DIR
(or, unset, a fixed directory of the checkout) says."""

import os
import pathlib
import subprocess
import sys

import pytest

import htm_hashjoin_tpu

ROOT = pathlib.Path(__file__).resolve().parent.parent
SOURCES = sorted((ROOT / "htm_hashjoin_tpu").rglob("*.py")) + [
    ROOT / "bench.py", ROOT / "chip_smoke.py", ROOT / "__graft_entry__.py"]


# needles assembled from parts, so that a search of the repository for
# these names does not find this test itself
_T = "t" + "pu"
NEEDLES = ["pallas." + _T, "pl" + _T, "interp" + "ret=", '== "' + _T + '"',
           _T.upper() + "_CLOCK"]


@pytest.mark.parametrize("needle", NEEDLES)
def test_no_foreign_accelerator_code(needle):
    hits = [str(p.relative_to(ROOT)) for p in SOURCES
            if needle in p.read_text()]
    assert not hits, hits


def test_importing_every_module_loads_no_pallas():
    code = ("import importlib, pkgutil, sys, htm_hashjoin_tpu as h\n"
            "for m in pkgutil.walk_packages(h.__path__, 'htm_hashjoin_tpu.'):\n"
            "    importlib.import_module(m.name)\n"
            "print(sorted(k for k in sys.modules if 'pallas' in k))\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    assert out.strip() == "[]"    # no Pallas module of any route


def test_cache_dir_unset_is_fixed_checkout_dir():
    assert htm_hashjoin_tpu.compile_cache_dir({}) == str(ROOT / ".jax_cache")


def test_cache_dir_set_leaves_jax_to_read_it():
    env = {"JAX_COMPILATION_CACHE_DIR": "/elsewhere"}
    assert htm_hashjoin_tpu.compile_cache_dir(env) is None


@pytest.mark.parametrize("env_dir", [None, "given"])
def test_cache_dir_in_a_fresh_process(tmp_path, env_dir):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    want = str(ROOT / ".jax_cache")
    if env_dir:
        want = env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / env_dir)
    code = ("import jax, htm_hashjoin_tpu\n"
            "print(jax.config.jax_compilation_cache_dir)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    assert out.strip() == want


def test_cache_dir_is_gitignored():
    assert ".jax_cache/" in (ROOT / ".gitignore").read_text().split()
