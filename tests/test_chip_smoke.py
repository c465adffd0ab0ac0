"""chip_smoke.py's phases at small sizes on the CPU, its refusal to run
without a GPU, and the same phases on the card (``gpu`` marker)."""

import os
import subprocess
import sys

import jax
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402


def test_phase_adaptive_local_shuffle():
    rec = chip_smoke.phase_adaptive_local_shuffle(1 << 13)
    assert rec["result"]["chosenPath"] == "htm"
    assert rec["result"]["totalMatches"] == 1 << 13


def test_phase_adaptive_zipf():
    rec = chip_smoke.phase_adaptive_zipf(1 << 13, 1 << 10)
    assert rec["result"]["chosenPath"] == "radix"
    assert rec["result"]["totalMatches"] == rec["reference"]["totalMatches"]


def test_phase_radix_zipf_probe():
    rec = chip_smoke.phase_radix_zipf_probe(1 << 13)
    assert rec["result"]["totalMatches"] == 1 << 13


def test_phase_algos_shuffle():
    recs = chip_smoke.phase_algos_shuffle(1 << 12)
    assert [r["result"]["algo"] for r in recs] == list(chip_smoke.SHUFFLE_ALGOS)


@pytest.mark.parametrize("conf_name", chip_smoke.WISCONSIN_CONFS)
def test_phase_wisconsin(conf_name):
    rec = chip_smoke.phase_wisconsin(conf_name, shift=10)
    assert rec["result"]["outputRows"] == (1 << 28) >> 10


def test_phase_distributed():
    """Both four-device meshes and the one-device run, on four of the
    virtual CPU devices."""
    recs = chip_smoke.phase_distributed(1 << 12)
    assert [r["phase"] for r in recs] == [
        "one_card", "distributed_4", "distributed_2,2"]
    assert len({r["result"]["totalMatches"] for r in recs}) == 1


def test_mismatch_raises():
    with pytest.raises(chip_smoke.PhaseMismatch, match="totalMatches"):
        chip_smoke.expect("p", "totalMatches", 1, 2)


def test_main_refuses_cpu(tmp_path):
    """No GPU: non-zero exit, the reason on stderr, nothing on stdout."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                       cwd=tmp_path, env=env, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0
    assert "no GPU found" in p.stderr
    assert p.stdout == ""


@pytest.fixture
def gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU (JAX_PLATFORMS=cuda python -m pytest -m gpu)")


@pytest.mark.gpu
def test_phases_on_gpu(gpu):
    chip_smoke.phase_adaptive_local_shuffle(1 << 20)
    chip_smoke.phase_adaptive_zipf(1 << 20, 1 << 17)
    chip_smoke.phase_radix_zipf_probe(1 << 20)
    chip_smoke.phase_algos_shuffle(1 << 20)
    chip_smoke.phase_wisconsin("radix1.conf", shift=6)
