"""chip_smoke.py's contract, checked on the CPU: no GPU means a non-zero
exit and no result line; the phases' checks run the real drivers on tiny
problems (the card runs them at published shapes)."""

import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

import chip_smoke

_REPO = os.path.join(os.path.dirname(__file__), "..")


def test_require_gpu_raises_on_cpu():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.require_gpu()


def test_result_line_has_exactly_the_contract_keys():
    line = json.loads(chip_smoke.result_line(jax.devices()[:4]))
    assert set(line) == {"ok", "device"}
    assert line["ok"] is True
    assert set(line["device"]) == {"platform", "kind", "count"}
    assert line["device"]["platform"] == jax.devices()[0].platform
    assert line["device"]["kind"] == jax.devices()[0].device_kind
    assert line["device"]["count"] == 4


def _run(cwd, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py", *args],
                          capture_output=True, text=True, env=env, cwd=cwd,
                          timeout=120)


@pytest.mark.parametrize("args", [(), ("--four-cards",)],
                         ids=["one-card", "four-cards"])
def test_exits_nonzero_without_gpu(args):
    r = _run(_REPO, *args)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_exits_nonzero_alone(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo."""
    shutil.copy(os.path.join(_REPO, "chip_smoke.py"), tmp_path)
    r = _run(str(tmp_path))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_sweep_parity_against_float64():
    """The parity phase on a tiny problem, with the CPU in the GPU's seat:
    both gaps are then the same float32 run, and both are small."""
    from gbp_poplar.utils import balio

    prob = balio.synthetic_problem_large(8, 200, 4, seed=1)
    g_dev, g_cpu = chip_smoke.sweep_parity(prob, jax.devices()[0])
    assert 0 < g_cpu < 1e-4
    assert g_dev == pytest.approx(g_cpu, rel=1e-6)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("smoke"))
    path, prob = chip_smoke.write_problem("tiny", (12, 600, 5), d)
    return d, path, prob


def test_ba_phase_checks_against_noise_floor(tiny):
    d, path, prob = tiny
    res = chip_smoke.ba_phase("tiny", path, prob, d, ["--n_iters", "300"])
    assert res["polished"] <= res["floor"] < res["start"]
    assert res["gbp"] < chip_smoke.GBP_FLOOR_RATIO * res["floor"]
    assert os.path.exists(os.path.join(d, "tiny_ckpt.npz"))


def test_slam_phase_final_error(tiny):
    d, path, prob = tiny
    res = chip_smoke.slam_phase("tiny-slam", path, prob, d)
    assert np.isfinite(res["final"])
    assert res["final"] < chip_smoke.SLAM_MAX_PX


def test_failed_check_raises():
    with pytest.raises(AssertionError, match="must hold"):
        chip_smoke.check(False, "must hold")
