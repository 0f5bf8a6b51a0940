"""CLI driver smoke tests: full subprocess runs on a tiny synthetic problem.

These exercise the user-facing surface end-to-end: argument parsing, solve,
telemetry, checkpoint write/resume, trajectory export.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from gbp_poplar.utils import balio

_ENV = dict(os.environ, GBP_PLATFORM="cpu",
            XLA_FLAGS=os.environ.get("XLA_FLAGS", ""))
_REPO = os.path.join(os.path.dirname(__file__), "..")


pytestmark = pytest.mark.slow   # full solves / subprocess runs

@pytest.fixture(scope="module")
def tiny_bal(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bal") / "tiny.txt")
    prob = balio.synthetic_problem(n_keyframes=5, n_points=40, seed=4,
                                   pixel_noise=0.5)
    balio.save_bal(path, prob)
    return path


def _run(mod, *args):
    return subprocess.run(
        [sys.executable, "-m", mod, *args],
        capture_output=True, text=True, env=_ENV, cwd=_REPO, timeout=240)


def test_ba_cli_end_to_end(tiny_bal, tmp_path):
    traj = str(tmp_path / "traj.txt")
    ckpt = str(tmp_path / "ckpt.npz")
    r = _run("gbp_poplar.drivers.ba",
             "--bal_file", tiny_bal, "--n_iters", "40",
             "--print_every", "20", "--save_traj", traj,
             "--checkpoint", ckpt, "--gn_check")
    assert r.returncode == 0, r.stderr[-2000:]
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("iter")]
    assert len(lines) == 40
    # error decreased
    first = float(lines[0].split()[3])
    last = float(lines[-1].split()[3])
    assert last < first
    assert os.path.exists(traj) and os.path.exists(ckpt)
    assert "GN baseline" in r.stderr
    # polish is the ba-driver DEFAULT (safe defaults: exact-MAP output)
    assert "polish:" in r.stderr
    rows = np.loadtxt(traj)
    assert rows.shape == (5, 8)


def test_ba_cli_resume(tiny_bal, tmp_path):
    ckpt = str(tmp_path / "c.npz")
    r1 = _run("gbp_poplar.drivers.ba", "--bal_file", tiny_bal,
              "--n_iters", "20", "--checkpoint", ckpt)
    assert r1.returncode == 0, r1.stderr[-2000:]
    r2 = _run("gbp_poplar.drivers.ba", "--bal_file", tiny_bal,
              "--n_iters", "40", "--resume", ckpt)
    assert r2.returncode == 0, r2.stderr[-2000:]
    assert "resumed from" in r2.stderr
    lines = [ln for ln in r2.stdout.splitlines() if ln.startswith("iter")]
    assert lines[0].split()[1] == "20"       # continues at the saved step


def test_slam_cli_end_to_end(tiny_bal):
    r = _run("gbp_poplar.drivers.slam",
             "--bal_file", tiny_bal, "--iters_between_kfs", "30",
             "--print_every", "30", "--avdepth", "6.0")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "final reprojection error" in r.stderr
    final = float(r.stderr.split("final reprojection error:")[1].split("px")[0])
    assert final < 2.0
    assert r.stderr.count("inserted") == 3   # keyframes 2..4


def test_ba_cli_polish(tiny_bal, tmp_path):
    traj = str(tmp_path / "pol.txt")
    r = _run("gbp_poplar.drivers.ba",
             "--bal_file", tiny_bal, "--n_iters", "40",
             "--print_every", "20", "--save_traj", traj, "--polish")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "polish:" in r.stderr
    # polished output is a valid trajectory
    assert np.isfinite(np.loadtxt(traj)).all()
    # --no_polish opts back out to raw message-passing means
    r2 = _run("gbp_poplar.drivers.ba",
              "--bal_file", tiny_bal, "--n_iters", "40",
              "--print_every", "20", "--no_polish")
    assert r2.returncode == 0, r2.stderr[-2000:]
    assert "polish:" not in r2.stderr


def test_ba_cli_verbose_streams_beliefs_every_iteration(tiny_bal):
    """--v prints the camera belief means at EVERY iteration (the
    reference streams beliefs to the host and prints them each sweep,
    ba/ba.cpp:1030-1051; here they ride the scan outputs)."""
    r = _run("gbp_poplar.drivers.ba",
             "--bal_file", tiny_bal, "--n_iters", "12",
             "--print_every", "6", "--no_polish", "--v")
    assert r.returncode == 0, r.stderr[-2000:]
    dumps = [ln for ln in r.stdout.splitlines()
             if ln.startswith("beliefs (cam means) at iter")]
    assert len(dumps) == 12, r.stdout[-2000:]
    # and the final iteration's means are real numbers
    seg = r.stdout.split("beliefs (cam means) at iter 11:")[1]
    assert "nan" not in seg.lower() and "inf" not in seg.lower()


def test_slam_cli_resume(tiny_bal, tmp_path):
    ckpt = str(tmp_path / "s.npz")
    traj1 = str(tmp_path / "t1.txt")
    r1 = _run("gbp_poplar.drivers.slam",
              "--bal_file", tiny_bal, "--iters_between_kfs", "30",
              "--print_every", "30", "--avdepth", "6.0",
              "--checkpoint", ckpt, "--save_traj", traj1)
    assert r1.returncode == 0, r1.stderr[-2000:]
    # resume from the final checkpoint: state round-trips losslessly, so the
    # exported trajectory is identical (no further segments run)
    traj2 = str(tmp_path / "t2.txt")
    r2 = _run("gbp_poplar.drivers.slam",
              "--bal_file", tiny_bal, "--iters_between_kfs", "30",
              "--resume", ckpt, "--save_traj", traj2)
    assert r2.returncode == 0, r2.stderr[-2000:]
    assert "resumed from" in r2.stderr
    np.testing.assert_allclose(np.loadtxt(traj2), np.loadtxt(traj1),
                               rtol=0, atol=0)
    # a mismatched --devices must be rejected, not silently ignored
    r3 = _run("gbp_poplar.drivers.slam",
              "--bal_file", tiny_bal, "--iters_between_kfs", "30",
              "--resume", ckpt, "--devices", "2")
    assert r3.returncode == 2


def test_slam_cli_sharded(tiny_bal, tmp_path):
    ckpt = str(tmp_path / "shard.npz")
    r = _run("gbp_poplar.drivers.slam",
             "--bal_file", tiny_bal, "--iters_between_kfs", "30",
             "--print_every", "30", "--avdepth", "6.0",
             "--devices", "2", "--checkpoint", ckpt,
             "--checkpoint_every", "30")
    assert r.returncode == 0, r.stderr[-2000:]
    final = float(r.stderr.split("final reprojection error:")[1].split("px")[0])
    assert final < 2.0
    assert os.path.exists(ckpt)
    # telemetry lines carry real cost/relins (not the round-1 NaN stubs)
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("iter")]
    assert lines and all("nan" not in ln.lower() for ln in lines)
    # sharded checkpoint resumes (same --devices) and matches
    r2 = _run("gbp_poplar.drivers.slam",
              "--bal_file", tiny_bal, "--iters_between_kfs", "30",
              "--resume", ckpt, "--devices", "2")
    assert r2.returncode == 0, r2.stderr[-2000:]
    assert "resumed from" in r2.stderr


def test_bench_emits_json(tiny_bal):
    """bench.py contract: runs end-to-end (reduced workload via env) and the
    last stdout line is ONE JSON object with the agreed keys."""
    env = dict(_ENV, GBP_PLATFORM="cpu", GBP_BENCH_SEQ=tiny_bal,
               GBP_BENCH_SWEEPS="20", GBP_BENCH_GUARD_ITERS="80",
               GBP_BENCH_GUARD_PX="3.0",
               # the extra fr2robot2 / 1M-edge measurements are card-scale
               GBP_BENCH_EXTRA="0", GBP_BENCH_SCALE="0")
    r = subprocess.run([sys.executable, "bench.py"], capture_output=True,
                       text=True, env=env, cwd=_REPO, timeout=240)
    assert r.returncode == 0, r.stderr[-2000:]
    data = json.loads(r.stdout.strip().splitlines()[-1])
    assert set(data) == {"metric", "value", "unit", "vs_baseline", "extra"}
    assert data["value"] > 0 and data["unit"] == "sweeps/s"


def test_slam_cli_polish(tiny_bal, tmp_path):
    traj = str(tmp_path / "t.txt")
    r = _run("gbp_poplar.drivers.slam",
             "--bal_file", tiny_bal, "--iters_between_kfs", "60",
             "--print_every", "30", "--polish", "--save_traj", traj)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "polish: reproj" in r.stderr
    pol = float(r.stderr.split("polish: reproj ")[1].split(" px")[0])
    fin = float(r.stderr.split("final reprojection error: ")[1].split(" px")[0])
    assert pol <= fin + 0.05       # refinement does not degrade the fit
    assert np.loadtxt(traj).shape == (5, 8)


def test_slam_cli_sharded_polish(tiny_bal, tmp_path):
    """Map-sharded --polish + host oracle: the partitioned landmark axis is
    the global order plus trailing dummies, so the exact-MAP toolchain runs
    at any --devices (reference: full-state round trips, slam.cpp:913-948)."""
    traj = str(tmp_path / "tp.txt")
    r = _run("gbp_poplar.drivers.slam",
             "--bal_file", tiny_bal, "--iters_between_kfs", "30",
             "--print_every", "30", "--avdepth", "6.0",
             "--devices", "2", "--polish", "--save_traj", traj)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "polish: reproj" in r.stderr
    assert "host oracle" in r.stderr
    pol = float(r.stderr.split("polish: reproj ")[1].split(" px")[0])
    fin = float(
        r.stderr.split("final reprojection error: ")[1].split(" px")[0])
    assert pol <= fin + 0.05
    assert np.isfinite(np.loadtxt(traj)).all()
