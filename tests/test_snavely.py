"""Snavely/BAL camera-model support (per-camera focal + radial distortion).

The reference only ships its TUM-variant pinhole format; the original BAL
datasets (Agarwal et al.) use 9-parameter cameras whose projection is
``uv = f (1 + k1 r^2 + k2 r^4) * -(x/z, y/z)`` with the camera looking down
-z. These tests pin: the analytic Jacobians against autodiff, the plane-form
kernel math against the dense oracle, the file-format autodetection
round-trip, and end-to-end GBP == GN convergence through every compute path
(XLA, blocked kernel, fused kernel — interpret mode — and both sharding
modes on the virtual CPU mesh).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gbp_poplar.config import GBPConfig
from gbp_poplar.core import build_graph, gauss_newton, gbp, init_state
from gbp_poplar.ops import planes as pl
from gbp_poplar.ops import projection as pj
from gbp_poplar.utils import balio, evaluation


@pytest.fixture(scope="module")
def snavely_problem():
    prob = balio.synthetic_problem_snavely(8, 80, pixel_noise=0.5, seed=3)
    rng = np.random.default_rng(0)
    prob.lmk_means = prob.lmk_means + rng.normal(0, 0.05,
                                                 prob.lmk_means.shape)
    return prob


def test_snavely_jacobians_match_autodiff():
    rng = np.random.default_rng(1)
    cam = jnp.asarray(rng.normal(0, 0.3, (7, 6)))
    lmk = jnp.asarray(rng.normal(0, 1.0, (7, 3)) + np.array([0, 0, -6.0]))
    intr = jnp.asarray(np.stack([rng.uniform(400, 600, 7),
                                 rng.normal(0, 0.1, 7),
                                 rng.normal(0, 0.01, 7)], 1))
    k = jnp.eye(3)
    jc, jl = pj.reproj_jacobians(cam, lmk, k, intr)
    for i in range(cam.shape[0]):
        jc_ad = jax.jacfwd(lambda c: pj.project(c, lmk[i], k, intr[i]))(
            cam[i])
        jl_ad = jax.jacfwd(lambda p: pj.project(cam[i], p, k, intr[i]))(
            lmk[i])
        np.testing.assert_allclose(jc[i], jc_ad, rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(jl[i], jl_ad, rtol=2e-3, atol=2e-3)


def test_snavely_planes_linearise_matches_dense():
    rng = np.random.default_rng(2)
    n = 9
    cam = jnp.asarray(rng.normal(0, 0.3, (n, 6)))
    lmk = jnp.asarray(rng.normal(0, 1.0, (n, 3)) + np.array([0, 0, -6.0]))
    intr = jnp.asarray(np.stack([rng.uniform(400, 600, n),
                                 rng.normal(0, 0.1, n),
                                 rng.normal(0, 0.01, n)], 1))
    k = jnp.eye(3)
    meas = pj.project(cam, lmk, k, intr) + jnp.asarray(
        rng.normal(0, 3.0, (n, 2)))
    mv = jnp.full((n,), 4.0)

    camp = [cam[:, i] for i in range(6)]
    lmkp = [lmk[:, i] for i in range(3)]
    intp = [intr[:, i] for i in range(3)]
    (u, v), _, _ = pl.project(camp, lmkp, k, intp)
    np.testing.assert_allclose(np.stack([u, v], 1),
                               pj.project(cam, lmk, k, intr), rtol=1e-5)

    eta_c, eta_l, lcc, lcl, lll, rob, _ = pl.linearise(
        camp, lmkp, k, meas[:, 0], meas[:, 1], mv, 2.5, intp)
    pot, rob_d = pj.linearise_factor(cam, lmk, k, meas, mv, 2.5, intr)
    np.testing.assert_allclose(np.stack(eta_c, 1), pot.eta_c,
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.stack(eta_l, 1), pot.eta_l,
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        np.stack([np.stack(row, 1) for row in lcl], 1), pot.lam_cl,
        rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        np.stack([np.stack(row, 1) for row in lcc], 1), pot.lam_cc,
        rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        np.stack([np.stack(row, 1) for row in lll], 1), pot.lam_ll,
        rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(np.asarray(rob), np.asarray(rob_d))


def test_bal_format_roundtrip(tmp_path, snavely_problem):
    path = str(tmp_path / "snavely.txt")
    balio.save_bal(path, snavely_problem)
    p2 = balio.load_bal(path)
    assert p2.camera_model == "snavely"
    np.testing.assert_allclose(p2.intrinsics, snavely_problem.intrinsics,
                               rtol=1e-12)
    np.testing.assert_allclose(p2.cam_means, snavely_problem.cam_means,
                               rtol=1e-12)
    np.testing.assert_allclose(p2.lmk_means, snavely_problem.lmk_means,
                               rtol=1e-12)
    np.testing.assert_allclose(p2.measurements,
                               snavely_problem.measurements, rtol=1e-5)
    np.testing.assert_array_equal(p2.cam_idx, snavely_problem.cam_idx)


@pytest.mark.slow
def test_snavely_gbp_matches_gn(snavely_problem):
    cfg = GBPConfig()
    graph = build_graph(snavely_problem, cfg)
    state = init_state(snavely_problem, cfg)
    final, diag = jax.jit(
        lambda s: gbp.solve(s, graph, cfg, n_iters=150))(state)
    err = float(np.asarray(diag.reproj_err)[-1])

    res = gauss_newton.solve_problem(snavely_problem, cfg, n_lm_iters=40)
    gn_err = float(res.reproj_err[-1])
    assert err < gn_err + 0.02, (err, gn_err)

    cam_mu, lmk_mu = map(np.asarray, gbp._variable_means(final))
    ate = evaluation.ate_rmse(cam_mu.T, np.asarray(res.cam))
    assert ate < 0.01, ate

    # independent NumPy oracle agrees with the on-device telemetry
    e_np, _ = evaluation.numpy_reprojection_error(
        cam_mu.T, lmk_mu.T, snavely_problem)
    assert abs(e_np - err) < 1e-3


@pytest.mark.parametrize("mode", ["edges", "map"])
def test_snavely_sharded_matches_single(snavely_problem, mode):
    from gbp_poplar import parallel
    from gbp_poplar.parallel.map_sharding import make_map_sharded_solver

    cfg = GBPConfig()
    graph = build_graph(snavely_problem, cfg)
    state = init_state(snavely_problem, cfg)
    _, diag = jax.jit(lambda s: gbp.solve(s, graph, cfg, n_iters=60))(state)
    e_ref = float(np.asarray(diag.reproj_err)[-1])

    mesh = parallel.make_mesh(4)
    if mode == "edges":
        solver = parallel.make_sharded_solver(mesh, cfg)
    else:
        solver = make_map_sharded_solver(mesh, cfg)
    g2, s2 = solver.prepare(graph, state)
    _, d2 = solver.solve(s2, g2, 60)
    e_sh = float(np.asarray(d2.reproj_err)[-1])
    assert abs(e_sh - e_ref) < 1e-3, (e_sh, e_ref)


@pytest.mark.slow
def test_ba_cli_on_bal_dataset(tmp_path, snavely_problem):
    """The user-facing ba driver runs a BAL-dataset file end-to-end
    (autodetected) including the GN cross-check and polish."""
    path = str(tmp_path / "snavely.txt")
    balio.save_bal(path, snavely_problem)
    env = dict(os.environ, GBP_PLATFORM="cpu",
               XLA_FLAGS=os.environ.get("XLA_FLAGS", ""))
    r = subprocess.run(
        [sys.executable, "-m", "gbp_poplar.drivers.ba",
         "--bal_file", path, "--n_iters", "60", "--print_every", "30",
         "--gn_check"],
        capture_output=True, text=True, env=env,
        cwd=os.path.join(os.path.dirname(__file__), ".."), timeout=240)
    assert r.returncode == 0, r.stderr[-2000:]
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("iter")]
    assert float(lines[-1].split()[3]) < float(lines[0].split()[3])
    assert "GN baseline" in r.stderr


@pytest.fixture(scope="module")
def perturbed_problem():
    """Snavely problem whose shipped intrinsics are off (as real BAL
    estimates are) — the target of --refine_intrinsics."""
    prob = balio.synthetic_problem_snavely(8, 80, pixel_noise=0.3, seed=3)
    rng = np.random.default_rng(1)
    prob.intrinsics[:, 0] *= rng.uniform(0.93, 1.07, prob.n_keyframes)
    prob.intrinsics[:, 1] += rng.normal(0, 0.05, prob.n_keyframes)
    prob.lmk_means = prob.lmk_means + rng.normal(0, 0.05,
                                                 prob.lmk_means.shape)
    return prob


@pytest.mark.slow
def test_refit_intrinsics_descends_and_guards(perturbed_problem):
    from gbp_poplar.core.intrinsics import refit_intrinsics

    cfg = GBPConfig()
    graph = build_graph(perturbed_problem, cfg)
    state = init_state(perturbed_problem, cfg)
    state, _ = jax.jit(lambda s: gbp.solve(s, graph, cfg, n_iters=150))(
        state)
    cost0 = float(gbp.map_cost(state, graph, cfg))
    new_intr, acc = jax.jit(
        lambda s: refit_intrinsics(s, graph, cfg))(state)
    assert bool(acc)
    g2 = graph._replace(intr=new_intr)
    cost1 = float(gbp.map_cost(state, g2, cfg))
    assert cost1 < cost0
    # at (near) the refit's own fixed point a second step must not be able
    # to increase the cost — acceptance is monotone in the objective
    intr3, acc3 = jax.jit(
        lambda s: refit_intrinsics(s, g2, cfg))(state)
    cost2 = float(gbp.map_cost(state, g2._replace(intr=intr3), cfg))
    assert cost2 <= cost1 + 1e-3


@pytest.mark.slow
def test_ba_cli_refine_intrinsics(tmp_path, perturbed_problem):
    path = str(tmp_path / "p.txt")
    balio.save_bal(path, perturbed_problem)
    env = dict(os.environ, GBP_PLATFORM="cpu",
               XLA_FLAGS=os.environ.get("XLA_FLAGS", ""))
    errs = {}
    for extra in ((), ("--refine_intrinsics",)):
        r = subprocess.run(
            [sys.executable, "-m", "gbp_poplar.drivers.ba",
             "--bal_file", path, "--n_iters", "400",
             "--print_every", "100", *extra],
            capture_output=True, text=True, env=env,
            cwd=os.path.join(os.path.dirname(__file__), ".."), timeout=400)
        assert r.returncode == 0, r.stderr[-2000:]
        last = [ln for ln in r.stdout.splitlines()
                if ln.startswith("iter")][-1]
        errs[bool(extra)] = float(last.split()[3])
        if extra:
            assert "intrinsics refits: " in r.stderr
    assert errs[True] < 0.75 * errs[False], errs

    # pinhole problems are rejected up front
    tum = str(tmp_path / "tum.txt")
    balio.save_bal(tum, balio.synthetic_problem(5, 40, seed=4))
    r = subprocess.run(
        [sys.executable, "-m", "gbp_poplar.drivers.ba",
         "--bal_file", tum, "--n_iters", "10", "--refine_intrinsics"],
        capture_output=True, text=True, env=env,
        cwd=os.path.join(os.path.dirname(__file__), ".."), timeout=240)
    assert r.returncode == 2 and "pinhole" in r.stderr


def test_loader_strictness(tmp_path, snavely_problem):
    """Corrupted files must raise, never silently mis-parse as the other
    layout — through BOTH the native fast path and the NumPy parser."""
    path = str(tmp_path / "x.txt")
    balio.save_bal(path, snavely_problem)
    with open(path) as f:
        toks = f.read().split()

    # a single-line BAL file defeats the line-2 sniff; the strict native
    # parser must refuse it (leftover tokens) and the NumPy token-count
    # disambiguation must still classify it
    with open(path, "w") as f:
        f.write(" ".join(toks))
    assert balio.load_bal(path).camera_model == "snavely"

    # one missing token matches neither layout
    with open(path, "w") as f:
        f.write(" ".join(toks[:-1]))
    with pytest.raises(ValueError):
        balio.load_bal(path)

    # non-numeric junk raises cleanly too
    with open(path, "w") as f:
        f.write("5 30 10\nabc xyz q w\n")
    with pytest.raises(ValueError):
        balio.load_bal(path)


def test_slam_driver_rejects_bal_dataset(tmp_path, snavely_problem):
    path = str(tmp_path / "snavely.txt")
    balio.save_bal(path, snavely_problem)
    env = dict(os.environ, GBP_PLATFORM="cpu",
               XLA_FLAGS=os.environ.get("XLA_FLAGS", ""))
    r = subprocess.run(
        [sys.executable, "-m", "gbp_poplar.drivers.slam",
         "--bal_file", path, "--iters_between_kfs", "10"],
        capture_output=True, text=True, env=env,
        cwd=os.path.join(os.path.dirname(__file__), ".."), timeout=240)
    assert r.returncode == 2
    assert "batch" in r.stderr


@pytest.mark.slow
def test_ba_cli_refine_intrinsics_sharded(tmp_path, perturbed_problem):
    """--refine_intrinsics composes with --devices 2: the refit runs as a
    plain jitted function over the GSPMD-sharded state/graph between
    sharded execution chunks."""
    path = str(tmp_path / "p2.txt")
    balio.save_bal(path, perturbed_problem)
    env = dict(os.environ, GBP_PLATFORM="cpu",
               XLA_FLAGS=os.environ.get("XLA_FLAGS", ""))
    r = subprocess.run(
        [sys.executable, "-m", "gbp_poplar.drivers.ba",
         "--bal_file", path, "--n_iters", "400",
         "--print_every", "100", "--devices", "2", "--no_polish",
         "--refine_intrinsics"],
        capture_output=True, text=True, env=env,
        cwd=os.path.join(os.path.dirname(__file__), ".."), timeout=400)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "intrinsics refits: " in r.stderr
    accepted = int(r.stderr.split("intrinsics refits: ")[1].split("/")[0])
    assert accepted >= 1
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("iter")]
    assert float(lines[-1].split()[3]) < float(lines[0].split()[3])
