"""Incremental SLAM: keyframe insertion semantics + end-to-end convergence."""

import jax
import numpy as np
import pytest

from gbp_poplar.config import GBPConfig
from gbp_poplar.core import build_graph, init_state, gbp, slam
from gbp_poplar.ops import planes as pl
from gbp_poplar.utils import balio, flags as flags_lib

from conftest import requires_sequences


def _col_mu(eta_planes, lam_planes, col, d):
    """Solve one variable's mean from plane-layout (eta, Lambda)."""
    lam = pl.unpack_sym(lam_planes[:, col], d)
    eta = pl.unpack_vec(eta_planes[:, col], d)
    return np.asarray(pl.pack_vec(pl.solve_sym(lam, eta)))


def _slam_problem():
    # sequential visibility: landmark l seen by consecutive keyframes
    return balio.synthetic_problem(n_keyframes=6, n_points=60, seed=2,
                                   pixel_noise=0.5)


def test_insert_keyframe_semantics():
    problem = _slam_problem()
    cfg = GBPConfig()
    graph = build_graph(problem, cfg)
    flags = flags_lib.create_flags(problem, cfg.steps)
    state = init_state(problem, cfg, flags=flags)
    state = gbp.initialise(state, graph, cfg)
    # run a few sweeps on keyframes 0, 1
    state, _ = gbp.run_gbp(state, graph, cfg, 40)

    new_kf = 2
    prev_mu = _col_mu(state.cam_eta, state.cam_lam, new_kf - 1, 6)
    state2 = slam.insert_keyframe(state, graph, cfg, new_kf)

    # edges of keyframe 2 are now active
    active = np.asarray(state2.active)
    cam_idx = np.asarray(graph.cam_idx)
    assert (active[cam_idx == new_kf] == 1).all()
    assert (active[cam_idx > new_kf] == 0).all()

    # new keyframe's prior mean == previous keyframe's belief mean
    prior_mu = _col_mu(state2.cam_prior_eta, state2.cam_prior_lam, new_kf, 6)
    np.testing.assert_allclose(prior_mu, prev_mu, rtol=1e-4, atol=1e-5)

    # weaken schedule restarted only for the new keyframe
    cam_weaken = np.asarray(state2.cam_weaken)
    assert cam_weaken[new_kf] == cfg.steps
    assert (cam_weaken[:new_kf] == 0).all()

    # undamped phase restarted everywhere
    assert (np.asarray(state2.damping_count)
            == -cfg.iters_before_damping).all()
    assert (np.asarray(state2.damping) == 0).all()

    # newly observed landmarks (first seen by kf 2) got the optic-axis prior
    first_kf = np.asarray(graph.first_kf)
    lmk_weaken = np.asarray(state2.lmk_weaken)
    assert (lmk_weaken[first_kf == new_kf] == cfg.steps).all()
    assert (lmk_weaken[first_kf < new_kf] == 0).all()


def test_slam_end_to_end():
    problem = _slam_problem()
    cfg = GBPConfig()
    graph = build_graph(problem, cfg)
    flags = flags_lib.create_flags(problem, cfg.steps)
    state = init_state(problem, cfg, flags=flags)

    # av_depth must roughly match the scene depth (the synthetic cloud sits
    # at z in [4, 8]); the reference exposes this as --avdepth for the same
    # reason (ba/slam.cpp:430-437).
    result = slam.solve_slam(state, graph, cfg, iters_between_kfs=60,
                             av_depth=6.0)
    assert result.reproj_err.shape == (problem.n_keyframes - 1, 60)
    assert np.isfinite(result.reproj_err).all()
    final_err = result.reproj_err[-1, -10:].mean()
    # all real edges active at the end (padding stays inert), and converged
    assert (np.asarray(result.state.active)[:problem.n_edges] == 1).all()
    assert final_err < 1.0, f"SLAM failed to converge: {final_err}px"


def test_slam_matches_batch_quality():
    """After all keyframes are in, incremental GBP should reach (roughly)
    the batch-BA solution quality on the same graph."""
    problem = _slam_problem()
    cfg = GBPConfig()
    graph = build_graph(problem, cfg)

    state_b = init_state(problem, cfg)
    run = jax.jit(lambda s: gbp.solve(s, graph, cfg, n_iters=150))
    _, diag_b = run(state_b)
    err_batch = float(np.asarray(diag_b.reproj_err)[-10:].mean())

    flags = flags_lib.create_flags(problem, cfg.steps)
    state_i = init_state(problem, cfg, flags=flags)
    result = slam.solve_slam(state_i, graph, cfg, iters_between_kfs=60,
                             av_depth=6.0)
    err_slam = float(result.reproj_err[-1, -10:].mean())

    # Incremental GBP settles at a slightly different fixed point than the
    # batch solve (it never revisits early linearisation decisions); within
    # half a pixel is the expected regime.
    assert abs(err_slam - err_batch) < 0.6, (err_slam, err_batch)


def test_first_uv_matches_first_observation():
    """graph.first_uv is the pixel of each landmark's first (lowest-kf)
    observation — the ray SLAM insertion back-projects along."""
    problem = _slam_problem()
    cfg = GBPConfig()
    graph = build_graph(problem, cfg)
    ci = np.asarray(problem.cam_idx)
    li = np.asarray(problem.lmk_idx)
    meas = np.asarray(problem.measurements)
    uv = np.asarray(graph.first_uv)
    for l in range(problem.n_points):
        m = li == l
        if not m.any():
            np.testing.assert_array_equal(uv[:, l], 0.0)
            continue
        first = np.flatnonzero(m)[np.argmin(ci[m])]
        np.testing.assert_allclose(uv[:, l], meas[first], rtol=0, atol=1e-4)


@pytest.mark.slow
@requires_sequences
def test_slam_fr1desk_stability():
    """Incremental SLAM on fr1desk — the fp32-multi-basin sequence whose
    batch solve storms without lambda damping (docs/VALIDATION.md). The
    driver's damped-GN schedule must hold through all 62 keyframe
    insertions: insertion transients are exactly the perturbation that
    re-triggered desk's Huber storms in batch mode. Reduced cadence
    (150 it/kf vs the reference's 700, ba/slam.cpp:414-417) keeps this
    CPU-feasible (~6 min); the full-cadence desk-SLAM accuracy row is
    measured in docs/VALIDATION.md."""
    problem = balio.load_bal("fr1desk")
    # the slam driver's default schedule (drivers/slam.py)
    cfg = GBPConfig(relin_every_iter=True, eta_damping=0.7,
                    lambda_damping=True, iters_before_damping=0,
                    relin_behind_camera=False,
                    behind_camera_rescue_iters=300)
    graph = build_graph(problem, cfg)
    flags = flags_lib.create_flags(problem, cfg.steps)
    state = init_state(problem, cfg, flags=flags)
    result = slam.solve_slam(state, graph, cfg, iters_between_kfs=150,
                             av_depth=1.0)
    errs = np.asarray(result.reproj_err)      # [n_kf-1, 150]
    assert np.isfinite(errs).all()
    # converged, and no storm in the settled tail of any late segment
    final_err = float(errs[-1, -10:].mean())
    assert final_err < 2.5, final_err
    assert errs[40:, -1].max() < 5.0, errs[40:, -1]
    assert (np.asarray(result.state.active)[:problem.n_edges] == 1).all()
