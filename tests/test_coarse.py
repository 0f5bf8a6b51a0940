"""Coarse-space correction (core/coarse.py): basis correctness and the
fixed-point property (zero increment at a MAP stationary point)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gbp_poplar.config import GBPConfig
from gbp_poplar.core import build_graph, coarse, gauss_newton, gbp, init_state
from gbp_poplar.ops import lie, projection
from gbp_poplar.utils import balio, priors as priors_lib


@pytest.fixture(scope="module")
def prob():
    return balio.synthetic_problem(n_keyframes=6, n_points=60, seed=0,
                                   pixel_noise=0.5)


def test_cam_rigid_basis_matches_finite_difference():
    """S maps a world rigid motion to the camera-parameter change such that
    reprojection of co-moving points is invariant."""
    rng = np.random.default_rng(0)
    cam = jnp.asarray(rng.normal(0, 0.3, (5, 6)).astype(np.float32))
    s = coarse._cam_rigid_basis(cam)
    assert s.shape == (5, 6, 6)
    xi = jnp.asarray(
        np.array([0.01, -0.02, 0.015, 0.01, -0.005, 0.02], np.float32))
    y = jnp.asarray(rng.normal(0, 1, (5, 3)).astype(np.float32) + 3.0)
    k = jnp.asarray(np.array([[500., 0, 320], [0, 500, 240], [0, 0, 1]],
                             np.float32))
    # move the world content by G and the cameras by S xi: the reprojection
    # of the co-moving point must be (to first order) unchanged
    rg = lie.so3_exp(xi[3:])
    y_new = (rg @ y.T).T + xi[:3]
    cam_new = cam + jnp.einsum("cij,j->ci", s, xi)
    uv0 = projection.project(cam, y, k)
    uv1 = projection.project(cam_new, y_new, k)
    np.testing.assert_allclose(np.asarray(uv1), np.asarray(uv0),
                               rtol=0, atol=0.2)   # first-order in |xi|~0.03


def test_lmk_rigid_basis():
    y = jnp.asarray(np.array([[1., 2., 3.], [0., -1., 2.]], np.float32))
    s = coarse._lmk_rigid_basis(y)
    xi = jnp.asarray(np.array([0.1, 0.2, -0.1, 0.05, -0.02, 0.03],
                              np.float32))
    dy = jnp.einsum("lij,j->li", s, xi)
    expect = xi[:3] + jnp.cross(jnp.broadcast_to(xi[3:], y.shape), y)
    np.testing.assert_allclose(np.asarray(dy), np.asarray(expect),
                               rtol=1e-5, atol=1e-6)


def test_zero_increment_at_gn_optimum(prob):
    """At the GN/LM solution of the same objective, the coarse gradient is
    (numerically) zero, so the increment must vanish — the corrector cannot
    move a converged solver."""
    cfg = GBPConfig(coarse_groups=3)
    graph = build_graph(prob, cfg)
    res = gauss_newton.solve_problem(prob, cfg, n_lm_iters=40)
    state = init_state(prob, cfg)
    state = gbp.initialise(state, graph, cfg)
    # means at the GN optimum (beliefs themselves are irrelevant here: the
    # increment depends on the means and the priors only)
    cam_mu = jnp.asarray(np.asarray(res.cam).T)
    lmk_mu = jnp.asarray(np.asarray(res.lmk).T)
    d_cam, d_lmk = coarse.coarse_increment(state, graph, cfg, cam_mu, lmk_mu)
    # fp32 LM leaves a small residual gradient; soft (annealed-prior) modes
    # amplify it, so "zero" is a few cm here while the off-optimum response
    # below is an order of magnitude larger
    assert float(jnp.abs(d_cam).max()) < 0.05
    assert float(jnp.abs(d_lmk).max()) < 0.05
    # ... and far from the optimum it is decisively non-zero
    d_cam2, _ = coarse.coarse_increment(
        state, graph, cfg, cam_mu + 0.3, lmk_mu + 0.3)
    assert float(jnp.abs(d_cam2).max()) > 0.1


def test_coarse_step_monotone_cost(prob):
    """_coarse_step never increases the on-device MAP cost."""
    cfg = GBPConfig(coarse_groups=3, accel_every=0)
    graph = build_graph(prob, cfg)
    state = init_state(prob, cfg)
    state = gbp.initialise(state, graph, cfg)
    state, _ = jax.jit(lambda s: gbp.run_gbp(s, graph, cfg, 60))(state)
    degs = gbp._active_degrees(state, graph, None, False)
    c0 = float(gbp.map_cost(state, graph, cfg))
    s2 = gbp._coarse_step(state, graph, cfg, degs, None, False)
    c1 = float(gbp.map_cost(s2, graph, cfg))
    assert np.isfinite(c1) and c1 <= c0 + 1e-3


def test_degenerate_edge_does_not_poison_increment(prob):
    """One edge whose landmark grazes the camera plane (|z| ~ 0, Jacobian
    overflows to inf) must drop only ITSELF from the reduced system — not
    NaN-poison the assembly and zero the entire correction."""
    cfg = GBPConfig(coarse_groups=3)
    graph = build_graph(prob, cfg)
    state = init_state(prob, cfg)
    state = gbp.initialise(state, graph, cfg)
    cam_mu, lmk_mu = gbp._variable_means(state)
    cam_mu, lmk_mu = cam_mu + 0.3, lmk_mu + 0.3   # off-optimum: nonzero d
    d0, _ = coarse.coarse_increment(state, graph, cfg, cam_mu, lmk_mu)
    ref = float(jnp.abs(d0).max())
    assert ref > 0.05

    # move edge 0's landmark onto its camera's plane: z_cam ~ 1e-30
    e = 0
    ci = int(graph.cam_idx[e])
    li = int(graph.lmk_idx[e])
    x = np.asarray(cam_mu)[:, ci]
    r = np.asarray(lie.so3_exp(jnp.asarray(x[3:])))
    y_plane = r.T @ (np.array([0.1, 0.1, 1e-30], np.float32) - x[:3])
    lmk_np = np.asarray(lmk_mu).copy()
    lmk_np[:, li] = y_plane
    d1, dl1 = coarse.coarse_increment(state, graph, cfg, cam_mu,
                                      jnp.asarray(lmk_np))
    assert np.isfinite(np.asarray(d1)).all()
    assert np.isfinite(np.asarray(dl1)).all()
    # the correction survives (same order of magnitude, not zeroed)
    assert float(jnp.abs(d1).max()) > 0.2 * ref
