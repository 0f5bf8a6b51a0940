"""Gauss-Newton / iterative-Schur baseline solver tests.

- one LM step == dense solve of the damped normal equations (oracle)
- converges to ~zero reprojection error on noise-free synthetic data
- agrees with the GBP solver on the same MAP objective
"""

import jax
import jax.numpy as jnp
import numpy as np

from gbp_poplar.config import GBPConfig
from gbp_poplar.core import build_graph, init_state, gbp
from gbp_poplar.core import gauss_newton as gn
from gbp_poplar.utils import balio, priors as priors_lib


def _setup(problem, cfg, dtype=jnp.float64):
    graph = build_graph(problem, cfg, dtype)
    cam_lam0, lmk_lam0 = priors_lib.prior_lambdas(problem, cfg.meas_var, dtype)
    cam0 = jnp.asarray(problem.cam_means, dtype)
    lmk0 = jnp.asarray(problem.lmk_means, dtype)
    pri = gn.annealed_priors(graph, cam0, lmk0, cam_lam0, lmk_lam0, cfg)
    return graph, cam0, lmk0, pri


def test_schur_step_matches_dense_solve():
    """dx from (Schur + PCG + back-substitution) == dense solve of the full
    damped normal equations, on a tiny problem in float64."""
    jax.config.update("jax_enable_x64", True)
    try:
        problem = balio.synthetic_problem(n_keyframes=4, n_points=20, seed=1,
                                          pixel_noise=1.0)
        cfg = GBPConfig()
        graph, cam0, lmk0, pri = _setup(problem, cfg, jnp.float64)
        lm_lambda = jnp.asarray(1e-3, jnp.float64)

        ne = gn._build(cam0, lmk0, graph, pri, cfg.huber_nstds, lm_lambda)
        rhs = gn._schur_rhs(ne, graph)
        dx_c = gn._pcg(ne, graph, rhs, n_iters=200, tol=1e-12)
        dx_l = gn._back_substitute(ne, graph, dx_c)

        # dense oracle
        c, l, e = problem.n_keyframes, problem.n_points, problem.n_edges
        n = 6 * c + 3 * l
        h = np.zeros((n, n))
        b = np.zeros(n)
        a_c = np.asarray(ne.a_c)
        m_inv = np.asarray(ne.m_inv)
        w = np.asarray(ne.w)
        for i in range(c):
            h[6 * i:6 * i + 6, 6 * i:6 * i + 6] = a_c[i]
        m_l = np.linalg.inv(m_inv)
        for j in range(l):
            o = 6 * c + 3 * j
            h[o:o + 3, o:o + 3] = m_l[j]
        # per-edge arrays are in the graph's canonical (lmk, cam) edge
        # order, not BAL file order
        cam_idx = np.asarray(graph.cam_idx)
        lmk_idx = np.asarray(graph.lmk_idx)
        for k in range(e):
            ci, li = int(cam_idx[k]), int(lmk_idx[k])
            o_c, o_l = 6 * ci, 6 * c + 3 * li
            h[o_c:o_c + 6, o_l:o_l + 3] += w[k]
            h[o_l:o_l + 3, o_c:o_c + 6] += w[k].T
        b[:6 * c] = np.asarray(ne.b_c).ravel()
        b[6 * c:] = np.asarray(ne.b_l).ravel()
        dx = np.linalg.solve(h, b)

        np.testing.assert_allclose(np.asarray(dx_c).ravel(), dx[:6 * c],
                                   rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(np.asarray(dx_l).ravel(), dx[6 * c:],
                                   rtol=1e-6, atol=1e-8)
    finally:
        jax.config.update("jax_enable_x64", False)


def test_gn_converges_noise_free():
    problem = balio.synthetic_problem(n_keyframes=6, n_points=60, seed=0,
                                      pixel_noise=0.0)
    # perturb the initialisation so there is something to solve
    from gbp_poplar.config import InitConfig
    noisy = priors_lib.apply_init_noise(
        problem, InitConfig(trans_noise=0.05, rot_noise=1.0,
                            lmk_noise=0.1, seed=3))
    cfg = GBPConfig()
    res = gn.solve_problem(noisy, cfg, n_lm_iters=40, cg_iters=60)
    err = float(np.asarray(res.reproj_err)[-1])
    # priors keep it from exactly zero; sub-0.2px is a converged BA
    assert err < 0.2, f"GN failed to converge: {err}px"


def test_gn_matches_gbp_solution():
    """GBP and LM optimise the same MAP objective -> same converged error."""
    problem = balio.synthetic_problem(n_keyframes=6, n_points=60, seed=0,
                                      pixel_noise=0.5)
    cfg = GBPConfig()

    res = gn.solve_problem(problem, cfg, n_lm_iters=40, cg_iters=60)
    err_gn = float(np.asarray(res.reproj_err)[-1])

    graph = build_graph(problem, cfg)
    state = init_state(problem, cfg)
    run = jax.jit(lambda s: gbp.solve(s, graph, cfg, n_iters=200))
    _, diag = run(state)
    err_gbp = float(np.asarray(diag.reproj_err)[-10:].mean())

    assert abs(err_gbp - err_gn) < 0.1, (err_gbp, err_gn)


def test_chunked_build_matches_single_shot(monkeypatch):
    """The streamed (lax.scan) normal-equation build must agree with the
    whole-E build to reduction-order tolerance — it is what makes the GN
    oracle (and gbp-ba --polish) runnable at >= 1M edges without the
    [E, 6, 6] HBM trap (round-5 task; docs/VALIDATION.md)."""
    problem = balio.synthetic_problem(n_keyframes=6, n_points=60, seed=0,
                                      pixel_noise=0.5)
    cfg = GBPConfig()
    # f64 isolates the reduction-order change from fp32 cancellation noise
    # (b_c sums near-cancelling ~1e2 terms; verified the fp32 delta is pure
    # summation order by this same f64 comparison)
    jax.config.update("jax_enable_x64", True)
    try:
        graph, cam0, lmk0, pri = _setup(problem, cfg, jnp.float64)
        lam = jnp.asarray(1e-4, jnp.float64)

        ne_ref = gn._build(cam0, lmk0, graph, pri, cfg.huber_nstds, lam)
        monkeypatch.setattr(gn, "_GN_CHUNK_EDGES", 64)  # force many chunks
        ne_chk = gn._build(cam0, lmk0, graph, pri, cfg.huber_nstds, lam)

        for a, b, name in zip(ne_ref, ne_chk, gn._NormalEqs._fields):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-12, atol=1e-8, err_msg=name)
    finally:
        jax.config.update("jax_enable_x64", False)

    # and the full fp32 LM solve still converges through the chunked path
    graph32, cam32, lmk32, pri32 = _setup(problem, cfg, jnp.float32)
    res = gn.solve_lm(cam32, lmk32, graph32, pri32, cfg, n_lm_iters=25)
    assert float(np.asarray(res.reproj_err)[-1]) < 1.0


def test_plane_lm_matches_batched(monkeypatch):
    """The plane-major large-E LM path (landmarks as [3, L] planes,
    per-edge blocks from ops/planes.linearise, chunked scans) must agree
    with the batched small-E path — forced here by dropping the chunk
    threshold. It is what makes gbp-ba --polish run at the Venice shape,
    where the batched [E, d, d] layout runs out of device memory."""
    problem = balio.synthetic_problem(n_keyframes=6, n_points=60, seed=3,
                                      pixel_noise=0.5)
    cfg = GBPConfig()
    graph, cam0, lmk0, pri = _setup(problem, cfg, jnp.float32)

    res_a = gn.solve_lm(cam0, lmk0, graph, pri, cfg, n_lm_iters=20)
    monkeypatch.setattr(gn, "_GN_CHUNK_EDGES", 64)
    res_b = gn.solve_lm(cam0, lmk0, graph, pri, cfg, n_lm_iters=20)

    # same optimum to fp32 optimisation tolerance (different expression
    # of the same math: planes.linearise vs batched Jacobians)
    assert abs(float(res_a.cost[-1]) - float(res_b.cost[-1])) \
        < 1e-4 * abs(float(res_a.cost[-1]))
    np.testing.assert_allclose(np.asarray(res_a.cam), np.asarray(res_b.cam),
                               rtol=0, atol=5e-3)
    np.testing.assert_allclose(np.asarray(res_a.lmk), np.asarray(res_b.lmk),
                               rtol=0, atol=5e-3)
    assert abs(float(res_a.reproj_err[-1]) - float(res_b.reproj_err[-1])) \
        < 1e-3
