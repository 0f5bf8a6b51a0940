"""Solver-core tests: tree exactness, state machine, flags, data IO."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gbp_poplar.config import GBPConfig
from gbp_poplar.core import build_graph, init_state, gbp
from gbp_poplar.ops import planes as pl
from gbp_poplar.utils import balio, flags as flags_lib


def _dense_marginal(prob, state, graph):
    """Oracle: mean of the full joint Gaussian (priors + factor potentials).

    Unpacks the solver's plane-layout state into dense blocks first.
    """
    c_n, l_n, e_n = prob.n_keyframes, prob.n_points, prob.n_edges
    cam_prior_lam = np.asarray(pl.sym_planes_to_dense(state.cam_prior_lam, 6))
    lmk_prior_lam = np.asarray(pl.sym_planes_to_dense(state.lmk_prior_lam, 3))
    f_lam_cc = np.asarray(pl.sym_planes_to_dense(state.f_lam_cc, 6))
    f_lam_ll = np.asarray(pl.sym_planes_to_dense(state.f_lam_ll, 3))
    f_lam_cl = np.asarray(pl.full_planes_to_dense(state.f_lam_cl, 6, 3))
    cam_prior_eta = np.asarray(state.cam_prior_eta).T
    lmk_prior_eta = np.asarray(state.lmk_prior_eta).T
    f_eta_c = np.asarray(state.f_eta_c).T
    f_eta_l = np.asarray(state.f_eta_l).T
    n = 6 * c_n + 3 * l_n
    lam = np.zeros((n, n))
    eta = np.zeros(n)
    for c in range(c_n):
        lam[6*c:6*c+6, 6*c:6*c+6] += cam_prior_lam[c]
        eta[6*c:6*c+6] += cam_prior_eta[c]
    for l in range(l_n):
        o = 6 * c_n + 3 * l
        lam[o:o+3, o:o+3] += lmk_prior_lam[l]
        eta[o:o+3] += lmk_prior_eta[l]
    cam_idx = np.asarray(graph.cam_idx)
    lmk_idx = np.asarray(graph.lmk_idx)
    for e in range(e_n):
        c, l = int(cam_idx[e]), int(lmk_idx[e])
        oc, ol = 6 * c, 6 * c_n + 3 * l
        lam[oc:oc+6, oc:oc+6] += f_lam_cc[e]
        lam[ol:ol+3, ol:ol+3] += f_lam_ll[e]
        lam[oc:oc+6, ol:ol+3] += f_lam_cl[e]
        lam[ol:ol+3, oc:oc+6] += f_lam_cl[e].T
        eta[oc:oc+6] += f_eta_c[e]
        eta[ol:ol+3] += f_eta_l[e]
    return np.linalg.solve(lam, eta)


def test_tree_gbp_exact_marginal():
    """On a tree factor graph, converged GBP beliefs equal the exact joint
    marginals — the gold-standard correctness check for the whole sweep."""
    cfg = GBPConfig(dmu_threshold=0.0, iters_before_damping=10000,
                    cavity_jitter=0.0)
    prob = balio.synthetic_problem(n_keyframes=2, n_points=1, seed=3,
                                   obs_per_lmk=2)
    fl = flags_lib.ba_flags(prob, 0)  # no annealing
    graph = build_graph(prob, cfg)
    state = gbp.initialise(init_state(prob, cfg, flags=fl), graph, cfg)
    mu_exact = _dense_marginal(prob, state, graph)

    step = jax.jit(lambda s: gbp.gbp_sweep(s, graph, cfg))
    for _ in range(20):
        state = step(state)
    from gbp_poplar.utils import analysis
    mu_cam, mu_lmk = analysis.belief_means(state)
    np.testing.assert_allclose(
        np.concatenate([mu_cam.ravel(), mu_lmk.ravel()]), mu_exact,
        rtol=1e-3, atol=1e-4)


def test_fixed_point_at_ground_truth():
    """With exact measurements and beliefs at ground truth, sweeps must not
    move the means (the GN fixed point is the truth)."""
    cfg = GBPConfig(iters_before_damping=0, lambda_damping=True,
                    relin_every_iter=True, steps=5)
    prob = balio.synthetic_problem(n_keyframes=4, n_points=30, seed=1,
                                   pixel_noise=0.0)
    graph = build_graph(prob, cfg)
    state = gbp.initialise(init_state(prob, cfg), graph, cfg)
    err0, _ = gbp.reprojection_error(state, graph)
    run = jax.jit(lambda s: gbp.run_gbp(s, graph, cfg, 40))
    state, diag = run(state)
    errs = np.asarray(diag.reproj_err)
    assert np.isfinite(errs).all()
    assert errs[-1] < 0.05, errs


def test_weaken_priors_schedule():
    cfg = GBPConfig()
    prob = balio.synthetic_problem(n_keyframes=3, n_points=12, seed=0)
    graph = build_graph(prob, cfg)
    state = gbp.initialise(init_state(prob, cfg), graph, cfg)
    lam0 = np.asarray(pl.sym_planes_to_dense(state.cam_prior_lam, 6)).copy()
    # apply weaken `steps` times + 2 extra (extras must be no-ops)
    for _ in range(cfg.steps + 2):
        state = gbp.weaken_priors(state, graph)
    lam5 = np.asarray(pl.sym_planes_to_dense(state.cam_prior_lam, 6))
    assert (np.asarray(state.cam_weaken) == 0).all()
    # anchors end at 1/first_cam_prior_std^2
    np.testing.assert_allclose(
        lam5[:2].diagonal(axis1=-2, axis2=-1),
        np.full((2, 6), 1.0 / cfg.first_cam_prior_std**2),
        rtol=1e-3)
    # others weakened by prior_std_weaker_factor^2
    np.testing.assert_allclose(
        lam5[2:], lam0[2:] / cfg.prior_std_weaker_factor**2, rtol=1e-3)


def test_damping_state_machine():
    cfg = GBPConfig(iters_before_damping=3, dmu_threshold=0.0)
    prob = balio.synthetic_problem(n_keyframes=3, n_points=12, seed=0)
    graph = build_graph(prob, cfg)
    state = gbp.initialise(init_state(prob, cfg), graph, cfg)
    assert (np.asarray(state.damping_count) == -3).all()
    act = np.asarray(state.active) > 0   # build-time padding edges are inert
    for i in range(4):
        state = gbp.gbp_sweep(state, graph, cfg)
        if i < 3:
            assert (np.asarray(state.damping)[act] == 0.0).all(), i
    # damping engages exactly when the counter crosses zero
    assert (np.asarray(state.damping)[act] == cfg.eta_damping).all()


def test_inactive_edges_send_zero_messages():
    cfg = GBPConfig()
    prob = balio.synthetic_problem(n_keyframes=4, n_points=20, seed=2)
    fl = flags_lib.create_flags(prob, cfg.steps)   # only kf 0,1 active
    graph = build_graph(prob, cfg)
    state = gbp.initialise(init_state(prob, cfg, flags=fl), graph, cfg)
    state = gbp.gbp_sweep(state, graph, cfg)
    inactive = np.asarray(state.active) == 0
    assert inactive.any()
    assert (np.abs(np.asarray(state.msg_c_eta)[:, inactive]) == 0).all()
    assert (np.abs(np.asarray(state.msg_c_lam)[:, inactive]) == 0).all()
    # inactive variables' beliefs stay at their priors (compare over the
    # real edges; the rest of the padded edge axis is inert padding)
    e = prob.n_edges
    touched_cams = np.unique(np.asarray(graph.cam_idx)[:e][~inactive[:e]])
    untouched = np.setdiff1d(np.arange(prob.n_keyframes), touched_cams)
    np.testing.assert_allclose(
        np.asarray(state.cam_eta)[:, untouched],
        np.asarray(state.cam_prior_eta)[:, untouched])


def test_warm_override_matches_static_offset(synthetic):
    """``run_gbp(traced offset, static warm)`` — the chunked CLI drivers'
    calling convention — must reproduce the static-offset path exactly,
    including through the accelerator chunk path (accel_every > 0)."""
    cfg = GBPConfig(accel_every=8, accel_start=10, steps=5)
    graph = build_graph(synthetic, cfg)
    state0 = gbp.initialise(init_state(synthetic, cfg), graph, cfg)

    run_static = jax.jit(
        lambda s, n, off: gbp.run_gbp(s, graph, cfg, n, iter_offset=off),
        static_argnums=(1, 2))
    run_warm = jax.jit(
        lambda s, n, off, w: gbp.run_gbp(s, graph, cfg, n, iter_offset=off,
                                         warm=w),
        static_argnums=(1, 3))

    def chunks(run, traced):
        s, diags = state0, []
        for off, n in ((0, 12), (12, 20)):
            w = max(0, min(n, 2 * cfg.steps - off))
            if traced:
                s, d = run(s, n, jnp.asarray(off, jnp.int32), w)
            else:
                s, d = run(s, n, off)
            diags.append(np.asarray(d.reproj_err))
        return s, np.concatenate(diags)

    s_a, err_a = chunks(run_static, False)
    s_b, err_b = chunks(run_warm, True)
    np.testing.assert_array_equal(err_a, err_b)
    for leaf_a, leaf_b in zip(jax.tree.leaves(s_a), jax.tree.leaves(s_b)):
        np.testing.assert_array_equal(np.asarray(leaf_a), np.asarray(leaf_b))


def test_solve_runs_and_is_finite(synthetic):
    cfg = GBPConfig(relin_every_iter=True, lambda_damping=True,
                    iters_before_damping=0)
    graph = build_graph(synthetic, cfg)
    state = init_state(synthetic, cfg)
    final, diag = jax.jit(lambda s: gbp.solve(s, graph, cfg, n_iters=60))(state)
    errs = np.asarray(diag.reproj_err)
    assert np.isfinite(errs).all()
    assert errs[-1] < errs[0]


def test_diagnostics_flag_does_not_change_solution(synthetic):
    """with_diagnostics is telemetry only: the solver trajectory — including
    the accelerator's chunk-averaged displacement estimate — must be
    bit-identical with it on or off."""
    cfg = GBPConfig(accel_every=8, accel_start=10)
    graph = build_graph(synthetic, cfg)
    state0 = gbp.initialise(init_state(synthetic, cfg), graph, cfg)
    s_on, d = jax.jit(
        lambda s: gbp.run_gbp(s, graph, cfg, 40, with_diagnostics=True))(
            state0)
    s_off, _ = jax.jit(
        lambda s: gbp.run_gbp(s, graph, cfg, 40, with_diagnostics=False))(
            state0)
    assert np.isfinite(np.asarray(d.reproj_err)).all()
    for a, b in zip(jax.tree.leaves(s_on), jax.tree.leaves(s_off)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_run_gbp_zero_iters(synthetic):
    """n_iters=0 is a no-op returning the state unchanged and None
    diagnostics (not a tree.map crash on an empty list)."""
    cfg = GBPConfig()
    graph = build_graph(synthetic, cfg)
    state0 = gbp.initialise(init_state(synthetic, cfg), graph, cfg)
    s, diag = gbp.run_gbp(state0, graph, cfg, 0, with_diagnostics=True)
    assert diag is None
    for a, b in zip(jax.tree.leaves(s), jax.tree.leaves(state0)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_relinearise_masked_depth_guard_sidedness(synthetic):
    """relinearise_masked applies the SAME depth-guard sidedness as the
    sweep: with relin_behind_camera=False a linearisation at a
    behind-camera mean is refused (SLAM insertion must not adopt the
    wrong-signed factors the one-sided guard exists to block)."""
    from gbp_poplar.ops import lie

    base = dict(min_depth=0.05)
    cfg_two = GBPConfig(relin_behind_camera=True, **base)
    cfg_one = GBPConfig(relin_behind_camera=False, **base)
    graph = build_graph(synthetic, cfg_two)
    state = gbp.initialise(init_state(synthetic, cfg_two), graph, cfg_two)

    # pin edge 0's landmark belief to a point 1 m BEHIND its camera
    e = 0
    ci = int(graph.cam_idx[e])
    li = int(graph.lmk_idx[e])
    cam_mu, _ = gbp._variable_means(state)
    x = np.asarray(cam_mu)[:, ci]                      # (t, w)
    r = np.asarray(lie.so3_exp(jnp.asarray(x[3:])))
    y_behind = r.T @ (np.array([0.0, 0.0, -1.0], np.float32) - x[:3])
    lam = 1e4
    lmk_eta = np.asarray(state.lmk_eta).copy()
    lmk_lam = np.asarray(state.lmk_lam).copy()
    dense = np.zeros((3, 3), np.float32)
    np.fill_diagonal(dense, lam)
    lmk_lam[:, li] = np.asarray(
        pl.dense_to_sym_planes(jnp.asarray(dense)[None], 3))[:, 0]
    lmk_eta[:, li] = lam * y_behind
    state = state._replace(lmk_eta=jnp.asarray(lmk_eta),
                           lmk_lam=jnp.asarray(lmk_lam))

    mask = jnp.zeros((graph.n_edges,), bool).at[e].set(True)
    before = np.asarray(state.f_lam_cc[:, e])
    after_two = np.asarray(
        gbp.relinearise_masked(state, graph, cfg_two, mask).f_lam_cc[:, e])
    after_one = np.asarray(
        gbp.relinearise_masked(state, graph, cfg_one, mask).f_lam_cc[:, e])
    # two-sided guard (|z| > min_depth): z = -1 passes, factor adopted
    assert not np.array_equal(after_two, before)
    # one-sided guard (z > min_depth): refused, factor unchanged
    np.testing.assert_array_equal(after_one, before)


def test_static_accel_elision_matches_traced_gating(synthetic):
    """With a static iter_offset, chunks before accel_start are ELIDED to
    plain hot scans (no accel-step compute at all); with a traced offset
    the same chunks run gated accel steps whose acceptance is masked off.
    Both must produce identical states and telemetry — the elision is an
    optimization, not a schedule change."""
    cfg = GBPConfig(accel_every=8, accel_start=40, steps=5)
    graph = build_graph(synthetic, cfg)
    state0 = gbp.initialise(init_state(synthetic, cfg), graph, cfg)

    # off2 = 10 static: chunks end at iters 18/26/34/42/50/58 -> 3 dead
    s_a, d_a = jax.jit(
        lambda s: gbp.run_gbp(s, graph, cfg, 48, iter_offset=10))(state0)
    s_b, d_b = jax.jit(
        lambda s: gbp.run_gbp(s, graph, cfg, 48,
                              iter_offset=jnp.asarray(10, jnp.int32),
                              warm=0))(state0)
    np.testing.assert_array_equal(np.asarray(d_a.reproj_err),
                                  np.asarray(d_b.reproj_err))
    for a, b in zip(jax.tree.leaves(s_a), jax.tree.leaves(s_b)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
