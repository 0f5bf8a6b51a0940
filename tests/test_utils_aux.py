"""Auxiliary subsystems: checkpoint round-trip, ATE/alignment, KL, analysis."""

import os

import pytest

import jax
import jax.numpy as jnp
import numpy as np

from gbp_poplar.config import GBPConfig
from gbp_poplar.core import build_graph, init_state, gbp
from gbp_poplar.utils import analysis, checkpoint, evaluation


def test_checkpoint_roundtrip_and_resume(synthetic, tmp_path):
    """Checkpoint mid-solve, resume, and land bit-exactly where an
    uninterrupted run lands."""
    cfg = GBPConfig()
    graph = build_graph(synthetic, cfg)
    state = init_state(synthetic, cfg)
    state = gbp.initialise(state, graph, cfg)

    run = jax.jit(lambda s, off: gbp.run_gbp(s, graph, cfg, 10,
                                             iter_offset=off)[0])
    mid = run(state, 0)
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save_checkpoint(path, mid, graph, step=10, cfg=cfg)

    mid2, graph2, meta = checkpoint.load_checkpoint(path)
    assert meta["step"] == 10
    cfg2 = checkpoint.load_config(meta)
    assert cfg2 == cfg
    for f in type(mid)._fields:
        np.testing.assert_array_equal(np.asarray(getattr(mid, f)),
                                      np.asarray(getattr(mid2, f)), err_msg=f)

    final_a = run(run(state, 0), 10)
    final_b = run(mid2, 10)
    np.testing.assert_array_equal(np.asarray(final_a.cam_eta),
                                  np.asarray(final_b.cam_eta))


def test_ate_zero_for_identical_and_aligned():
    rng = np.random.default_rng(0)
    cams = rng.normal(0, 0.5, (10, 6))
    assert evaluation.ate_rmse(cams, cams, align=False) == 0.0

    # a rigidly transformed trajectory aligns back to ATE ~ 0
    centers = evaluation.camera_centers(cams)
    r, _, _ = evaluation.umeyama_align(
        rng.normal(0, 1, (4, 3)), rng.normal(0, 1, (4, 3)))  # random rotation
    moved = (r @ centers.T).T + np.array([1.0, -2.0, 3.0])
    rr, tt, ss = evaluation.umeyama_align(moved, centers)
    back = (ss * (rr @ moved.T)).T + tt
    assert np.abs(back - centers).max() < 1e-7


def test_export_tum(tmp_path, synthetic):
    path = str(tmp_path / "traj.txt")
    evaluation.export_tum(path, synthetic.cam_means)
    rows = np.loadtxt(path)
    assert rows.shape == (synthetic.n_keyframes, 8)
    # quaternions are unit
    q = rows[:, 4:8]
    np.testing.assert_allclose(np.linalg.norm(q, axis=1), 1.0, atol=1e-6)


def test_kl_divergence_properties():
    rng = np.random.default_rng(1)
    a = rng.normal(0, 1, (5, 3, 3))
    lam0 = jnp.asarray(a @ np.transpose(a, (0, 2, 1)) + 3 * np.eye(3))
    eta0 = jnp.asarray(rng.normal(0, 1, (5, 3)))
    # KL(p || p) == 0
    np.testing.assert_allclose(
        np.asarray(analysis.kl_divergence(eta0, lam0, eta0, lam0)),
        0.0, atol=1e-4)
    # KL >= 0 against a different Gaussian; symmetric_kl is symmetric
    lam1 = lam0 * 1.5
    eta1 = eta0 + 0.3
    kl01 = np.asarray(analysis.kl_divergence(eta0, lam0, eta1, lam1))
    assert (kl01 > 0).all()
    s01 = np.asarray(analysis.symmetric_kl(eta0, lam0, eta1, lam1))
    s10 = np.asarray(analysis.symmetric_kl(eta1, lam1, eta0, lam0))
    np.testing.assert_allclose(s01, s10, rtol=1e-5)

    # numpy mean-form oracle for the first element
    l0, l1 = np.asarray(lam0[0]), np.asarray(lam1[0])
    e0, e1 = np.asarray(eta0[0]), np.asarray(eta1[0])
    s0, s1 = np.linalg.inv(l0), np.linalg.inv(l1)
    m0, m1 = s0 @ e0, s1 @ e1
    d = m1 - m0
    kl_np = 0.5 * (np.trace(np.linalg.inv(s1) @ s0) + d @ l1 @ d - 3
                   + np.log(np.linalg.det(s1) / np.linalg.det(s0)))
    np.testing.assert_allclose(kl01[0], kl_np, rtol=1e-3)


def test_recenter_priors(synthetic):
    """recenter_priors == the reference's update_eta semantics: prior means
    move to the given values, strengths unchanged."""
    from gbp_poplar.ops import planes as pl

    cfg = GBPConfig()
    graph = build_graph(synthetic, cfg)
    state = init_state(synthetic, cfg)
    rng = np.random.default_rng(3)
    new_mu = rng.normal(0, 1, (synthetic.n_keyframes, 6)).astype(np.float32)
    state2 = gbp.recenter_priors(state, cam_mu=new_mu)
    # solve back the prior means
    got = np.asarray(pl.pack_vec(pl.solve_sym(
        pl.unpack_sym(state2.cam_prior_lam, 6),
        pl.unpack_vec(state2.cam_prior_eta, 6)))).T
    np.testing.assert_allclose(got, new_mu, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(state2.cam_prior_lam),
                                  np.asarray(state.cam_prior_lam))
    np.testing.assert_array_equal(np.asarray(state2.lmk_prior_eta),
                                  np.asarray(state.lmk_prior_eta))


def test_debug_dump_edge(synthetic):
    from gbp_poplar.utils import debug
    cfg = GBPConfig()
    graph = build_graph(synthetic, cfg)
    state = gbp.initialise(init_state(synthetic, cfg), graph, cfg)
    state = gbp.gbp_sweep(state, graph, cfg)
    info = debug.dump_edge(state, graph, 3)
    assert info["f_lam_cc"].shape == (6, 6)
    assert info["f_lam_cl"].shape == (6, 3)
    np.testing.assert_allclose(info["f_lam_cc"], info["f_lam_cc"].T)
    assert np.isfinite(info["msg_to_cam_eta"]).all()
    debug.print_edge(state, graph, 3)   # smoke: formats without error


def test_bad_associations_excluded(synthetic):
    """The reference's bad_associations skip list (ba/util.cpp:100):
    excluded edges must not contribute to either evaluation path, and
    the two paths must agree on the exclusion."""
    from gbp_poplar.core.factor_graph import bad_edge_mask

    cfg = GBPConfig()
    graph = build_graph(synthetic, cfg)
    state = gbp.initialise(init_state(synthetic, cfg), graph, cfg)
    state = gbp.gbp_sweep(state, graph, cfg)

    bad_ids = [0, 7, synthetic.n_edges - 1]
    mask = bad_edge_mask(synthetic, bad_ids)
    assert mask.shape[0] == graph.n_edges and mask.sum() == len(bad_ids)

    err_all, cost_all = map(float, gbp.reprojection_error(state, graph))
    err_ex, cost_ex = map(float, gbp.reprojection_error(
        state, graph, bad=jnp.asarray(mask)))
    assert cost_ex < cost_all          # strictly fewer residuals summed
    assert err_ex != err_all

    # host oracle agrees with the device eval under the same exclusion
    cam_mu, lmk_mu = analysis.belief_means(state)
    o_err, _ = evaluation.numpy_reprojection_error(
        cam_mu, lmk_mu, synthetic, bad_associations=bad_ids)
    assert abs(o_err - err_ex) < 1e-3

    # map_cost drops the excluded edges' data term (zero the priors so the
    # quadratic term cannot swamp the Huber sum in fp32)
    s0 = state._replace(
        cam_prior_eta=jnp.zeros_like(state.cam_prior_eta),
        cam_prior_lam=jnp.zeros_like(state.cam_prior_lam),
        lmk_prior_eta=jnp.zeros_like(state.lmk_prior_eta),
        lmk_prior_lam=jnp.zeros_like(state.lmk_prior_lam))
    c_all = float(gbp.map_cost(s0, graph, cfg))
    c_ex = float(gbp.map_cost(s0, graph, cfg, bad=jnp.asarray(mask)))
    assert c_ex < c_all

    import pytest
    with pytest.raises(ValueError):
        bad_edge_mask(synthetic, [synthetic.n_edges])


@pytest.mark.slow
def test_checkpoint_venice_scale(tmp_path):
    """Multi-GB checkpoint at the synthetic-Venice shape (4.97M edges):
    save the initialised state + graph, reload, and require every leaf
    bit-identical (the resume-semantics equivalence is pinned at small
    scale by test_checkpoint_roundtrip_and_resume; this exercises the IO
    path — np.savez chunking, the .tmp/rename dance, >2 GB array entries —
    at the scale the round-4 capacity work validated the solver at)."""
    from gbp_poplar.utils import balio

    prob = balio.synthetic_problem_large(1778, 994000, 5)
    cfg = GBPConfig()
    graph = build_graph(prob, cfg)
    state = init_state(prob, cfg)
    state = jax.jit(lambda s: gbp.initialise(s, graph, cfg))(state)
    jax.block_until_ready(state)

    path = str(tmp_path / "venice.npz")
    checkpoint.save_checkpoint(path, state, graph, step=7, cfg=cfg)
    assert os.path.getsize(path) > 2 * 2**30   # really multi-GB

    state2, graph2, meta = checkpoint.load_checkpoint(path)
    assert meta["step"] == 7
    for f in type(state)._fields:
        np.testing.assert_array_equal(np.asarray(getattr(state, f)),
                                      np.asarray(getattr(state2, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(np.asarray(graph.cam_idx),
                                  np.asarray(graph2.cam_idx))
