"""Sharded solver == single-device solver, numerically.

Runs on the virtual 8-device CPU mesh configured in conftest.py. The sharded
path reuses the exact single-chip sweep code with one psum added to the
belief reduction, so results should agree to float32 reduction-order noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gbp_poplar.config import GBPConfig
from gbp_poplar.core import build_graph, init_state, gbp
from gbp_poplar.parallel import (
    make_mesh, make_sharded_solver, pad_edges,
)


@pytest.fixture(scope="module")
def problem(synthetic):
    return synthetic


def _solve_single(problem, cfg, n_iters):
    graph = build_graph(problem, cfg)
    state = init_state(problem, cfg)
    run = jax.jit(lambda s: gbp.solve(s, graph, cfg, n_iters=n_iters))
    return run(state)


def _solve_sharded(problem, cfg, n_iters, n_devices):
    mesh = make_mesh(n_devices)
    solver = make_sharded_solver(mesh, cfg)
    graph = build_graph(problem, cfg)
    state = init_state(problem, cfg)
    graph, state = solver.prepare(graph, state)
    return solver.solve(state, graph, n_iters)


@pytest.mark.parametrize("n_devices", [2, 8])
def test_sharded_single_sweep_close(problem, n_devices):
    """One initialise + sweep: sharded == single up to fp32 psum
    reduction-order noise (partial per-shard segment sums are summed in a
    different order than one global segment_sum)."""
    assert len(jax.devices()) >= n_devices, "conftest should force 8 CPU devices"
    cfg = GBPConfig()
    graph = build_graph(problem, cfg)
    state = init_state(problem, cfg)
    s1 = gbp.gbp_sweep(gbp.initialise(state, graph, cfg), graph, cfg)

    mesh = make_mesh(n_devices)
    solver = make_sharded_solver(mesh, cfg)
    g2, st2 = solver.prepare(graph, state)
    s2 = solver.sweep(solver.initialise(st2, g2), g2)

    # fp32 + different XLA compilations (per-shard body vs global fusion)
    # contract differently; 1e-4 of the max is well below any structural
    # error and well above benign rounding noise.
    scale = np.abs(np.asarray(s1.cam_eta)).max()
    np.testing.assert_allclose(
        np.asarray(s2.cam_eta) / scale, np.asarray(s1.cam_eta) / scale,
        rtol=0, atol=1e-4)
    e = problem.n_edges
    mscale = np.abs(np.asarray(s1.msg_c_eta)).max()
    np.testing.assert_allclose(
        np.asarray(s2.msg_c_eta)[:, :e] / mscale,
        np.asarray(s1.msg_c_eta)[:, :e] / mscale, rtol=0, atol=1e-4)


@pytest.mark.parametrize("n_devices", [2, 8])
def test_sharded_converges_like_single(problem, n_devices):
    """Full solve: the discrete relin/robust state machine makes long fp32
    runs bitwise-divergent between reduction orders, so compare converged
    solution quality, not raw state."""
    cfg = GBPConfig()
    n_iters = 80
    _, diag_s = _solve_single(problem, cfg, n_iters)
    _, diag_p = _solve_sharded(problem, cfg, n_iters, n_devices)

    err_s = np.asarray(diag_s.reproj_err)
    err_p = np.asarray(diag_p.reproj_err)
    assert np.isfinite(err_p).all()
    # same converged reprojection error (px) within a few percent
    tail_s, tail_p = err_s[-10:].mean(), err_p[-10:].mean()
    assert abs(tail_p - tail_s) < 0.05 * max(tail_s, 1e-3) + 5e-3


def test_padding_is_inert(problem):
    """Padded inactive edges contribute nothing to beliefs."""
    cfg = GBPConfig()
    graph = build_graph(problem, cfg)
    state = init_state(problem, cfg)
    graph_p, state_p, pad = pad_edges(graph, state, 7)
    assert pad > 0 and graph_p.n_edges % 7 == 0

    run = jax.jit(lambda s, g: gbp.solve(s, g, cfg, n_iters=10))
    final_a, diag_a = run(state, graph)
    final_b, diag_b = run(state_p, graph_p)
    # different edge extents compile to different fusions -> fp32
    # contraction noise; padding being *inert* is the exact-zero check below
    np.testing.assert_allclose(
        np.asarray(diag_b.reproj_err), np.asarray(diag_a.reproj_err),
        rtol=1e-4, atol=1e-4)
    scale = np.abs(np.asarray(final_a.cam_eta)).max()
    np.testing.assert_allclose(
        np.asarray(final_b.cam_eta) / scale,
        np.asarray(final_a.cam_eta) / scale, rtol=0, atol=1e-4)
    # padding edges never emitted a message
    assert np.all(np.asarray(final_b.msg_c_eta)[:, problem.n_edges:] == 0.0)


def test_sharded_sweep_and_init(problem):
    """Piecewise entry points (initialise + sweep) compose like solve."""
    cfg = GBPConfig()
    mesh = make_mesh(4)
    solver = make_sharded_solver(mesh, cfg)
    graph = build_graph(problem, cfg)
    state = init_state(problem, cfg)
    graph, state = solver.prepare(graph, state)
    state = solver.initialise(state, graph)
    state = solver.sweep(state, graph)
    assert np.isfinite(np.asarray(state.cam_eta)).all()


@pytest.mark.parametrize("n_devices", [2, 8])
def test_map_sharded_converges_like_single(problem, n_devices):
    """Map-partitioned mode (landmark blocks sharded, keyframes boundary):
    same converged quality as the single-device solver."""
    from gbp_poplar.parallel import make_map_sharded_solver
    cfg = GBPConfig()
    n_iters = 80
    _, diag_s = _solve_single(problem, cfg, n_iters)
    err_s = np.asarray(diag_s.reproj_err)

    mesh = make_mesh(n_devices)
    solver = make_map_sharded_solver(mesh, cfg)
    graph, state = solver.prepare(build_graph(problem, cfg),
                                  init_state(problem, cfg))
    _, diag_p = solver.solve(state, graph, n_iters)
    err_p = np.asarray(diag_p.reproj_err)
    assert np.isfinite(err_p).all()
    tail_s, tail_p = err_s[-10:].mean(), err_p[-10:].mean()
    assert abs(tail_p - tail_s) < 0.05 * max(tail_s, 1e-3) + 5e-3


def test_partition_by_landmark_bookkeeping(problem):
    """Each shard owns a contiguous landmark block + exactly its edges."""
    from gbp_poplar.parallel import partition_by_landmark
    cfg = GBPConfig()
    graph = build_graph(problem, cfg)
    state = init_state(problem, cfg)
    n = 4
    g2, s2 = partition_by_landmark(graph, state, n)
    l_blk = g2.n_points // n
    assert g2.n_points % n == 0 and g2.n_edges % n == 0
    e_blk = g2.n_edges // n
    lmk_local = np.asarray(g2.lmk_idx)
    active = np.asarray(s2.active)
    # local landmark ids stay within the block; active edge count preserved
    assert (lmk_local[active > 0] < l_blk).all()
    assert active.sum() == np.asarray(state.active).sum()
    # reconstruct global ids and compare edge multisets
    shard_of = np.repeat(np.arange(n), e_blk)
    glob = lmk_local + shard_of * l_blk
    got = sorted(zip(np.asarray(g2.cam_idx)[active > 0],
                     glob[active > 0]))
    act0 = np.asarray(state.active) > 0
    want = sorted(zip(np.asarray(graph.cam_idx)[act0],
                      np.asarray(graph.lmk_idx)[act0]))
    assert got == want


def test_map_sharded_slam(problem):
    """Incremental keyframe insertion under the map-partitioned sharding."""
    from gbp_poplar.parallel import make_map_sharded_solver
    from gbp_poplar.utils import flags as flags_lib
    cfg = GBPConfig()
    graph = build_graph(problem, cfg)
    flags = flags_lib.create_flags(problem, cfg.steps)
    state = init_state(problem, cfg, flags=flags)
    mesh = make_mesh(4)
    solver = make_map_sharded_solver(mesh, cfg)
    g2, st2 = solver.prepare(graph, state)
    st2 = solver.initialise(st2, g2)
    last = None
    for k in range(1, problem.n_keyframes):
        st2, diag = solver.run(st2, g2, 60, 0)
        last = np.asarray(diag.reproj_err)
        if k + 1 < problem.n_keyframes:
            st2 = solver.insert_keyframe(st2, g2, k + 1, 6.0)
    final = last[-10:].mean()
    assert np.isfinite(final) and final < 1.5
