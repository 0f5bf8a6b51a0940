"""The XLA sweep path: float32 against float64, the belief reduction against
np.add.at, and a graph above 131,072 edges (the size that used to switch
on kernel-only index structures) that builds, sweeps and anneals with
nothing but plain arrays."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gbp_poplar.config import GBPConfig
from gbp_poplar.core import build_graph, gbp, init_state
from gbp_poplar.core.factor_graph import GBPGraph
from gbp_poplar.parallel import pad_edges
from gbp_poplar.utils import balio

FIELDS = ("msg_c_eta", "msg_c_lam", "msg_l_eta", "msg_l_lam",
          "cam_eta", "cam_lam", "lmk_eta", "lmk_lam")


def _problem(model: str):
    if model == "snavely":
        return balio.synthetic_problem_snavely(n_keyframes=6, n_points=50,
                                               seed=3, pixel_noise=0.5)
    return balio.synthetic_problem(n_keyframes=6, n_points=50, seed=3,
                                   pixel_noise=0.5)


def _two_sweeps(problem, dtype, n_pad_shards: int | None):
    cfg = GBPConfig()
    graph = build_graph(problem, cfg, dtype)
    state = init_state(problem, cfg, dtype=dtype)
    if n_pad_shards is not None:
        graph, state, pad = pad_edges(graph, state, n_pad_shards)
        assert pad > 0
    step = jax.jit(lambda s, g: gbp.gbp_sweep(
        gbp.gbp_sweep(gbp.initialise(s, g, cfg), g, cfg), g, cfg))
    return jax.device_get(step(state, graph))


@pytest.mark.parametrize("padded", [False, True],
                         ids=["unpadded", "padded"])
@pytest.mark.parametrize("model", ["pinhole", "snavely"])
def test_gbp_sweep_matches_float64(model, padded):
    """Two sweeps in float32 stay within float32 rounding of the same
    sweeps in float64; inert padding edges change nothing and send zero."""
    problem = _problem(model)
    e = problem.n_edges
    got = _two_sweeps(problem, jnp.float32, 7 if padded else None)
    with jax.enable_x64(True):
        ref = _two_sweeps(problem, jnp.float64, None)
    assert ref.cam_eta.dtype == np.float64
    for f in FIELDS:
        a = np.asarray(getattr(got, f), np.float64)[..., :getattr(
            ref, f).shape[-1]]
        b = np.asarray(getattr(ref, f))
        gap = np.linalg.norm(a - b) / np.linalg.norm(b)
        assert gap < 1e-4, (f, gap)
    if padded:
        for f in ("msg_c_eta", "msg_c_lam", "msg_l_eta", "msg_l_lam"):
            assert np.all(np.asarray(getattr(got, f))[:, e:] == 0.0), f


@pytest.mark.parametrize("kind", ["cam", "lmk"])
def test_update_beliefs_matches_add_at(kind):
    """belief = prior + sum of the incoming messages of each variable."""
    problem = _problem("pinhole")
    cfg = GBPConfig()
    graph = build_graph(problem, cfg)
    state = init_state(problem, cfg)
    rng = np.random.default_rng(0)
    e = graph.n_edges
    msgs = {f: rng.normal(size=getattr(state, f).shape).astype(np.float32)
            for f in ("msg_c_eta", "msg_c_lam", "msg_l_eta", "msg_l_lam")}
    out = gbp.update_beliefs(state._replace(**msgs), graph)

    if kind == "cam":
        idx, n = np.asarray(graph.cam_idx), graph.n_keyframes
        parts = (("cam_eta", "msg_c_eta", "cam_prior_eta"),
                 ("cam_lam", "msg_c_lam", "cam_prior_lam"))
    else:
        idx, n = np.asarray(graph.lmk_idx), graph.n_points
        parts = (("lmk_eta", "msg_l_eta", "lmk_prior_eta"),
                 ("lmk_lam", "msg_l_lam", "lmk_prior_lam"))
    assert idx.shape == (e,)
    for belief, msg, prior in parts:
        want = np.asarray(getattr(state, prior), np.float64).copy()
        np.add.at(want.T, idx, msgs[msg].T.astype(np.float64))
        np.testing.assert_allclose(np.asarray(getattr(out, belief)), want,
                                   rtol=1e-5, atol=1e-4)


@pytest.fixture(scope="module")
def large():
    """A graph above 131,072 edges: 64 keyframes x 20,000 landmarks x 7."""
    problem = balio.synthetic_problem_large(64, 20_000, 7, seed=2)
    cfg = GBPConfig()
    graph = build_graph(problem, cfg)
    state = gbp.initialise(init_state(problem, cfg), graph, cfg)
    return problem, cfg, graph, state


def test_large_graph_builds_and_sweeps_plain(large):
    problem, cfg, graph, state = large
    assert graph.n_edges == problem.n_edges >= 1 << 17
    assert GBPGraph._fields == (
        "cam_idx", "lmk_idx", "meas", "meas_var", "k", "intr",
        "cam_scaling", "lmk_scaling", "first_kf", "first_uv")
    assert all(isinstance(x, jax.Array)
               for x in jax.tree.leaves(graph))
    err0, _ = gbp.reprojection_error(state, graph)
    out = jax.jit(lambda s: gbp.gbp_sweep(s, graph, cfg))(state)
    err1, _ = gbp.reprojection_error(out, graph)
    assert np.isfinite(np.asarray(out.cam_eta)).all()
    assert np.isfinite(float(err1)) and float(err0) > 0


def test_weaken_priors_on_large_graph(large):
    _, _, graph, state = large
    out = gbp.weaken_priors(state, graph)
    cs = np.where(np.asarray(state.cam_weaken) > 0,
                  np.asarray(graph.cam_scaling), 1.0)
    np.testing.assert_allclose(np.asarray(out.cam_prior_lam),
                               np.asarray(state.cam_prior_lam) * cs,
                               rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(out.lmk_weaken),
                                  np.asarray(state.lmk_weaken) - 1)
    # beliefs refreshed from the weakened priors (messages are zero here)
    np.testing.assert_allclose(np.asarray(out.lmk_lam),
                               np.asarray(out.lmk_prior_lam), rtol=1e-6)


def test_coarse_dot_generals_pin_highest():
    """A float32 product at default precision may run in TF32 on the GPU:
    every dot_general of the coarse-space solve asks for HIGHEST."""
    from jax.extend import core as jex_core

    from gbp_poplar.core import coarse

    problem = _problem("pinhole")
    cfg = GBPConfig(coarse_groups=3)
    graph = build_graph(problem, cfg)
    state = gbp.initialise(init_state(problem, cfg), graph, cfg)
    cam_mu, lmk_mu = gbp._variable_means(state)
    jaxpr = jax.make_jaxpr(lambda s, g, a, b: coarse.coarse_increment(
        s, g, cfg, a, b))(state, graph, cam_mu, lmk_mu)

    precisions = []

    def walk(jx):
        for eqn in jx.eqns:
            for v in eqn.params.values():
                if isinstance(v, jex_core.ClosedJaxpr):
                    walk(v.jaxpr)
                elif isinstance(v, jex_core.Jaxpr):
                    walk(v)
            if eqn.primitive.name == "dot_general":
                precisions.append(eqn.params["precision"])

    walk(jaxpr.jaxpr)
    assert precisions
    highest = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)
    assert all(p == highest for p in precisions), precisions
