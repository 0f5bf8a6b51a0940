"""Sequence-level regression guard on a real TUM sequence (fr2robot2, the
smallest shipped problem): reference-schedule GBP must converge to the
Gauss-Newton MAP solution. Previously this behaviour was only checked by
scripts/docs; a drift in the solver schedule now fails CI.

Skipped when the reference sequences are not on disk (conftest)."""

import jax
import numpy as np
import pytest

from gbp_poplar.config import GBPConfig
from gbp_poplar.core import build_graph, gauss_newton, gbp, init_state
from gbp_poplar.utils import balio, evaluation

from conftest import requires_sequences


pytestmark = pytest.mark.slow   # full solves / subprocess runs

@requires_sequences
def test_fr2robot2_reference_schedule_matches_gn():
    prob = balio.load_bal("fr2robot2")
    cfg = GBPConfig()
    graph = build_graph(prob, cfg)
    state = init_state(prob, cfg)
    final, diag = jax.jit(
        lambda s: gbp.solve(s, graph, cfg, n_iters=300))(state)
    errs = np.asarray(diag.reproj_err)
    assert np.isfinite(errs).all()
    # converged mean reprojection error at the GN level (GN: 0.879 px)
    assert errs[-1] < 1.0, errs[-1]

    res = gauss_newton.solve_problem(prob, cfg, n_lm_iters=25)
    assert float(res.reproj_err[-1]) < 1.0
    cam_mu = np.asarray(pl_means(final))
    ate = evaluation.ate_rmse(cam_mu, np.asarray(res.cam))
    # round-1/2 measured 0.001 m; fail on an order-of-magnitude regression
    assert ate < 0.01, ate


def pl_means(state):
    from gbp_poplar.utils import analysis
    cam_mu, _ = analysis.belief_means(state)
    return cam_mu


@requires_sequences
def test_fr1xyz_short_budget_px():
    """fr1xyz px-convergence guard (the hardest-won round-2 result was
    previously pinned only by scripts/docs): the library-default schedule
    must reach GN-level reprojection error within a short budget.
    Round-2/3 measured ~1.6 px at 300 iters on CPU; fail at 2.5."""
    prob = balio.load_bal("fr1xyz")
    cfg = GBPConfig()
    graph = build_graph(prob, cfg)
    state = init_state(prob, cfg)
    _, diag = jax.jit(
        lambda s: gbp.solve(s, graph, cfg, n_iters=300))(state)
    errs = np.asarray(diag.reproj_err)
    assert np.isfinite(errs).all()
    assert errs[-1] < 2.5, errs[-1]


@requires_sequences
def test_fr1desk_default_schedule_polishes_to_map():
    """fr1desk guard on the DEFAULT ba-driver schedule (drift recapture
    0.05 + coarse 16 + lambda damping): px at GN parity, NO late Huber
    storm, and LM-polish of the GBP point lands on the exact MAP
    (measured 1.376 px monotone / polished 11381.66 == GN under the CI
    device flags). History: the eta-only-damped default was fp32-bistable
    on desk — it converged under the round-3 codegen but STORMED under a
    later one (n_robust 158 -> 600+ after iter ~1000, final means
    non-finite, polish NaN; observed in round 4 on an unchanged solver),
    and the pure lazy schedule diverges outright (2246 px). Lambda
    damping (config.py default since round 4) removes the oscillation
    mechanism rather than betting on rounding; docs/VALIDATION.md."""
    import jax.numpy as jnp

    from gbp_poplar.drivers.ba import _polish_problem

    prob = balio.load_bal("fr1desk")
    cfg = GBPConfig(coarse_groups=16)       # the ba-driver defaults
    graph = build_graph(prob, cfg)
    state = init_state(prob, cfg)
    final, diag = jax.jit(
        lambda s: gbp.solve(s, graph, cfg, n_iters=1500))(state)
    errs = np.asarray(diag.reproj_err)
    assert np.isfinite(errs).all()
    assert errs[-1] < 2.5, errs[-1]          # GN parity (GN: 1.386 px)
    # no Huber storm past the annealing transient (the bistable failure
    # mode of the eta-only-damped schedule this test used to ride).
    # Cutoff = well past the prior-weakening window (2*cfg.steps = 10
    # iters) plus the post-anneal settling observed under the default
    # schedule (~100 iters on desk); if the default steps/weaken schedule
    # ever stretches the transient past this, update it knowingly.
    transient = max(200, 40 * cfg.steps)
    assert errs[transient:].max() < 4.0, errs[transient:].max()

    res_gn = gauss_newton.solve_problem(prob, cfg, n_lm_iters=25)
    from gbp_poplar.utils import analysis
    cam_mu, lmk_mu = analysis.belief_means(final)
    res_pol = gauss_newton.solve_lm(
        jnp.asarray(cam_mu), jnp.asarray(lmk_mu),
        *_polish_problem(prob, cfg), cfg, n_lm_iters=30)
    cost_pol = float(res_pol.cost[-1])
    cost_gn = float(res_gn.cost[-1])
    assert np.isfinite(cost_pol) and np.isfinite(cost_gn)
    assert cost_pol < 1.02 * cost_gn, (cost_pol, cost_gn)


def test_fr1desk_lazy_lambda_damped_converges():
    """The PURE lazy schedule (relin_drift 0, accel off — the reference's
    exact dynamics) diverges on fr1desk under this test env's 8-virtual-
    device CPU codegen (2246 px @1500; a ~100-ulp seed in the linearise
    etas grows through Huber-storm oscillations — docs/VALIDATION.md,
    round 4). Lambda damping is the measured mitigation: the same
    schedule + lambda_damping must converge HERE, in the env that kills
    the undamped run."""
    cfg = GBPConfig(relin_drift_threshold=0.0, accel_every=0,
                    lambda_damping=True)
    problem = balio.load_bal("fr1desk")
    graph = build_graph(problem, cfg)
    state = init_state(problem, cfg)
    _, diag = jax.jit(lambda s: gbp.solve(s, graph, cfg, n_iters=1500))(
        state)
    errs = np.asarray(diag.reproj_err)
    assert np.isfinite(errs).all()
    assert errs[-1] < 2.0, f"lambda-damped lazy desk at {errs[-1]} px"
    # and no Huber storm blow-up anywhere past the annealing transient
    assert errs[200:].max() < 4.0
