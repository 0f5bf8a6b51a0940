"""Two-phase drift-relinearisation experiment.

The drift-recapture trigger (relin_drift_threshold) cuts the annealing
transient ~8x and prevents fp32 oscillation deadlock, but on fr1desk it
lets the solver walk between equal-reprojection Huber basins late in the
solve (ATE vs GN degrades), while with drift off the stored linearisation
points pin the solver to the GN init basin. Hypothesis: drift-on during the
transient, drift-off afterwards gets both.

    python scripts/exp_drift_phase.py fr1desk 1500 300
                                      <seq>   <total> <phase-1 iters>
Extra key=value args override the base config for BOTH phases.
"""

import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from gbp_poplar.drivers.common import maybe_force_platform  # noqa: E402

maybe_force_platform()

import jax
import jax.numpy as jnp
import numpy as np

from gbp_poplar.config import GBPConfig
from gbp_poplar.core import build_graph, gauss_newton, gbp, init_state
from gbp_poplar.utils import balio, evaluation
from gbp_poplar.utils import priors as priors_lib

seq = sys.argv[1] if len(sys.argv) > 1 else "fr1desk"
n_total = int(sys.argv[2]) if len(sys.argv) > 2 else 1500
n_phase1 = int(sys.argv[3]) if len(sys.argv) > 3 else 300
overrides = {}
for kv in sys.argv[4:]:
    k, _, v = kv.partition("=")
    cur = getattr(GBPConfig(), k)
    overrides[k] = type(cur)(float(v) if not isinstance(cur, bool)
                             else v not in ("0", "false"))

base = dataclasses.replace(GBPConfig(coarse_groups=16), **overrides)
# an explicit relin_drift_threshold override sets the "on" phase threshold
cfg_on = (base if "relin_drift_threshold" in overrides
          else dataclasses.replace(base, relin_drift_threshold=0.05))
cfg_off = dataclasses.replace(base, relin_drift_threshold=0.0)

prob = balio.load_bal(seq)
graph = build_graph(prob, cfg_on)
print(f"{seq}: {prob.n_keyframes} kf / {prob.n_points} lmk / "
      f"{prob.n_edges} edges; total {n_total}, phase1 {n_phase1}; "
      f"overrides {overrides}")

# GN baseline + annealed priors for the MAP cost (built once)
res_gn = gauss_newton.solve_problem(prob, cfg_on, n_lm_iters=60)
gn_cam = np.asarray(res_gn.cam)
g1 = build_graph(prob, cfg_on)
cam_lam0, lmk_lam0 = priors_lib.prior_lambdas(prob, cfg_on.meas_var)
pri = gauss_newton.annealed_priors(
    g1, jnp.asarray(prob.cam_means), jnp.asarray(prob.lmk_means),
    cam_lam0, lmk_lam0, cfg_on)


def map_cost(cam, lmk):
    from gbp_poplar.ops import projection as pj
    r = g1.meas.T - pj.project(jnp.asarray(cam)[g1.cam_idx],
                               jnp.asarray(lmk)[g1.lmk_idx], g1.k)
    return (float(gauss_newton._robust_cost(r, g1.meas_var, cfg_on.huber_nstds))
            + float(gauss_newton._prior_cost(jnp.asarray(cam),
                                             jnp.asarray(lmk), pri)))


c_gn = map_cost(gn_cam, np.asarray(res_gn.lmk))


def report(tag, final, err):
    cam_mu, lmk_mu = map(np.asarray, gbp._variable_means(final))
    ate = evaluation.ate_rmse(cam_mu.T, gn_cam)
    c = map_cost(cam_mu.T, lmk_mu.T)
    print(f"  {tag:28s} err {err:6.3f} px  ATE(GBP,GN) {ate:8.5f} m  "
          f"cost ratio {c / c_gn:.4f}")
    return ate, c / c_gn


def run_two_phase(n1, reverse=False):
    """n1 iters in phase-1 config, rest in phase-2 (same state).

    Default: drift ON first, OFF after. ``reverse``: OFF first, ON after —
    tests whether sparing the early basin walk (smooth modes move fastest
    in the first few hundred sweeps) while keeping the late-solve
    oscillation protection gets the best of both."""
    a, b = (cfg_off, cfg_on) if reverse else (cfg_on, cfg_off)
    st = gbp.initialise(init_state(prob, a), graph, a)
    if n1 > 0:
        st, d1 = jax.jit(lambda s: gbp.run_gbp(s, graph, a, n1))(st)
    n2 = n_total - n1
    if n2 > 0:
        st, d2 = jax.jit(lambda s: gbp.run_gbp(
            s, graph, b, n2, iter_offset=n1))(st)
        err = float(np.asarray(d2.reproj_err)[-1])
    else:
        err = float(np.asarray(d1.reproj_err)[-1])
    jax.block_until_ready(st)
    return st, err


print(f"GN: {float(res_gn.reproj_err[-1]):.4f} px, cost {c_gn:.1f}")
for n1, rev, tag in ((n_total, False, "drift always"),
                     (0, False, "drift never"),
                     (n_phase1, False, f"drift first {n_phase1}"),
                     (n_phase1, True, f"drift AFTER {n_phase1}")):
    st, err = run_two_phase(n1, rev)
    report(tag, st, err)
