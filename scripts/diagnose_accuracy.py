"""Diagnose why the lazy-relinearisation (reference) schedule stalls short
of the Gauss-Newton MAP fixed point on the hard TUM sequences.

Collects per-iteration relin/robust traces and final per-edge stats
(residual, drift from linearisation point, dmu quiescence) and compares the
final solution against the GN baseline per-variable.

    python scripts/diagnose_accuracy.py fr1desk 1000
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from gbp_poplar.drivers.common import maybe_force_platform  # noqa: E402

maybe_force_platform()   # honour GBP_PLATFORM=cpu for parallel experiments

import jax
import jax.numpy as jnp
import numpy as np

from gbp_poplar.config import GBPConfig
from gbp_poplar.core import build_graph, gauss_newton, gbp, init_state
from gbp_poplar.ops import planes as pl
from gbp_poplar.utils import balio, evaluation

seq = sys.argv[1] if len(sys.argv) > 1 else "fr1desk"
n_iters = int(sys.argv[2]) if len(sys.argv) > 2 else 1000
overrides = {}
for kv in sys.argv[3:]:
    k, _, v = kv.partition("=")
    cur = getattr(GBPConfig(), k)
    overrides[k] = type(cur)(float(v) if not isinstance(cur, bool)
                             else v not in ("0", "false"))

prob = balio.load_bal(seq)
cfg = GBPConfig(**overrides)
print(f"{seq}: {prob.n_keyframes} kf / {prob.n_points} lmk / "
      f"{prob.n_edges} edges; cfg overrides: {overrides}")

graph = build_graph(prob, cfg)
state0 = init_state(prob, cfg)
final, diag = jax.jit(lambda s: gbp.solve(s, graph, cfg, n_iters=n_iters))(state0)
jax.block_until_ready(final)

errs = np.asarray(diag.reproj_err)
relins = np.asarray(diag.n_relins)
robusts = np.asarray(diag.n_robust)
print("\niteration trace (err / relins / robust):")
for i in [9, 25, 50, 100, 200, 300, 500, 700, n_iters - 1]:
    if i < n_iters:
        print(f"  it {i:4d}: {errs[i]:8.4f} px  relins {relins[i]:5d}  "
              f"robust {robusts[i]:5d}")
print(f"  min err {np.nanmin(errs):.4f} at it {int(np.nanargmin(errs))}")
print(f"  relins over last 100 iters: mean {relins[-100:].mean():.1f}")

e = prob.n_edges
st = jax.tree.map(lambda x: np.asarray(x), final)

# final per-edge stats
cam_mu, lmk_mu = map(np.asarray, gbp._variable_means(final))
mu_c = cam_mu[:, np.asarray(graph.cam_idx)[:e]]
mu_l = lmk_mu[:, np.asarray(graph.lmk_idx)[:e]]
mu = np.concatenate([mu_c, mu_l])                      # [9, e]
dmu = np.linalg.norm(mu - st.mu[:, :e], axis=0)        # change last iter
drift = np.linalg.norm(mu - st.lin_mu[:, :e], axis=0)  # from linearisation pt

(u, v), y_cf, _ = pl.project(pl.unpack_vec(jnp.asarray(mu_c), 6),
                             pl.unpack_vec(jnp.asarray(mu_l), 3), graph.k)
meas = np.asarray(graph.meas)[:, :e]
res = np.hypot(meas[0] - np.squeeze(np.asarray(u)),
               meas[1] - np.squeeze(np.asarray(v)))
depth = np.squeeze(np.asarray(y_cf[2]))   # landmark depth in camera frame

print(f"\nfinal per-edge stats over {e} edges:")
print(f"  residual px: mean {res.mean():.3f}  median {np.median(res):.3f} "
      f" p90 {np.percentile(res, 90):.3f}  p99 {np.percentile(res, 99):.3f}"
      f"  max {res.max():.2f}")
print(f"  robust fraction: {st.robust[:e].mean():.4f}")
print(f"  dmu: median {np.median(dmu):.2e}  p90 {np.percentile(dmu, 90):.2e}"
      f"  frac above 3e-3 (never quiesce): {(dmu > cfg.dmu_threshold).mean():.4f}")
print(f"  drift from lin point: median {np.median(drift):.2e}  "
      f"p90 {np.percentile(drift, 90):.2e}  max {drift.max():.2e}")

hi = res > np.percentile(res, 95)
print(f"\n  top-5% residual edges: dmu median {np.median(dmu[hi]):.2e}, "
      f"frac dmu>thr {(dmu[hi] > cfg.dmu_threshold).mean():.3f}, "
      f"drift median {np.median(drift[hi]):.2e}, "
      f"robust frac {st.robust[:e][hi].mean():.3f}")
lo = ~hi
print(f"  rest: dmu median {np.median(dmu[lo]):.2e}, "
      f"frac dmu>thr {(dmu[lo] > cfg.dmu_threshold).mean():.3f}, "
      f"drift median {np.median(drift[lo]):.2e}")

print(f"  depth at belief mean: frac < 0 {np.mean(depth < 0):.4f}, "
      f"frac < {cfg.min_depth}: {np.mean(depth < cfg.min_depth):.4f}")
worst_e = np.argsort(res)[-25:][::-1]
lmk_ids = np.asarray(graph.lmk_idx)[:e]
cam_ids = np.asarray(graph.cam_idx)[:e]
lmk_deg = np.bincount(lmk_ids, minlength=prob.n_points)
print("\n  25 worst edges (res, depth, dmu, drift, robust, dc, lmk, deg):")
for i in worst_e:
    print(f"    e{i:6d}: res {res[i]:9.2f}  z {depth[i]:8.3f}  "
          f"dmu {dmu[i]:.2e}  drift {drift[i]:.2e}  "
          f"rob {int(st.robust[i])}  dc {int(st.damping_count[i]):5d}  "
          f"lmk {lmk_ids[i]:5d} (deg {lmk_deg[lmk_ids[i]]})")
# how much do the catastrophic edges alone explain of the mean gap?
for thr in (10.0, 50.0):
    m = res > thr
    print(f"  edges with res>{thr}: {m.sum()} "
          f"({res[m].sum() / e:.3f} px of the mean)")

# GN comparison (a cold start needs generous LM iterations in fp32)
res_gn = gauss_newton.solve_problem(prob, cfg, n_lm_iters=60)
gn_cam = np.asarray(res_gn.cam)
gn_lmk = np.asarray(res_gn.lmk)
from gbp_poplar.ops import projection as proj
r_gn = np.asarray(graph.meas).T[:e] - np.asarray(proj.project(
    jnp.asarray(gn_cam)[cam_ids], jnp.asarray(gn_lmk)[lmk_ids], graph.k))
res_gn_e = np.linalg.norm(r_gn, axis=-1)
print(f"\nGN per-edge residuals: mean {res_gn_e.mean():.3f}  median "
      f"{np.median(res_gn_e):.3f}  p99 {np.percentile(res_gn_e, 99):.3f}  "
      f"max {res_gn_e.max():.2f}")
print("  GN residual on GBP's 25 worst edges: "
      + " ".join(f"{res_gn_e[i]:.1f}" for i in worst_e))
# per-landmark disagreement
dl = np.linalg.norm(np.asarray(lmk_mu).T - gn_lmk, axis=1)
print(f"  per-landmark |y_GBP - y_GN| (m): median {np.median(dl):.4f}  "
      f"p99 {np.percentile(dl, 99):.4f}  max {dl.max():.3f}; "
      f"n>0.1m: {(dl > 0.1).sum()}")
ate = evaluation.ate_rmse(cam_mu.T, gn_cam)
print(f"\nGN: reproj {float(res_gn.reproj_err[-1]):.4f} px; "
      f"ATE(GBP,GN) {ate:.5f} m")

# --- MAP-cost comparison: are the two solvers in the same basin? ---
from gbp_poplar.utils import priors as priors_lib
g1 = build_graph(prob, cfg)
cam_lam0, lmk_lam0 = priors_lib.prior_lambdas(prob, cfg.meas_var)
pri = gauss_newton.annealed_priors(
    g1, jnp.asarray(prob.cam_means), jnp.asarray(prob.lmk_means),
    cam_lam0, lmk_lam0, cfg)

def map_cost(cam, lmk):
    from gbp_poplar.ops import projection as pj
    r = g1.meas.T - pj.project(jnp.asarray(cam)[g1.cam_idx],
                               jnp.asarray(lmk)[g1.lmk_idx], g1.k)
    return (float(gauss_newton._robust_cost(r, g1.meas_var, cfg.huber_nstds))
            + float(gauss_newton._prior_cost(jnp.asarray(cam),
                                             jnp.asarray(lmk), pri)))

def cost_split(cam, lmk):
    from gbp_poplar.ops import projection as pj
    r = g1.meas.T - pj.project(jnp.asarray(cam)[g1.cam_idx],
                               jnp.asarray(lmk)[g1.lmk_idx], g1.k)
    rob = float(gauss_newton._robust_cost(r, g1.meas_var, cfg.huber_nstds))
    prior = float(gauss_newton._prior_cost(jnp.asarray(cam),
                                           jnp.asarray(lmk), pri))
    return rob, prior

rob_gbp, pri_gbp = cost_split(cam_mu.T, lmk_mu.T)
rob_gn, pri_gn = cost_split(gn_cam, gn_lmk)
c_gbp, c_gn = rob_gbp + pri_gbp, rob_gn + pri_gn
print(f"\nMAP cost: GBP {c_gbp:.2f} (robust {rob_gbp:.2f} + prior "
      f"{pri_gbp:.2f})  GN {c_gn:.2f} (robust {rob_gn:.2f} + prior "
      f"{pri_gn:.2f})  ratio {c_gbp / c_gn:.4f}")
gn_cost_trace = np.asarray(res_gn.cost)
print(f"  GN cost trace last 5: {gn_cost_trace[-5:]}  "
      f"accepted {int(np.asarray(res_gn.accepted).sum())}/30")
dd = np.linalg.norm(cam_mu.T[:, :3] - gn_cam[:, :3], axis=1)
print("  anchor kfs |t_GBP - t_GN| (m): "
      + " ".join(f"kf{i}={dd[i]:.5f}" for i in range(3)))

# Decisive basin test: polish the GBP solution with LM. If it rolls to GN's
# cost, GBP had not finished converging; if it stays, it is a distinct
# local minimum of the same objective.
res_pol = gauss_newton.solve_lm(
    jnp.asarray(cam_mu.T), jnp.asarray(lmk_mu.T), g1, pri, cfg,
    n_lm_iters=30)
pol_cam = np.asarray(res_pol.cam)
print(f"  LM-polish of GBP point: cost {float(res_pol.cost[-1]):.2f}, "
      f"moved {np.linalg.norm(pol_cam[:, :3] - cam_mu.T[:, :3], axis=1).max():.4f} m max, "
      f"ATE(polished, GN) {evaluation.ate_rmse(pol_cam, gn_cam):.5f} m")
# per-camera disagreement (GBP cam means are [6, C] -> [C, 6])
d = np.linalg.norm(cam_mu.T[:, :3] - gn_cam[:, :3], axis=1)
print("  per-camera |t_GBP - t_GN| (m): "
      f"median {np.median(d):.4f}  p90 {np.percentile(d, 90):.4f}  "
      f"max {d.max():.4f} at kf {int(d.argmax())}")
worst = np.argsort(d)[-5:][::-1]
deg = np.bincount(np.asarray(graph.cam_idx)[:e], minlength=prob.n_keyframes)
for c in worst:
    m = np.asarray(graph.cam_idx)[:e] == c
    print(f"    kf {c:3d}: |dt| {d[c]:.4f} m, degree {deg[c]:4d}, "
          f"mean res {res[m].mean():.3f} px, robust {st.robust[:e][m].mean():.3f}")
