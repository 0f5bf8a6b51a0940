"""ATE grid: batch GBP vs the GN MAP oracle across config variants.

    python scripts/exp_ate_grid.py <seq> <iters> "k=v,k=v" ["k=v,..."] ...

Each positional spec after <iters> is one config variant (comma-separated
overrides on top of the ba-driver defaults, i.e. coarse_groups=16). "base"
runs the driver defaults unchanged. GN is solved once per sequence; each
variant reports final reprojection error, ATE vs GN, and the MAP cost
ratio at the converged means (same annealed-prior robust objective).
Runs on whatever backend GBP_PLATFORM selects (CPU for parallel grids).
"""

import dataclasses
import os
import sys
import time

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


def parse_spec(spec: str) -> dict:
    out = {}
    if spec == "base":
        return out
    for kv in spec.split(","):
        k, _, v = kv.partition("=")
        cur = getattr(GBPConfig(), k)
        out[k] = type(cur)(float(v) if not isinstance(cur, bool)
                           else v not in ("0", "false"))
    return out


def main():
    seq = sys.argv[1]
    n_iters = int(sys.argv[2])
    specs = sys.argv[3:] or ["base"]

    prob = balio.load_bal(seq)
    base = GBPConfig(coarse_groups=min(16, prob.n_keyframes))

    # GN oracle (solved once; same annealed robust objective)
    res_gn = gauss_newton.solve_problem(prob, base, n_lm_iters=60)
    gn_cam = np.asarray(res_gn.cam)
    gn_lmk = np.asarray(res_gn.lmk)

    g1 = build_graph(prob, base)
    cam_lam0, lmk_lam0 = priors_lib.prior_lambdas(prob, base.meas_var)
    pri = gauss_newton.annealed_priors(
        g1, jnp.asarray(prob.cam_means), jnp.asarray(prob.lmk_means),
        cam_lam0, lmk_lam0, base)

    def map_cost(cam, lmk):
        from gbp_poplar.ops import projection as pj
        r = g1.meas.T - pj.project(jnp.asarray(cam)[g1.cam_idx],
                                   jnp.asarray(lmk)[g1.lmk_idx], g1.k)
        return (float(gauss_newton._robust_cost(r, g1.meas_var,
                                                base.huber_nstds))
                + float(gauss_newton._prior_cost(jnp.asarray(cam),
                                                 jnp.asarray(lmk), pri)))

    c_gn = map_cost(gn_cam, gn_lmk)
    print(f"{seq}: {prob.n_keyframes} kf / {prob.n_edges} edges, "
          f"{n_iters} iters; GN reproj {float(res_gn.reproj_err[-1]):.3f} px"
          f", cost {c_gn:.1f}", flush=True)
    print(f"{'variant':48s} {'err px':>7s} {'ATE m':>9s} {'ratio':>7s} "
          f"{'time s':>7s}", flush=True)

    for spec in specs:
        cfg = dataclasses.replace(base, **parse_spec(spec))
        graph = build_graph(prob, cfg)
        state0 = init_state(prob, cfg)
        t0 = time.perf_counter()
        final, diag = jax.jit(
            lambda s, g=graph, c=cfg: gbp.solve(s, g, c, n_iters=n_iters)
        )(state0)
        jax.block_until_ready(final)
        dt = time.perf_counter() - t0
        err = float(np.asarray(diag.reproj_err)[-1])
        cam_mu, lmk_mu = map(np.asarray, gbp._variable_means(final))
        ate = evaluation.ate_rmse(cam_mu.T, gn_cam)
        ratio = map_cost(cam_mu.T, lmk_mu.T) / c_gn
        print(f"{spec:48s} {err:7.3f} {ate:9.5f} {ratio:7.4f} {dt:7.1f}",
              flush=True)


if __name__ == "__main__":
    main()
