"""MAP-accuracy validation at >= 1M edges (docs/VALIDATION.md large-scale
section): GBP vs the chunked Gauss-Newton oracle at the Ladybug shape.

    python scripts/validate_scale.py [gbp_iters] [--venice]

Up to round 4 the large-scale evidence was "reprojection error decreases";
this runs the full GN-parity protocol (the repo's stronger version of the
reference's host eval, ba/util.cpp:74-144) at 1.09M edges:

  1. GBP solve (default schedule) -> means, MAP cost, reproj px
  2. LM polish warm-started from the GBP means (what gbp-ba --polish does)
  3. Cold GN/Schur baseline from the problem init
  4. Report: costs, px, cost ratios, ATE(GBP, GN)

Run it on the card; the GN build streams 512k-edge chunks
(core/gauss_newton._GN_CHUNK_EDGES) so no [E, 6, 6] temporary appears.
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from gbp_poplar.config import GBPConfig
from gbp_poplar.core import build_graph, init_state, gbp
from gbp_poplar.core import gauss_newton as gn
from gbp_poplar.utils import analysis, balio, evaluation


def main():
    n_iters = int(sys.argv[1]) if len(sys.argv) > 1 else 500
    shape = ((1778, 994000, 5) if "--venice" in sys.argv
             else (1723, 156000, 7))
    prob = balio.synthetic_problem_large(*shape)
    cfg = GBPConfig()

    # --- GBP ---
    graph = build_graph(prob, cfg)
    state = init_state(prob, cfg)
    t0 = time.perf_counter()
    final, diag = jax.jit(
        lambda s: gbp.solve(s, graph, cfg, n_iters=n_iters))(state)
    jax.block_until_ready(final)
    dt = time.perf_counter() - t0
    errs = np.asarray(diag.reproj_err)
    cam_mu, lmk_mu = analysis.belief_means(final)
    print(f"GBP: {graph.n_edges} edges, {n_iters} iters in {dt:.1f}s, "
          f"err {errs[0]:.3f} -> {errs[-1]:.4f} px", flush=True)

    # --- shared MAP objective (GN machinery, chunked) ---
    from gbp_poplar.drivers.ba import _polish_problem
    graph1, pri = _polish_problem(prob, cfg)
    cost_fn = jax.jit(lambda c, l: gn.map_cost(c, l, graph1, pri, cfg))
    gbp_cost = float(cost_fn(jnp.asarray(cam_mu), jnp.asarray(lmk_mu)))
    print(f"GBP MAP cost: {gbp_cost:.2f}", flush=True)

    # --- polish (what gbp-ba does by default) ---
    t0 = time.perf_counter()
    res_p = gn.solve_lm(jnp.asarray(cam_mu), jnp.asarray(lmk_mu),
                        graph1, pri, cfg, n_lm_iters=15)
    jax.block_until_ready(res_p.cam)
    dt_p = time.perf_counter() - t0
    pol_cost = float(np.asarray(res_p.cost)[-1])
    print(f"polish: 15 LM iters in {dt_p:.1f}s, reproj "
          f"{float(res_p.reproj_err[-1]):.4f} px, cost {pol_cost:.2f}",
          flush=True)

    # --- cold GN baseline, in 10-iteration dispatches (each a short jit
    # call; lambda carries across them) ---
    t0 = time.perf_counter()
    cam_g, lmk_g = jnp.asarray(prob.cam_means), jnp.asarray(prob.lmk_means)
    lam0 = 1e-4
    for _ in range(4):
        res_g = gn.solve_lm(cam_g, lmk_g, graph1, pri, cfg,
                            n_lm_iters=10, lambda0=lam0)
        jax.block_until_ready(res_g.cam)
        cam_g, lmk_g = res_g.cam, res_g.lmk
        lam0 = float(res_g.lm_lambda)
    dt_g = time.perf_counter() - t0
    gn_cost = float(np.asarray(res_g.cost)[-1])
    ate = evaluation.ate_rmse(cam_mu, np.asarray(res_g.cam))
    ate_p = evaluation.ate_rmse(np.asarray(res_p.cam), np.asarray(res_g.cam))
    print(f"GN cold: 40 LM iters in {dt_g:.1f}s, reproj "
          f"{float(res_g.reproj_err[-1]):.4f} px, cost {gn_cost:.2f}",
          flush=True)
    print(f"cost ratio GBP/GN {gbp_cost / gn_cost:.6f}, "
          f"polished/GN {pol_cost / gn_cost:.6f}", flush=True)
    print(f"ATE(GBP, GN) {ate:.6f} m   ATE(polished, GN) {ate_p:.6f} m",
          flush=True)


if __name__ == "__main__":
    main()
