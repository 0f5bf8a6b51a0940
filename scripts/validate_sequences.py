"""Full validation: GBP + Gauss-Newton on all TUM sequences + SLAM mode.

Produces the accuracy/agreement table recorded in docs/VALIDATION.md.

    python scripts/validate_sequences.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import numpy as np

from gbp_poplar.config import GBPConfig
from gbp_poplar.core import build_graph, init_state, gbp, slam
from gbp_poplar.core import gauss_newton as gn
from gbp_poplar.utils import analysis, balio, evaluation, flags as flags_lib


def run_sequence(seq: str, n_iters: int = 1000):
    problem = balio.load_bal(seq)
    cfg = GBPConfig()

    # --- batch GBP ---
    graph = build_graph(problem, cfg)
    state = init_state(problem, cfg)
    t0 = time.perf_counter()
    final, diag = jax.jit(
        lambda s: gbp.solve(s, graph, cfg, n_iters=n_iters))(state)
    jax.block_until_ready(final)
    dt = time.perf_counter() - t0
    errs = np.asarray(diag.reproj_err)
    gbp_err = float(errs[-10:].mean())
    cam_mu, _ = analysis.belief_means(final)

    # --- Gauss-Newton / iterative Schur baseline ---
    res = gn.solve_problem(problem, cfg, n_lm_iters=40, cg_iters=80)
    gn_err = float(np.asarray(res.reproj_err)[-1])
    ate_vs_gn = evaluation.ate_rmse(cam_mu, np.asarray(res.cam))

    # --- incremental SLAM ---
    flags = flags_lib.create_flags(problem, cfg.steps)
    state_i = init_state(problem, cfg, flags=flags)
    import dataclasses
    slam_cfg = dataclasses.replace(cfg, relin_drift_threshold=0.05,
                                   lambda_damping=True)
    graph_s = build_graph(problem, slam_cfg)
    result = slam.solve_slam(state_i, graph_s, slam_cfg,
                             iters_between_kfs=300, av_depth=1.0)
    slam_err = float(result.reproj_err[-1, -10:].mean())
    cam_mu_slam, _ = analysis.belief_means(result.state)
    ate_slam_vs_gn = evaluation.ate_rmse(cam_mu_slam, np.asarray(res.cam))

    print(f"{seq:10s} | GBP {gbp_err:7.3f}px ({n_iters} it, {dt:5.1f}s) | "
          f"GN {gn_err:7.3f}px | ATE(GBP,GN) {ate_vs_gn:.5f} m | "
          f"SLAM {slam_err:7.3f}px | ATE(SLAM,GN) {ate_slam_vs_gn:.5f} m",
          flush=True)
    return dict(seq=seq, gbp_err=gbp_err, gn_err=gn_err, ate=ate_vs_gn,
                slam_err=slam_err, ate_slam=ate_slam_vs_gn)


def main():
    for seq in ["fr2robot2", "fr1xyz", "fr1desk"]:
        run_sequence(seq)


if __name__ == "__main__":
    main()
