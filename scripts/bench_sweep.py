"""Canonical sweep-time measurement (chained scan, K=2000, min of 3).

    python scripts/bench_sweep.py [fr1xyz|fr2robot2|fr1desk|ladybug|
                                   ladybug_snavely|scale] ...

K is large so the per-call launch and host overhead is noise next to the
device time. For per-kernel device time, use scripts/profile_sweep.py.

``scale`` sweeps the problem-size ladder (TUM -> Ladybug-1723 shape) with
a convergence sanity check per size — the former scripts/bench_scale.py,
folded in here so there is one timing harness.
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import numpy as np

from gbp_poplar.config import GBPConfig
from gbp_poplar.core import build_graph, init_state, gbp
from gbp_poplar.utils import balio


def bench(prob, name, cfg, K, sanity=False, production=False):
    """``production`` times run_gbp (the chunked hot loop with its accel
    boundaries) instead of the raw gbp_sweep chain."""
    graph = build_graph(prob, cfg)
    s = jax.jit(lambda st: gbp.initialise(st, graph, cfg))(
        init_state(prob, cfg))
    jax.block_until_ready(s)

    if production:
        run = jax.jit(lambda x: gbp.run_gbp(
            x, graph, cfg, K, with_diagnostics=False,
            iter_offset=2 * cfg.steps)[0])
    else:
        @jax.jit
        def run(x):
            return jax.lax.scan(
                lambda c, _: (gbp.gbp_sweep(c, graph, cfg), None),
                x, None, length=K)[0]

    r = run(s)
    jax.block_until_ready(r)
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(run(s))
        ts.append(time.perf_counter() - t0)
    line = (f"{name:20s} E={graph.n_edges:8d} "
            f"{min(ts)/K*1e3:8.3f} ms/sweep ({K/min(ts):9.1f} sweeps/s)")
    if sanity:
        _, diag = jax.jit(
            lambda st: gbp.solve(st, graph, cfg, n_iters=60))(
                init_state(prob, cfg))
        errs = np.asarray(diag.reproj_err)
        line += f"  err {errs[0]:8.2f} -> {errs[-1]:6.2f}"
    print(line, flush=True)


def main():
    args = sys.argv[1:]
    production = "--production" in args
    names = [a for a in args if a != "--production"] or ["fr1xyz"]
    cfg = GBPConfig()
    for n in names:
        if n == "ladybug":
            bench(balio.synthetic_problem_large(1723, 156000, 7), n, cfg,
                  100, production=production)
        elif n == "ladybug_snavely":
            bench(balio.synthetic_problem_large(1723, 156000, 7,
                                                snavely=True), n, cfg, 100)
        elif n == "venice":
            bench(balio.synthetic_problem_large(1778, 994000, 5), n, cfg,
                  50, production=production)
        elif n == "scale":
            for seq in ("fr2robot2", "fr1xyz", "fr1desk"):
                try:
                    bench(balio.load_bal(seq), seq, cfg, 2000, sanity=True)
                except FileNotFoundError:
                    print(f"{seq}: not found, skipping")
            for (c, l, o, name) in [
                (200, 20_000, 7, "synthetic-140k"),
                (800, 60_000, 7, "synthetic-420k"),
                (1723, 156_000, 7, "ladybug-scale-1.1M"),
            ]:
                bench(balio.synthetic_problem_large(c, l, o), name, cfg,
                      100, sanity=True)
        else:
            bench(balio.load_bal(n), n, cfg, 2000, production=production)


if __name__ == "__main__":
    main()
