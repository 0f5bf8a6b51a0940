"""Multi-device scaling efficiency of the sharded GBP solver.

Measures sweeps/sec at 1, 2, 4, ... devices over whatever mesh is
available. On a multi-GPU host this reports the scaling efficiency
(BASELINE target: >= 0.7 at N >= 2); on a CPU host it exercises the same
SPMD program over a virtual mesh (set
XLA_FLAGS=--xla_force_host_platform_device_count=8 GBP_PLATFORM=cpu), which
validates the collective structure but NOT hardware speed.

    python scripts/bench_scaling.py [sequence|ladybug] [n_sweeps]
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

if os.environ.get("GBP_PLATFORM") == "cpu":
    import jax
    jax.config.update("jax_platforms", "cpu")

import jax
import numpy as np

from gbp_poplar.config import GBPConfig
from gbp_poplar.core import build_graph, init_state
from gbp_poplar.parallel import (
    make_map_sharded_solver, make_mesh, make_sharded_solver,
)
from gbp_poplar.utils import balio

MODE = os.environ.get("GBP_SHARD_MODE", "edges")   # edges | map


def bench_n(problem, cfg, n_devices, n_sweeps):
    mesh = make_mesh(n_devices)
    solver = (make_map_sharded_solver(mesh, cfg) if MODE == "map"
              else make_sharded_solver(mesh, cfg))
    graph, state = solver.prepare(build_graph(problem, cfg),
                                  init_state(problem, cfg))
    state = solver.initialise(state, graph)
    jax.block_until_ready(state)
    out, _ = solver.run(state, graph, n_sweeps, 0)
    jax.block_until_ready(out)
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        out, _ = solver.run(state, graph, n_sweeps, 0)
        jax.block_until_ready(out)
        ts.append(time.perf_counter() - t0)
    return n_sweeps / min(ts)


def main():
    name = sys.argv[1] if len(sys.argv) > 1 else "fr1xyz"
    n_sweeps = int(sys.argv[2]) if len(sys.argv) > 2 else 100
    if name == "ladybug":
        problem = balio.synthetic_problem_large(1723, 156000, 7)
    else:
        problem = balio.load_bal(name)
    cfg = GBPConfig()
    n_avail = len(jax.devices())
    print(f"{name}: E={problem.n_edges}, devices available: {n_avail} "
          f"({jax.devices()[0].platform}), mode={MODE}")
    base = None
    n = 1
    while n <= n_avail:
        sps = bench_n(problem, cfg, n, n_sweeps)
        if base is None:
            base = sps
        eff = sps / (base * n)
        print(f"  {n:2d} device(s): {sps:10.1f} sweeps/s  "
              f"(scaling efficiency {eff:5.2f})", flush=True)
        n *= 2


if __name__ == "__main__":
    main()
