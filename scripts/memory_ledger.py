"""Single-chip HBM footprint ledger for the large-scale solver.

    python scripts/memory_ledger.py [edges_in_millions] [--production]

Enumerates every live buffer at a given synthetic-Venice-density shape
(5 obs/landmark) and answers, buffer by buffer, where the single-card
capacity wall is, against the device's own limit
(``device.memory_stats()["bytes_limit"]``):

 1. the STATE pytree (per-edge planes + beliefs + priors) by field,
 2. the GRAPH pytree (static planes and indices) by field,
 3. the compiled hot program's own accounting (XLA memory_analysis of the
    jitted run_gbp step: argument/output/temp/peak bytes) — temps cover
    the intermediates that the pytrees don't show,
 4. the device's limit (``memory_stats()["bytes_limit"]``).

The per-field tallies are exact (shape x dtype of the arrays actually
resident); the XLA analysis is the compiler's own allocation plan for the
solve step, so build-time temporaries that survive into the solve would
show up as unexplained argument/temp bytes. This is the reference's
tile-budget arithmetic (ba/ba.cpp:616-636) done the XLA way.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import numpy as np

from gbp_poplar.config import GBPConfig
from gbp_poplar.core import build_graph, init_state, gbp
from gbp_poplar.utils import balio


def _leaf_bytes(nt) -> list:
    rows = []
    for f in type(nt)._fields:
        v = getattr(nt, f)
        if v is not None:
            rows.append((f, f"{v.dtype}{list(v.shape)}",
                         int(np.prod(v.shape)) * v.dtype.itemsize))
    return rows


def _print_rows(title, rows):
    total = sum(r[2] for r in rows)
    print(f"\n== {title}: {total / 2**30:.3f} GiB ==")
    for f, desc, n in sorted(rows, key=lambda r: -r[2]):
        if n >= 2**20:
            print(f"  {n / 2**20:10.1f} MiB  {f:16s} {desc}")
    small = sum(n for _, _, n in rows if n < 2**20)
    print(f"  {small / 2**20:10.1f} MiB  (everything under 1 MiB)")
    return total


def main():
    em = float(sys.argv[1]) if len(sys.argv) > 1 else 4.97
    production = "--production" in sys.argv
    obs = 5
    l = int(em * 1e6 / obs)
    c = max(int(l / 560), 2)            # venice-like kf:lmk ratio
    prob = balio.synthetic_problem_large(c, l, obs)
    cfg = GBPConfig()
    graph = build_graph(prob, cfg)
    state = init_state(prob, cfg)
    e = graph.n_edges
    print(f"shape: {c} kf / {l} lmk / {obs} obs = {e} edges")

    g_total = _print_rows("GBPGraph (static)", _leaf_bytes(graph))
    s_total = _print_rows("GBPState (carried)", _leaf_bytes(state))
    print(f"\npytrees total: {(g_total + s_total) / 2**30:.3f} GiB "
          f"({(g_total + s_total) / e:.1f} B/edge)")

    # donate the state exactly as the drivers do (drivers/ba._SingleChip):
    # the output state writes into the input buffers, so the plan below is
    # the driver-realistic one (without donation arguments and outputs
    # are both held)
    if production:
        run = jax.jit(lambda s: gbp.run_gbp(
            s, graph, cfg, 8, with_diagnostics=False,
            iter_offset=cfg.accel_start)[0], donate_argnums=0)
    else:
        run = jax.jit(lambda s: jax.lax.scan(
            lambda c_, _: (gbp.gbp_sweep(c_, graph, cfg), None),
            s, None, length=8)[0], donate_argnums=0)
    lowered = run.lower(state)
    compiled = lowered.compile()
    ma = compiled.memory_analysis()
    print(f"\n== XLA memory_analysis of the "
          f"{'run_gbp' if production else 'sweep-chain'} step ==")
    for attr in ("argument_size_in_bytes", "output_size_in_bytes",
                 "temp_size_in_bytes", "alias_size_in_bytes",
                 "generated_code_size_in_bytes",
                 "peak_memory_in_bytes"):
        v = getattr(ma, attr, None)
        if v is not None:
            print(f"  {attr:32s} {v / 2**30:9.3f} GiB")
    # arguments alias outputs for the carried state (donated in the scan);
    # peak ~= args + temps when aliasing holds
    limit = (jax.devices()[0].memory_stats() or {}).get("bytes_limit")
    print(f"  {'device bytes_limit':32s} "
          + (f"{limit / 2**30:9.3f} GiB" if limit else "not reported"))
    print("\n(initialise must be a separate dispatch before this step; "
          "its build temporaries do not survive into the solve "
          "allocation plan above)")


if __name__ == "__main__":
    main()
