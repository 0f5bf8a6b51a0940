"""Sweep solver-schedule variants on TUM sequences and report convergence.

One parameterised harness (replaces the round-1 tune_schedule{,2,3}.py
experiment scripts):

    python scripts/tune_schedule.py --seq fr1desk --n_iters 1000 \
        --set reference \
        --set gn:relin_every_iter=1,lambda_damping=1,eta_damping=0.7 \
        --set drift:relin_drift_threshold=0.05

Each --set is ``name[:key=val,key=val...]`` of GBPConfig overrides (ints,
floats and 0/1 bools are parsed; everything else stays a string).
"""

import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import numpy as np

from gbp_poplar.config import GBPConfig
from gbp_poplar.core import build_graph, gbp, init_state
from gbp_poplar.utils import balio


def parse_variant(spec: str) -> tuple[str, GBPConfig]:
    name, _, kvs = spec.partition(":")
    fields = {f.name: f.type for f in dataclasses.fields(GBPConfig)}
    overrides = {}
    for kv in filter(None, kvs.split(",")):
        k, _, v = kv.partition("=")
        if k not in fields:
            raise SystemExit(f"unknown GBPConfig field: {k}")
        cur = getattr(GBPConfig(), k)
        if isinstance(cur, bool):
            overrides[k] = v not in ("0", "false", "False")
        elif isinstance(cur, int):
            overrides[k] = int(v)
        elif isinstance(cur, float):
            overrides[k] = float(v)
        else:
            overrides[k] = v
    return name, GBPConfig(**overrides)


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--seq", action="append", default=None)
    p.add_argument("--n_iters", type=int, default=1000)
    p.add_argument("--set", dest="variants", action="append", default=None,
                   metavar="NAME[:k=v,...]")
    args = p.parse_args()
    seqs = args.seq or ["fr2robot2", "fr1xyz", "fr1desk"]
    variants = [parse_variant(s) for s in (args.variants or ["reference"])]
    n_iters = args.n_iters

    for seq in seqs:
        prob = balio.load_bal(seq)
        print(f"{seq}: {prob.n_keyframes} kf / {prob.n_points} lmk / "
              f"{prob.n_edges} edges", flush=True)
        for name, cfg in variants:
            graph = build_graph(prob, cfg)
            state = init_state(prob, cfg)
            run = jax.jit(
                lambda s, g=graph, c=cfg: gbp.solve(s, g, c, n_iters=n_iters))
            t0 = time.time()
            final, diag = run(state)
            jax.block_until_ready(final)
            dt = time.time() - t0
            errs = np.asarray(diag.reproj_err)
            idx = [i for i in (9, 50, 100, 200, 500, n_iters - 1)
                   if i < n_iters]
            print(f"  {name:28s} t={dt:6.1f}s  "
                  + "  ".join(f"e[{i}]={errs[i]:.3f}" for i in idx)
                  + f"  min={np.nanmin(errs):.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
