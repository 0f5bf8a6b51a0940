"""Exact per-edge elementwise op count of the sweep body.

Traces ``core.gbp.edge_math`` (the single source of truth for the sweep)
with ``jax.make_jaxpr`` and tallies every elementwise primitive, weighted
by its output element count per edge, with a breakdown by primitive, so
kernel work can be targeted and "done" quantified against a roofline (the
reference's equivalent per-tile work is fixed by ba/gbp_codelets.cpp).
Transcendental-class ops (sqrt, rsqrt, sin, cos, div, exp, log) are
tallied separately and charged at TRANS_COST plain ops each.

Usage: python scripts/count_edge_ops.py [--snavely] [--detail]
"""

from __future__ import annotations

import argparse
import os
import sys
from collections import Counter

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
jax.config.update("jax_platforms", "cpu")

from gbp_poplar.config import GBPConfig  # noqa: E402
from gbp_poplar.core import gbp  # noqa: E402

# elementwise primitives counted as 1 op per output element
_ONE = {
    "add", "sub", "mul", "neg", "max", "min", "and", "or", "not", "xor",
    "select_n", "eq", "ne", "ge", "gt", "le", "lt", "abs", "sign",
    "convert_element_type", "integer_pow", "is_finite",
}
# transcendental-class (slower pipes); charged at TRANS_COST each
_TRANS = {"sqrt", "rsqrt", "sin", "cos", "div", "exp", "log", "tanh",
          "atan2", "pow"}
# free at trace/layout level (views, packing, broadcasts of constants)
_FREE = {"concatenate", "slice", "reshape", "broadcast_in_dim", "squeeze",
         "reduce_max", "reduce_min", "transpose", "iota", "copy",
         "stop_gradient", "dynamic_slice", "rev"}

TRANS_COST = 4


def tally(jaxpr, n_edges: int) -> tuple[Counter, Counter]:
    """(one-class ops/edge, transcendental ops/edge) by primitive name."""
    ones: Counter = Counter()
    trans: Counter = Counter()

    from jax.extend import core as jex_core

    # containers: walk their bodies, never count the call itself
    _CONTAINERS = {"jit", "pjit", "closed_call", "custom_jvp_call",
                   "custom_vjp_call", "remat", "checkpoint", "scan",
                   "while", "cond"}

    def walk(jx):
        for eqn in jx.eqns:
            has_sub = False
            for v in eqn.params.values():
                if isinstance(v, jex_core.ClosedJaxpr):
                    walk(v.jaxpr)
                    has_sub = True
                elif isinstance(v, jex_core.Jaxpr):
                    walk(v)
                    has_sub = True
            name = eqn.primitive.name
            if (name in _FREE or name in _CONTAINERS or has_sub
                    or not eqn.outvars):
                continue
            n_elem = sum(
                int(v.aval.size) for v in eqn.outvars
                if hasattr(v.aval, "size"))
            per_edge = n_elem / n_edges
            if name in _TRANS:
                trans[name] += per_edge
            elif name in _ONE:
                ones[name] += per_edge
            elif name in ("integer_pow",):
                ones[name] += per_edge
            else:
                # unknown primitive: surface it loudly rather than skew
                ones[f"?{name}"] += per_edge
        return ones, trans

    return walk(jaxpr)


# edge_math's per-edge operands in order, with their row counts
_EDGE_MATH_ARGS = (
    ("bc", 27), ("bl", 9), ("meas", 2), ("meas_var", 1),
    ("f_eta_c", 6), ("f_eta_l", 3), ("f_lam_cc", 21), ("f_lam_cl", 18),
    ("f_lam_ll", 6), ("msg_c_eta", 6), ("msg_c_lam", 21), ("msg_l_eta", 3),
    ("msg_l_lam", 6), ("damping", 1), ("damping_count", 1), ("mu", 9),
    ("lin_mu", 9), ("robust", 1), ("active", 1),
)


def edge_math_args(e: int, snavely: bool):
    f32 = jnp.float32
    ints = {"damping_count": jnp.int32, "robust": jnp.bool_,
            "active": jnp.int32}
    args = [jnp.zeros((n, e), ints.get(name, f32))
            for name, n in _EDGE_MATH_ARGS]
    k = jnp.eye(3, dtype=f32)
    intr = jnp.zeros((3, e), f32) if snavely else None
    return args, k, intr


def count(cfg: GBPConfig, e: int, snavely: bool):
    args, k, intr = edge_math_args(e, snavely)
    jx = jax.make_jaxpr(
        lambda *vals: gbp.edge_math(*vals, k, cfg, intr=intr))(*args)
    return tally(jx.jaxpr, e)


def report(label: str, ones: Counter, trans: Counter):
    n1 = sum(ones.values())
    nt = sum(trans.values())
    eff = n1 + TRANS_COST * nt
    print(f"{label:34s} {n1:7.0f} one-class + {nt:5.1f} trans "
          f"= {eff:7.0f} eff ops/edge")
    return eff


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--snavely", action="store_true")
    ap.add_argument("--detail", action="store_true",
                    help="per-primitive breakdown")
    args = ap.parse_args()

    cfg = GBPConfig()
    ones, trans = count(cfg, 1024, args.snavely)
    report("edge_math", ones, trans)
    if args.detail:
        for name, v in sorted(ones.items(), key=lambda kv: -kv[1]):
            print(f"    {name:24s} {v:8.1f}")
        for name, v in sorted(trans.items(), key=lambda kv: -kv[1]):
            print(f"    [trans] {name:16s} {v:8.1f}")

if __name__ == "__main__":
    main()
