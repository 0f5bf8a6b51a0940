"""Where a sweep's time goes on the GPU, per layer, at published shapes.

    python scripts/profile_sweep.py [--shapes fr1xyz,ladybug,venice]
                                    [--k 50] [--out_dir chiprun_out/profile]

For each shape (seeded synthetic at the published size) it prints:

- ``run_gbp`` (the production chunked loop, accel steps live) and the raw
  ``gbp_sweep`` chain, host clock around ``block_until_ready``, min of 3;
- ``edge_math`` alone: the number of kernels XLA emits for it, its time,
  and the one-pass floor (bytes of the per-edge state read and written
  once, over the card's HBM bandwidth);
- the belief gathers and ``segment_sum`` reductions alone;
- a device-trace breakdown of the raw chain by kernel name (per sweep),
  and the device's busy share of the traced window.

Device times come from a ``jax.profiler`` trace read with
``jax.profiler.ProfileData``; everything else is host clock. Run it on the
card: a CPU run says nothing about the GPU.
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from gbp_poplar.config import GBPConfig
from gbp_poplar.core import build_graph, gbp, init_state
from gbp_poplar.utils import balio

SHAPES = {
    # (keyframes, landmarks, observations per landmark)
    "fr1xyz": (42, 2194, 6),          # TUM fr1xyz size
    "ladybug": (1723, 156_000, 7),    # BAL Ladybug-1723
    "venice": (1778, 994_000, 5),     # BAL Venice-1778 density
}
HBM_BYTES_PER_S = 3.35e12             # H100 SXM data sheet


def _timed(fn, *args, reps=3, calls=1):
    jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = None
        for _ in range(calls):
            out = fn(*args)
        jax.block_until_ready(out)
        best = min(best, (time.perf_counter() - t0) / calls)
    return best


def _n_kernels(compiled) -> int:
    """Kernel launches in the entry computation of a compiled program."""
    text = compiled.as_text()
    entry = text[text.find("ENTRY"):]
    entry = entry[:entry.find("\n}")]
    return sum(1 for ln in entry.splitlines()
               if " fusion(" in ln or " custom-call(" in ln
               or " scatter(" in ln or " gather(" in ln)


def _device_breakdown(trace_dir: str, k: int):
    """(busy share of the window, {kernel name: us per sweep}) from the
    newest xplane under ``trace_dir``."""
    from jax.profiler import ProfileData

    paths = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                             recursive=True), key=os.path.getmtime)
    if not paths:
        return None, {}
    pd = ProfileData.from_file(paths[-1])
    by_name = collections.Counter()
    intervals = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            # kernels run on the stream lines; "XLA Ops"/"XLA Modules"
            # lines repeat them at other granularities
            if "Stream" not in line.name:
                continue
            for ev in line.events:
                by_name[ev.name] += ev.duration_ns
                intervals.append((ev.start_ns, ev.end_ns))
    if not intervals:
        return None, {}
    intervals.sort()
    busy, cur_s, cur_e = 0.0, *intervals[0]
    for s, e in intervals[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = intervals[-1][1] - intervals[0][0]
    per_sweep = {n: d / 1e3 / k for n, d in by_name.most_common()}
    return busy / max(window, 1), per_sweep


def profile_shape(name: str, k: int, out_dir: str) -> dict:
    c, l, o = SHAPES[name]
    cfg = GBPConfig()
    t0 = time.perf_counter()
    prob = balio.synthetic_problem_large(c, l, o, seed=0)
    graph = build_graph(prob, cfg)
    state = jax.jit(lambda s: gbp.initialise(s, graph, cfg))(
        init_state(prob, cfg))
    jax.block_until_ready(state)
    res = {"shape": name, "edges": int(graph.n_edges),
           "setup_s": time.perf_counter() - t0}

    run = jax.jit(lambda s: gbp.run_gbp(
        s, graph, cfg, k, with_diagnostics=False,
        iter_offset=cfg.accel_start)[0])
    res["run_gbp_ms_per_sweep"] = _timed(run, state) * 1e3 / k

    @jax.jit
    def chain(s):
        return jax.lax.scan(lambda x, _: (gbp.gbp_sweep(x, graph, cfg), None),
                            s, None, length=k)[0]

    res["chain_ms_per_sweep"] = _timed(chain, state) * 1e3 / k
    traced_state = state
    state = chain(state)      # per-layer timings on a mid-solve state

    # --- belief gathers alone ---
    cam_src = jnp.concatenate([state.cam_eta, state.cam_lam])
    lmk_src = jnp.concatenate([state.lmk_eta, state.lmk_lam])
    take = jax.jit(lambda src, i: jnp.take(src, i, axis=1))
    res["cam_gather_ms"] = _timed(take, cam_src, graph.cam_idx,
                                  calls=10) * 1e3
    res["lmk_gather_ms"] = _timed(take, lmk_src, graph.lmk_idx,
                                  calls=10) * 1e3

    # --- edge_math alone ---
    bc = take(cam_src, graph.cam_idx)
    bl = take(lmk_src, graph.lmk_idx)
    inputs = (bc, bl, graph.meas, graph.meas_var,
              state.f_eta_c, state.f_eta_l, state.f_lam_cc,
              state.f_lam_cl, state.f_lam_ll,
              state.msg_c_eta, state.msg_c_lam,
              state.msg_l_eta, state.msg_l_lam,
              state.damping, state.damping_count, state.mu, state.lin_mu,
              state.robust, state.active)
    em = jax.jit(lambda *a: gbp.edge_math(*a, k=graph.k, cfg=cfg,
                                         intr=graph.intr))
    compiled = em.lower(*inputs).compile()
    outs = compiled(*inputs)
    n_bytes = (sum(x.nbytes for x in inputs)
               + sum(x.nbytes for x in jax.tree.leaves(outs)))
    res["edge_math_kernels"] = _n_kernels(compiled)
    res["edge_math_bytes_once"] = int(n_bytes)
    res["edge_math_floor_ms"] = n_bytes / HBM_BYTES_PER_S * 1e3
    res["edge_math_ms"] = _timed(compiled, *inputs, calls=10) * 1e3
    try:
        ca = compiled.cost_analysis()
        ca = ca[0] if isinstance(ca, (list, tuple)) else ca
        res["edge_math_xla_bytes_accessed"] = float(ca.get("bytes accessed",
                                                           -1))
    except Exception as exc:   # cost analysis is advisory only
        res["edge_math_xla_bytes_accessed"] = repr(exc)

    # --- belief reductions alone ---
    lmk_planes = jnp.concatenate([state.msg_l_eta, state.msg_l_lam])
    cam_planes = jnp.concatenate([state.msg_c_eta, state.msg_c_lam])
    nl, nc = graph.n_points, graph.n_keyframes
    lred = jax.jit(lambda p, i: jax.ops.segment_sum(p.T, i,
                                                    num_segments=nl).T)
    res["lmk_segment_sum_ms"] = _timed(lred, lmk_planes, graph.lmk_idx,
                                       calls=10) * 1e3
    cred = jax.jit(lambda p, i: jax.ops.segment_sum(p.T, i,
                                                    num_segments=nc).T)
    res["cam_segment_sum_ms"] = _timed(cred, cam_planes, graph.cam_idx,
                                       calls=10) * 1e3

    # --- device trace of the raw chain ---
    tdir = os.path.join(out_dir, f"trace_{name}")
    with jax.profiler.trace(tdir):
        jax.block_until_ready(chain(traced_state))
    busy, per_sweep = _device_breakdown(tdir, k)
    res["trace_busy_share"] = busy
    res["trace_device_us_per_sweep"] = sum(per_sweep.values())
    res["trace_top_kernels_us_per_sweep"] = dict(list(per_sweep.items())[:25])
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", default="fr1xyz,ladybug,venice")
    ap.add_argument("--k", type=int, default=50)
    ap.add_argument("--out_dir", default=os.path.join("chiprun_out",
                                                       "profile"))
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    except FileNotFoundError:
        card = "no nvidia-smi"
    d = jax.devices()[0]
    print(f"card: {card} | jax {jax.__version__} "
          f"{d.platform} {d.device_kind} x{len(jax.devices())}", flush=True)
    results = []
    for name in args.shapes.split(","):
        res = profile_shape(name, args.k, args.out_dir)
        results.append(res)
        top = res.pop("trace_top_kernels_us_per_sweep")
        print(json.dumps(res), flush=True)
        for kname, us in list(top.items())[:12]:
            print(f"    {us:10.2f} us/sweep  {kname[:100]}", flush=True)
        res["trace_top_kernels_us_per_sweep"] = top
    with open(os.path.join(args.out_dir, "profile.json"), "w") as f:
        json.dump({"card": card, "results": results}, f,
                  indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
