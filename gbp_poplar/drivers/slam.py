"""Incremental SLAM driver (equivalent of the reference `slam` binary,
ba/slam.cpp:479-1135).

    python -m gbp_poplar.drivers.slam --bal_file fr2robot2 \
        --iters_between_kfs 700

Keyframes activate one at a time; each new keyframe's prior is handed off
from the previous keyframe's converged belief, newly observed landmarks
start at --avdepth on the previous keyframe's optic axis (all on device,
core/slam.py).

Capabilities beyond the reference CLI (ba/slam.cpp:414-417):
  --devices N        map-partitioned multi-chip execution (landmark blocks
                     sharded, keyframes replicated; parallel/map_sharding.py)
  --checkpoint/--checkpoint_every/--resume
                     lossless segment-boundary checkpointing; checkpoints are
                     written after each keyframe insertion so a resume
                     continues with the next segment bit-exactly
  --save_traj        TUM trajectory export
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ..core import build_graph, init_state, slam
from ..utils import analysis, balio, checkpoint, evaluation, flags as flags_lib, priors
from . import common


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Incremental GBP SLAM")
    common.add_common_args(p)
    p.add_argument("--iters_between_kfs", type=int, default=700)
    p.add_argument("--polish", action="store_true",
                   help="final global-BA refinement: a warm-started "
                        "Levenberg-Marquardt/Schur pass on the batch MAP "
                        "objective (annealed priors — the incremental "
                        "handoff priors are replaced, as in a standard "
                        "post-SLAM bundle adjustment); the exported "
                        "trajectory uses the polished means")
    # The damped-Gauss-Newton schedule is the robust incremental default
    # (measured fr1xyz 2.6 px / 700 it/kf vs 5.9 px for the lazy reference
    # schedule, no hand-tuned per-sequence presets needed); the reference's
    # lazy schedule stays available via --schedule reference.
    p.set_defaults(schedule="gn")
    return p


class _SingleChipSlam:
    """Default execution: plain jitted steps on one device."""

    def __init__(self, graph, cfg, ibk, av_depth):
        import jax

        from ..core import gbp
        # the state flows linearly through solve_slam (each call rebinds
        # it), so donate it — halves the resident state at large maps
        # (see drivers/ba._SingleChip and scripts/memory_ledger.py)
        self.initialiser = jax.jit(lambda s: gbp.initialise(s, graph, cfg),
                                   donate_argnums=0)
        self.runner = jax.jit(lambda s: gbp.run_gbp(s, graph, cfg, ibk),
                              donate_argnums=0)
        self.inserter = jax.jit(
            lambda s, k: slam.insert_keyframe(s, graph, cfg, k, av_depth),
            donate_argnums=0)
        self.graph = graph

    def prep(self, state):
        return state

    def checkpointable(self, state):
        return state


class _MapShardedSlam:
    """Map-partitioned execution over a device mesh (landmark blocks local,
    keyframe boundary psum; parallel/map_sharding.py)."""

    def __init__(self, graph, cfg, ibk, av_depth, n_devices):
        import jax
        from jax.sharding import NamedSharding

        from ..parallel import make_map_sharded_solver, make_mesh
        from ..parallel.map_sharding import map_state_specs
        self._solver = make_map_sharded_solver(make_mesh(n_devices), cfg)
        self._graph_raw = graph
        self._ibk = ibk
        self._av_depth = av_depth
        self._mesh = self._solver.mesh
        self._sspec = jax.tree.map(
            lambda s: NamedSharding(self._mesh, s), map_state_specs())
        self.graph = None

    def prep(self, state, partitioned: bool = False):
        import jax
        from jax.sharding import NamedSharding

        from ..parallel.map_sharding import map_graph_specs
        from ..parallel.sharding import expand_specs

        if partitioned:
            # resume path: state/graph already in block-local layout
            graph = self._graph_raw
            gs = jax.tree.map(
                lambda s: NamedSharding(self._mesh, s),
                expand_specs(graph, map_graph_specs()))
            graph = jax.tree.map(jax.device_put, graph, gs)
            state = jax.tree.map(jax.device_put, state, self._sspec)
        else:
            graph, state = self._solver.prepare(self._graph_raw, state)
        self.graph = graph
        self.initialiser = lambda s: self._solver.initialise(s, graph)
        # Explicit STATIC warm: inside shard_map the iter_offset is traced,
        # and run_gbp with a traced offset and no warm runs EVERY sweep
        # through the annealing body — the accel/coarse hot path would be
        # unreachable and multi-chip SLAM would silently run a different
        # algorithm than single-chip (whose offset is a static 0).
        warm = min(self._ibk, max(0, 2 * self._solver.cfg.steps))
        self.runner = lambda s: self._solver.run(s, graph, self._ibk,
                                                 0, warm)
        self.inserter = lambda s, k: self._solver.insert_keyframe(
            s, graph, k, self._av_depth)
        return state

    def checkpointable(self, state):
        import jax

        return jax.device_get(state)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    common.init_jax()
    # Incremental solves are stabilised by drift-triggered relinearisation +
    # PSD-preserving Lambda damping (late keyframes otherwise oscillate on
    # fr2robot2); --relin_drift 0 --no_lambda_damping restores the exact
    # reference schedule.
    # Incremental insertion creates behind-camera transients; relinearising
    # them (the batch-BA default) destabilises the handoff — keep the
    # one-sided depth guard here (see config.relin_behind_camera).
    # rescue_iters: settled edges escape the one-sided guard late in each
    # segment — recaptures landmarks deadlocked behind a camera (fr1xyz
    # end-state was 2.6 px with ~3 such runaways, ~1.6 px rescued) while
    # fresh insertion transients stay protected.
    cfg, init_cfg = common.config_from_args(
        args, default_relin_drift=0.05, default_lambda_damping=True,
        relin_behind_camera=False, default_rescue_iters=300)

    problem = balio.load_bal(args.bal_file)
    # reject BEFORE any init helper (av_depth_init is pinhole-only)
    if problem.intrinsics is not None:
        print("error: incremental SLAM needs a temporally ordered TUM-"
              "variant sequence; BAL-dataset (Snavely-model) problems have "
              "no keyframe order — use the batch `ba` driver", file=sys.stderr)
        return 2
    problem = priors.apply_init_noise(problem, init_cfg,
                                      k_anchor=cfg.num_anchor_cams)
    ibk = args.iters_between_kfs
    print(f"{args.bal_file}: {problem.n_keyframes} keyframes, "
          f"{problem.n_points} landmarks, {problem.n_edges} edges "
          f"({ibk} iters/keyframe)", file=sys.stderr)

    graph = build_graph(problem, cfg)
    state = None
    start_kf = 1
    resumed_partitioned = False
    if args.resume:
        state, g2, meta = checkpoint.load_checkpoint(args.resume)
        ck_devices = meta.get("devices", 1)
        if ck_devices != args.devices:
            print(f"error: checkpoint was written with --devices "
                  f"{ck_devices}, run has --devices {args.devices}",
                  file=sys.stderr)
            return 2
        resumed_partitioned = ck_devices > 1
        # map-sharded checkpoints hold the block-local partitioned graph,
        # for which the built (global-layout) graph does not apply
        if g2 is not None:
            graph = g2
        start_kf = meta.get("kf", meta.get("step", 0) // ibk + 1)
        print(f"resumed from {args.resume} at keyframe {start_kf}",
              file=sys.stderr)
    else:
        flags = flags_lib.create_flags(problem, cfg.steps)
        state = init_state(problem, cfg, flags=flags)

    if args.devices > 1:
        solver = _MapShardedSlam(graph, cfg, ibk, args.avdepth, args.devices)
        state = solver.prep(state, partitioned=resumed_partitioned)
    else:
        solver = _SingleChipSlam(graph, cfg, ibk, args.avdepth)

    step = {"i": (start_kf - 1) * ibk, "since_save": 0}

    def progress(k, diag):
        errs = np.asarray(diag.reproj_err)
        costs = np.asarray(diag.cost)
        relins = np.asarray(diag.n_relins)
        robusts = np.asarray(diag.n_robust)
        stride = max(1, args.print_every)
        for j in range(0, errs.shape[0], stride):
            common.print_iteration(step["i"] + j, errs[j], costs[j],
                                   int(relins[j]), int(robusts[j]))
        step["i"] += errs.shape[0]
        if k + 1 < problem.n_keyframes:
            print(f"-- keyframe {k + 1} inserted --", file=sys.stderr)

    def save(path, st, k):
        checkpoint.save_checkpoint(
            path, solver.checkpointable(st), solver.graph, step=k * ibk,
            cfg=cfg)
        # segment-level metadata: the state includes keyframe k+1's insertion
        _amend_meta(path, kf=k + 1, devices=args.devices)

    def segment_callback(k, st):
        if args.v:
            # verbose belief stream at segment cadence (reference --v
            # prints every iteration, ba/slam.cpp:1060-1101)
            v_cam, _ = analysis.belief_means(solver.checkpointable(st))
            np.set_printoptions(precision=5, suppress=True)
            print(f"beliefs (cam means) after keyframe {k}:\n{v_cam}",
                  flush=True)
        if not (args.checkpoint and args.checkpoint_every):
            return
        step["since_save"] += ibk
        if step["since_save"] >= args.checkpoint_every:
            step["since_save"] = 0
            save(args.checkpoint, st, k)

    t0 = time.perf_counter()
    result = slam.solve_slam(
        state, graph, cfg,
        n_keyframes=problem.n_keyframes,
        iters_between_kfs=ibk,
        av_depth=args.avdepth,
        progress=progress,
        start_kf=start_kf,
        runner=solver.runner,
        inserter=solver.inserter,
        initialiser=solver.initialiser,
        segment_callback=segment_callback)
    dt = time.perf_counter() - t0
    total_iters = (problem.n_keyframes - start_kf) * ibk
    print(f"total {dt:.3f}s, {total_iters / dt:.1f} sweeps/s",
          file=sys.stderr)

    final_state = solver.checkpointable(result.state)
    cam_mu, lmk_mu = analysis.belief_means(final_state)
    # The map-partitioned landmark axis IS the global landmark order plus
    # trailing dummy padding (partition_by_landmark: block s = global ids
    # [s*l_blk, (s+1)*l_blk)), so slicing recovers the problem's layout —
    # polish and the host oracle run identically at any --devices. This is
    # the analogue of the reference's full-state READ round trips
    # (ba/slam.cpp:913-948).
    lmk_mu = lmk_mu[: problem.n_points]
    if args.polish:
        # same warm-started LM/Schur machinery as the ba driver, against
        # the BATCH annealed-prior objective (the GN baseline's own): a
        # standard post-SLAM global bundle adjustment. The incremental
        # handoff priors are full-matrix and weak; the data term dominates.
        import jax.numpy as jnp

        from ..core import gauss_newton as gn
        from .ba import _polish_problem
        res = gn.solve_lm(
            jnp.asarray(cam_mu), jnp.asarray(lmk_mu),
            *_polish_problem(problem, cfg), cfg, n_lm_iters=15)
        pol_cam = np.asarray(res.cam)
        moved = float(np.linalg.norm(pol_cam[:, :3] - cam_mu[:, :3],
                                     axis=1).max())
        cam_mu, lmk_mu = pol_cam, np.asarray(res.lmk)
        print(f"polish: reproj {float(res.reproj_err[-1]):.5f} px, "
              f"max camera movement {moved:.5f} m", file=sys.stderr)
    # independent host-side oracle (pure NumPy; ba/util.cpp:74-144;
    # --bad_assoc = the reference's bad_associations skip list)
    bad = common.parse_bad_assoc(args.bad_assoc)
    o_err, o_cost = evaluation.numpy_reprojection_error(
        cam_mu, lmk_mu, problem, bad_associations=bad or None)
    excl = f"  ({len(bad)} bad associations excluded)" if bad else ""
    print(f"host oracle: reproj_err {o_err:.5f} px  cost {o_cost:.4f}{excl}",
          file=sys.stderr)
    if args.v:
        np.set_printoptions(precision=5, suppress=True)
        print("cam means:\n", cam_mu)
    if args.save_traj:
        evaluation.export_tum(args.save_traj, cam_mu)
        print(f"trajectory written to {args.save_traj}", file=sys.stderr)
    if args.save_means:
        np.savez(args.save_means, cam=cam_mu, lmk=lmk_mu)
    if args.checkpoint:
        save(args.checkpoint, result.state, problem.n_keyframes - 1)
        print(f"checkpoint written to {args.checkpoint}", file=sys.stderr)
    if result.reproj_err.shape[0]:
        final_err = result.reproj_err[-1, -10:].mean()
        print(f"final reprojection error: {final_err:.5f} px",
              file=sys.stderr)
    return 0


def _amend_meta(path: str, **extra) -> None:
    """Add driver-level keys to a checkpoint's metadata."""
    import json

    data = dict(np.load(path))
    meta = json.loads(bytes(data[checkpoint._META_KEY]).decode())
    meta.update(extra)
    data[checkpoint._META_KEY] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8)
    tmp = path + ".tmp"
    np.savez(tmp, **data)
    import os

    os.replace(tmp if tmp.endswith(".npz") else tmp + ".npz", path)


if __name__ == "__main__":
    sys.exit(main())
