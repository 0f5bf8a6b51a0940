"""Batch bundle-adjustment driver (equivalent of the reference `ba`
binary, ba/ba.cpp:479-1085).

    python -m gbp_poplar.drivers.ba --bal_file fr1xyz --n_iters 1500

Unlike the reference — which streams every belief to the host every
iteration (ba/ba.cpp:1009) — the solve runs on device in jitted chunks of
`--print_every` iterations and only the per-iteration scalar telemetry is
fetched.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ..config import GBPConfig
from ..core import build_graph, gbp, init_state
from ..utils import analysis, balio, checkpoint, evaluation, priors
from . import common


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="GBP bundle adjustment (batch)")
    common.add_common_args(p)
    p.add_argument("--n_iters", type=int, default=1500)
    p.add_argument("--gn_check", action="store_true",
                   help="also run the Gauss-Newton/Schur baseline and "
                        "report agreement")
    # Polish is ON by default: GBP converges to GN-parity reprojection
    # error on every sequence, but the fr1 Huber objectives are multi-basin
    # along near-gauge modes and plain message passing can land cm-level
    # ATE from the MAP at the reference's 1500-iteration budget
    # (docs/VALIDATION.md "Remaining ATE gap"). The 15 warm-started LM
    # iterations cost ~1% of the solve and land on the exact MAP
    # (0.03-1.4 mm vs GN on every TUM sequence) — safe defaults beat a
    # footnote. --no_polish restores raw message-passing output.
    p.add_argument("--polish", dest="polish", action="store_true",
                   default=True,
                   help="refine the GBP solution to the exact MAP with a "
                        "warm-started Levenberg-Marquardt/Schur pass "
                        "(the exported trajectory uses the polished means; "
                        "the checkpoint keeps the GBP state). DEFAULT ON; "
                        "disable with --no_polish")
    p.add_argument("--no_polish", dest="polish", action="store_false",
                   help="export the raw GBP means without the LM polish")
    p.add_argument("--refine_intrinsics", action="store_true",
                   help="Snavely/BAL problems only: between execution "
                        "chunks, refit every camera's (f, k1, k2) with a "
                        "damped per-camera Gauss-Newton step, accepted only "
                        "when the MAP objective decreases (block-coordinate "
                        "descent; core/intrinsics.py)")
    return p


def main(argv=None) -> int:
    t_start = time.perf_counter()
    args = build_parser().parse_args(argv)
    common.init_jax()
    import jax

    # coarse_groups=16: per-group rigid coarse-space correction at accel
    # chunk boundaries. Collapses the slow near-gauge modes that message
    # passing relaxes diffusively — fr1xyz GBP-GN ATE 63mm -> 29mm at 1500
    # iters (<1mm at 3000), MAP cost ratio 1.109 -> 1.004, fr2robot2
    # unchanged at <1mm (docs/VALIDATION.md). Off in slam (insertion
    # transients) and in the raw-library default (bench purity).
    cfg, init_cfg = common.config_from_args(args, default_coarse_groups=16)

    problem = balio.load_bal(args.bal_file)
    if cfg.coarse_groups > problem.n_keyframes:
        import dataclasses
        cfg = dataclasses.replace(cfg, coarse_groups=problem.n_keyframes)
    problem = priors.apply_init_noise(problem, init_cfg,
                                      k_anchor=cfg.num_anchor_cams)
    print(f"{args.bal_file}: {problem.n_keyframes} keyframes, "
          f"{problem.n_points} landmarks, {problem.n_edges} edges",
          file=sys.stderr)

    graph = build_graph(problem, cfg)
    if args.resume:
        state, g2, meta = checkpoint.load_checkpoint(args.resume)
        if g2 is not None:   # authoritative: may carry refit intrinsics
            graph = g2
        start_iter = meta.get("step", 0)
        print(f"resumed from {args.resume} at iter {start_iter}",
              file=sys.stderr)
    else:
        state = init_state(problem, cfg)
        start_iter = 0

    if args.refine_intrinsics and problem.intrinsics is None:
        print("error: --refine_intrinsics needs a Snavely/BAL problem "
              "(per-camera intrinsics); this file uses the shared "
              "pinhole model", file=sys.stderr)
        return 2

    solver = _make_solver(graph, cfg, args.devices, verbose=args.v)
    state = solver.prep(state)
    # the graph the solver actually runs (prepared/padded when sharded);
    # refit + relinearise below are plain jitted functions over it — under
    # --devices > 1 XLA's GSPMD partitions them over the same sharded
    # state/graph the sweeps use (per-edge work sharded, per-camera
    # segment sums all-reduced)
    run_graph = solver.run_graph()

    refit_fn = relin_fn = None
    intr = run_graph.intr
    n_refits = [0, 0]               # accepted, attempted
    if args.refine_intrinsics:
        from ..core.intrinsics import refit_intrinsics
        refit_fn = jax.jit(lambda s, it: refit_intrinsics(
            s, run_graph._replace(intr=it), cfg))
        relin_fn = jax.jit(lambda s, it: gbp.linearise_all(
            s, run_graph._replace(intr=it), cfg))

    if args.profile:
        jax.profiler.start_trace(args.profile_dir)

    t0 = time.perf_counter()
    c0 = common.compile_seconds()
    if start_iter == 0:
        state = solver.initialise(state)
    # Execution chunk vs print cadence: telemetry is per-iteration either
    # way (scan outputs), but the accel/coarse chunk path inside run_gbp
    # only engages when a single jitted call spans >= 2 accel chunks — so
    # execute in spans of 4*accel_every (accel keeps 3/4 of its cadence
    # across call boundaries, where its rate history resets) and print the
    # buffered per-iter lines after each span.
    chunk = max(1, args.print_every)
    if cfg.accel_every > 0:
        chunk = max(chunk, 4 * cfg.accel_every)
    i = start_iter
    t_first_chunk = None
    while i < args.n_iters:
        n = min(chunk, args.n_iters - i)
        warm = min(n, max(0, 2 * cfg.steps - i))
        if refit_fn is not None:
            state, diag = solver.run_with_intr(state, n, i, warm, intr)
        else:
            state, diag = solver.run(state, n, i, warm)
        errs = np.asarray(diag.reproj_err)
        costs = np.asarray(diag.cost)
        relins = np.asarray(diag.n_relins)
        robusts = np.asarray(diag.n_robust)
        if t_first_chunk is None:
            t_first_chunk = time.perf_counter()   # compile happened here
        v_means = (np.asarray(diag.cam_means)
                   if args.v and diag.cam_means is not None else None)
        for j in range(n):
            common.print_iteration(i + j, errs[j], costs[j],
                                   int(relins[j]), int(robusts[j]))
            if v_means is not None:
                # per-iteration belief stream, from the scan outputs
                # (reference --v prints every iteration from streamed
                # beliefs, ba/ba.cpp:1030-1051)
                np.set_printoptions(precision=5, suppress=True)
                print(f"beliefs (cam means) at iter {i + j}:\n"
                      f"{v_means[j].T}", flush=True)
        i += n
        if args.v and v_means is None:
            # sharded runs surface the means at chunk cadence (a per-iter
            # [6, C] stream across chips is pure host traffic; the scalar
            # telemetry stays per-iteration)
            v_cam, _ = analysis.belief_means(state)
            np.set_printoptions(precision=5, suppress=True)
            print(f"beliefs (cam means) at iter {i}:\n{v_cam}", flush=True)
        # Independent host oracle at chunk cadence (the reference recomputes
        # the error host-side EVERY iteration from streamed beliefs,
        # ba/util.cpp:74-144; the device telemetry shares ops.planes with
        # the solver, so this cross-check uses the from-scratch NumPy
        # implementation). Silent when it agrees; loud when it does not.
        # Tolerance note: the state here is post-accel/coarse boundary while
        # errs[-1] is the last in-chunk sweep, so the comparison carries the
        # (cost-decreasing) boundary jump — loose enough to stay silent
        # through it, tight enough to catch genuine device-math corruption.
        h_mu = analysis.belief_means(state)
        h_err, _ = evaluation.numpy_reprojection_error(*h_mu, problem)
        dev_err = float(errs[-1])
        if not (abs(h_err - dev_err) <= max(0.25, 0.05 * abs(dev_err))):
            print(f"WARNING: host oracle disagrees at iter {i}: "
                  f"device {dev_err:.5f} px vs host {h_err:.5f} px",
                  file=sys.stderr)
        if refit_fn is not None and i < args.n_iters:
            # block-coordinate intrinsics step (after the oracle check, so
            # that comparison sees the same intrinsics the chunk ran under)
            new_intr, acc = refit_fn(state, intr)
            n_refits[1] += 1
            if bool(np.asarray(acc)):
                intr = new_intr
                # stored potentials were linearised under the old
                # intrinsics; refresh them all at the current means
                state = relin_fn(state, intr)
                n_refits[0] += 1
                problem.intrinsics = _per_camera_intr(intr, run_graph,
                                                      problem)
                # keep the raw (build-padded) graph in sync for the
                # checkpoint; sharded prep only appends padding, so the
                # leading slice is the build layout
                graph = graph._replace(
                    intr=intr[:, :graph.n_edges])
        if args.checkpoint and args.checkpoint_every and (
                i % args.checkpoint_every < chunk):
            checkpoint.save_checkpoint(args.checkpoint, solver.unprep(state),
                                       graph, step=i, cfg=cfg)
    jax.block_until_ready(state.cam_eta)
    t_end = time.perf_counter()
    compile_s = common.compile_seconds() - c0
    dt = t_end - t0
    msg = f"total {dt:.3f}s ({(args.n_iters - start_iter) / dt:.1f} sweeps/s incl. compile"
    steady_iters = args.n_iters - start_iter - chunk
    if steady_iters > 0 and t_end > t_first_chunk:
        msg += (f"; steady-state "
                f"{steady_iters / (t_end - t_first_chunk):.1f} sweeps/s")
    print(msg + ")", file=sys.stderr)

    if refit_fn is not None:
        print(f"intrinsics refits: {n_refits[0]}/{n_refits[1]} accepted",
              file=sys.stderr)

    if args.profile:
        jax.profiler.stop_trace()
        print(f"profile written to {args.profile_dir}", file=sys.stderr)

    state = solver.unprep(state)
    cam_mu, lmk_mu = analysis.belief_means(state)
    t_polish = time.perf_counter()
    if args.polish:
        # GBP resolves the geometry; a handful of warm-started LM/Schur
        # steps on the same MAP objective remove the residual smooth-mode
        # error (mm-exact agreement with the GN baseline). The priors are
        # the solver's current (annealed) priors, so this optimises the
        # identical objective the GBP fixed point targets.
        import jax.numpy as jnp

        from ..core import gauss_newton as gn
        res = gn.solve_lm(
            jnp.asarray(cam_mu), jnp.asarray(lmk_mu),
            *_polish_problem(problem, cfg), cfg, n_lm_iters=15)
        pol_cam = np.asarray(res.cam)
        moved = float(np.linalg.norm(pol_cam[:, :3] - cam_mu[:, :3],
                                     axis=1).max())
        cam_mu, lmk_mu = pol_cam, np.asarray(res.lmk)
        print(f"polish: reproj {float(res.reproj_err[-1]):.5f} px, "
              f"max camera movement {moved:.5f} m", file=sys.stderr)
    t_polish = time.perf_counter() - t_polish
    print(f"timing: setup {t0 - t_start:.3f} s, solve {dt:.3f} s of which "
          f"compile {compile_s:.3f} s, polish {t_polish:.3f} s",
          file=sys.stderr)
    # independent host-side oracle (pure NumPy, no shared device code) —
    # the reference's per-iteration host eval (ba/util.cpp:74-144), here at
    # end-of-solve granularity (--bad_assoc = its bad_associations skip list)
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
        checkpoint.save_checkpoint(args.checkpoint, state, graph,
                                   step=args.n_iters, cfg=cfg)
        print(f"checkpoint written to {args.checkpoint}", file=sys.stderr)

    if args.gn_check:
        from ..core import gauss_newton as gn
        res = gn.solve_problem(problem, cfg, n_lm_iters=30)
        ate = evaluation.ate_rmse(cam_mu, np.asarray(res.cam))
        print(f"GN baseline: reproj_err {float(res.reproj_err[-1]):.5f} px, "
              f"ATE(GBP vs GN) {ate:.6f} m", file=sys.stderr)
    return 0


class _SingleChip:
    def __init__(self, graph, cfg, verbose: bool = False):
        import jax
        from functools import partial
        self._graph = graph
        self._cfg_steps = cfg.steps
        # The state flows LINEARLY through the driver (each call rebinds
        # it), so donate it: XLA then writes the output state into the
        # input buffers instead of holding both copies live (about half
        # the resident state at large maps; scripts/memory_ledger.py).
        # Never reuse a state after passing it to these.
        self.initialise = jax.jit(lambda s: gbp.initialise(s, graph, cfg),
                                  donate_argnums=0)
        # n and warm static (program structure), offset traced (only feeds
        # the accel_start comparison — no recompile per chunk position).
        # verbose stacks per-iteration cam means into the diagnostics
        # (--v; the reference's per-iteration belief stream)
        self._run = partial(jax.jit, static_argnums=(1, 3),
                            donate_argnums=0)(
            lambda s, n, off, warm: gbp.run_gbp(
                s, graph, cfg, n, iter_offset=off, warm=warm,
                verbose_means=verbose))
        # variant with the Snavely intrinsics as a TRACED operand so the
        # driver's block-coordinate refit (--refine_intrinsics) swaps them
        # between chunks without recompiling
        self._run_intr = partial(jax.jit, static_argnums=(1, 3),
                                 donate_argnums=0)(
            lambda s, n, off, warm, it: gbp.run_gbp(
                s, graph._replace(intr=it), cfg, n, iter_offset=off,
                warm=warm, verbose_means=verbose))

    def prep(self, state):
        return state

    def unprep(self, state):
        return state

    def run_graph(self):
        return self._graph

    def run(self, state, n, offset, warm=None):
        import jax.numpy as jnp
        if warm is None:
            warm = n if not isinstance(offset, int) else max(
                0, min(n, 2 * self._cfg_steps - offset))
        return self._run(state, n, jnp.asarray(offset, jnp.int32), warm)

    def run_with_intr(self, state, n, offset, warm, intr):
        import jax.numpy as jnp
        return self._run_intr(state, n, jnp.asarray(offset, jnp.int32),
                              warm, intr)


class _Sharded:
    def __init__(self, graph, cfg, n_devices):
        from ..parallel import make_mesh, make_sharded_solver
        self._mesh = make_mesh(n_devices)
        self._solver = make_sharded_solver(self._mesh, cfg)
        self._graph_raw = graph
        self._graph = None
        self._n_edges = graph.n_edges

    def prep(self, state):
        self._graph, state = self._solver.prepare(self._graph_raw, state)
        return state

    def unprep(self, state):
        import jax

        from ..core.factor_graph import STATE_EDGE_FIELDS

        e = self._n_edges
        return state._replace(**{
            f: jax.device_get(getattr(state, f))[..., :e]
            for f in STATE_EDGE_FIELDS})

    def run_graph(self):
        assert self._graph is not None, "call prep() first"
        return self._graph

    def initialise(self, state):
        return self._solver.initialise(state, self._graph)

    def run(self, state, n, offset, warm=None):
        return self._solver.run(state, self._graph, n, offset, warm)

    def run_with_intr(self, state, n, offset, warm, intr):
        # same jitted shard_map program: the graph is a traced operand, so
        # swapping the intrinsics planes between chunks costs no recompile
        return self._solver.run(state, self._graph._replace(intr=intr),
                                n, offset, warm)


def _per_camera_intr(intr, graph, problem) -> np.ndarray:
    """[C, 3] per-camera intrinsics from the per-edge [3, E] planes (every
    edge of a camera carries the same value; unobserved cameras keep their
    previous estimate)."""
    out = np.asarray(problem.intrinsics).copy()
    ci = np.asarray(graph.cam_idx)[: problem.n_edges]
    cams, first = np.unique(ci, return_index=True)
    out[cams] = np.asarray(intr)[:, : problem.n_edges][:, first].T
    return out


def _polish_problem(problem, cfg: GBPConfig):
    """(graph, annealed GN priors) for the warm-started LM pass — the
    identical MAP objective the GBP fixed point targets."""
    import jax.numpy as jnp

    from ..core import gauss_newton as gn
    from ..core.factor_graph import build_graph
    from ..utils import priors as priors_lib

    graph1 = build_graph(problem, cfg)
    cam_lam0, lmk_lam0 = priors_lib.prior_lambdas(problem, cfg.meas_var)
    pri = gn.annealed_priors(
        graph1, jnp.asarray(problem.cam_means),
        jnp.asarray(problem.lmk_means), cam_lam0, lmk_lam0, cfg)
    return graph1, pri


def _make_solver(graph, cfg: GBPConfig, n_devices: int,
                 verbose: bool = False):
    if n_devices <= 1:
        return _SingleChip(graph, cfg, verbose)
    return _Sharded(graph, cfg, n_devices)


if __name__ == "__main__":
    sys.exit(main())
