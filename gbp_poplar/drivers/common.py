"""Shared CLI plumbing for the ba/slam drivers.

Flag names follow the reference CLIs (ba/ba.cpp:394-476, slam.cpp:414-417)
so command lines port over mechanically; additions (checkpointing, sharding,
trajectory export, profiling) are new capabilities the reference lacks.
"""

from __future__ import annotations

import argparse
import os
import tempfile

from ..config import GBPConfig, InitConfig


_COMPILE_EVENTS = frozenset({
    "/jax/core/compile/jaxpr_trace_duration",
    "/jax/core/compile/jaxpr_to_mlir_module_duration",
    "/jax/core/compile/backend_compile_duration",
})
_compile_total = 0.0
_listening = False


def _count_compile(event: str, secs: float, **_) -> None:
    global _compile_total
    if event in _COMPILE_EVENTS:
        _compile_total += secs


def init_jax() -> None:
    """Prepare JAX before a driver's first device use: GBP_PLATFORM=cpu
    forces the CPU (otherwise JAX picks the accelerator), and the
    persistent compile cache is turned on (utils/compile_cache.py)."""
    global _listening
    import jax

    from ..utils.compile_cache import enable_compile_cache

    if os.environ.get("GBP_PLATFORM") == "cpu":
        jax.config.update("jax_platforms", "cpu")
    enable_compile_cache()
    if not _listening:
        jax.monitoring.register_event_duration_secs_listener(_count_compile)
        _listening = True


def compile_seconds() -> float:
    """Seconds this process has spent tracing, lowering and compiling
    (cache lookups included) since :func:`init_jax` — drivers report the
    difference across a solve apart from its run time."""
    return _compile_total


def add_common_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--bal_file", required=True,
                   help="BAL-format file or sequence name (e.g. fr1xyz)")
    p.add_argument("--tn", type=float, default=0.0,
                   help="keyframe translation noise std (m)")
    p.add_argument("--rn", type=float, default=0.0,
                   help="keyframe rotation noise std (degrees)")
    p.add_argument("--ltn", type=float, default=0.0,
                   help="landmark translation noise std (m)")
    p.add_argument("--avdepth_on", action="store_true",
                   help="initialise landmarks at --avdepth on the first "
                        "observing keyframe's optic axis")
    p.add_argument("--avdepth", type=float, default=1.0)
    p.add_argument("--reproj_meas_var", type=float, default=4.0,
                   help="measurement variance (px^2)")
    p.add_argument("--prior_std_weaker_factor", type=float, default=100.0)
    p.add_argument("--first_cam_prior_std", type=float, default=0.01)
    p.add_argument("--steps", type=int, default=5,
                   help="prior-annealing steps")
    p.add_argument("--undamped_start", type=int, default=15,
                   help="undamped iterations before damping activates")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--v", action="store_true", help="verbose belief dumps")
    p.add_argument("--profile", action="store_true",
                   help="capture a jax.profiler trace to --profile_dir")
    p.add_argument("--profile_dir",
                   default=os.path.join(tempfile.gettempdir(), "gbp_profile"))
    p.add_argument("--devices", type=int, default=1,
                   help="shard the edge axis over this many devices")
    p.add_argument("--save_traj", default=None,
                   help="write final TUM trajectory here")
    p.add_argument("--save_means", default=None,
                   help="write the final means here (.npz with cam [C, 6] "
                        "and lmk [L, 3]; polished when --polish ran)")
    p.add_argument("--checkpoint", default=None,
                   help="write a checkpoint here at the end (and every "
                        "--checkpoint_every iters)")
    p.add_argument("--checkpoint_every", type=int, default=0)
    p.add_argument("--resume", default=None,
                   help="resume from a checkpoint file")
    p.add_argument("--print_every", type=int, default=1,
                   help="print telemetry every N iterations")
    p.add_argument("--relin_drift", type=float, default=None,
                   help="relinearise when the belief mean drifts this far "
                        "from the linearisation point (stability extension; "
                        "<=0 disables, reference behaviour)")
    p.add_argument("--lambda_damping", dest="lambda_damping",
                   action="store_true", default=None,
                   help="damp Lambda messages too (PSD-preserving; the "
                        "reference damps only eta). DEFAULT ON: eta-only "
                        "damping leaves Huber-storm oscillations "
                        "fp32-bistable even with drift recapture "
                        "(docs/VALIDATION.md); --no_lambda_damping opts "
                        "out")
    p.add_argument("--no_lambda_damping", dest="lambda_damping",
                   action="store_false")
    p.add_argument("--rescue_iters", type=int, default=None,
                   help="with the incremental one-sided depth guard, edges "
                        "that have neither relinearised nor seen a keyframe "
                        "insertion for this many sweeps may relinearise "
                        "behind the camera (recaptures deadlocked runaway "
                        "landmarks; <=0 disables)")
    p.add_argument("--coarse_groups", type=int, default=None,
                   help="coarse-space (multigrid) correction over this many "
                        "rigid keyframe groups at each accel chunk boundary "
                        "(core/coarse.py); <=0 disables. The batch ba "
                        "driver defaults to 16 — it collapses the slow "
                        "near-gauge modes (fr1xyz GBP-GN ATE 63mm -> <1mm); "
                        "slam keeps it off (insertion transients)")
    p.add_argument("--schedule", choices=["reference", "gn"],
                   default="reference",
                   help="'reference' = the IPU reference's lazy-"
                        "relinearisation schedule; 'gn' = relinearise every "
                        "sweep with Lambda damping 0.7 (damped Gauss-Newton "
                        "message passing — nearly free in the dense sweep, more robust on hard "
                        "sequences such as fr1desk)")
    p.add_argument("--bad_assoc", default=None,
                   help="known-bad data associations to exclude from the "
                        "error evaluation: comma-separated original edge "
                        "ids, or @file with one id per line (the "
                        "reference's bad_associations list, "
                        "ba/util.cpp:100 — default empty there too)")


def parse_bad_assoc(arg: str | None) -> list[int]:
    """--bad_assoc value -> list of original-problem edge indices."""
    if not arg:
        return []
    if arg.startswith("@"):
        with open(arg[1:]) as f:
            return [int(t) for t in f.read().split()]
    return [int(t) for t in arg.split(",") if t.strip()]


def config_from_args(
    args,
    default_relin_drift: float = 0.05,
    default_lambda_damping: bool = True,
    relin_behind_camera: bool = True,
    default_rescue_iters: int = 0,
    default_coarse_groups: int = 0,
) -> tuple[GBPConfig, InitConfig]:
    relin_drift = (default_relin_drift if args.relin_drift is None
                   else args.relin_drift)
    lambda_damping = (default_lambda_damping if args.lambda_damping is None
                      else args.lambda_damping)
    rescue = (default_rescue_iters
              if getattr(args, "rescue_iters", None) is None
              else args.rescue_iters)
    coarse = (default_coarse_groups
              if getattr(args, "coarse_groups", None) is None
              else args.coarse_groups)
    gn_schedule = getattr(args, "schedule", "reference") == "gn"
    cfg = GBPConfig(
        relin_behind_camera=relin_behind_camera,
        behind_camera_rescue_iters=rescue,
        coarse_groups=max(coarse, 0),
        meas_var=args.reproj_meas_var,
        prior_std_weaker_factor=args.prior_std_weaker_factor,
        first_cam_prior_std=args.first_cam_prior_std,
        steps=args.steps,
        iters_before_damping=0 if gn_schedule else args.undamped_start,
        n_iters=getattr(args, "n_iters", 1500),
        iters_between_kfs=getattr(args, "iters_between_kfs", 700),
        relin_drift_threshold=relin_drift,
        lambda_damping=True if gn_schedule else lambda_damping,
        relin_every_iter=gn_schedule,
        eta_damping=0.7 if gn_schedule else 0.4,
    )
    if (cfg.relin_drift_threshold <= 0 and not cfg.lambda_damping
            and not cfg.relin_every_iter):
        import sys
        print("warning: --relin_drift 0 without --lambda_damping runs the "
              "reference's exact lazy dynamics INCLUDING its oscillation "
              "instability — convergence on fr1desk-like graphs then "
              "depends on the fp32 realisation of the backend "
              "(docs/VALIDATION.md, round 4). Add --lambda_damping for a "
              "stable lazy schedule.", file=sys.stderr)
    init_cfg = InitConfig(
        trans_noise=args.tn, rot_noise=args.rn, lmk_noise=args.ltn,
        av_depth_on=args.avdepth_on, av_depth=args.avdepth, seed=args.seed)
    return cfg, init_cfg


def print_iteration(i: int, err: float, cost: float,
                    n_relins: int, n_robust: int) -> None:
    # telemetry line format follows the reference (ba/ba.cpp:1026-1028)
    print(f"iter {i:5d}  reproj_err {err:10.5f} px  cost {cost:14.4f}  "
          f"relins {n_relins:5d}  robust {n_robust:5d}", flush=True)
