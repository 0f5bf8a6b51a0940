"""End-to-end smoke run of GBP bundle adjustment and SLAM on NVIDIA GPUs.

    python chip_smoke.py                # one card, phases 1-5
    python chip_smoke.py --four-cards   # ba/slam --devices 4 against 1 card

Everything runs in this one process (a second JAX process could not get
the card's memory) through the entry points a user calls: the ``gbp-ba``
and ``gbp-slam`` drivers' ``main(argv)`` on BAL files written with
``balio.save_bal`` into ``smoke_data/`` (seeded synthetic problems at
published shapes). Phases, each timed:

1. device: the default JAX devices must be GPUs (no CPU fallback);
2. one-sweep parity at Ladybug width (1.09M edges): ``initialise`` +
   ``gbp_sweep`` on the GPU in float32 against the CPU in float64; the GPU
   gap must stay within PARITY_RATIO times the CPU-float32 gap;
3. batch BA at Ladybug-1723 shape (500 sweeps, polish, checkpoint);
4. batch BA and incremental SLAM at TUM fr1xyz size;
5. BAL Venice-1778 density (4.97M edges, 150 sweeps, no polish), with the
   device's peak memory against its limit.

Results are checked in NumPy float64 against the noise floor: the mean
reprojection error of the generator's ground truth. Any failed check
raises, so the exit code is non-zero; the last line of standard output is
one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA_DIR = os.path.join(ROOT, "smoke_data")

# (keyframes, landmarks, observations per landmark), as in profile_sweep
LADYBUG = (1723, 156_000, 7)        # BAL Ladybug-1723: 1.09M edges
FR1XYZ = (42, 2194, 6)              # TUM fr1xyz size: 13.2k edges
VENICE = (1778, 994_000, 5)         # BAL Venice-1778 density: 4.97M edges

# Initialisation noise given to every driver run, so each solve starts
# away from the generator's ground truth: keyframe translation (m),
# keyframe rotation (degrees), landmark translation (m).
NOISE = ("--tn", "0.02", "--rn", "0.2", "--ltn", "0.05")

PARITY_RATIO = 4.0     # GPU-f32 gap may be this many CPU-f32 gaps
GBP_FLOOR_RATIO = 2.0  # GBP error must end under this many noise floors
SLAM_MAX_PX = 3.0      # the benchmark's SLAM guard
SHARD_REL_TOL = 0.05   # --devices 4 vs 1: final error within 5% ...
SHARD_ABS_TOL = 0.02   # ... plus 0.02 px


def require_gpu():
    """The default JAX devices, which must be GPUs; raises otherwise."""
    import jax

    devices = jax.devices()
    if not devices or devices[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: jax.devices() = {devices}; this smoke run needs one")
    return devices


def result_line(devices) -> str:
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


def card_description() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


@contextlib.contextmanager
def phase(name: str):
    print(f"== {name}", flush=True)
    t0 = time.perf_counter()
    yield
    print(f"== {name}: {time.perf_counter() - t0:.1f} s", flush=True)


@contextlib.contextmanager
def tee_stderr():
    """Copy everything written to sys.stderr into a buffer (the drivers
    report on stderr)."""
    buf = io.StringIO()
    real = sys.stderr

    class _Tee(io.TextIOBase):
        def write(self, s):
            real.write(s)
            buf.write(s)
            return len(s)

        def flush(self):
            real.flush()

    with contextlib.redirect_stderr(_Tee()):
        yield buf


def write_problem(name: str, shape, data_dir: str = DATA_DIR):
    """(path, problem): a seeded synthetic problem saved as a BAL file."""
    from gbp_poplar.utils import balio

    os.makedirs(data_dir, exist_ok=True)
    prob = balio.synthetic_problem_large(*shape, seed=0)
    path = os.path.join(data_dir, f"{name}.txt")
    balio.save_bal(path, prob)
    return path, balio.load_bal(path)


# ---------------------------------------------------------------------------
# phase 2: one sweep, GPU float32 against CPU float64
# ---------------------------------------------------------------------------

PARITY_FIELDS = ("msg_c_eta", "msg_c_lam", "msg_l_eta", "msg_l_lam",
                 "cam_eta", "cam_lam", "lmk_eta", "lmk_lam")


def one_sweep(problem, cfg, dtype, device) -> dict:
    """Host copies of PARITY_FIELDS after ``initialise`` + ``gbp_sweep``
    on ``device`` in ``dtype``."""
    import jax

    from gbp_poplar.core import build_graph, gbp, init_state

    with jax.default_device(device):
        graph = build_graph(problem, cfg, dtype)
        state = init_state(problem, cfg, dtype=dtype)
        step = jax.jit(lambda s, g: gbp.gbp_sweep(
            gbp.initialise(s, g, cfg), g, cfg))
        out = step(state, graph)
        return {f: np.asarray(getattr(out, f), np.float64)
                for f in PARITY_FIELDS}


def parity_gap(got: dict, ref: dict) -> dict:
    """Per-field relative RMS distance ||got - ref|| / ||ref||."""
    return {f: float(np.linalg.norm(got[f] - ref[f])
                     / max(np.linalg.norm(ref[f]), 1e-300))
            for f in PARITY_FIELDS}


def sweep_parity(problem, device) -> tuple[float, float]:
    """(device-f32 gap, CPU-f32 gap), both against CPU-f64, worst field."""
    import jax
    import jax.numpy as jnp

    from gbp_poplar.config import GBPConfig

    cfg = GBPConfig()
    cpu = jax.devices("cpu")[0]
    dut = one_sweep(problem, cfg, jnp.float32, device)
    cpu32 = one_sweep(problem, cfg, jnp.float32, cpu)
    with jax.enable_x64(True):
        ref = one_sweep(problem, cfg, jnp.float64, cpu)
    g_dut, g_cpu = parity_gap(dut, ref), parity_gap(cpu32, ref)
    for f in PARITY_FIELDS:
        print(f"   {f:10s} device-f32 {g_dut[f]:.3e}  cpu-f32 {g_cpu[f]:.3e}")
    return max(g_dut.values()), max(g_cpu.values())


# ---------------------------------------------------------------------------
# driver runs and their float64 checks
# ---------------------------------------------------------------------------

def noise_floor(problem) -> float:
    from gbp_poplar.utils import evaluation

    return evaluation.numpy_reprojection_error(
        problem.cam_means, problem.lmk_means, problem)[0]


def initial_error(problem, noise=NOISE) -> float:
    """Error of the noisy start the drivers build from ``noise``."""
    from gbp_poplar.config import GBPConfig, InitConfig
    from gbp_poplar.utils import evaluation, priors

    flags = dict(zip(noise[::2], map(float, noise[1::2])))
    init = InitConfig(trans_noise=flags.get("--tn", 0.0),
                      rot_noise=flags.get("--rn", 0.0),
                      lmk_noise=flags.get("--ltn", 0.0))
    noisy = priors.apply_init_noise(problem, init,
                                    k_anchor=GBPConfig().num_anchor_cams)
    return evaluation.numpy_reprojection_error(
        noisy.cam_means, noisy.lmk_means, problem)[0]


def means_error(path: str, problem) -> float:
    from gbp_poplar.utils import evaluation

    with np.load(path) as z:
        return evaluation.numpy_reprojection_error(z["cam"], z["lmk"],
                                                   problem)[0]


def checkpoint_error(path: str, problem) -> float:
    from gbp_poplar.utils import analysis, checkpoint, evaluation

    state, _, _ = checkpoint.load_checkpoint(path)
    cam, lmk = analysis.belief_means(state)
    return evaluation.numpy_reprojection_error(
        cam, lmk[:problem.n_points], problem)[0]


def run_driver(module, argv, log_path: str) -> str:
    """Run a driver's ``main(argv)`` in this process, its per-iteration
    telemetry (stdout) going to ``log_path``; returns its stderr and raises
    on a non-zero return code."""
    with open(log_path, "w") as log, contextlib.redirect_stdout(log), \
            tee_stderr() as err:
        rc = module.main(list(argv))
    if rc != 0:
        raise RuntimeError(f"{module.__name__} {argv} returned {rc}")
    return err.getvalue()


def check(cond: bool, msg: str) -> None:
    print(f"   {'ok  ' if cond else 'FAIL'} {msg}", flush=True)
    if not cond:
        raise AssertionError(msg)


def ba_phase(tag: str, path: str, problem, work_dir: str,
             extra=(), polish: bool = True, noise=NOISE) -> dict:
    """``gbp-ba`` on ``path``; checks that the GBP error fell below
    GBP_FLOOR_RATIO noise floors and that the polished means reach the
    floor. Returns the measured errors."""
    from gbp_poplar.drivers import ba

    means = os.path.join(work_dir, f"{tag}_means.npz")
    ckpt = os.path.join(work_dir, f"{tag}_ckpt.npz")
    argv = ["--bal_file", path, "--print_every", "1000000", *noise,
            "--checkpoint", ckpt, "--save_means", means, *extra]
    if not polish:
        argv.append("--no_polish")
    err_log = run_driver(ba, argv, os.path.join(work_dir, f"{tag}.log"))
    timing = re.findall(r"^timing: .*$", err_log, re.M)
    if timing:
        print(f"   {tag} {timing[-1]}", flush=True)
    res = {"floor": noise_floor(problem), "start": initial_error(problem,
                                                                 noise),
           "gbp": checkpoint_error(ckpt, problem)}
    print(f"   {tag}: noise floor {res['floor']:.4f} px, start "
          f"{res['start']:.4f} px, GBP {res['gbp']:.4f} px", flush=True)
    check(np.isfinite(res["gbp"]) and res["gbp"] < res["start"],
          f"{tag}: GBP error fell")
    if polish:
        check(res["gbp"] < GBP_FLOOR_RATIO * res["floor"],
              f"{tag}: GBP error under {GBP_FLOOR_RATIO} noise floors")
        res["polished"] = means_error(means, problem)
        print(f"   {tag}: polished {res['polished']:.4f} px", flush=True)
        check(res["polished"] <= res["floor"],
              f"{tag}: polished error at or below the noise floor")
    return res


def slam_phase(tag: str, path: str, problem, work_dir: str,
               extra=(), noise=NOISE) -> dict:
    """``gbp-slam`` at 700 sweeps per keyframe; the final error must be
    finite and under SLAM_MAX_PX."""
    from gbp_poplar.drivers import slam

    means = os.path.join(work_dir, f"{tag}_means.npz")
    run_driver(slam, ["--bal_file", path, "--iters_between_kfs", "700",
                      "--avdepth", "6.0", "--print_every", "1000000",
                      *noise, "--save_means", means, *extra],
               os.path.join(work_dir, f"{tag}.log"))
    res = {"start": initial_error(problem, noise),
           "final": means_error(means, problem)}
    print(f"   {tag}: start {res['start']:.4f} px, final "
          f"{res['final']:.4f} px", flush=True)
    check(np.isfinite(res["final"]) and res["final"] < SLAM_MAX_PX,
          f"{tag}: final error finite and under {SLAM_MAX_PX} px")
    return res


def memory_line(device) -> str:
    st = device.memory_stats() or {}
    peak, limit = st.get("peak_bytes_in_use"), st.get("bytes_limit")
    if not (peak and limit):
        return "memory stats not reported"
    return (f"peak_bytes_in_use {peak / 2**30:.2f} GiB of bytes_limit "
            f"{limit / 2**30:.2f} GiB ({100 * peak / limit:.1f}%)")


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def one_card(devices) -> None:
    with phase("2 one-sweep parity at Ladybug width"):
        _, lady = write_problem("ladybug", LADYBUG)
        g_dev, g_cpu = sweep_parity(lady, devices[0])
        print(f"   worst field: device-f32 {g_dev:.3e}, cpu-f32 "
              f"{g_cpu:.3e} (limit {PARITY_RATIO} x cpu-f32)", flush=True)
        check(g_dev <= PARITY_RATIO * g_cpu,
              "device float32 within the stated multiple of CPU float32")
    with phase("3 batch BA at Ladybug-1723 shape"):
        path = os.path.join(DATA_DIR, "ladybug.txt")
        ba_phase("ladybug", path, lady, DATA_DIR, ["--n_iters", "500"])
    with phase("4 batch BA and SLAM at fr1xyz size"):
        path, fr1 = write_problem("fr1xyz", FR1XYZ)
        ba_phase("fr1xyz-ba", path, fr1, DATA_DIR)
        slam_phase("fr1xyz-slam", path, fr1, DATA_DIR)
    with phase("5 Venice-1778 density"):
        path, ven = write_problem("venice", VENICE)
        ba_phase("venice", path, ven, DATA_DIR,
                 ["--n_iters", "150"], polish=False)
        print(f"   {memory_line(devices[0])}", flush=True)


def four_cards(devices) -> None:
    if len(devices) < 4:
        raise RuntimeError(f"--four-cards needs 4 GPUs, have {len(devices)}")

    def close(a: float, b: float) -> bool:
        return abs(a - b) <= SHARD_REL_TOL * b + SHARD_ABS_TOL

    with phase("ba --devices 4 against 1 at Ladybug-1723 shape"):
        path, lady = write_problem("ladybug", LADYBUG)
        args = ["--n_iters", "500"]
        r1 = ba_phase("ladybug-1", path, lady, DATA_DIR, args, polish=False)
        r4 = ba_phase("ladybug-4", path, lady, DATA_DIR,
                      [*args, "--devices", "4"], polish=False)
        check(close(r4["gbp"], r1["gbp"]),
              f"4-card GBP error {r4['gbp']:.4f} px matches 1-card "
              f"{r1['gbp']:.4f} px within {SHARD_REL_TOL:.0%} + "
              f"{SHARD_ABS_TOL} px")
    with phase("slam --devices 4 against 1 at fr1xyz size"):
        path, fr1 = write_problem("fr1xyz", FR1XYZ)
        s1 = slam_phase("fr1xyz-slam-1", path, fr1, DATA_DIR)
        s4 = slam_phase("fr1xyz-slam-4", path, fr1, DATA_DIR,
                        ["--devices", "4"])
        check(close(s4["final"], s1["final"]),
              f"4-card SLAM error {s4['final']:.4f} px matches 1-card "
              f"{s1['final']:.4f} px within {SHARD_REL_TOL:.0%} + "
              f"{SHARD_ABS_TOL} px")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card ba/slam paths and their "
                         "1-card comparison")
    args = ap.parse_args(argv)
    # the parity reference runs on JAX's CPU backend beside the GPU
    platforms = os.environ.get("JAX_PLATFORMS")
    if platforms and "cpu" not in platforms.split(","):
        os.environ["JAX_PLATFORMS"] = platforms + ",cpu"

    import jax

    with phase("1 device"):
        devices = require_gpu()
        sys.path.insert(0, ROOT)
        from gbp_poplar.utils.compile_cache import enable_compile_cache

        cache = enable_compile_cache()
        print(card_description())       # name, power limit: as nvidia-smi
        print(f"   jax {jax.__version__}, {len(devices)} x "
              f"{devices[0].device_kind}, compile cache {cache}", flush=True)
    if args.four_cards:
        four_cards(devices)
    else:
        one_card(devices)
    print(result_line(jax.devices()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
