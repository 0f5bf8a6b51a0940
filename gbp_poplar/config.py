"""Solver configuration.

The reference keeps its solver hyper-parameters as compile-time globals in the
device codelet file (reference: ba/gbp_codelets.cpp:10-16) and the remaining
options in a boost::program_options CLI struct (reference: ba/ba.cpp:374-476).
Here everything is promoted to one explicit, hashable config object that is
treated as a static argument under ``jax.jit``.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class GBPConfig:
    """Hyper-parameters of the GBP bundle-adjustment solver.

    Defaults reproduce the reference exactly:
      - damping schedule (reference: ba/gbp_codelets.cpp:11-14)
      - Huber threshold  (reference: ba/gbp_codelets.cpp:16)
      - CLI defaults     (reference: ba/ba.cpp:394-476)
    """

    # --- measurement model ---
    meas_var: float = 4.0              # px^2, reproj_meas_var (ba.cpp:442-445)
    huber_nstds: float = 2.5           # Nstds (gbp_codelets.cpp:16)

    # --- message damping / relinearisation state machine ---
    eta_damping: float = 0.4           # maxeta_damping (gbp_codelets.cpp:11)
    num_undamped_iters: int = 8        # (gbp_codelets.cpp:12)
    dmu_threshold: float = 3e-3        # (gbp_codelets.cpp:13)
    min_linear_iters: int = 10         # (gbp_codelets.cpp:14)
    iters_before_damping: int = 15     # undamped_start (ba.cpp:458-461)

    # --- stability extensions (not in the reference; see core/gbp.py) ---
    # Damp Lambda messages with the same factor as eta. The reference damps
    # only eta (gbp_codelets.cpp:458-462 vs 618-627); damping both keeps each
    # message a consistent (eta, Lambda) pair (log-domain damped BP) and
    # preserves PSD-ness. Default ON (round 4): eta-only damping leaves the
    # Huber-storm oscillation on never-settling edge clusters fp32-bistable
    # EVEN WITH drift recapture — the fr1desk default schedule was observed
    # to storm (n_robust 158 -> 600+, final means non-finite) under one
    # backend codegen and converge under another; with lambda damping the
    # same run is monotone (1.376 px, n_robust flat, polish == GN MAP to 6
    # digits; docs/VALIDATION.md). Costs ~27 extra ops/edge in the
    # sweep. Reference-exact dynamics: lambda_damping=False,
    # relin_drift_threshold=0.
    lambda_damping: bool = True
    # Also relinearise when the belief mean has drifted more than this from
    # the stored linearisation point (runaway-edge recapture). <= 0 disables
    # (reference behaviour: quiescence-only relinearisation). Default ON:
    # quiescence-only relin leaves never-settling edge clusters oscillating
    # with permanently stale potentials (fr1desk), which is fp32-rounding
    # bistable — stable on one backend, divergent on another. Drift
    # recapture quiesces them and also cuts the initial transient ~8x
    # (fr1desk reaches 2 px by sweep 50 instead of sweep 400).
    relin_drift_threshold: float = 0.05
    # Reset damping to 0 for freshly relinearised factors (reference
    # behaviour, gbp_codelets.cpp:282). With lambda_damping the (eta, Lambda)
    # consistency argument for the reset disappears, so it can be disabled.
    reset_damping_on_relin: bool = True
    # Relinearise every active factor every sweep. The reference relinearises
    # lazily because per-tile relinearisation is expensive on IPU; the dense
    # sweep computes the linearisation for every edge anyway, so using it
    # each iteration is free and turns GBP into damped Gauss-Newton message
    # passing. Implies reset_damping_on_relin is ignored.
    relin_every_iter: bool = False

    # --- prior annealing ---
    steps: int = 5                     # prior weakened over this many steps (ba.cpp:454-457)
    prior_std_weaker_factor: float = 100.0  # (ba.cpp:446-449)
    first_cam_prior_std: float = 0.01  # anchor prior std (ba.cpp:450-453)
    num_anchor_cams: int = 2           # first k keyframes anchored (include/dataio.h:115)

    # --- solver loop ---
    n_iters: int = 1500                # (ba.cpp:406-408)
    iters_between_kfs: int = 700       # SLAM only (slam.cpp:414-417)

    # --- fixed-point acceleration (not in the reference) ---
    # After annealing, the dominant convergence error is a near-gauge drift
    # of the whole map toward the weak prior means; message passing relaxes
    # it at a per-sweep contraction rate of 1-eps (hundreds of sweeps per
    # decade). Every `accel_every` sweeps the eta state (belief + message
    # etas) is Aitken-extrapolated along its recent displacement with gain
    # r/(1-r), r the measured contraction of successive displacement vectors.
    # The correction is proportional to the displacement, so the GBP fixed
    # point is unchanged — at convergence the extrapolation vanishes.
    # <= 0 disables (exact reference schedule dynamics).
    accel_every: int = 50
    # First iteration eligible for extrapolation (lets annealing + the first
    # relinearisation waves settle; SLAM segments restart this per segment).
    accel_start: int = 150
    # Clip on the estimated contraction rate (bounds the gain at
    # rate/(1-rate); 0.98 -> max gain 49).
    accel_max_rate: float = 0.98
    # Trust region: the extrapolation jump is scaled down so no camera mean
    # moves more than this (metres).
    accel_max_step: float = 0.5
    # Coarse-space correction (core/coarse.py): at each accel boundary,
    # solve the MAP increment exactly over this many per-group rigid modes
    # (keyframe groups; landmarks follow their first observer) and apply it
    # when the cost decreases. Attacks the smooth low-frequency error that
    # message passing relaxes diffusively. EXPERIMENTAL: cost-guarded and
    # monotone per jump, but the jumps can disturb the message equilibrium
    # on oscillation-prone sequences (fr1desk) — default off. 0 disables.
    coarse_groups: int = 0

    # --- robustness guards (not in the reference, which relies on IPU FP
    # traps to abort instead; ba/ba.cpp:888) ---
    # Tikhonov jitter added to the cavity precision before inversion,
    # relative to its mean diagonal. 0 disables.
    cavity_jitter: float = 1e-6
    # Factors are not relinearised while the landmark sits within this
    # distance of the camera plane (|z| < min_depth, either side) at the
    # candidate linearisation point — the projection Jacobian is singular at
    # z = 0 and its magnitude grows as 1/z^3 net of Huber, so a tight band
    # admits potentials strong enough to blow up fp32 (observed at 0.01).
    # Behind-camera points DO relinearise (Huber makes those factors
    # weak; a one-sided guard deadlocks runaway landmarks). <= 0 disables.
    min_depth: float = 0.05
    # Allow relinearisation with the landmark BEHIND the camera (|z| guard
    # instead of z > min_depth). Required for batch BA (the one-sided guard
    # deadlocks runaway landmarks into unbounded residuals); the SLAM
    # driver disables it — incremental insertion creates behind-camera
    # transients whose Huber-weak but wrong-signed factors destabilise the
    # handoff, and the drift-relin recapture already prevents the deadlock.
    relin_behind_camera: bool = True
    # Time-gated escape hatch for the one-sided guard: edges whose
    # damping_count exceeds this ALSO relinearise behind the camera.
    # damping_count restarts at every keyframe insertion (core/slam.py)
    # AND on every relinearisation (reset_damping_on_relin), so the gate
    # reads "this edge has neither relinearised nor seen an insertion for
    # N sweeps". That is exactly the deadlock signature — a behind-camera
    # edge CANNOT relinearise under the one-sided guard, so its count
    # grows without bound while fresh handoff transients (which do relin)
    # keep resetting theirs. Landmarks pinned behind a camera by a stale
    # potential (unbounded residual) are recaptured once settled; under
    # --schedule gn (relin_every_iter) the relin reset is skipped and the
    # gate depends on insertions only. Measured on fr1xyz SLAM at 700
    # it/kf: the end-state error is dominated by ~3 such landmarks (edges
    # at 300-1500 px, z in [-0.03, -0.8]); <= 0 disables.
    behind_camera_rescue_iters: int = 0

    @property
    def relin_count_threshold(self) -> int:
        """damping_count must exceed this for relinearisation.

        Mirrors ``damping_count > min_linear_iters - num_undamped_iters``
        (reference: ba/gbp_codelets.cpp:280).
        """
        return self.min_linear_iters - self.num_undamped_iters


@dataclasses.dataclass(frozen=True)
class InitConfig:
    """Problem initialisation options (reference: ba/ba.cpp:374-448)."""

    trans_noise: float = 0.0           # --tn
    rot_noise: float = 0.0             # --rn (degrees std)
    lmk_noise: float = 0.0             # --ltn
    av_depth_on: bool = False          # --avdepth_on
    av_depth: float = 1.0              # --avdepth
    seed: int = 0
