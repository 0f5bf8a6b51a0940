"""Incremental SLAM: keyframe-at-a-time growth of the factor graph.

The reference `slam` binary (ba/slam.cpp:479-1135) pre-builds the full graph
and grows the *active* problem with flags: every `iters_between_kfs`
iterations it activates the next keyframe's edges, hands the new keyframe a
prior centred on the previous keyframe's converged belief, places
newly-observed landmarks at depth `av_depth` on the previous keyframe's
optic axis, restarts the undamped phase, and streams it all back to the
device (READ_PRIORS / NEW_KEYFRAME round-trip, slam.cpp:1018-1047).

Here insertion is one jittable function on the device-resident state — no
host round-trip: the flag updates are pure functions of (new_kf, static
graph indices) and the prior handoff reads the previous keyframe's belief
directly. The per-segment GBP run is the same `lax.scan` as batch BA.

The reference's out-of-bounds flag indexing in ``initialise_new_kf``
(ba/util.cpp:215) is not replicated; newly-observed landmarks are identified
exactly via ``graph.first_kf`` (intent of the flag==steps test).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import GBPConfig
from ..ops import planes as pl
from . import gbp
from .factor_graph import GBPGraph, GBPState


def insert_keyframe(
    state: GBPState,
    graph: GBPGraph,
    cfg: GBPConfig,
    new_kf: jax.Array | int,
    av_depth: float = 1.0,
    axis_name: str | None = None,
    lmk_sharded: bool = False,
) -> GBPState:
    """Activate keyframe `new_kf`'s edges and hand off priors.

    Jit-compatible (``new_kf`` may be traced). Mirrors the intent of
    update_flags (ba/dataio.cpp:477-508) + initialise_new_kf
    (ba/util.cpp:183-223) + the damping restart (ba/slam.cpp:1039-1041).
    """
    new_kf = jnp.asarray(new_kf, jnp.int32)
    dtype = state.cam_eta.dtype

    # --- activate the new keyframe's edges ---
    newly_active = graph.cam_idx == new_kf                       # [E]
    active = jnp.where(newly_active, 1, state.active)

    # --- new keyframe prior <- previous keyframe's belief mean ---
    prev_lam = pl.unpack_sym(state.cam_lam[:, new_kf - 1], 6)    # scalars
    prev_eta = pl.unpack_vec(state.cam_eta[:, new_kf - 1], 6)
    mu_prev = pl.solve_sym(prev_lam, prev_eta)                   # 6 scalars
    # A near-singular previous belief (weakly constrained keyframe after
    # prior annealing) must not poison the handoff: fall back to the
    # previous keyframe's PRIOR mean, which always exists and is finite.
    handoff_ok = jnp.isfinite(sum(jnp.abs(m) for m in mu_prev))
    prev_prior_mu = pl.solve_sym(
        pl.unpack_sym(state.cam_prior_lam[:, new_kf - 1], 6),
        pl.unpack_vec(state.cam_prior_eta[:, new_kf - 1], 6))
    mu_prev = [jnp.where(handoff_ok, m, p)
               for m, p in zip(mu_prev, prev_prior_mu)]
    new_prior_lam = pl.unpack_sym(state.cam_prior_lam[:, new_kf], 6)
    new_cam_eta = pl.pack_vec(pl.matvec(new_prior_lam, mu_prev))
    cam_prior_eta = state.cam_prior_eta.at[:, new_kf].set(
        new_cam_eta.astype(dtype))

    # --- newly observed landmarks: back-project along each landmark's
    # first MEASURED pixel ray at the map's current depth. The reference
    # drops every new landmark at a fixed --avdepth on the previous
    # keyframe's OPTIC AXIS (ba/util.cpp:198-211), which needs per-sequence
    # avdepth hand-tuning; using the measurement ray + the median depth of
    # the established map is hand-tuning-free and starts each landmark with
    # a near-zero reprojection residual on its first observation. ---
    new_lmk = graph.first_kf == new_kf                           # [L]
    r_prev = pl.so3_exp(mu_prev[3:6])

    # adaptive depth: median z (previous keyframe's frame) of established
    # landmarks; fall back to av_depth when none are valid
    lmk_mu = pl.matvec(pl.inv_sym3(pl.unpack_sym(state.lmk_lam, 3)),
                       pl.unpack_vec(state.lmk_eta, 3))          # 3 x (1,L)
    z_est = (r_prev[2][0] * lmk_mu[0] + r_prev[2][1] * lmk_mu[1]
             + r_prev[2][2] * lmk_mu[2] + mu_prev[2])
    z_est = z_est.reshape(-1)                                    # [L]
    valid = ((graph.first_kf < new_kf) & jnp.isfinite(z_est)
             & (z_est > 0.1) & (z_est < 100.0))
    if axis_name is None:
        depth = jnp.nanmedian(jnp.where(valid, z_est, jnp.nan))
    else:
        # landmark axis may be sharded: use the psum'd masked mean instead
        s, n = jax.lax.psum(
            (jnp.sum(jnp.where(valid, z_est, 0.0)),
             jnp.sum(valid.astype(dtype))), axis_name)
        depth = s / jnp.maximum(n, 1.0)
    depth = jnp.where(jnp.isfinite(depth) & (depth > 0.1), depth,
                      jnp.asarray(av_depth, dtype))

    # world point of the pixel ray at `depth`: y_w = R^T (d*K^-1 uv1 - t)
    fx, fy = graph.k[0, 0], graph.k[1, 1]
    cx, cy = graph.k[0, 2], graph.k[1, 2]
    y_cam = [depth * (graph.first_uv[0] - cx) / fx,
             depth * (graph.first_uv[1] - cy) / fy,
             jnp.broadcast_to(depth, (graph.first_uv.shape[1],))]
    p_minus_t = [y_cam[i] - mu_prev[i] for i in range(3)]
    y_new = pl.mat_t_vec(r_prev, p_minus_t)                      # 3 x [L]
    lmk_prior_mat = pl.unpack_sym(state.lmk_prior_lam, 3)        # [L] planes
    new_lmk_eta = pl.pack_vec(pl.matvec(lmk_prior_mat, y_new))   # [3, L]
    lmk_prior_eta = jnp.where(new_lmk[None, :], new_lmk_eta,
                              state.lmk_prior_eta)

    # --- weaken schedule: only the new keyframe + its new landmarks ---
    cam_weaken = jnp.where(jnp.arange(graph.n_keyframes) == new_kf,
                           cfg.steps, state.cam_weaken)
    lmk_weaken = jnp.where(new_lmk, cfg.steps, state.lmk_weaken)

    # --- restart the undamped phase everywhere (ba/slam.cpp:1039-1041) ---
    damping = jnp.zeros_like(state.damping)
    damping_count = jnp.full_like(state.damping_count,
                                  -cfg.iters_before_damping)

    state = state._replace(
        active=active.astype(state.active.dtype),
        cam_prior_eta=cam_prior_eta,
        lmk_prior_eta=lmk_prior_eta,
        cam_weaken=cam_weaken.astype(state.cam_weaken.dtype),
        lmk_weaken=lmk_weaken.astype(state.lmk_weaken.dtype),
        damping=damping,
        damping_count=damping_count,
    )

    # Refresh beliefs with the new priors (NEW_KEYFRAME runs prog_ub,
    # slam.cpp:946-948), then linearise the just-activated factors at them.
    state = gbp.update_beliefs(state, graph, axis_name, lmk_sharded)
    return gbp.relinearise_masked(state, graph, cfg, newly_active)


class SlamResult(NamedTuple):
    state: GBPState
    reproj_err: np.ndarray   # [n_segments, iters_between_kfs]
    cost: np.ndarray
    n_relins: np.ndarray
    n_robust: np.ndarray


def solve_slam(
    state: GBPState,
    graph: GBPGraph,
    cfg: GBPConfig,
    n_keyframes: int | None = None,
    iters_between_kfs: int | None = None,
    av_depth: float = 1.0,
    with_diagnostics: bool = True,
    progress=None,
    start_kf: int = 1,
    runner=None,
    inserter=None,
    initialiser=None,
    segment_callback=None,
) -> SlamResult:
    """Full incremental solve.

    `state` must be initialised with SLAM flags (utils/flags.create_flags:
    keyframes 0 and 1 active). Runs `iters_between_kfs` GBP iterations per
    segment, inserting keyframe k+1 after segment k — the host loop only
    sequences jitted segments (compile once, reuse per keyframe), matching
    the reference's schedule niters = (n_kf-1)*iters_between_kfs - 1
    (slam.cpp:1013-1047) with insertion at segment boundaries.

    ``runner(state) -> (state, diag)``, ``inserter(state, k) -> state`` and
    ``initialiser(state) -> state`` override the default single-chip jitted
    steps (used by the driver for map-sharded execution). ``start_kf > 1``
    resumes at that segment — the state must already contain keyframe
    `start_kf`'s insertion (checkpoints are written post-insertion) and
    initialisation is skipped. ``segment_callback(k, state)`` fires after
    segment k's insertion (or after the final segment) with the
    checkpointable state.
    """
    n_kf = graph.n_keyframes if n_keyframes is None else n_keyframes
    ibk = cfg.iters_between_kfs if iters_between_kfs is None else iters_between_kfs

    if runner is None:
        runner = jax.jit(lambda s: gbp.run_gbp(
            s, graph, cfg, ibk, with_diagnostics=with_diagnostics))
    if inserter is None:
        inserter = jax.jit(
            lambda s, k: insert_keyframe(s, graph, cfg, k, av_depth))
    if initialiser is None:
        initialiser = jax.jit(lambda s: gbp.initialise(s, graph, cfg))

    if start_kf <= 1:
        state = initialiser(state)

    # Segment k (k = 1..n_kf-1) runs with keyframes 0..k active; keyframe
    # k+1 is inserted at the segment boundary, so the last segment refines
    # the fully-activated graph — (n_kf-1) segments total, matching the
    # reference's niters = (n_kf-1) * iters_between_kfs (slam.cpp:1013).
    errs, costs, relins, robusts = [], [], [], []
    for k in range(max(1, start_kf), n_kf):
        state, diag = runner(state)
        if with_diagnostics:
            errs.append(np.asarray(diag.reproj_err))
            costs.append(np.asarray(diag.cost))
            relins.append(np.asarray(diag.n_relins))
            robusts.append(np.asarray(diag.n_robust))
            if progress is not None:
                progress(k, diag)
        if k + 1 < n_kf:
            state = inserter(state, k + 1)
        if segment_callback is not None:
            segment_callback(k, state)

    stack = (lambda xs: np.stack(xs) if xs else np.zeros((0, ibk)))
    return SlamResult(state=state, reproj_err=stack(errs), cost=stack(costs),
                      n_relins=stack(relins), n_robust=stack(robusts))
