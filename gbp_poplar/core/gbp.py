"""Synchronous Gaussian Belief Propagation — the solver core.

One GBP iteration on the IPU is five compute sets chained by the host
(reference: ba/ba.cpp:895-905): prep (damping/relinearisation state machine),
message computation (4 vertex types), belief reduction, and message
double-buffer copies. Here the whole iteration is ONE jitted dense function
over the edge axis, and a full solve is a single ``lax.scan`` — no
host<->device round-trips inside the loop (the reference streams all beliefs
to the host every iteration, ba/ba.cpp:1009; we fetch diagnostics from the
scan outputs instead).

All per-edge state lives in **plane layout** ([component, E] arrays — see
ops/planes.py): the small-matrix algebra of the message marginalisation
unrolls into elementwise arithmetic over full-width edge rows, which XLA
fuses into a few loops over the edge axis.

Branchy per-vertex control flow (active/robust/relinearise) becomes masked
dense compute: the relinearisation path is evaluated for every edge every
sweep and selected with ``jnp.where`` instead of diverging per edge.

Belief means for relinearisation, costs and diagnostics are solved once per
*variable* (C + L small solves) and gathered per edge. The sweep's prep
step instead solves them per edge from the beliefs it has already gathered
(as the reference does per tile, gbp_codelets.cpp:289-300), which costs
arithmetic but no second gather.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import GBPConfig
from ..ops import planes as pl
from .factor_graph import GBPGraph, GBPState


def _variable_means(state: GBPState) -> tuple[jax.Array, jax.Array]:
    """Solve belief means per variable: cam_mu [6, C], lmk_mu [3, L]."""
    cam_mu = pl.solve_sym(pl.unpack_sym(state.cam_lam, 6),
                          pl.unpack_vec(state.cam_eta, 6))
    lmk_mu = pl.matvec(pl.inv_sym3(pl.unpack_sym(state.lmk_lam, 3)),
                       pl.unpack_vec(state.lmk_eta, 3))
    return pl.pack_vec(cam_mu), pl.pack_vec(lmk_mu)


def _edge_gather(src: jax.Array, idx: jax.Array) -> jax.Array:
    """Gather per-variable planes [comp, V] to per-edge [comp, E]."""
    return jnp.take(src, idx, axis=1)


# ---------------------------------------------------------------------------
# belief update (replaces popops reduceWithOutput, reference: ba/ba.cpp:104-139)
# ---------------------------------------------------------------------------

def update_beliefs(
    state: GBPState, graph: GBPGraph, axis_name: str | None = None,
    lmk_sharded: bool = False,
) -> GBPState:
    """belief = prior + sum of incoming messages (scatter-add over edges).

    Under ``shard_map`` with the edge axis sharded, each shard computes a
    partial segment-sum over its local edges; ``axis_name`` names the mesh
    axis over which the partials are ``psum``-reduced — the equivalent of
    Poplar's cross-tile ``reduceWithOutput`` (reference: ba/ba.cpp:104-139).

    With ``lmk_sharded`` (map-partitioned mode: each shard owns a landmark
    block and ALL of its edges), the landmark reduction is purely local —
    only the keyframes are boundary variables, so the psum payload shrinks
    to O(27*C) floats regardless of problem size.
    """
    c, l = graph.n_keyframes, graph.n_points
    # one fused reduction per variable kind: [6+21, E] and [3+6, E]
    cam_planes = jnp.concatenate([state.msg_c_eta, state.msg_c_lam])
    lmk_planes = jnp.concatenate([state.msg_l_eta, state.msg_l_lam])
    cam_sum = jax.ops.segment_sum(cam_planes.T, graph.cam_idx,
                                  num_segments=c).T                # [27, C]
    lmk_sum = jax.ops.segment_sum(lmk_planes.T, graph.lmk_idx,
                                  num_segments=l).T                # [9, L]
    if axis_name is not None:
        if lmk_sharded:
            cam_sum = jax.lax.psum(cam_sum, axis_name)
        else:
            cam_sum, lmk_sum = jax.lax.psum((cam_sum, lmk_sum), axis_name)
    return state._replace(
        cam_eta=state.cam_prior_eta + cam_sum[:6],
        cam_lam=state.cam_prior_lam + cam_sum[6:],
        lmk_eta=state.lmk_prior_eta + lmk_sum[:3],
        lmk_lam=state.lmk_prior_lam + lmk_sum[3:])


# ---------------------------------------------------------------------------
# relinearisation
# ---------------------------------------------------------------------------

def _linearise_planes(state: GBPState, graph: GBPGraph, cfg: GBPConfig):
    """Relinearise every factor at current belief means (plane form).

    Returns (packed potentials..., robust, mu [9, E] packed means,
    z [1, E] landmark depth in the camera frame — for depth guards).
    """
    cam_mu, lmk_mu = _variable_means(state)
    mu_c = _edge_gather(cam_mu, graph.cam_idx)
    mu_l = _edge_gather(lmk_mu, graph.lmk_idx)
    eta_c, eta_l, lam_cc, lam_cl, lam_ll, robust, y_cf = pl.linearise(
        pl.unpack_vec(mu_c, 6), pl.unpack_vec(mu_l, 3), graph.k,
        graph.meas[0:1], graph.meas[1:2], graph.meas_var[None],
        cfg.huber_nstds,
        None if graph.intr is None else pl.unpack_vec(graph.intr, 3))
    return (pl.pack_vec(eta_c), pl.pack_vec(eta_l),
            pl.pack_sym(lam_cc, 6), pl.pack_full(lam_cl),
            pl.pack_sym(lam_ll, 3), robust[0],
            jnp.concatenate([mu_c, mu_l]), y_cf[2])


def linearise_all(state: GBPState, graph: GBPGraph, cfg: GBPConfig) -> GBPState:
    """Unconditionally relinearise every factor at current belief means.

    Mirrors LINEARISE_PROG's cs_relinearise (reference: ba/ba.cpp:890-893,
    gbp_codelets.cpp:20-172): runs once after beliefs are first set to priors.
    """
    f_eta_c, f_eta_l, f_lam_cc, f_lam_cl, f_lam_ll, robust, mu, _ = (
        _linearise_planes(state, graph, cfg))
    return state._replace(
        f_eta_c=f_eta_c, f_eta_l=f_eta_l, f_lam_cc=f_lam_cc,
        f_lam_cl=f_lam_cl, f_lam_ll=f_lam_ll, robust=robust, lin_mu=mu)


def relinearise_masked(
    state: GBPState, graph: GBPGraph, cfg: GBPConfig, mask: jax.Array
) -> GBPState:
    """Relinearise only the edges in `mask` at current belief means
    (used by SLAM keyframe insertion — stale linearisation points would
    otherwise block the lazy relin trigger, whose dmu test needs
    quiescence)."""
    f_eta_c, f_eta_l, f_lam_cc, f_lam_cl, f_lam_ll, robust, mu, z = (
        _linearise_planes(state, graph, cfg))
    # never adopt a linearisation at a non-finite mean (a weakly-constrained
    # adjacent belief can be numerically singular)
    mask = mask & jnp.isfinite(jnp.sum(jnp.abs(mu), axis=0))
    if cfg.min_depth > 0.0:
        # same Jacobian-singularity guard as the sweep's relin path,
        # including its sidedness: with relin_behind_camera=False (the SLAM
        # driver default) a linearisation at a behind-camera mean is refused
        # here exactly as the sweep would refuse it — insertion must not
        # adopt the wrong-signed factors the one-sided guard exists to block
        ok_depth = (jnp.abs(z) > cfg.min_depth if cfg.relin_behind_camera
                    else z > cfg.min_depth)
        mask = mask & ok_depth[0]
    m1 = mask[None, :]
    return state._replace(
        f_eta_c=jnp.where(m1, f_eta_c, state.f_eta_c),
        f_eta_l=jnp.where(m1, f_eta_l, state.f_eta_l),
        f_lam_cc=jnp.where(m1, f_lam_cc, state.f_lam_cc),
        f_lam_cl=jnp.where(m1, f_lam_cl, state.f_lam_cl),
        f_lam_ll=jnp.where(m1, f_lam_ll, state.f_lam_ll),
        lin_mu=jnp.where(m1, mu, state.lin_mu),
        mu=jnp.where(m1, mu, state.mu),
        robust=jnp.where(mask, robust, state.robust),
    )


def recenter_priors(
    state: GBPState,
    cam_mu: jax.Array | None = None,
    lmk_mu: jax.Array | None = None,
) -> GBPState:
    """Recompute prior eta = Lambda_prior @ mu for the given means.

    The reference's ``update_eta`` (ba/util.cpp:146-181):
    re-centres the priors (keeping their strengths) at new means — e.g. a
    solution imported from another solver. ``cam_mu`` is [C, 6] row-major,
    ``lmk_mu`` [L, 3]; omitted kinds keep their current prior means.
    """
    upd = {}
    if cam_mu is not None:
        rows = pl.matvec(pl.unpack_sym(state.cam_prior_lam, 6),
                         pl.unpack_vec(jnp.asarray(cam_mu).T, 6))
        upd["cam_prior_eta"] = pl.pack_vec(rows).astype(
            state.cam_prior_eta.dtype)
    if lmk_mu is not None:
        rows = pl.matvec(pl.unpack_sym(state.lmk_prior_lam, 3),
                         pl.unpack_vec(jnp.asarray(lmk_mu).T, 3))
        upd["lmk_prior_eta"] = pl.pack_vec(rows).astype(
            state.lmk_prior_eta.dtype)
    return state._replace(**upd) if upd else state


# ---------------------------------------------------------------------------
# prior annealing (reference: gbp_codelets.cpp:176-197 + ba/ba.cpp:1003-1006)
# ---------------------------------------------------------------------------

def _anneal_priors(
    state: GBPState, graph: GBPGraph,
    cam_live: jax.Array, lmk_live: jax.Array,
) -> GBPState:
    """Scale priors by the per-variable annealing factor where `*_live`,
    decrementing the weaken flags there (masked dense compute; the masks are
    already flag-gated by the callers)."""
    cs = jnp.where(cam_live, graph.cam_scaling, 1.0)[None, :]
    ls = jnp.where(lmk_live, graph.lmk_scaling, 1.0)[None, :]
    return state._replace(
        cam_prior_eta=state.cam_prior_eta * cs,
        cam_prior_lam=state.cam_prior_lam * cs,
        lmk_prior_eta=state.lmk_prior_eta * ls,
        lmk_prior_lam=state.lmk_prior_lam * ls,
        cam_weaken=state.cam_weaken - cam_live.astype(state.cam_weaken.dtype),
        lmk_weaken=state.lmk_weaken - lmk_live.astype(state.lmk_weaken.dtype),
    )


def weaken_priors(
    state: GBPState, graph: GBPGraph, axis_name: str | None = None,
    lmk_sharded: bool = False,
) -> GBPState:
    """Scale priors by the per-variable annealing factor while the weaken
    flag is live, decrementing the flag; then refresh beliefs."""
    # The reference hardcodes flag in {1..5} (gbp_codelets.cpp:185); flags are
    # only ever set to `steps` and decremented, so `> 0` is the exact intent.
    state = _anneal_priors(state, graph,
                           state.cam_weaken > 0, state.lmk_weaken > 0)
    return update_beliefs(state, graph, axis_name, lmk_sharded)


# ---------------------------------------------------------------------------
# one synchronous GBP sweep (= GBP_PROG, reference: ba/ba.cpp:895-905)
# ---------------------------------------------------------------------------

def edge_math(
    bc, bl, meas, meas_var,
    f_eta_c0, f_eta_l0, f_lam_cc0, f_lam_cl0, f_lam_ll0,
    msg_c_eta0, msg_c_lam0, msg_l_eta0, msg_l_lam0,
    damping0, damping_count0, mu0, lin_mu0, robust0, active_i,
    k, cfg: GBPConfig, intr=None,
):
    """The complete per-edge GBP sweep body on plane arrays.

    Fuses the reference's PrepMessageVertex (damping/relin state machine +
    in-place relinearisation, gbp_codelets.cpp:215-379) with all four
    message vertices (gbp_codelets.cpp:382-710). Pure elementwise on [*, N]
    planes, so XLA compiles it as fusions over the edge axis.

    ``k`` is the [3,3] intrinsics; ``cfg`` is static. Returns the 14 edge
    fields in GBPState order (f_eta_c ... robust); per-edge scalar rows
    (damping, damping_count, robust) come back shaped (1, N) — callers
    squeeze.
    """
    def row(x):
        return x[None] if x.ndim == 1 else x

    meas_var = row(meas_var)
    damping0 = row(damping0)
    damping_count0 = row(damping_count0)
    robust0 = row(robust0)
    active = row(active_i) > 0
    a1 = active

    # split the combined belief gathers (eta | packed Lambda)
    bc_eta, bc_lam = bc[:6], bc[6:]
    bl_eta, bl_lam = bl[:3], bl[3:]

    # --- prep: damping state machine (reference: gbp_codelets.cpp:215-283) --
    damping = jnp.where(active & (damping_count0 == 0),
                        cfg.eta_damping, damping0)
    damping_count = damping_count0 + active.astype(jnp.int32)

    # adjacent-belief means per edge, solved from the gathered beliefs
    mu_c_rows = pl.solve_sym(pl.unpack_sym(bc_lam, 6),
                             pl.unpack_vec(bc_eta, 6))
    mu_l_rows = pl.matvec(pl.inv_sym3(pl.unpack_sym(bl_lam, 3)),
                          pl.unpack_vec(bl_eta, 3))
    mu_c = pl.pack_vec(mu_c_rows)
    mu_l = pl.pack_vec(mu_l_rows)

    # relinearisation candidates at current belief means
    meas_u, meas_v = pl.unpack_vec(meas, 2)
    intr_rows = None if intr is None else pl.unpack_vec(intr, 3)
    (eta_c_n, eta_l_n, lam_cc_n, lam_cl_n, lam_ll_n, robust_new,
     y_cf) = pl.linearise(
        mu_c_rows, mu_l_rows, k,
        meas_u, meas_v, meas_var, cfg.huber_nstds, intr_rows)
    pot_eta_c = pl.pack_vec(eta_c_n)
    pot_eta_l = pl.pack_vec(eta_l_n)
    pot_lam_cc = pl.pack_sym(lam_cc_n, 6)
    pot_lam_cl = pl.pack_full(lam_cl_n)
    pot_lam_ll = pl.pack_sym(lam_ll_n, 3)
    mu = jnp.concatenate([mu_c, mu_l])

    def _sqnorm_rows(delta_packed, d):
        # squared norm: the thresholds compare squared too, saving a sqrt
        # per edge per norm (monotone — same decisions up to the
        # rounding of borderline lanes)
        rows = pl.unpack_vec(delta_packed, d)
        acc = rows[0] * rows[0]
        for r in rows[1:]:
            acc = acc + r * r
        return acc

    dmu2 = _sqnorm_rows(mu - mu0, 9)
    # a non-finite mean (belief turned indefinite upstream) must never be
    # adopted as a linearisation point or stored state
    mu_ok = jnp.isfinite(dmu2)

    if cfg.relin_every_iter:
        relin = active & mu_ok
    else:
        relin = (
            active & mu_ok
            & (dmu2 < cfg.dmu_threshold * cfg.dmu_threshold)
            & (damping_count > cfg.relin_count_threshold)
        )
        if cfg.relin_drift_threshold > 0.0:
            # Runaway-edge recapture: relinearise when the belief mean has
            # left the stored linearisation point (the reference only
            # relinearises on quiescence, which cannot catch edges that
            # never settle). mu_ok keeps NaN means from ever triggering
            # the drift path.
            drift2 = _sqnorm_rows(mu - lin_mu0, 9)
            thr = cfg.relin_drift_threshold
            relin = relin | (
                active & mu_ok
                & (drift2 > thr * thr)
                & (damping_count > cfg.relin_count_threshold)
            )
    if cfg.min_depth > 0.0:
        # Never adopt a linearisation with the landmark ON the camera plane —
        # the projection Jacobians blow up as z -> 0. The guard is on |z|,
        # NOT z > eps: a landmark that wanders behind the camera must keep
        # relinearising (Huber inflates the variance with the huge residual,
        # so the factor goes weak and the landmark's other edges pull it back
        # in front — the reference's behaviour, gbp_codelets.cpp:137-141).
        # A one-sided guard deadlocks: the stale potential pins the landmark
        # behind the camera and the edge's residual grows without bound.
        # y_cf is reused from the linearisation (same means) instead of a
        # second Rodrigues pass.
        if cfg.relin_behind_camera:
            relin = relin & (jnp.abs(y_cf[2]) > cfg.min_depth)
        else:
            ok_depth = y_cf[2] > cfg.min_depth
            if cfg.behind_camera_rescue_iters > 0:
                # settled edges (no relin and no keyframe insertion for N
                # sweeps — damping_count restarts at both; see
                # config.behind_camera_rescue_iters) escape the one-sided
                # guard's behind-camera deadlock
                settled = damping_count > cfg.behind_camera_rescue_iters
                ok_depth = ok_depth | (
                    settled & (jnp.abs(y_cf[2]) > cfg.min_depth))
            relin = relin & ok_depth

    f_eta_c = jnp.where(pl.row_mask(relin, 6), pot_eta_c, f_eta_c0)
    f_eta_l = jnp.where(pl.row_mask(relin, 3), pot_eta_l, f_eta_l0)
    f_lam_cc = jnp.where(pl.row_mask(relin, 21), pot_lam_cc, f_lam_cc0)
    f_lam_cl = jnp.where(pl.row_mask(relin, 18), pot_lam_cl, f_lam_cl0)
    f_lam_ll = jnp.where(pl.row_mask(relin, 6), pot_lam_ll, f_lam_ll0)
    r9 = pl.row_mask(relin, 9)
    lin_mu = jnp.where(r9, mu, lin_mu0)
    robust = jnp.where(relin, robust_new, robust0)
    if cfg.reset_damping_on_relin and not cfg.relin_every_iter:
        damping = jnp.where(relin, 0.0, damping)
    if not cfg.relin_every_iter:
        damping_count = jnp.where(relin, -cfg.num_undamped_iters,
                                  damping_count)
    new_mu = jnp.where(pl.row_mask(a1 & mu_ok, 9), mu, mu0)

    # --- factor -> variable messages (reference: gbp_codelets.cpp:382-710) --
    f_cl = pl.unpack_full(f_lam_cl, 6, 3)
    f_cc = pl.unpack_sym(f_lam_cc, 6)
    f_ll = pl.unpack_sym(f_lam_ll, 3)
    e_c = pl.unpack_vec(f_eta_c, 6)
    e_l = pl.unpack_vec(f_eta_l, 3)

    # to keyframe: marginalise the landmark out (3x3 inverse, closed form)
    cav_ll = pl.add_rel_jitter(
        pl.unpack_sym(f_lam_ll + bl_lam - msg_l_lam0, 3),
        cfg.cavity_jitter)
    # per-edge PSD guard: an indefinite cavity means this edge's message is
    # not computable this sweep — hold the previous message instead of
    # inverting garbage (the reference faults via FP traps here); the
    # Sylvester test shares the adjugate's cofactors
    inv_ll, ok_ll = pl.inv_sym3_posdef(cav_ll)
    w_cl = pl.matmul(f_cl, inv_ll)                            # 6x3
    eta_l_cav = pl.unpack_vec(f_eta_l + bl_eta - msg_l_eta0, 3)
    msg_c_eta = pl.pack_vec(pl.vsub(e_c, pl.matvec(w_cl, eta_l_cav)))
    mc_lam = [[None] * 6 for _ in range(6)]
    for i in range(6):
        for j in range(i + 1):
            acc = w_cl[i][0] * f_cl[j][0]
            for k2 in range(1, 3):
                acc = acc + w_cl[i][k2] * f_cl[j][k2]
            v = f_cc[i][j] - acc
            mc_lam[i][j] = v
            mc_lam[j][i] = v
    msg_c_lam = pl.pack_sym(mc_lam, 6)

    # to landmark: marginalise the keyframe out (6x6 Cholesky solves)
    cav_cc = pl.add_rel_jitter(
        pl.unpack_sym(f_lam_cc + bc_lam - msg_c_lam0, 6),
        cfg.cavity_jitter)
    # the returned reciprocal diagonal is not used: true divides keep these
    # solves the same computation as pl.solve_sym's
    l_cc, min_pivot, _ = pl.cholesky_with_pivot(cav_cc)
    ok_cc = min_pivot > 0
    eta_c_cav = pl.unpack_vec(f_eta_c + bc_eta - msg_c_eta0, 6)
    y_sol = pl.chol_solve(l_cc, eta_c_cav)
    x_cols = [pl.chol_solve(l_cc, [f_cl[i][a] for i in range(6)])
              for a in range(3)]
    ml_eta = [e_l[a] - pl.vdot([f_cl[i][a] for i in range(6)], y_sol)
              for a in range(3)]
    msg_l_eta = pl.pack_vec(ml_eta)
    ml_lam = [[None] * 3 for _ in range(3)]
    for a in range(3):
        for b in range(a + 1):
            acc = f_cl[0][a] * x_cols[b][0]
            for i in range(1, 6):
                acc = acc + f_cl[i][a] * x_cols[b][i]
            v = f_ll[a][b] - acc
            ml_lam[a][b] = v
            ml_lam[b][a] = v
    msg_l_lam = pl.pack_sym(ml_lam, 3)

    # eta messages are damped against the previous message; the reference
    # leaves Lambda undamped (gbp_codelets.cpp:458-462 vs 618-627), while
    # lambda_damping blends both (log-domain damped BP; PSD-preserving).
    def blend(new, old, n_slots):
        d = pl.row_mask(damping, n_slots)
        return (1.0 - d) * new + d * old

    msg_c_eta = blend(msg_c_eta, msg_c_eta0, 6)
    msg_l_eta = blend(msg_l_eta, msg_l_eta0, 3)
    if cfg.lambda_damping:
        msg_c_lam = blend(msg_c_lam, msg_c_lam0, 21)
        msg_l_lam = blend(msg_l_lam, msg_l_lam0, 6)

    # PSD guards: hold the previous message where the cavity was indefinite
    msg_c_eta = jnp.where(pl.row_mask(ok_ll, 6), msg_c_eta, msg_c_eta0)
    msg_c_lam = jnp.where(pl.row_mask(ok_ll, 21), msg_c_lam, msg_c_lam0)
    msg_l_eta = jnp.where(pl.row_mask(ok_cc, 3), msg_l_eta, msg_l_eta0)
    msg_l_lam = jnp.where(pl.row_mask(ok_cc, 6), msg_l_lam, msg_l_lam0)

    # Inactive factors emit zeros (reference: gbp_codelets.cpp:464-468).
    # jnp.where (not multiply-by-mask) so a non-finite value computed on an
    # inactive/padding edge cannot poison the reduction (NaN * 0 = NaN).
    msg_c_eta = jnp.where(pl.row_mask(a1, 6), msg_c_eta, 0.0)
    msg_l_eta = jnp.where(pl.row_mask(a1, 3), msg_l_eta, 0.0)
    msg_c_lam = jnp.where(pl.row_mask(a1, 21), msg_c_lam, 0.0)
    msg_l_lam = jnp.where(pl.row_mask(a1, 6), msg_l_lam, 0.0)

    return (f_eta_c, f_eta_l, f_lam_cc, f_lam_cl, f_lam_ll,
            msg_c_eta, msg_c_lam, msg_l_eta, msg_l_lam,
            damping, damping_count, new_mu, lin_mu, robust)


def gbp_sweep(
    state: GBPState, graph: GBPGraph, cfg: GBPConfig,
    axis_name: str | None = None, lmk_sharded: bool = False,
) -> GBPState:
    # --- belief gathers (one gather per variable kind) ---
    bc = _edge_gather(jnp.concatenate([state.cam_eta, state.cam_lam]),
                      graph.cam_idx)                            # [27, E]
    bl = _edge_gather(jnp.concatenate([state.lmk_eta, state.lmk_lam]),
                      graph.lmk_idx)                            # [9, E]

    (f_eta_c, f_eta_l, f_lam_cc, f_lam_cl, f_lam_ll,
     msg_c_eta, msg_c_lam, msg_l_eta, msg_l_lam,
     damping, damping_count, new_mu, lin_mu, robust) = edge_math(
        bc, bl, graph.meas, graph.meas_var,
        state.f_eta_c, state.f_eta_l, state.f_lam_cc,
        state.f_lam_cl, state.f_lam_ll,
        state.msg_c_eta, state.msg_c_lam,
        state.msg_l_eta, state.msg_l_lam,
        state.damping, state.damping_count, state.mu, state.lin_mu,
        state.robust, state.active, graph.k, cfg, intr=graph.intr)
    state = state._replace(
        f_eta_c=f_eta_c, f_eta_l=f_eta_l, f_lam_cc=f_lam_cc,
        f_lam_cl=f_lam_cl, f_lam_ll=f_lam_ll,
        msg_c_eta=msg_c_eta, msg_c_lam=msg_c_lam,
        msg_l_eta=msg_l_eta, msg_l_lam=msg_l_lam,
        # per-edge scalar rows come back (1, E) — restore the state's [E]
        damping=damping[0], damping_count=damping_count[0],
        mu=new_mu, lin_mu=lin_mu, robust=robust[0],
    )

    # --- belief update (reduce) ---
    return update_beliefs(state, graph, axis_name, lmk_sharded)


def _sanitize_means(cam_mu: jax.Array, lmk_mu: jax.Array):
    """Zero whole columns with any non-finite component (a singular
    belief's mean must not leak ANY component into the chunk averages)."""
    cam_ok = jnp.all(jnp.isfinite(cam_mu), axis=0, keepdims=True)
    lmk_ok = jnp.all(jnp.isfinite(lmk_mu), axis=0, keepdims=True)
    return jnp.where(cam_ok, cam_mu, 0.0), jnp.where(lmk_ok, lmk_mu, 0.0)


# ---------------------------------------------------------------------------
# diagnostics (device-side replacement for the host TBB eval,
# reference: ba/util.cpp:74-144)
# ---------------------------------------------------------------------------

class Diagnostics(NamedTuple):
    reproj_err: jax.Array   # mean residual norm over active edges (px)
    cost: jax.Array         # 0.5 * sum ||r||^2
    n_relins: jax.Array     # edges that just relinearised
    n_robust: jax.Array     # edges with Huber active
    # per-iteration camera belief means [6, C], filled only under the
    # drivers' --v (the reference streams beliefs to the host and prints
    # them every iteration, ba/ba.cpp:1030-1051; here they ride the scan
    # outputs — None costs nothing, it is an empty pytree subtree)
    cam_means: jax.Array | None = None


def reprojection_error(
    state: GBPState, graph: GBPGraph, axis_name: str | None = None,
    bad: jax.Array | None = None,
) -> tuple[jax.Array, jax.Array]:
    """Mean reprojection residual norm and total cost over active edges.

    ``bad`` is an optional [E] bool mask (canonical graph edge order) of
    known-bad data associations to exclude from the statistics — the
    reference's ``bad_associations`` list (ba/util.cpp:100, default empty;
    build one from original-problem edge ids with
    ``factor_graph.bad_edge_mask``).
    """
    cam_mu, lmk_mu = _variable_means(state)
    mu_c = _edge_gather(cam_mu, graph.cam_idx)
    mu_l = _edge_gather(lmk_mu, graph.lmk_idx)
    (u, v), _, _ = pl.project(
        pl.unpack_vec(mu_c, 6), pl.unpack_vec(mu_l, 3), graph.k,
        None if graph.intr is None else pl.unpack_vec(graph.intr, 3))
    ru = graph.meas[0] - u
    rv = graph.meas[1] - v
    norm = jnp.sqrt(ru * ru + rv * rv)
    # exclude edges whose adjacent belief is numerically singular (the mean
    # solve overflows); they are transient during annealing/insertion and
    # would otherwise wipe the whole telemetry to NaN
    valid = (state.active > 0)[None] & jnp.isfinite(norm)
    if bad is not None:
        valid = valid & ~bad[None]
    active = valid.astype(norm.dtype)
    norm = jnp.where(valid, norm, 0.0)
    n_active = jnp.sum(active)
    sum_norm = jnp.sum(norm)
    cost = 0.5 * jnp.sum(norm * norm)
    if axis_name is not None:
        n_active, sum_norm, cost = jax.lax.psum(
            (n_active, sum_norm, cost), axis_name)
    # no valid edge at all -> report NaN, not a deceptive 0.0
    mean_err = jnp.where(n_active > 0,
                         sum_norm / jnp.maximum(n_active, 1.0), jnp.nan)
    return mean_err, cost


def diagnostics(
    state: GBPState, graph: GBPGraph, cfg: GBPConfig,
    axis_name: str | None = None, with_cam_means: bool = False,
) -> Diagnostics:
    err, cost = reprojection_error(state, graph, axis_name)
    n_relins = jnp.sum(
        (state.damping_count == -cfg.num_undamped_iters).astype(jnp.int32)
        * state.active.astype(jnp.int32))
    n_robust = jnp.sum((state.robust & (state.active > 0)).astype(jnp.int32))
    if axis_name is not None:
        n_relins, n_robust = jax.lax.psum((n_relins, n_robust), axis_name)
    cam_means = None
    if with_cam_means:
        cam_means, _ = _variable_means(state)
    return Diagnostics(err, cost, n_relins, n_robust, cam_means)


# ---------------------------------------------------------------------------
# full solves
# ---------------------------------------------------------------------------

def initialise(
    state: GBPState, graph: GBPGraph, cfg: GBPConfig,
    axis_name: str | None = None, lmk_sharded: bool = False,
) -> GBPState:
    """WRITE + LINEARISE: beliefs <- priors, then linearise every factor
    (reference: ba/ba.cpp:982-987)."""
    state = update_beliefs(state, graph, axis_name, lmk_sharded)
    return linearise_all(state, graph, cfg)


def iteration(
    state: GBPState, graph: GBPGraph, cfg: GBPConfig, i: jax.Array,
    axis_name: str | None = None, lmk_sharded: bool = False,
) -> GBPState:
    """One scheduled solver iteration: weaken priors on every 2nd iteration
    (flag-gated, so annealing self-terminates after `steps` applications;
    reference: ba/ba.cpp:1003-1006), then one GBP sweep.

    The weaken step is masked dense compute, not a ``lax.cond`` — a cond
    here would force the whole state through a branch barrier, while the
    masked prior scaling is O(C+L) elementwise, i.e. nearly free.
    Consequently the prep step of the following sweep sees beliefs that
    are one prior-refresh stale on the ~2*steps annealing
    iterations (the reference refreshes beliefs inside WEAKEN_PRIORS,
    ba/ba.cpp:877); the fixed point is unchanged and the sweep's closing
    belief update applies the new priors immediately after.
    """
    do_weaken = (i + 1) % 2 == 0
    state = _anneal_priors(state, graph,
                           do_weaken & (state.cam_weaken > 0),
                           do_weaken & (state.lmk_weaken > 0))
    return gbp_sweep(state, graph, cfg, axis_name, lmk_sharded)


def _prior_quad(lam_planes, eta_planes, mu_planes, d):
    """Gaussian prior quadratic 0.5 mu'Lam mu - eta'mu, summed over finite
    variables (the prior mean's constant cancels in cost comparisons)."""
    lam = pl.unpack_sym(lam_planes, d)
    mu_rows = pl.unpack_vec(mu_planes, d)
    eta_rows = pl.unpack_vec(eta_planes, d)
    lam_mu = pl.matvec(lam, mu_rows)
    val = 0.5 * pl.vdot(mu_rows, lam_mu) - pl.vdot(eta_rows, mu_rows)
    return jnp.sum(jnp.where(jnp.isfinite(val), val, 0.0))


def _cost_parts(
    state: GBPState, graph: GBPGraph, cfg: GBPConfig,
    mu_c_e: jax.Array, mu_l_e: jax.Array,
    cam_mu: jax.Array, lmk_mu: jax.Array,
    bad: jax.Array | None = None,
):
    """(robust data term, cam prior quad, lmk prior quad) of the MAP
    objective at the given means — ``map_cost``'s body with the per-edge
    gathers hoisted out, so chunk-boundary callers can price several
    candidate mean shifts from ONE stacked gather per variable kind and
    batch the cross-shard psums (the per-edge gathers dominate the accel
    step on large graphs)."""
    (u, v), _, _ = pl.project(
        pl.unpack_vec(mu_c_e, 6), pl.unpack_vec(mu_l_e, 3), graph.k,
        None if graph.intr is None else pl.unpack_vec(graph.intr, 3))
    ru = graph.meas[0] - u
    rv = graph.meas[1] - v
    err2 = (ru * ru + rv * rv) / graph.meas_var
    err = jnp.sqrt(err2)
    k = cfg.huber_nstds
    loss = jnp.where(err > k, k * err - 0.5 * k * k, 0.5 * err2)
    ok = (state.active > 0)[None] & jnp.isfinite(loss)
    if bad is not None:
        ok = ok & ~bad[None]
    robust = jnp.sum(jnp.where(ok, loss, 0.0))
    cam_prior = _prior_quad(state.cam_prior_lam, state.cam_prior_eta,
                            cam_mu, 6)
    lmk_prior = _prior_quad(state.lmk_prior_lam, state.lmk_prior_eta,
                            lmk_mu, 3)
    return robust, cam_prior, lmk_prior


def map_cost(
    state: GBPState, graph: GBPGraph, cfg: GBPConfig,
    axis_name: str | None = None, lmk_sharded: bool = False,
    bad: jax.Array | None = None,
) -> jax.Array:
    """The MAP objective at the current belief means: sum of Huber losses
    (whitened) over active edges + the Gaussian prior quadratic (up to the
    prior mean's constant, which cancels in comparisons).

    Mirrors the Gauss-Newton baseline's objective (core/gauss_newton.py),
    evaluated on the GBP state entirely on device. ``bad`` optionally
    excludes known-bad associations from the data term (the reference's
    ``bad_associations`` hook, ba/util.cpp:100).
    """
    cam_mu, lmk_mu = _variable_means(state)
    mu_c = _edge_gather(cam_mu, graph.cam_idx)
    mu_l = _edge_gather(lmk_mu, graph.lmk_idx)
    robust, cam_prior, lmk_prior = _cost_parts(
        state, graph, cfg, mu_c, mu_l, cam_mu, lmk_mu, bad)
    if axis_name is not None:
        # edges are always sharded; landmark priors only in map mode
        # (camera priors are replicated in both sharding modes)
        if lmk_sharded:
            robust, lmk_prior = jax.lax.psum((robust, lmk_prior), axis_name)
        else:
            robust = jax.lax.psum(robust, axis_name)
    return robust + cam_prior + lmk_prior


def _active_degrees(state: GBPState, graph: GBPGraph,
                    axis_name: str | None, lmk_sharded: bool):
    """Number of ACTIVE edges incident to each variable ([C], [L])."""
    act = (state.active > 0).astype(state.cam_eta.dtype)
    degc = jax.ops.segment_sum(act, graph.cam_idx,
                               num_segments=graph.n_keyframes)
    degl = jax.ops.segment_sum(act, graph.lmk_idx,
                               num_segments=graph.n_points)
    if axis_name is not None:
        if lmk_sharded:
            degc = jax.lax.psum(degc, axis_name)
        else:
            degc, degl = jax.lax.psum((degc, degl), axis_name)
    return degc, degl


def _mean_shift_etas(state: GBPState, dc_mu: jax.Array, dl_mu: jax.Array,
                     degs):
    """Belief-eta corrections realising the mean shift (dc_mu [6,C],
    dl_mu [3,L]) at fixed Lambda.

    The shift is carried on the MESSAGE state (each variable's correction
    Lambda_v * dmu_v split equally over its active incident messages, so
    the per-message perturbation stays O(1/degree) and is relaxed by
    subsequent sweeps); the belief picks up the full correction directly.
    Non-finite correction components (transiently singular beliefs) are
    dropped, and a variable with no active edges cannot carry a shift —
    the realised mean shift is Sigma_v @ (masked deta).

    NOTE: forcing relinearisation at the shifted means was tried and is
    actively harmful (relin storms destabilise fr1desk); the sweep's own
    lazy trigger recaptures once the jump re-quiesces.
    """
    degc, degl = degs
    cam_deta = pl.pack_vec(pl.matvec(pl.unpack_sym(state.cam_lam, 6),
                                     pl.unpack_vec(dc_mu, 6)))
    lmk_deta = pl.pack_vec(pl.matvec(pl.unpack_sym(state.lmk_lam, 3),
                                     pl.unpack_vec(dl_mu, 3)))
    cam_deta = jnp.where(jnp.isfinite(cam_deta) & (degc > 0)[None],
                         cam_deta, 0.0)
    lmk_deta = jnp.where(jnp.isfinite(lmk_deta) & (degl > 0)[None],
                         lmk_deta, 0.0)
    return cam_deta, lmk_deta


def _cand_means(state: GBPState, cam_deta, lmk_deta, scale: float):
    """Belief means of the shift candidate (eta + scale * deta at fixed
    Lambda) — EXACTLY the means the applied candidate (_apply_shift) will
    have, solved per variable (O(C+L)). Pricing the cost guard at these
    means (rather than at the analytic mu + Sigma @ deta) keeps the
    monotone-acceptance guarantee exact even for ill-conditioned beliefs
    (desk-style Huber storms), where the analytic proxy can be off by far
    more than rounding."""
    cam = pl.pack_vec(pl.solve_sym(
        pl.unpack_sym(state.cam_lam, 6),
        pl.unpack_vec(state.cam_eta + scale * cam_deta, 6)))
    lmk = pl.pack_vec(pl.matvec(
        pl.inv_sym3(pl.unpack_sym(state.lmk_lam, 3)),
        pl.unpack_vec(state.lmk_eta + scale * lmk_deta, 3)))
    return cam, lmk


def _shift_gather(graph: GBPGraph, cfg: GBPConfig, cam_groups, lmk_groups):
    """ONE stacked gather per variable kind for a chunk-boundary shift
    trial: per-edge rows of the current means, each candidate's exact
    means, and the per-message eta-correction SHARES (deta/degree) —
    everything the candidate costs AND the acceptance application need,
    instead of six-plus separate takes per chunk."""
    gc = _edge_gather(jnp.concatenate(cam_groups), graph.cam_idx)
    gl = _edge_gather(jnp.concatenate(lmk_groups), graph.lmk_idx)
    cs = [g.shape[0] for g in cam_groups]
    ls = [g.shape[0] for g in lmk_groups]
    co = [sum(cs[:i]) for i in range(len(cs) + 1)]
    lo = [sum(ls[:i]) for i in range(len(ls) + 1)]
    return ([gc[a:b] for a, b in zip(co, co[1:])],
            [gl[a:b] for a, b in zip(lo, lo[1:])])


def _msg_shares(cam_deta, lmk_deta, degs):
    """Per-message eta-correction shares (deta/active-degree)."""
    degc, degl = degs
    cshare = jnp.where(degc > 0, 1.0 / jnp.maximum(degc, 1.0), 0.0)[None]
    lshare = jnp.where(degl > 0, 1.0 / jnp.maximum(degl, 1.0), 0.0)[None]
    return cam_deta * cshare, lmk_deta * lshare


def _apply_shift(state: GBPState, dmsg_c, dmsg_l, cam_deta, lmk_deta,
                 gain) -> GBPState:
    """Apply ``gain`` times the shift: messages pick up their O(1/degree)
    share of the eta correction (``dmsg_*`` are the gathered per-edge
    shares), beliefs the full correction directly — the next sweep's
    belief reduction re-establishes belief = prior + sum(messages) to fp
    exactness. ``gain`` 0 must be an exact no-op (the traced-offset gated
    path relies on it), hence the select. ``gain`` must be >= 0: the
    liveness gate is ``gain > 0``, so a negative (reversed) shift would
    silently no-op rather than apply."""
    act = (state.active > 0).astype(cam_deta.dtype)[None]
    live = gain > 0
    upd = lambda old, d: jnp.where(live, old + gain * d, old)  # noqa: E731
    return state._replace(
        msg_c_eta=upd(state.msg_c_eta, act * dmsg_c),
        msg_l_eta=upd(state.msg_l_eta, act * dmsg_l),
        cam_eta=upd(state.cam_eta, cam_deta),
        lmk_eta=upd(state.lmk_eta, lmk_deta))


def _combine_costs(parts, axis_name: str | None, lmk_sharded: bool):
    """Total each (robust, cam_prior, lmk_prior) triple into a cost vector,
    psum-ing the sharded terms of ALL candidates in ONE collective (edges
    are always sharded; landmark priors only in map mode; camera priors
    are replicated in both sharding modes)."""
    robust = jnp.stack([p[0] for p in parts])
    lmk_prior = jnp.stack([p[2] for p in parts])
    if axis_name is not None:
        if lmk_sharded:
            robust, lmk_prior = jax.lax.psum((robust, lmk_prior), axis_name)
        else:
            robust = jax.lax.psum(robust, axis_name)
    cam_prior = jnp.stack([p[1] for p in parts])
    return robust + cam_prior + lmk_prior


def _coarse_step(
    state: GBPState, graph: GBPGraph, cfg: GBPConfig, degs,
    axis_name: str | None, lmk_sharded: bool,
    cost: jax.Array | None = None, live=None,
) -> GBPState:
    """Coarse-space correction (core/coarse.py): solve the MAP increment in
    the per-group rigid subspace and apply it if the cost decreases.
    Vanishes at the MAP fixed point (zero coarse gradient). ``cost`` is the
    caller's already-computed map_cost of ``state``, threaded through from
    _accel_step so a chunk boundary evaluates each candidate once. ``live``
    (traced bool or None = statically live) folds the caller's
    accel-window gate into the acceptance, replacing a full-state select
    outside.

    Both scale candidates are priced at their EXACT means (_cand_means:
    the means the applied candidate will have) from one stacked gather
    (_shift_gather) and the chosen scale is applied once (_apply_shift)
    — no candidate state, belief re-reduction or full-state select is
    materialised."""
    from . import coarse

    cam_mu, lmk_mu = _variable_means(state)
    d_cam, d_lmk = coarse.coarse_increment(
        state, graph, cfg, cam_mu, lmk_mu, axis_name, lmk_sharded)
    cam_deta, lmk_deta = _mean_shift_etas(state, d_cam, d_lmk, degs)
    dmsg_c, dmsg_l = _msg_shares(cam_deta, lmk_deta, degs)
    scales = (1.0, 0.3)
    cands = [_cand_means(state, cam_deta, lmk_deta, s) for s in scales]
    # gather the CURRENT means only when the caller didn't price them
    # (production always threads cost=...; keeping dead mu groups in the
    # stacked gather wastes ~a quarter of its bytes per chunk boundary)
    mu_groups = int(cost is None)
    cg, lg = _shift_gather(
        graph, cfg,
        [cam_mu] * mu_groups + [c for c, _ in cands] + [dmsg_c],
        [lmk_mu] * mu_groups + [l for _, l in cands] + [dmsg_l])
    parts = []
    if cost is None:
        parts.append(_cost_parts(state, graph, cfg, cg[0], lg[0],
                                 cam_mu, lmk_mu))
    for i, (cand_c, cand_l) in enumerate(cands):
        parts.append(_cost_parts(state, graph, cfg,
                                 cg[mu_groups + i], lg[mu_groups + i],
                                 cand_c, cand_l))
    costs = _combine_costs(parts, axis_name, lmk_sharded)
    if cost is None:
        best_cost, costs = costs[0], costs[1:]
    else:
        best_cost = cost
    gain = jnp.zeros((), cam_mu.dtype)
    for s, c in zip(scales, costs):
        better = c < best_cost
        if live is not None:
            better = better & live
        gain = jnp.where(better, jnp.asarray(s, cam_mu.dtype), gain)
        best_cost = jnp.where(better, c, best_cost)
    return _apply_shift(state, cg[-1], lg[-1], cam_deta, lmk_deta, gain)


def _accel_step(
    state: GBPState, snap, avg, graph: GBPGraph, cfg: GBPConfig, degs,
    axis_name: str | None, lmk_sharded: bool, live=None,
):
    """One fixed-point extrapolation at a chunk boundary.

    The post-annealing convergence error is dominated by a near-gauge mode
    (the whole map drifting toward the weak prior means) contracting at
    1-eps per sweep — hundreds of sweeps per error decade. Successive
    chunk-boundary displacements d_k of the belief means satisfy
    d_k ~ r d_{k-1}, so the remaining error is d_k * r/(1-r): jumping by it
    lands near the extrapolated limit, and the correction vanishes at the
    fixed point (d -> 0), so the solver's fixed point is unchanged.

    The jump is realised on the eta state (_mean_shift_etas/_apply_shift):
    each variable's belief-eta correction Lambda_v * g * dmu_v is split
    equally over its active incident messages (so the per-message
    perturbation stays O(1/degree) and is relaxed by subsequent sweeps)
    and added to the belief directly — the next sweep's reduction
    re-establishes belief = prior + sum(messages) exactly.
    (Extrapolating raw message deltas does NOT work: they are dominated
    by staggered relinearisation jumps, not the smooth mode.)

    Safety: the rate is estimated on camera-mean deltas (replicated under
    both sharding modes — no collective), trusted only when successive
    deltas are strongly aligned; the jump is trust-region capped; and the
    extrapolated state is only ACCEPTED if the on-device MAP cost does not
    increase — acceleration is monotone in the objective. Both costs are
    priced from ONE stacked gather per variable kind at the candidate's
    EXACT means (_cand_means — what _apply_shift realises; an analytic
    mu + Sigma @ deta proxy was tried and measurably weakens the guard
    for ill-conditioned beliefs) — no per-candidate take, belief
    re-reduction or full-state acceptance select.

    The displacement is measured between CHUNK-AVERAGED means (``avg``),
    not endpoint means: never-quiescing edge clusters superimpose an
    oscillation on the smooth drift that buries the mode in endpoint
    deltas (measured cos^2 < 0.5 on fr1desk); averaging over a chunk
    cancels the oscillation and leaves the drift.

    ``snap`` = (avg_cam_prev, avg_lmk_prev, cam_dmu_prev). ``live``
    (traced bool, or None = statically live) is the caller's accel-window
    gate (it_end >= accel_start), folded into the acceptance so a gated
    chunk needs no full-state select outside this function.
    """
    cam_mu_prev, lmk_mu_prev, dmu_prev = snap
    avg_cam, avg_lmk = avg
    degc, degl = degs
    dc_mu = avg_cam - cam_mu_prev
    dl_mu = avg_lmk - lmk_mu_prev
    # weakly-constrained landmarks can have transiently singular beliefs;
    # never extrapolate a non-finite row
    dl_mu = jnp.where(jnp.isfinite(dl_mu), dl_mu, 0.0)

    num = jnp.sum(dc_mu * dmu_prev)
    den = jnp.sum(dmu_prev * dmu_prev)
    cur = jnp.sum(dc_mu * dc_mu)
    safe_den = jnp.where(den > 0, den, 1.0)
    r = jnp.where(den > 0, num / safe_den, 0.0)
    cos2 = jnp.where((den > 0) & (cur > 0),
                     (num * num) / (safe_den * jnp.where(cur > 0, cur, 1.0)),
                     0.0)
    aligned = (cos2 > 0.8) & (r > 0.1) & jnp.all(jnp.isfinite(dc_mu))
    r = jnp.clip(r, 0.0, cfg.accel_max_rate)
    gain = jnp.where(aligned, r / (1.0 - r), 0.0)
    # trust region: no camera mean moves more than accel_max_step
    step = gain * jnp.sqrt(jnp.max(jnp.sum(dc_mu * dc_mu, axis=0)))
    gain = gain * jnp.minimum(1.0, cfg.accel_max_step / jnp.maximum(
        step, 1e-30))

    cam_deta, lmk_deta = _mean_shift_etas(state, gain * dc_mu,
                                          gain * dl_mu, degs)
    dmsg_c, dmsg_l = _msg_shares(cam_deta, lmk_deta, degs)
    cam_mu, lmk_mu = _variable_means(state)
    cand_c, cand_l = _cand_means(state, cam_deta, lmk_deta, 1.0)
    cg, lg = _shift_gather(graph, cfg, [cam_mu, cand_c, dmsg_c],
                           [lmk_mu, cand_l, dmsg_l])
    cost_cur, cost_cand = _combine_costs(
        [_cost_parts(state, graph, cfg, cg[0], lg[0], cam_mu, lmk_mu),
         _cost_parts(state, graph, cfg, cg[1], lg[1], cand_c, cand_l)],
        axis_name, lmk_sharded)
    better = cost_cand <= cost_cur
    if live is not None:
        better = better & live
    g = jnp.where(better, jnp.ones((), cam_mu.dtype), 0.0)
    state = _apply_shift(state, cg[2], lg[2], cam_deta, lmk_deta, g)

    # next chunk's averages are measured from the accepted state's frame:
    # shift the stored averages by the applied jump so the following delta
    # is drift, not the jump echo
    jump_c = jnp.where(better, gain * dc_mu, 0.0)
    jump_l = jnp.where(better, gain * dl_mu, 0.0)
    dmu_out = (dc_mu if live is None
               else jnp.where(live, dc_mu, dmu_prev))
    snap = (avg_cam + jump_c, avg_lmk + jump_l, dmu_out)
    return state, snap, jnp.where(better, cost_cand, cost_cur)


def run_gbp(
    state: GBPState,
    graph: GBPGraph,
    cfg: GBPConfig,
    n_iters: int,
    with_diagnostics: bool = True,
    iter_offset: jax.Array | int = 0,
    axis_name: str | None = None,
    lmk_sharded: bool = False,
    warm: int | None = None,
    verbose_means: bool = False,
):
    """Run `n_iters` GBP iterations on device.

    Returns (final_state, Diagnostics stacked over iterations) — the per-iter
    telemetry the reference prints from the host each sweep
    (reference: ba/ba.cpp:1022-1028) without any per-iter host round-trip.
    ``verbose_means`` additionally stacks the per-iteration camera belief
    means into ``Diagnostics.cam_means`` (the drivers' --v; matches the
    reference's per-iteration belief stream, ba/ba.cpp:1030-1051).

    With ``cfg.accel_every > 0`` the loop runs as chunks of that many sweeps
    with a fixed-point extrapolation step at each chunk boundary
    (``_accel_step``) — the hot per-sweep path is unchanged; all accelerator
    work happens once per chunk.

    The masked prior-annealing step costs ~8 small ops per sweep, but
    weaken flags are only ever SET at a solve's local iteration 0 (batch
    init or SLAM insertion) and are provably exhausted after 2*steps
    iterations; when ``iter_offset`` is a static int, annealing runs only
    for that warmup and the remaining sweeps skip it entirely.

    ``warm`` overrides that warmup length STATICALLY while leaving
    ``iter_offset`` free to be a traced value — the chunked CLI drivers
    need this: with a traced offset alone, every sweep would run the
    annealing body and the accel/coarse chunk path below would be
    unreachable (the offset only ever feeds traced comparisons once the
    warmup split is pinned).
    """

    def sweep_body(anneal):
        def body(s, i):
            if anneal:
                s = iteration(s, graph, cfg, i + iter_offset, axis_name,
                              lmk_sharded)
            else:
                s = gbp_sweep(s, graph, cfg, axis_name, lmk_sharded)
            out = (diagnostics(s, graph, cfg, axis_name, verbose_means)
                   if with_diagnostics else None)
            return s, out
        return body

    if warm is None:
        warm = (n_iters if not isinstance(iter_offset, int)
                else min(n_iters, max(0, 2 * cfg.steps - iter_offset)))
    else:
        warm = min(n_iters, max(0, warm))
    diag_parts = []
    if warm:
        state, dw = jax.lax.scan(sweep_body(True), state, jnp.arange(warm))
        diag_parts.append(dw)
    n2 = n_iters - warm
    off2 = iter_offset + warm
    # Hot sweeps are only reached with a STATIC iter_offset or an explicit
    # static ``warm`` (a traced offset alone forces warm == n_iters and
    # the early return below), so every hot sweep is anneal-free; a traced
    # off2 is fine — it only feeds the traced accel_start comparison.
    def hot_scan(s, n, collect_means):
        """``n`` anneal-free sweeps. Returns (state, diag, chunk-summed
        means or None)."""
        zero_means = (jnp.zeros((6, graph.n_keyframes), s.cam_eta.dtype),
                      jnp.zeros((3, graph.n_points), s.cam_eta.dtype))

        def body(carry, _):
            st, ac, al = carry
            st = gbp_sweep(st, graph, cfg, axis_name, lmk_sharded)
            out = (diagnostics(st, graph, cfg, axis_name, verbose_means)
                   if with_diagnostics else None)
            if collect_means:
                # a singular belief's mean contributes nothing (whole
                # column zeroed)
                mc, ml = _sanitize_means(*_variable_means(st))
                ac, al = ac + mc, al + ml
            return (st, ac, al), out

        (s, ac, al), diag = jax.lax.scan(
            body, (s, *zero_means), None, length=n)
        return s, diag, ((ac, al) if collect_means else None)

    ce = cfg.accel_every

    def finish(diag_parts):
        if not with_diagnostics or not diag_parts:   # n_iters == 0 -> None
            return None
        if len(diag_parts) == 1:
            return diag_parts[0]
        return jax.tree.map(lambda *xs: jnp.concatenate(xs), *diag_parts)

    if n2 == 0:
        return state, finish(diag_parts)
    if ce <= 0 or n2 < 2 * ce:
        state, dh, _ = hot_scan(state, n2, False)
        diag_parts.append(dh)
        return state, finish(diag_parts)

    n_chunks = n2 // ce
    rem = n2 - n_chunks * ce
    degs = _active_degrees(state, graph, axis_name, lmk_sharded)

    # Static dead-chunk elision: with a static offset, chunks whose accel
    # step cannot fire (it_end < accel_start) run as PLAIN hot scans — the
    # gated path would compute the full accel step (stacked shift-trial
    # gathers + two analytic cost evaluations) and discard it. Only the
    # LAST dead chunk collects means, seeding
    # `snap` exactly as the gated path would (its dmu entry stays zero
    # through dead chunks).
    static_off = isinstance(off2, int)
    n_dead = 0
    if static_off:
        n_dead = min(n_chunks,
                     max(0, -(-(cfg.accel_start - ce - off2) // ce)))
    if n_dead:
        if n_dead > 1:
            state, d0, _ = hot_scan(state, (n_dead - 1) * ce, False)
            if with_diagnostics:
                diag_parts.append(d0)
        state, d1, sums = hot_scan(state, ce, True)
        if with_diagnostics:
            diag_parts.append(d1)
        avg_c, avg_l = sums[0] / ce, sums[1] / ce
        snap0 = (avg_c, avg_l, jnp.zeros_like(avg_c))
    else:
        cam_mu0, lmk_mu0 = _variable_means(state)
        snap0 = (cam_mu0, lmk_mu0, jnp.zeros_like(cam_mu0))
    n_live = n_chunks - n_dead

    def chunk_body(carry, c):
        s, snap = carry

        # Chunk-AVERAGED means for the rate estimate, ALWAYS (cancels edge
        # oscillation — endpoint deltas have cos^2 < 0.5 on fr1desk, see
        # _accel_step). The accumulation must not depend on
        # with_diagnostics, or a telemetry flag would change the accepted
        # jumps and hence the solver's trajectory.
        s, diag, sums = hot_scan(s, ce, True)
        avg = (sums[0] / ce, sums[1] / ce)
        # post-elision chunks are statically live; with a TRACED offset the
        # gate rides inside the acceptance of the accel/coarse steps
        live = (None if static_off
                else (c * ce + ce + off2) >= cfg.accel_start)
        s, snap, cost2 = _accel_step(s, snap, avg, graph, cfg, degs,
                                     axis_name, lmk_sharded, live=live)
        if cfg.coarse_groups > 0:
            s = _coarse_step(s, graph, cfg, degs, axis_name, lmk_sharded,
                             cost=cost2, live=live)
        return (s, snap), diag

    if n_live:
        (state, _), diag = jax.lax.scan(chunk_body, (state, snap0),
                                        jnp.arange(n_dead, n_chunks))
        if with_diagnostics:
            diag = jax.tree.map(
                lambda x: x.reshape((n_live * ce,) + x.shape[2:]), diag)
            diag_parts.append(diag)
    if rem:
        state, diag_rem, _ = hot_scan(state, rem, False)
        if with_diagnostics:
            diag_parts.append(diag_rem)
    return state, finish(diag_parts)


def solve(
    problem_state: GBPState,
    graph: GBPGraph,
    cfg: GBPConfig,
    n_iters: int | None = None,
    axis_name: str | None = None,
    lmk_sharded: bool = False,
):
    """Full batch-BA solve: initialise + scan. Jit-compatible end to end."""
    n = cfg.n_iters if n_iters is None else n_iters
    state = initialise(problem_state, graph, cfg, axis_name, lmk_sharded)
    return run_gbp(state, graph, cfg, n, axis_name=axis_name,
                   lmk_sharded=lmk_sharded)
