"""Coarse-space correction for GBP bundle adjustment (multigrid-style).

Message passing resolves local geometry in tens of sweeps, but smooth
low-frequency error — the whole trajectory bending or drifting against the
annealed weak priors — relaxes diffusively (information crosses the graph
one edge per sweep), taking thousands of sweeps on the longer TUM sequences.
This is the classic smooth-mode bottleneck of local relaxation, and the
classic cure is a coarse space: solve the MAP increment EXACTLY in a small
subspace spanned by per-group rigid motions, where the smooth modes live.

Construction:
  - keyframes are split into `n_groups` contiguous groups; every landmark
    joins the group of its first observing keyframe (graph.first_kf);
  - group g contributes 6 basis directions = the rigid motion G(xi) of the
    group's world content: landmarks move y -> y + xi_t + xi_w x y, cameras
    compose T_w2c -> T_w2c . G(xi)^-1 (the per-camera parameter derivative
    S_i is computed exactly by vmapped jacfwd through the SE(3) composition
    — no hand-derived adjoints);
  - the reduced 6G x 6G Gauss-Newton system (Huber-IRLS weights, current
    annealed priors) is assembled with batched per-edge matmuls +
    segment-sums — the same dense-batch layout as the GN baseline — and
    solved with one tiny dense factorisation;
  - the increment is realised on the message state (each variable's
    belief-eta correction split over its active incident messages) and
    ACCEPTED only if the on-device MAP cost decreases, trying a few step
    scales. At the MAP fixed point the coarse gradient vanishes, so the
    correction is exactly zero — GBP's fixed point is unchanged.

Everything is jit-compatible and runs on device once per accel chunk
(core/gbp.run_gbp); cost is ~one sweep's worth of work per `accel_every`
sweeps. The reference has no equivalent (it simply runs 1500 sweeps and
accepts the residual drift); this addition is enabled by the dense
batched layout.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import GBPConfig
from ..ops import lie, linalg, planes as pl, projection
from .factor_graph import GBPGraph, GBPState

RIGID_DOF = 6
_HI = jax.lax.Precision.HIGHEST


def _cam_rigid_basis(cam_mu: jax.Array) -> jax.Array:
    """d(params of T_w2c . G(xi)^-1)/d(xi) at xi = 0, per camera.

    cam_mu: [C, 6] (t, w). Returns S [C, 6, 6] mapping a world rigid motion
    (xi_t, xi_w) of the camera's group to the camera's parameter change.
    """

    def composed(x, xi):
        r = lie.so3_exp(x[3:])
        t = x[:3]
        rg = lie.so3_exp(xi[3:])
        # world content moves by G: p -> rg p + xi_t, so the SAME physical
        # camera in new coordinates is T_w2c . G^-1:
        #   x_c = R (rg^T (p' - xi_t)) + t
        rn = jnp.matmul(r, rg.T, precision=_HI)
        tn = t - jnp.matmul(rn, xi[:3], precision=_HI)
        return jnp.concatenate([tn, lie.so3_log(rn)])

    zero = jnp.zeros((RIGID_DOF,), cam_mu.dtype)
    return jax.vmap(lambda x: jax.jacfwd(composed, argnums=1)(x, zero))(
        cam_mu)


def _lmk_rigid_basis(lmk_mu: jax.Array) -> jax.Array:
    """[L, 3, 6]: dy/dxi for y -> y + xi_t + xi_w x y = [I3 | -hat(y)]."""
    l = lmk_mu.shape[0]
    eye = jnp.broadcast_to(jnp.eye(3, dtype=lmk_mu.dtype), (l, 3, 3))
    return jnp.concatenate([eye, -jax.vmap(lie.so3_hat)(lmk_mu)], axis=-1)


def _sym_planes_to_dense(packed: jax.Array, d: int) -> jax.Array:
    # plane rows come back (1, N) — flatten to [N] before stacking dense
    rows = pl.unpack_sym(packed, d)
    return jnp.stack(
        [jnp.stack([rows[i][j].reshape(-1) for j in range(d)], axis=-1)
         for i in range(d)], axis=-2)                # [N, d, d]


def coarse_increment(
    state: GBPState, graph: GBPGraph, cfg: GBPConfig,
    cam_mu: jax.Array, lmk_mu: jax.Array,
    axis_name: str | None = None, lmk_sharded: bool = False,
) -> tuple[jax.Array, jax.Array]:
    """Solve the reduced Gauss-Newton system over per-group rigid modes.

    cam_mu [6, C] / lmk_mu [3, L] are the current belief means in plane
    layout. Returns (delta_cam [6, C], delta_lmk [3, L]) parameter
    increments (zero where the coarse gradient is zero).
    """
    g = cfg.coarse_groups
    c, l = graph.n_keyframes, graph.n_points
    camr = cam_mu.T                                   # [C, 6] row-major
    lmkr = lmk_mu.T                                   # [L, 3]
    camr = jnp.where(jnp.isfinite(camr), camr, 0.0)
    lmkr = jnp.where(jnp.isfinite(lmkr), lmkr, 0.0)

    g_cam = (jnp.arange(c) * g) // c                  # [C]
    g_lmk = jnp.minimum((graph.first_kf * g) // c, g - 1)   # [L]

    s_cam = _cam_rigid_basis(camr)                    # [C, 6, 6]
    s_cam = jnp.where(jnp.isfinite(s_cam), s_cam, 0.0)
    s_lmk = _lmk_rigid_basis(lmkr)                    # [L, 3, 6]

    # --- per-edge reduced Jacobians and residuals (Huber-IRLS weights) ---
    cam_e = camr[graph.cam_idx]                       # [E, 6]
    lmk_e = lmkr[graph.lmk_idx]                       # [E, 3]
    intr_e = None if graph.intr is None else graph.intr.T
    j_c, j_l = projection.reproj_jacobians(cam_e, lmk_e, graph.k, intr_e)
    r = graph.meas.T - projection.project(cam_e, lmk_e, graph.k,
                                          intr_e)    # [E, 2]
    err = jnp.linalg.norm(r, axis=-1)
    var, _ = projection.huber_meas_var(err, graph.meas_var, cfg.huber_nstds)
    # one degenerate edge (landmark grazing the camera plane: j ~ fx/z
    # explodes) must poison only ITSELF, not the reduced system — its 1e20+
    # contributions would otherwise dominate or NaN the assembled solve and
    # the ok-guard below would silently zero the ENTIRE correction.
    # Deactivate such edges (the sweep's own min_depth Jacobian-singularity
    # guard, applied at the coarse level) and zero their operands outright.
    z_cf = lie.w2c_apply(cam_e, lmk_e)[..., 2]
    act = ((state.active > 0) & jnp.all(jnp.isfinite(r), axis=-1)
           & (jnp.abs(z_cf) > cfg.min_depth)
           & jnp.all(jnp.isfinite(j_c), axis=(-2, -1))
           & jnp.all(jnp.isfinite(j_l), axis=(-2, -1)))
    w = jnp.where(act, 1.0 / var, 0.0)[:, None, None]              # [E,1,1]
    r = jnp.where(act[:, None], r, 0.0)

    m = act[:, None, None]
    b_c = jnp.where(m, linalg.bmm(j_c, s_cam[graph.cam_idx]), 0.0)  # [E,2,6]
    b_l = jnp.where(m, linalg.bmm(j_l, s_lmk[graph.lmk_idx]), 0.0)  # [E,2,6]
    ga = g_cam[graph.cam_idx]
    gb = g_lmk[graph.lmk_idx]

    # block contributions: A[ga,ga], A[gb,gb], A[ga,gb] (+sym), rhs; a
    # finite-but-huge Jacobian can still overflow the PRODUCTS to inf —
    # sanitise per edge so the damage stays local
    def _fin(x):
        return jnp.where(jnp.isfinite(x), x, 0.0)

    aa = _fin(linalg.bmm(linalg.transpose(b_c), b_c) * w)
    bb = _fin(linalg.bmm(linalg.transpose(b_l), b_l) * w)
    ab = _fin(linalg.bmm(linalg.transpose(b_c), b_l) * w)
    rc = _fin(linalg.bmv(linalg.transpose(b_c), r) * w[..., 0])
    rl = _fin(linalg.bmv(linalg.transpose(b_l), r) * w[..., 0])

    a = jnp.zeros((g * g, RIGID_DOF, RIGID_DOF), camr.dtype)
    a = a + jax.ops.segment_sum(aa, ga * g + ga, num_segments=g * g)
    a = a + jax.ops.segment_sum(bb, gb * g + gb, num_segments=g * g)
    # cross block (ga, gb) and its transpose into (gb, ga)
    a = a + jax.ops.segment_sum(ab, ga * g + gb, num_segments=g * g)
    a = a + jax.ops.segment_sum(linalg.transpose(ab), gb * g + ga,
                                num_segments=g * g)
    rhs = (jax.ops.segment_sum(rc, ga, num_segments=g)
           + jax.ops.segment_sum(rl, gb, num_segments=g))          # [G, 6]

    if axis_name is not None:
        a, rhs = jax.lax.psum((a, rhs), axis_name)

    # --- prior terms (gradient + curvature of the annealed priors) ---
    lam_c = _sym_planes_to_dense(state.cam_prior_lam, 6)           # [C,6,6]
    eta_c = state.cam_prior_eta.T                                  # [C, 6]
    grad_c = eta_c - linalg.bmv(lam_c, camr)                       # [C, 6]
    pa_c = linalg.bmm(linalg.transpose(s_cam), linalg.bmm(lam_c, s_cam))
    pb_c = linalg.bmv(linalg.transpose(s_cam), grad_c)
    a_pc = jax.ops.segment_sum(pa_c, g_cam * g + g_cam, num_segments=g * g)
    r_pc = jax.ops.segment_sum(pb_c, g_cam, num_segments=g)

    lam_l = _sym_planes_to_dense(state.lmk_prior_lam, 3)           # [L,3,3]
    eta_l = state.lmk_prior_eta.T
    grad_l = eta_l - linalg.bmv(lam_l, lmkr)
    pa_l = linalg.bmm(linalg.transpose(s_lmk), linalg.bmm(lam_l, s_lmk))
    pb_l = linalg.bmv(linalg.transpose(s_lmk), grad_l)
    a_pl = jax.ops.segment_sum(pa_l, g_lmk * g + g_lmk, num_segments=g * g)
    r_pl = jax.ops.segment_sum(pb_l, g_lmk, num_segments=g)
    if axis_name is not None and lmk_sharded:
        # landmark axis is sharded in map mode; camera priors are replicated
        a_pl, r_pl = jax.lax.psum((a_pl, r_pl), axis_name)
    a = a + a_pc + a_pl
    rhs = rhs + r_pc + r_pl

    # --- assemble dense [6G, 6G], damp, solve ---
    a_dense = a.reshape(g, g, 6, 6).transpose(0, 2, 1, 3).reshape(
        g * 6, g * 6)
    diag = jnp.diag(a_dense)
    damp = 1e-3 * jnp.maximum(diag, 1e-8) + 1e-8
    a_dense = a_dense + jnp.diag(damp)
    ok = jnp.all(jnp.isfinite(a_dense)) & jnp.all(jnp.isfinite(rhs))
    a_dense = jnp.where(ok, a_dense, jnp.eye(g * 6, dtype=a_dense.dtype))
    rhs_flat = jnp.where(ok, rhs.reshape(-1), 0.0)
    xi = jax.scipy.linalg.solve(a_dense, rhs_flat, assume_a="pos")
    xi = jnp.where(jnp.isfinite(xi), xi, 0.0).reshape(g, 6)

    d_cam = linalg.bmv(s_cam, xi[g_cam])               # [C, 6]
    d_lmk = linalg.bmv(s_lmk, xi[g_lmk])               # [L, 3]
    return d_cam.T, d_lmk.T
