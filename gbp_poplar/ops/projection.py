"""Reprojection measurement model, analytic Jacobians, Huber robustification
and factor-potential assembly.

Batched equivalents of the reference's device measurement code
(ba/bafuncs.cpp:82-213) and the factor-relinearisation body shared by
``RelineariseFactorVertex`` / ``PrepMessageVertex``
(ba/gbp_codelets.cpp:38-171, 285-374). Everything is batched over a leading
edge axis and branch-free so one fused XLA computation handles every factor.

Camera intrinsics are a single shared pinhole ``K = [[fx,0,cx],[0,fy,cy],[0,0,1]]``
(reference: ba/ba.cpp:494-501). Pose convention: ``x = [t, w]`` with
``y_cam = exp(w^) y_world + t``.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

_PREC = jax.lax.Precision.HIGHEST

from . import lie

_SMALL_THETA_SQ = 1e-12


def project(cam: jax.Array, lmk: jax.Array, k: jax.Array,
            intr: jax.Array | None = None) -> jax.Array:
    """Measurement function h(x): pixel coords of landmark seen by camera.

    (reference: ba/bafuncs.cpp:82-103)

    Args:
      cam: [..., 6] pose (t, w).
      lmk: [..., 3] world point.
      k:   [3, 3] intrinsics (shared pinhole), ignored when ``intr`` given.
      intr: [..., 3] per-edge Snavely/BAL intrinsics (f, k1, k2): the
        camera looks down -z and uv = f (1 + k1 r^2 + k2 r^4) p with
        p = -(x/z, y/z). No principal point (BAL pixels are centred).
    Returns: [..., 2] (u, v).
    """
    y_cf = lie.w2c_apply(cam, lmk)
    if intr is None:
        u = k[0, 0] * (y_cf[..., 0] / y_cf[..., 2]) + k[0, 2]
        v = k[1, 1] * (y_cf[..., 1] / y_cf[..., 2]) + k[1, 2]
        return jnp.stack([u, v], axis=-1)
    p = -y_cf[..., :2] / y_cf[..., 2:3]
    rho = jnp.sum(p * p, axis=-1, keepdims=True)
    dist = 1.0 + rho * (intr[..., 1:2] + intr[..., 2:3] * rho)
    return intr[..., 0:1] * dist * p


def _proj_jacobian(y_cf: jax.Array, k: jax.Array,
                   intr: jax.Array | None = None) -> jax.Array:
    """d(u,v)/d(y_cam): [..., 2, 3] (reference: ba/bafuncs.cpp:134-140;
    with ``intr``, the Snavely-model chain rule through the distortion)."""
    z = y_cf[..., 2]
    inv_z = 1.0 / z
    inv_z2 = inv_z * inv_z
    zero = jnp.zeros_like(z)
    if intr is None:
        fx, fy = k[0, 0], k[1, 1]
        row_u = jnp.stack([fx * inv_z, zero, -fx * y_cf[..., 0] * inv_z2],
                          axis=-1)
        row_v = jnp.stack([zero, fy * inv_z, -fy * y_cf[..., 1] * inv_z2],
                          axis=-1)
        return jnp.stack([row_u, row_v], axis=-2)
    f, d1, d2 = intr[..., 0], intr[..., 1], intr[..., 2]
    px = -y_cf[..., 0] * inv_z
    py = -y_cf[..., 1] * inv_z
    rho = px * px + py * py
    dist = 1.0 + rho * (d1 + d2 * rho)
    g = d1 + 2.0 * d2 * rho
    dpx = jnp.stack([-inv_z, zero, y_cf[..., 0] * inv_z2], axis=-1)
    dpy = jnp.stack([zero, -inv_z, y_cf[..., 1] * inv_z2], axis=-1)
    drho = 2.0 * (px[..., None] * dpx + py[..., None] * dpy)
    row_u = f[..., None] * (dist[..., None] * dpx
                            + (px * g)[..., None] * drho)
    row_v = f[..., None] * (dist[..., None] * dpy
                            + (py * g)[..., None] * drho)
    return jnp.stack([row_u, row_v], axis=-2)


def reproj_jacobians(
    cam: jax.Array, lmk: jax.Array, k: jax.Array,
    intr: jax.Array | None = None,
) -> tuple[jax.Array, jax.Array]:
    """Analytic Jacobians of the reprojection h(x) wrt pose and landmark.

    Mirrors the device `Jac` (reference: ba/bafuncs.cpp:106-213):
      - J_lmk = J_proj @ R                                     [..., 2, 3]
      - J_kf[:, :3] = J_proj (translation block)               [..., 2, 6]
      - J_kf[:, 3:] = J_proj @ dRy/dw using the global axis-angle derivative
        dRy/dw = -R ŷ ((R^T - I) ŵ + w w^T) / ||w||^2   (bafuncs.cpp:152-206)

    The reference formula divides by ||w||^2 without a guard; here small-angle
    poses fall back to the exact limit ``dRy/dw -> -hat(y)`` (R -> I) so the
    batched computation stays finite everywhere.
    """
    r, _ = lie.pose_to_rt(cam)
    y_cf = lie.w2c_apply(cam, lmk)
    j_proj = _proj_jacobian(y_cf, k, intr)

    j_lmk = jnp.einsum("...ij,...jk->...ik", j_proj, r, precision=_PREC)

    w = cam[..., 3:6]
    w_hat = lie.so3_hat(w)
    y_hat = lie.so3_hat(lmk)
    ww = w[..., :, None] * w[..., None, :]
    rt_minus_i = jnp.swapaxes(r, -1, -2) - jnp.eye(3, dtype=cam.dtype)
    numerator = jnp.einsum("...ij,...jk->...ik", rt_minus_i, w_hat, precision=_PREC) + ww
    r_yhat = jnp.einsum("...ij,...jk->...ik", r, y_hat, precision=_PREC)
    theta_sq = jnp.sum(w * w, axis=-1)
    small = theta_sq < _SMALL_THETA_SQ
    denom = jnp.where(small, 1.0, theta_sq)
    d_ry_dw = -jnp.einsum("...ij,...jk->...ik", r_yhat, numerator, precision=_PREC) / denom[..., None, None]
    # Limit w -> 0: d(R y)/dw = -hat(y).
    d_ry_dw = jnp.where(small[..., None, None], -y_hat, d_ry_dw)

    j_rot = jnp.einsum("...ij,...jk->...ik", j_proj, d_ry_dw, precision=_PREC)
    j_kf = jnp.concatenate([j_proj, j_rot], axis=-1)
    return j_kf, j_lmk


def reproj_jacobian_local(
    cam: jax.Array, lmk: jax.Array, k: jax.Array,
    intr: jax.Array | None = None,
) -> jax.Array:
    """Host-style 2x9 Jacobian with the local rotation perturbation.

    Mirrors ``reprojectionJacFn`` (reference: ba/util.cpp:48-72), which uses
    ``dR(w)y/dw ~= -hat(R y)`` — used only for prior-strength estimation
    (set_prior_lambda, ba/dataio.cpp:67-117), not in the solver itself.
    Returns [..., 2, 9] ordered (translation, rotation, landmark).
    """
    r, _ = lie.pose_to_rt(cam)
    y_cf = lie.w2c_apply(cam, lmk)
    j_proj = _proj_jacobian(y_cf, k, intr)
    r_lmk = jnp.einsum("...ij,...j->...i", r, lmk, precision=_PREC)
    d_rot = -lie.so3_hat(r_lmk)
    j_rot = jnp.einsum("...ij,...jk->...ik", j_proj, d_rot, precision=_PREC)
    j_lmk = jnp.einsum("...ij,...jk->...ik", j_proj, r, precision=_PREC)
    return jnp.concatenate([j_proj, j_rot, j_lmk], axis=-1)


def huber_meas_var(
    err: jax.Array, meas_var: jax.Array, nstds: float
) -> tuple[jax.Array, jax.Array]:
    """Huber-style measurement-variance inflation.

    For residual norm > N sigma the effective variance is inflated so the
    quadratic factor matches the Huber loss gradient
    (reference: ba/gbp_codelets.cpp:134-141):
      var' = var * err^2 / (2 (N sqrt(var) err - 0.5 N^2 var))

    Returns (modified_var, robust_flag).
    """
    sigma = jnp.sqrt(meas_var)
    robust = err > nstds * sigma
    denom = 2.0 * (nstds * sigma * err - 0.5 * nstds * nstds * meas_var)
    denom = jnp.where(robust, denom, 1.0)  # safe where not robust
    inflated = meas_var * err * err / denom
    return jnp.where(robust, inflated, meas_var), robust


class FactorPotential(NamedTuple):
    """Linearised reprojection-factor potential, stored blockwise.

    The reference stores eta [9] and Lambda as four blocks cc/ll/cl/lc
    (ba/gbp_codelets.cpp:30-34); lc = cl^T is never stored here.
    """

    eta_c: jax.Array    # [..., 6]
    eta_l: jax.Array    # [..., 3]
    lam_cc: jax.Array   # [..., 6, 6]
    lam_cl: jax.Array   # [..., 6, 3]
    lam_ll: jax.Array   # [..., 3, 3]


def linearise_factor(
    cam_mu: jax.Array,
    lmk_mu: jax.Array,
    k: jax.Array,
    meas: jax.Array,
    meas_var: jax.Array,
    nstds: float,
    intr: jax.Array | None = None,
) -> tuple[FactorPotential, jax.Array]:
    """Relinearise reprojection factors at the given belief means.

    Mirrors the body of ``RelineariseFactorVertex``
    (reference: ba/gbp_codelets.cpp:38-171):
      Lambda = J^T J / var',  eta = J^T (J x0 + z - h(x0)) / var'
    with Huber variance inflation. Batched over the leading edge axis.

    Returns (potential, robust_flag).
    """
    j_kf, j_lmk = reproj_jacobians(cam_mu, lmk_mu, k, intr)
    hx0 = project(cam_mu, lmk_mu, k, intr)              # [...,2]

    # residual-side vector: J x0 + z - h(x0)   [..., 2]
    jx0 = (
        jnp.einsum("...ij,...j->...i", j_kf, cam_mu, precision=_PREC)
        + jnp.einsum("...ij,...j->...i", j_lmk, lmk_mu, precision=_PREC)
    )
    b = jx0 + meas - hx0

    err = jnp.linalg.norm(hx0 - meas, axis=-1)
    var, robust = huber_meas_var(err, meas_var, nstds)
    inv_var = (1.0 / var)[..., None]

    eta_c = jnp.einsum("...ij,...i->...j", j_kf, b, precision=_PREC) * inv_var
    eta_l = jnp.einsum("...ij,...i->...j", j_lmk, b, precision=_PREC) * inv_var
    inv_var2 = inv_var[..., None]
    lam_cc = jnp.einsum("...ki,...kj->...ij", j_kf, j_kf, precision=_PREC) * inv_var2
    lam_ll = jnp.einsum("...ki,...kj->...ij", j_lmk, j_lmk, precision=_PREC) * inv_var2
    lam_cl = jnp.einsum("...ki,...kj->...ij", j_kf, j_lmk, precision=_PREC) * inv_var2

    return FactorPotential(eta_c, eta_l, lam_cc, lam_cl, lam_ll), robust
