"""Batched SO(3)/SE(3) operations.

Vectorised, branch-free equivalents of the reference's device
Lie-group helpers (ba/bafuncs.cpp:19-80) and host Eigen mirrors
(ba/util.cpp:11-46). All functions accept arbitrary leading batch dims.

Pose convention follows the reference: a keyframe is parameterised by
``x = [t (3), w (3)]`` with world-to-camera action ``y_cam = exp(w^) y_world + t``
(reference: ba/bafuncs.cpp:57-80).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_PREC = jax.lax.Precision.HIGHEST

_SMALL_THETA = 1e-6


def so3_hat(w: jax.Array) -> jax.Array:
    """Hat operator: [..., 3] -> [..., 3, 3] skew-symmetric.

    (reference: ba/bafuncs.cpp:19-28)
    """
    zero = jnp.zeros_like(w[..., 0])
    return jnp.stack(
        [
            jnp.stack([zero, -w[..., 2], w[..., 1]], axis=-1),
            jnp.stack([w[..., 2], zero, -w[..., 0]], axis=-1),
            jnp.stack([-w[..., 1], w[..., 0], zero], axis=-1),
        ],
        axis=-2,
    )


def so3_exp(w: jax.Array) -> jax.Array:
    """Rodrigues' formula: [..., 3] axis-angle -> [..., 3, 3] rotation.

    The reference guards theta < 1e-6 with identity (ba/bafuncs.cpp:30-55);
    here the guard is a branch-free ``where`` with numerically safe
    coefficients so the same compiled code covers all inputs.
    """
    theta_sq = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(theta_sq)
    small = theta < _SMALL_THETA
    # Safe denominators (value irrelevant where `small`).
    theta_safe = jnp.where(small, 1.0, theta)
    theta_sq_safe = jnp.where(small, 1.0, theta_sq)
    a = jnp.where(small, 1.0, jnp.sin(theta_safe) / theta_safe)
    b = jnp.where(small, 0.5, (1.0 - jnp.cos(theta_safe)) / theta_sq_safe)
    w_hat = so3_hat(w)
    w_hat_sq = jnp.einsum("...ij,...jk->...ik", w_hat, w_hat, precision=_PREC)
    eye = jnp.eye(3, dtype=w.dtype)
    return eye + a[..., None, None] * w_hat + b[..., None, None] * w_hat_sq


def so3_log(r: jax.Array) -> jax.Array:
    """Rotation matrix [..., 3, 3] -> axis-angle [..., 3].

    Mirrors the host-side acos-trace formula (ba/util.cpp:34-46) with a guard
    for the identity (d -> 1) where the formula is 0/0.
    """
    d = 0.5 * (jnp.trace(r, axis1=-2, axis2=-1) - 1.0)
    d = jnp.clip(d, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = jnp.arccos(d)
    coef = theta / (2.0 * jnp.sqrt(1.0 - d * d))
    # As R -> I, (R - R^T)/2 -> hat(w) with coef -> 1/2.
    near_identity = jnp.abs(d - 1.0) < 1e-6
    coef = jnp.where(near_identity, 0.5, coef)
    ln_r = coef[..., None, None] * (r - jnp.swapaxes(r, -1, -2))
    return jnp.stack(
        [ln_r[..., 2, 1], ln_r[..., 0, 2], ln_r[..., 1, 0]], axis=-1
    )


def pose_to_rt(x: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Split pose [..., 6] into (R_w2c [..., 3, 3], t [..., 3])."""
    t = x[..., :3]
    r = so3_exp(x[..., 3:6])
    return r, t


def tranf_w2c(x: jax.Array) -> jax.Array:
    """Pose [..., 6] -> homogeneous world-to-camera transform [..., 4, 4].

    (reference: ba/bafuncs.cpp:57-80)
    """
    r, t = pose_to_rt(x)
    batch = x.shape[:-1]
    top = jnp.concatenate([r, t[..., :, None]], axis=-1)       # [..., 3, 4]
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], dtype=x.dtype), batch + (1, 4)
    )
    return jnp.concatenate([top, bottom], axis=-2)


def w2c_apply(x: jax.Array, y_world: jax.Array) -> jax.Array:
    """Transform world points into the camera frame: R y + t."""
    r, t = pose_to_rt(x)
    return jnp.einsum("...ij,...j->...i", r, y_world, precision=_PREC) + t


def tranf_c2w(x: jax.Array) -> jax.Array:
    """Pose [..., 6] -> camera-to-world transform [..., 4, 4] (R^T, -R^T t)."""
    r, t = pose_to_rt(x)
    rt = jnp.swapaxes(r, -1, -2)
    t_inv = -jnp.einsum("...ij,...j->...i", rt, t, precision=_PREC)
    batch = x.shape[:-1]
    top = jnp.concatenate([rt, t_inv[..., :, None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], dtype=x.dtype), batch + (1, 4)
    )
    return jnp.concatenate([top, bottom], axis=-2)


def optic_axis_point_world(x: jax.Array, depth: float | jax.Array = 1.0) -> jax.Array:
    """World coords of the point at `depth` on the camera's optic axis.

    Used by the average-depth landmark initialiser (ba/dataio.cpp:417-453)
    and new-keyframe landmark priors (ba/util.cpp:198-211): the camera-frame
    point (0, 0, depth) mapped through T_c2w.
    """
    r, t = pose_to_rt(x)
    rt = jnp.swapaxes(r, -1, -2)
    p_cam = jnp.stack(
        [jnp.zeros_like(x[..., 0]), jnp.zeros_like(x[..., 0]),
         jnp.broadcast_to(jnp.asarray(depth, x.dtype), x.shape[:-1])],
        axis=-1,
    )
    return jnp.einsum("...ij,...j->...i", rt, p_cam - t, precision=_PREC)
