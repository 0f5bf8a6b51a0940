"""Prior construction, annealing scalings, and initialisation noise.

Equivalents of the reference's host-side problem setup:
  - per-variable prior strength from max |J| over incident edges
    (reference: ba/dataio.cpp:67-117)
  - prior-annealing scalings (reference: ba/ba.cpp:560-572)
  - Gaussian noise / average-depth initialisers (reference:
    ba/dataio.cpp:330-453)

The reference computes priors with an O((C+L)*E) nested scan; here a single
vectorised Jacobian evaluation over all edges plus segment-max gives the same
numbers in O(E).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..config import GBPConfig, InitConfig
from ..ops import projection
from .balio import BAProblem


def prior_lambdas(
    problem: BAProblem, meas_var: float, dtype=jnp.float32
) -> tuple[jax.Array, jax.Array]:
    """Per-variable isotropic prior precision.

    lambda_v = (max_{edges at v} max |J_edge|)^2 / meas_var, where J is the
    host-style 2x9 reprojection Jacobian (reference: ba/dataio.cpp:76-116).
    Returns (cam_lam [C], lmk_lam [L]) scalar precisions.
    """
    k = jnp.asarray(problem.k, dtype)
    intr = getattr(problem, "intrinsics", None)
    cam_all = jnp.asarray(problem.cam_means, dtype)
    lmk_all = jnp.asarray(problem.lmk_means, dtype)
    intr_all = None if intr is None else jnp.asarray(intr, dtype)
    e = problem.n_edges
    # Chunk the Jacobian pass: the [E, 2, 9] batched evaluation's XLA
    # intermediates are ~50 f32 planes of E elements PER SMALL-MATRIX STEP
    # in this (non-plane) layout — at 5M edges a single whole-E evaluation
    # runs out of device memory (the build-time wall found by the
    # Venice-scale probe). One jitted chunk, reused E/chunk times.
    chunk = 1 << 19
    ci_np = problem.cam_idx.astype(np.int32)
    li_np = problem.lmk_idx.astype(np.int32)

    @jax.jit
    def chunk_max(ci, li):
        cam = cam_all[ci]
        lmk = lmk_all[li]
        intr_e = None if intr_all is None else intr_all[ci]
        jac = projection.reproj_jacobian_local(cam, lmk, k, intr_e)
        return jnp.max(jnp.abs(jac), axis=(-2, -1))       # [chunk]

    if e <= chunk:
        max_abs = chunk_max(jnp.asarray(ci_np), jnp.asarray(li_np))
    else:
        pad = (-e) % chunk
        ci_p = np.pad(ci_np, (0, pad))
        li_p = np.pad(li_np, (0, pad))
        parts = [chunk_max(jnp.asarray(ci_p[o:o + chunk]),
                           jnp.asarray(li_p[o:o + chunk]))
                 for o in range(0, e + pad, chunk)]
        max_abs = jnp.concatenate(parts)[:e]

    cam_ids = jnp.asarray(ci_np)
    lmk_ids = jnp.asarray(li_np)
    cam_max = jax.ops.segment_max(
        max_abs, cam_ids, num_segments=problem.n_keyframes
    )
    lmk_max = jax.ops.segment_max(
        max_abs, lmk_ids, num_segments=problem.n_points
    )
    # Variables with no incident edges get -inf from segment_max; clamp to 0.
    cam_max = jnp.maximum(cam_max, 0.0)
    lmk_max = jnp.maximum(lmk_max, 0.0)
    return cam_max**2 / meas_var, lmk_max**2 / meas_var


def build_priors(
    problem: BAProblem, cfg: GBPConfig, dtype=jnp.float32
) -> dict[str, jax.Array]:
    """Initial prior (eta, Lambda) per variable plus annealing scalings.

    eta = lambda * mu0 with isotropic lambda (reference: ba/dataio.cpp:88-115).
    Scalings (reference: ba/ba.cpp:560-572):
      anchors (first `num_anchor_cams` kfs):
        exp(-1/steps * log(lambda_prior * first_cam_prior_std^2))
        -> after `steps` applications lambda = 1 / first_cam_prior_std^2
      others: exp(-2/steps * log(prior_std_weaker_factor))
        -> after `steps` applications lambda weakened by factor^2

    Arrays are emitted in plane layout (ops/planes.py): eta [d, C],
    Lambda packed symmetric [n_slots, C] (isotropic: diagonal slots only).
    """
    from ..ops import planes as pl

    cam_lam_s, lmk_lam_s = prior_lambdas(problem, cfg.meas_var, dtype)
    cam_mu = jnp.asarray(problem.cam_means.T, dtype)   # [6, C]
    lmk_mu = jnp.asarray(problem.lmk_means.T, dtype)   # [3, L]

    cam_prior_eta = cam_lam_s[None, :] * cam_mu
    lmk_prior_eta = lmk_lam_s[None, :] * lmk_mu
    diag6 = jnp.zeros((pl.N_SYM6,), dtype).at[
        jnp.asarray([pl.sym_slot(i, i) for i in range(6)])].set(1.0)
    diag3 = jnp.zeros((pl.N_SYM3,), dtype).at[
        jnp.asarray([pl.sym_slot(i, i) for i in range(3)])].set(1.0)
    cam_prior_lam = diag6[:, None] * cam_lam_s[None, :]
    lmk_prior_lam = diag3[:, None] * lmk_lam_s[None, :]

    anchor = jnp.arange(problem.n_keyframes) < cfg.num_anchor_cams
    # steps == 0 disables annealing entirely (scaling 1 -> priors stay at
    # build strength); the reference always anneals, but the schedule knob
    # must not divide by zero when turned off
    inv_steps = 1.0 / cfg.steps if cfg.steps else 0.0
    anchor_scaling = jnp.exp(
        -inv_steps * jnp.log(cam_lam_s * cfg.first_cam_prior_std**2)
    )
    weak_scaling = jnp.exp(
        jnp.asarray(-2.0 * inv_steps * np.log(cfg.prior_std_weaker_factor),
                    dtype)
    )
    cam_scaling = jnp.where(anchor, anchor_scaling, weak_scaling).astype(dtype)
    lmk_scaling = jnp.full((problem.n_points,), weak_scaling, dtype)

    return dict(
        cam_prior_eta=cam_prior_eta,
        cam_prior_lam=cam_prior_lam,
        lmk_prior_eta=lmk_prior_eta,
        lmk_prior_lam=lmk_prior_lam,
        cam_scaling=cam_scaling,
        lmk_scaling=lmk_scaling,
    )


# ---------------------------------------------------------------------------
# Initialisation perturbations (host-side, NumPy — run once at load time)
# ---------------------------------------------------------------------------

def _so3exp_np(w: np.ndarray) -> np.ndarray:
    theta = np.linalg.norm(w)
    if theta < 1e-9:
        return np.eye(3)
    w_hat = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    return (
        np.eye(3)
        + np.sin(theta) / theta * w_hat
        + (1 - np.cos(theta)) / theta**2 * (w_hat @ w_hat)
    )


def _so3log_np(r: np.ndarray) -> np.ndarray:
    d = 0.5 * (np.trace(r) - 1)
    d = np.clip(d, -1 + 1e-9, 1 - 1e-9)
    if abs(d - 1) < 1e-9:
        return np.zeros(3)
    ln_r = (np.arccos(d) / (2 * np.sqrt(1 - d * d))) * (r - r.T)
    return np.array([ln_r[2, 1], ln_r[0, 2], ln_r[1, 0]])


def add_cam_trans_noise(
    cam_means: np.ndarray, std: float, rng: np.random.Generator, k_anchor: int = 2
) -> np.ndarray:
    """Gaussian translation noise, skipping the first k anchor keyframes
    (reference: ba/dataio.cpp:330-343)."""
    out = cam_means.copy()
    out[k_anchor:, :3] += rng.normal(0, std, out[k_anchor:, :3].shape)
    return out


def add_cam_rot_noise(
    cam_means: np.ndarray, std_deg: float, rng: np.random.Generator, k_anchor: int = 2
) -> np.ndarray:
    """Random-axis rotation perturbation composed in the camera frame
    (reference: ba/dataio.cpp:345-400)."""
    out = cam_means.copy()
    for c in range(k_anchor, out.shape[0]):
        angle = rng.normal(0, std_deg) * np.pi / 180
        axis = rng.integers(0, 3)
        ca, sa = np.cos(angle), np.sin(angle)
        r_noise = np.eye(3)
        i, j = [(1, 2), (0, 2), (0, 1)][axis]
        r_noise[i, i] = ca
        r_noise[j, j] = ca
        r_noise[i, j] = -sa if axis != 1 else sa
        r_noise[j, i] = sa if axis != 1 else -sa
        r_w2c = _so3exp_np(out[c, 3:])
        t = out[c, :3]
        t_w2c = np.eye(4)
        t_w2c[:3, :3] = r_w2c
        t_w2c[:3, 3] = t
        t_c2w = np.linalg.inv(t_w2c)
        t_c2w[:3, :3] = r_noise @ t_c2w[:3, :3]
        t_w2c = np.linalg.inv(t_c2w)
        out[c, :3] = t_w2c[:3, 3]
        out[c, 3:] = _so3log_np(t_w2c[:3, :3])
    return out


def add_lmk_noise(
    lmk_means: np.ndarray, std: float, rng: np.random.Generator
) -> np.ndarray:
    """Gaussian noise on all landmarks (reference: ba/dataio.cpp:402-415)."""
    return lmk_means + rng.normal(0, std, lmk_means.shape)


def av_depth_init(
    problem: BAProblem, av_depth: float, cam_means: np.ndarray
) -> np.ndarray:
    """Place each landmark at `av_depth` on the optic axis of the first
    keyframe that observes it (reference: ba/dataio.cpp:417-453)."""
    if getattr(problem, "intrinsics", None) is not None:
        raise ValueError(
            "av_depth_init assumes the pinhole +z optic-axis convention; "
            "BAL/Snavely problems ship initial landmark estimates — "
            "run without --avdepth_on")
    out = problem.lmk_means.copy()
    first_cam = np.full(problem.n_points, -1, np.int64)
    # Edges scanned in keyframe order; first observation wins.
    order = np.argsort(problem.cam_idx, kind="stable")
    for e in order:
        l = problem.lmk_idx[e]
        if first_cam[l] < 0:
            first_cam[l] = problem.cam_idx[e]
    for l in range(problem.n_points):
        c = first_cam[l]
        if c < 0:
            continue
        r = _so3exp_np(cam_means[c, 3:])
        t = cam_means[c, :3]
        out[l] = r.T @ (np.array([0.0, 0.0, av_depth]) - t)
    return out


def apply_init_noise(
    problem: BAProblem, init_cfg: InitConfig, k_anchor: int = 2
) -> BAProblem:
    """Apply the configured initialisation perturbations
    (reference: ba/ba.cpp:536-548)."""
    rng = np.random.default_rng(init_cfg.seed)
    cam_means = problem.cam_means
    lmk_means = problem.lmk_means
    if init_cfg.trans_noise != 0.0:
        cam_means = add_cam_trans_noise(cam_means, init_cfg.trans_noise, rng, k_anchor)
    if init_cfg.rot_noise != 0.0:
        cam_means = add_cam_rot_noise(cam_means, init_cfg.rot_noise, rng, k_anchor)
    if init_cfg.lmk_noise != 0.0 and not init_cfg.av_depth_on:
        lmk_means = add_lmk_noise(lmk_means, init_cfg.lmk_noise, rng)
    elif init_cfg.av_depth_on:
        lmk_means = av_depth_init(problem, init_cfg.av_depth, cam_means)
    import dataclasses

    return dataclasses.replace(problem, cam_means=cam_means, lmk_means=lmk_means)
