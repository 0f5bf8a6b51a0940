"""Projection model, Jacobians (vs autodiff), Huber, factor assembly."""

import jax
import jax.numpy as jnp
import numpy as np

from gbp_poplar.ops import projection

K = jnp.asarray([[517.3, 0.0, 318.6], [0.0, 516.5, 255.3], [0.0, 0.0, 1.0]],
                jnp.float32)


def _random_edge(rng, n):
    cam = rng.normal(size=(n, 6)).astype(np.float32)
    cam[:, 3:] *= 0.5
    # keep landmarks in front of the cameras
    lmk = rng.normal(size=(n, 3)).astype(np.float32)
    lmk[:, 2] += 4.0
    cam[:, :3] *= 0.2
    return jnp.asarray(cam), jnp.asarray(lmk)


def test_jacobians_match_autodiff(rng):
    cam, lmk = _random_edge(rng, 12)
    j_kf, j_lmk = projection.reproj_jacobians(cam, lmk, K)
    jac_fn_c = jax.vmap(jax.jacfwd(lambda c, l: projection.project(c, l, K)))
    jac_fn_l = jax.vmap(jax.jacfwd(lambda l, c: projection.project(c, l, K)))
    expected_c = jac_fn_c(cam, lmk)
    expected_l = jac_fn_l(lmk, cam)
    np.testing.assert_allclose(np.asarray(j_kf), np.asarray(expected_c),
                               rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(np.asarray(j_lmk), np.asarray(expected_l),
                               rtol=2e-2, atol=2e-2)


def test_jacobian_zero_rotation_finite(rng):
    cam = jnp.zeros((2, 6), jnp.float32).at[:, 2].set(0.0)
    lmk = jnp.asarray([[0.2, -0.1, 3.0], [0.0, 0.0, 5.0]], jnp.float32)
    j_kf, j_lmk = projection.reproj_jacobians(cam, lmk, K)
    assert np.isfinite(np.asarray(j_kf)).all()
    assert np.isfinite(np.asarray(j_lmk)).all()
    # w -> 0 limit: rotation block == J_proj @ (-hat(y))
    jac_fn = jax.vmap(jax.jacfwd(lambda c, l: projection.project(c, l, K)))
    expected = np.asarray(jac_fn(cam, lmk))
    np.testing.assert_allclose(np.asarray(j_kf), expected, rtol=1e-3, atol=1e-3)


def test_huber_inactive_below_threshold():
    var = jnp.asarray([4.0, 4.0], jnp.float32)
    err = jnp.asarray([1.0, 4.9], jnp.float32)   # threshold = 2.5 * 2 = 5
    out, robust = projection.huber_meas_var(err, var, 2.5)
    np.testing.assert_allclose(np.asarray(out), [4.0, 4.0])
    assert not np.asarray(robust).any()


def test_huber_inflates_above_threshold():
    var = jnp.asarray([4.0], jnp.float32)
    err = jnp.asarray([50.0], jnp.float32)
    out, robust = projection.huber_meas_var(err, var, 2.5)
    # reference formula: var * err^2 / (2 (N sigma err - 0.5 N^2 var))
    expected = 4.0 * 2500.0 / (2 * (2.5 * 2 * 50 - 0.5 * 6.25 * 4))
    np.testing.assert_allclose(np.asarray(out), [expected], rtol=1e-6)
    assert np.asarray(robust).all()
    # continuity at the threshold
    at = projection.huber_meas_var(jnp.asarray([5.0 + 1e-4]), var, 2.5)[0]
    np.testing.assert_allclose(np.asarray(at), [4.0], rtol=1e-3)


def test_linearise_factor_consistency(rng):
    """eta = Lambda x0 + J^T r / var must hold; at zero residual the GN fixed
    point is the linearisation point."""
    cam, lmk = _random_edge(rng, 6)
    meas = projection.project(cam, lmk, K)   # zero residual
    var = jnp.full((6,), 4.0, jnp.float32)
    pot, robust = projection.linearise_factor(cam, lmk, K, meas, var, 2.5)
    assert not np.asarray(robust).any()
    # eta == Lambda @ x0 when residual is zero
    eta_c_expected = (
        np.einsum("bij,bj->bi", np.asarray(pot.lam_cc), np.asarray(cam))
        + np.einsum("bij,bj->bi", np.asarray(pot.lam_cl), np.asarray(lmk)))
    np.testing.assert_allclose(np.asarray(pot.eta_c), eta_c_expected,
                               rtol=1e-3, atol=1e-2)
    # Lambda blocks are (J^T J)/var blocks: PSD, symmetric cc/ll
    np.testing.assert_allclose(np.asarray(pot.lam_cc),
                               np.swapaxes(np.asarray(pot.lam_cc), -1, -2),
                               rtol=1e-5, atol=1e-5)
    eigs = np.linalg.eigvalsh(np.asarray(pot.lam_cc))
    # PSD up to fp32 roundoff, relative to the largest eigenvalue
    assert (eigs > -1e-5 * eigs.max(axis=-1, keepdims=True)).all()
