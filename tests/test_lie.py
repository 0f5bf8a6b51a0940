"""Unit tests for SO(3)/SE(3) ops against NumPy/autodiff oracles."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gbp_poplar.ops import lie


def _np_so3exp(w):
    theta = np.linalg.norm(w)
    if theta < 1e-12:
        return np.eye(3)
    w_hat = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    return (
        np.eye(3)
        + np.sin(theta) / theta * w_hat
        + (1 - np.cos(theta)) / theta**2 * (w_hat @ w_hat)
    )


def test_so3_hat_antisymmetric(rng):
    w = jnp.asarray(rng.normal(size=(7, 3)), jnp.float32)
    h = lie.so3_hat(w)
    np.testing.assert_allclose(np.asarray(h), -np.swapaxes(np.asarray(h), -1, -2))
    # hat(w) v == w x v
    v = rng.normal(size=(7, 3)).astype(np.float32)
    np.testing.assert_allclose(
        np.einsum("bij,bj->bi", np.asarray(h), v),
        np.cross(np.asarray(w), v),
        rtol=1e-5,
    )


def test_so3_exp_matches_numpy(rng):
    w = rng.normal(size=(16, 3)).astype(np.float32)
    r = np.asarray(lie.so3_exp(jnp.asarray(w)))
    for i in range(16):
        np.testing.assert_allclose(r[i], _np_so3exp(w[i]), rtol=1e-5, atol=1e-6)


def test_so3_exp_small_angle():
    w = jnp.asarray([[0.0, 0.0, 0.0], [1e-8, -1e-8, 1e-8]], jnp.float32)
    r = np.asarray(lie.so3_exp(w))
    np.testing.assert_allclose(r[0], np.eye(3), atol=1e-7)
    assert np.isfinite(r).all()


def test_so3_exp_is_rotation(rng):
    w = rng.normal(size=(8, 3)).astype(np.float32) * 2.0
    r = np.asarray(lie.so3_exp(jnp.asarray(w)))
    eye = np.einsum("bij,bkj->bik", r, r)
    np.testing.assert_allclose(eye, np.broadcast_to(np.eye(3), (8, 3, 3)), atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(r), np.ones(8), atol=1e-5)


def test_so3_log_roundtrip(rng):
    w = rng.normal(size=(8, 3)).astype(np.float32)
    w = w / np.linalg.norm(w, axis=-1, keepdims=True) * rng.uniform(0.01, 3.0, (8, 1))
    r = lie.so3_exp(jnp.asarray(w))
    w_back = np.asarray(lie.so3_log(r))
    np.testing.assert_allclose(w_back, w, rtol=1e-3, atol=1e-4)


def test_so3_log_identity():
    w = np.asarray(lie.so3_log(jnp.eye(3)[None]))
    np.testing.assert_allclose(w, np.zeros((1, 3)), atol=1e-6)


def test_w2c_apply_and_transforms(rng):
    x = rng.normal(size=(5, 6)).astype(np.float32)
    y = rng.normal(size=(5, 3)).astype(np.float32)
    out = np.asarray(lie.w2c_apply(jnp.asarray(x), jnp.asarray(y)))
    t44 = np.asarray(lie.tranf_w2c(jnp.asarray(x)))
    for i in range(5):
        expected = _np_so3exp(x[i, 3:]) @ y[i] + x[i, :3]
        np.testing.assert_allclose(out[i], expected, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(t44[i, :3, :3], _np_so3exp(x[i, 3:]), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(t44[i, :3, 3], x[i, :3], rtol=1e-6)


def test_c2w_inverse_of_w2c(rng):
    x = jnp.asarray(rng.normal(size=(4, 6)), jnp.float32)
    t = np.asarray(lie.tranf_w2c(x))
    t_inv = np.asarray(lie.tranf_c2w(x))
    prod = np.einsum("bij,bjk->bik", t, t_inv)
    np.testing.assert_allclose(prod, np.broadcast_to(np.eye(4), (4, 4, 4)), atol=1e-5)


def test_optic_axis_point(rng):
    x = jnp.asarray(rng.normal(size=(3, 6)), jnp.float32)
    p = lie.optic_axis_point_world(x, depth=2.5)
    back = np.asarray(lie.w2c_apply(x, p))
    np.testing.assert_allclose(back, np.broadcast_to([0, 0, 2.5], (3, 3)), atol=1e-5)
