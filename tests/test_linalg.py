"""Unit tests for batched small-matrix linalg against numpy.linalg."""

import jax.numpy as jnp
import numpy as np

from gbp_poplar.ops import linalg


def _random_spd(rng, n, d, scale=1.0):
    a = rng.normal(size=(n, d, d))
    return (np.einsum("bij,bkj->bik", a, a) + d * np.eye(d)) * scale


def test_inv3x3(rng):
    a = _random_spd(rng, 32, 3).astype(np.float32)
    inv = np.asarray(linalg.inv3x3(jnp.asarray(a)))
    np.testing.assert_allclose(inv, np.linalg.inv(a), rtol=2e-4, atol=1e-5)


def test_inv3x3_nonsymmetric(rng):
    a = rng.normal(size=(8, 3, 3)).astype(np.float32) + 3 * np.eye(3, dtype=np.float32)
    inv = np.asarray(linalg.inv3x3(jnp.asarray(a)))
    np.testing.assert_allclose(inv, np.linalg.inv(a), rtol=2e-3, atol=1e-4)


def test_inv6x6(rng):
    a = _random_spd(rng, 32, 6).astype(np.float32)
    inv = np.asarray(linalg.inv6x6(jnp.asarray(a)))
    np.testing.assert_allclose(inv, np.linalg.inv(a), rtol=2e-3, atol=1e-4)


def test_inv6x6_wide_scale(rng):
    # precision-like matrices with large dynamic range
    a = _random_spd(rng, 16, 6, scale=1e4).astype(np.float32)
    inv = np.asarray(linalg.inv6x6(jnp.asarray(a)))
    prod = np.einsum("bij,bjk->bik", a, inv)
    np.testing.assert_allclose(prod, np.broadcast_to(np.eye(6), (16, 6, 6)), atol=1e-2)


def test_inf_to_mean(rng):
    lam = _random_spd(rng, 8, 6).astype(np.float32)
    eta = rng.normal(size=(8, 6)).astype(np.float32)
    mu, sigma = linalg.inf_to_mean(jnp.asarray(eta), jnp.asarray(lam))
    for i in range(8):
        np.testing.assert_allclose(
            np.asarray(mu)[i], np.linalg.solve(lam[i], eta[i]), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(np.asarray(sigma), np.linalg.inv(lam), rtol=2e-3, atol=1e-4)


def test_bmm_bmv(rng):
    a = rng.normal(size=(4, 6, 3)).astype(np.float32)
    b = rng.normal(size=(4, 3, 5)).astype(np.float32)
    v = rng.normal(size=(4, 3)).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(linalg.bmm(jnp.asarray(a), jnp.asarray(b))),
        np.einsum("bij,bjk->bik", a, b), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(linalg.bmv(jnp.asarray(a), jnp.asarray(v))),
        np.einsum("bij,bj->bi", a, v), rtol=1e-5, atol=1e-6)
