"""Plane-layout algebra vs NumPy oracles — the kernel-language unit tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gbp_poplar.ops import planes as pl


def _spd(rng, n, d):
    a = rng.normal(0, 1, (n, d, d))
    return a @ np.transpose(a, (0, 2, 1)) + d * np.eye(d)


@pytest.fixture(scope="module")
def rng_():
    return np.random.default_rng(7)


@pytest.mark.parametrize("d", [3, 6])
def test_sym_pack_roundtrip(rng_, d):
    n = 37
    dense = _spd(rng_, n, d)
    packed = pl.dense_to_sym_planes(jnp.asarray(dense), d)
    assert packed.shape == ((21 if d == 6 else 6), n)
    back = pl.sym_planes_to_dense(packed, d)
    np.testing.assert_allclose(np.asarray(back), dense, rtol=1e-6)  # f32
    # unpack shares rows between (i, j) and (j, i)
    m = pl.unpack_sym(packed, d)
    assert m[0][d - 1] is m[d - 1][0]


def test_full_pack_roundtrip(rng_):
    n = 11
    dense = rng_.normal(0, 1, (n, 6, 3))
    packed = pl.dense_to_full_planes(jnp.asarray(dense), 6, 3)
    back = pl.full_planes_to_dense(packed, 6, 3)
    np.testing.assert_allclose(np.asarray(back), dense, rtol=1e-6)  # f32


@pytest.mark.parametrize("d", [3, 6])
def test_cholesky_and_solve(rng_, d):
    n = 53
    dense = _spd(rng_, n, d)
    rhs = rng_.normal(0, 1, (n, d))
    packed = pl.dense_to_sym_planes(jnp.asarray(dense, jnp.float32), d)
    m = pl.unpack_sym(packed, d)
    x_rows = pl.solve_sym(m, pl.unpack_vec(
        pl.dense_to_vec_planes(jnp.asarray(rhs, jnp.float32)), d))
    x = np.asarray(pl.vec_planes_to_dense(pl.pack_vec(x_rows)))
    ref = np.linalg.solve(dense, rhs[..., None])[..., 0]
    np.testing.assert_allclose(x, ref, rtol=2e-4, atol=1e-5)

    lfac = pl.cholesky(m)
    ldense = np.zeros((n, d, d), np.float32)
    for i in range(d):
        for j in range(i + 1):
            ldense[:, i, j] = np.asarray(lfac[i][j])[0]
    np.testing.assert_allclose(
        ldense @ np.transpose(ldense, (0, 2, 1)), dense, rtol=2e-4, atol=1e-4)


def test_inv_sym3_oracle(rng_):
    n = 64
    dense = _spd(rng_, n, 3)
    packed = pl.dense_to_sym_planes(jnp.asarray(dense, jnp.float32), 3)
    inv = pl.inv_sym3(pl.unpack_sym(packed, 3))
    got = np.asarray(pl.sym_planes_to_dense(pl.pack_sym(inv, 3), 3))
    np.testing.assert_allclose(got, np.linalg.inv(dense), rtol=2e-4, atol=1e-5)


def test_inv_sym_from_chol_oracle(rng_):
    n = 29
    dense = _spd(rng_, n, 6)
    packed = pl.dense_to_sym_planes(jnp.asarray(dense, jnp.float32), 6)
    inv = pl.inv_sym_from_chol(pl.cholesky(pl.unpack_sym(packed, 6)))
    got = np.asarray(pl.sym_planes_to_dense(pl.pack_sym(inv, 6), 6))
    np.testing.assert_allclose(got, np.linalg.inv(dense), rtol=5e-4, atol=1e-4)


def test_so3_exp_matches_lie(rng_):
    from gbp_poplar.ops import lie
    w = rng_.normal(0, 1.0, (40, 3)).astype(np.float32)
    w[0] = 0.0                      # small-angle branch
    w[1] = [1e-8, -1e-8, 1e-8]
    r_rows = pl.so3_exp(pl.unpack_vec(jnp.asarray(w.T), 3))
    got = np.stack([np.stack([np.asarray(r_rows[i][j])[0] for j in range(3)],
                             -1) for i in range(3)], -2)
    ref = np.asarray(lie.so3_exp(jnp.asarray(w)))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_linearise_matches_dense_projection(rng_):
    """Plane linearisation == ops/projection.linearise_factor (dense)."""
    from gbp_poplar.ops import projection
    n = 50
    cam = rng_.normal(0, 0.3, (n, 6)).astype(np.float32)
    lmk = (rng_.normal(0, 1, (n, 3)) + [0, 0, 5]).astype(np.float32)
    k = jnp.asarray([[500.0, 0, 320], [0, 500, 240], [0, 0, 1]], jnp.float32)
    meas = rng_.uniform(0, 640, (n, 2)).astype(np.float32)
    var = jnp.full((n,), 4.0, jnp.float32)

    pot, robust_d = projection.linearise_factor(
        jnp.asarray(cam), jnp.asarray(lmk), k, jnp.asarray(meas), var, 2.5)

    eta_c, eta_l, lam_cc, lam_cl, lam_ll, robust_p, _ = pl.linearise(
        pl.unpack_vec(jnp.asarray(cam.T), 6),
        pl.unpack_vec(jnp.asarray(lmk.T), 3),
        k, jnp.asarray(meas[:, 0])[None], jnp.asarray(meas[:, 1])[None],
        var[None], 2.5)

    np.testing.assert_allclose(
        np.asarray(pl.pack_vec(eta_c)).T, np.asarray(pot.eta_c),
        rtol=2e-4, atol=2e-2)
    np.testing.assert_allclose(
        np.asarray(pl.sym_planes_to_dense(pl.pack_sym(lam_cc, 6), 6)),
        np.asarray(pot.lam_cc), rtol=2e-4, atol=2e-3)
    np.testing.assert_allclose(
        np.asarray(pl.full_planes_to_dense(pl.pack_full(lam_cl), 6, 3)),
        np.asarray(pot.lam_cl), rtol=2e-4, atol=2e-3)
    np.testing.assert_array_equal(np.asarray(robust_p)[0],
                                  np.asarray(robust_d))


def test_row_mask():
    m = jnp.asarray([[True, False, True]])
    out = pl.row_mask(m, 3)
    assert out.shape == (3, 3)
    assert bool(out[2, 0]) and not bool(out[1, 1])
