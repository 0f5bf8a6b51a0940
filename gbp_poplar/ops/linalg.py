"""Batched small-matrix linear algebra.

The reference implements tiny dense kernels (triple-loop GEMM, adjugate 3x3
inverse, LDL^T 6x6 inverse) that each IPU tile runs on one factor
(reference: ba/matlib.cpp:47-222). On an accelerator the equivalent is a dense
batch over the edge axis: every op below takes arrays shaped ``[..., d, d]``
and is fully vectorised — no data-dependent control flow, no scalar loops —
so XLA compiles it into fused passes over the batch.

The 6x6 inverse uses 3x3-block Schur inversion instead of the reference's
LDL^T back-substitution (ba/matlib.cpp:180-222): mathematically identical for
symmetric positive-definite inputs, but expressible with closed-form 3x3
inverses and small einsums, which vectorise much better than a sequential
triangular solve.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_PREC = jax.lax.Precision.HIGHEST

# Batched matmul on tiny matrices: dot_general with a leading batch dim, at
# HIGHEST precision (a float32 product may otherwise run in TF32 on a GPU).
def bmm(a: jax.Array, b: jax.Array) -> jax.Array:
    """Batched matrix multiply: [..., m, k] @ [..., k, n] -> [..., m, n]."""
    return jnp.einsum("...ij,...jk->...ik", a, b,
                      preferred_element_type=a.dtype, precision=_PREC)


def bmv(a: jax.Array, v: jax.Array) -> jax.Array:
    """Batched matrix-vector: [..., m, k] @ [..., k] -> [..., m]."""
    return jnp.einsum("...ij,...j->...i", a, v,
                      preferred_element_type=a.dtype, precision=_PREC)


def transpose(a: jax.Array) -> jax.Array:
    return jnp.swapaxes(a, -1, -2)


def symmetrize(a: jax.Array) -> jax.Array:
    return 0.5 * (a + transpose(a))


def det3x3(a: jax.Array) -> jax.Array:
    """Determinant of [..., 3, 3]."""
    return (
        a[..., 0, 0] * (a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1])
        - a[..., 0, 1] * (a[..., 1, 0] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 0])
        + a[..., 0, 2] * (a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0])
    )


def inv3x3(a: jax.Array) -> jax.Array:
    """Closed-form adjugate/determinant inverse of [..., 3, 3].

    Mirrors the reference's closed-form 3x3 inverse (ba/matlib.cpp:143-161)
    but vectorised over the batch.
    """
    c00 = a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1]
    c01 = a[..., 0, 2] * a[..., 2, 1] - a[..., 0, 1] * a[..., 2, 2]
    c02 = a[..., 0, 1] * a[..., 1, 2] - a[..., 0, 2] * a[..., 1, 1]
    c10 = a[..., 1, 2] * a[..., 2, 0] - a[..., 1, 0] * a[..., 2, 2]
    c11 = a[..., 0, 0] * a[..., 2, 2] - a[..., 0, 2] * a[..., 2, 0]
    c12 = a[..., 0, 2] * a[..., 1, 0] - a[..., 0, 0] * a[..., 1, 2]
    c20 = a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0]
    c21 = a[..., 0, 1] * a[..., 2, 0] - a[..., 0, 0] * a[..., 2, 1]
    c22 = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
    det = a[..., 0, 0] * c00 + a[..., 0, 1] * c10 + a[..., 0, 2] * c20
    inv_det = 1.0 / det
    adj = jnp.stack(
        [
            jnp.stack([c00, c01, c02], axis=-1),
            jnp.stack([c10, c11, c12], axis=-1),
            jnp.stack([c20, c21, c22], axis=-1),
        ],
        axis=-2,
    )
    return adj * inv_det[..., None, None]


def cholesky6x6(a: jax.Array) -> jax.Array:
    """Unrolled Cholesky factor L (lower) of SPD [..., 6, 6].

    Fully vectorised over the batch — 6 rsqrt + ~35 fused multiply-adds per
    matrix, no data-dependent control flow. This mirrors the reference's
    LDL^T factorisation (ba/matlib.cpp:180-222), which is numerically
    essential: a 3x3-block Schur inverse loses enough accuracy on
    ill-conditioned message cavities (kappa ~ 1e5-1e6) to destabilise the
    whole Lambda-message fixed-point iteration.
    """
    rows = []
    l_cols: list[list[jax.Array]] = []  # l_cols[j][i] = L[i, j] for i >= j
    for j in range(6):
        col = []
        # diagonal entry
        d = a[..., j, j]
        for k in range(j):
            d = d - l_cols[k][j - k] * l_cols[k][j - k]
        d = jnp.sqrt(d)
        inv_d = 1.0 / d
        col.append(d)
        for i in range(j + 1, 6):
            v = a[..., i, j]
            for k in range(j):
                v = v - l_cols[k][i - k] * l_cols[k][j - k]
            col.append(v * inv_d)
        l_cols.append(col)
    # assemble dense L
    zero = jnp.zeros_like(a[..., 0, 0])
    for i in range(6):
        row = []
        for j in range(6):
            row.append(l_cols[j][i - j] if i >= j else zero)
        rows.append(jnp.stack(row, axis=-1))
    return jnp.stack(rows, axis=-2)


def _inv_lower6x6(l: jax.Array) -> jax.Array:
    """Inverse of lower-triangular [..., 6, 6] by forward substitution."""
    inv_diag = [1.0 / l[..., i, i] for i in range(6)]
    zero = jnp.zeros_like(l[..., 0, 0])
    # m[i][j] = (L^-1)[i, j]
    m = [[zero] * 6 for _ in range(6)]
    for i in range(6):
        m[i][i] = inv_diag[i]
        for j in range(i - 1, -1, -1):
            s = zero
            for k in range(j, i):
                s = s + l[..., i, k] * m[k][j]
            m[i][j] = -s * inv_diag[i]
    rows = [jnp.stack(m[i], axis=-1) for i in range(6)]
    return jnp.stack(rows, axis=-2)


def inv6x6(a: jax.Array) -> jax.Array:
    """Inverse of SPD [..., 6, 6] via equilibrated unrolled Cholesky.

    Diagonal equilibration (A -> D A D with D = diag(A)^-1/2) removes the
    unit mismatch between translation/rotation blocks before factorising,
    then A^-1 = D (L^-T L^-1) D. Symmetric by construction.
    """
    d = jax.lax.rsqrt(jnp.abs(jnp.diagonal(a, axis1=-2, axis2=-1)) + 1e-30)
    a_eq = a * d[..., :, None] * d[..., None, :]
    l = cholesky6x6(a_eq)
    l_inv = _inv_lower6x6(l)
    inv_eq = bmm(transpose(l_inv), l_inv)
    return inv_eq * d[..., :, None] * d[..., None, :]


def inv_dxd(a: jax.Array) -> jax.Array:
    """Dispatch on trailing dim: 3 -> inv3x3, 6 -> inv6x6."""
    d = a.shape[-1]
    if d == 3:
        return inv3x3(a)
    if d == 6:
        return inv6x6(a)
    return jnp.linalg.inv(a)


def inf_to_mean(eta: jax.Array, lam: jax.Array) -> tuple[jax.Array, jax.Array]:
    """(eta, Lambda) -> (mu, Sigma): Sigma = Lambda^-1, mu = Sigma eta.

    Information-form to mean-form conversion (reference: ba/bafuncs.cpp:2-15).
    """
    sigma = inv_dxd(lam)
    mu = bmv(sigma, eta)
    return mu, sigma


def inf_to_mu(eta: jax.Array, lam: jax.Array) -> jax.Array:
    """Mean only: Lambda^-1 eta."""
    return bmv(inv_dxd(lam), eta)
