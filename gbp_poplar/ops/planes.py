"""Plane-layout (structure-of-arrays) small-matrix algebra.

THE core layout idea of this framework. Batching small matrices as
[E, 6, 6] arrays puts the 6x6 matrix in the innermost dimensions, so every
small-matrix step is a strided gather/scatter over tiny tiles. Plane layout
stores one array per matrix/vector *component* instead: a symmetric 6x6
field over E edges is a packed [21, E] array whose rows are full
[E]-vectors. Every small-matrix operation (Cholesky, triangular solve,
adjugate inverse, products with projection Jacobians) unrolls at trace time
into pure elementwise arithmetic on [E] rows, which XLA fuses into loops
over the edge axis with fully coalesced loads. This is the equivalent of
the reference's per-tile scalar codelets (ba/matlib.cpp:47-222) — same
formulas, vectorised across the graph instead of spread across tiles.

Conventions:
  - a "vec" is a Python list of d arrays, each shaped [...] (usually [E])
  - a "mat" is a list of lists, mat[i][j]
  - symmetric matrices are packed row-major over the lower triangle:
    (i, j), i >= j  ->  slot i*(i+1)/2 + j  (21 slots for 6x6, 6 for 3x3)
  - packed storage is a single jnp array [n_slots, E] (or [n_slots, C])
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

SYM6_IDX = [(i, j) for i in range(6) for j in range(i + 1)]   # 21
SYM3_IDX = [(i, j) for i in range(3) for j in range(i + 1)]   # 6
N_SYM6 = len(SYM6_IDX)
N_SYM3 = len(SYM3_IDX)


def sym_slot(i: int, j: int) -> int:
    if i < j:
        i, j = j, i
    return i * (i + 1) // 2 + j


# ---------------------------------------------------------------------------
# pack / unpack
# ---------------------------------------------------------------------------

# Rows are kept 2-D ((1, N) views of a packed [n_slots, N] array) and are
# concatenated rather than stacked, so packing is a plain concatenate.

def _check_slots(p: jax.Array, n_slots: int) -> None:
    assert p.shape[0] == n_slots, (p.shape, n_slots)


def unpack_sym(p: jax.Array, d: int) -> list[list[jax.Array]]:
    """Packed [n_slots, ...] -> symmetric mat of shared (1, N) row views."""
    idx = SYM6_IDX if d == 6 else SYM3_IDX
    _check_slots(p, len(idx))
    m = [[None] * d for _ in range(d)]
    for s, (i, j) in enumerate(idx):
        m[i][j] = p[s:s + 1]
        m[j][i] = m[i][j]
    return m


def pack_sym(m: list[list[jax.Array]], d: int) -> jax.Array:
    idx = SYM6_IDX if d == 6 else SYM3_IDX
    return jnp.concatenate([m[i][j] for (i, j) in idx])


def unpack_full(p: jax.Array, rows: int, cols: int) -> list[list[jax.Array]]:
    """Packed [rows*cols, ...] row-major -> mat of (1, N) row views."""
    _check_slots(p, rows * cols)
    return [[p[i * cols + j:i * cols + j + 1]
             for j in range(cols)] for i in range(rows)]


def pack_full(m: list[list[jax.Array]]) -> jax.Array:
    return jnp.concatenate([x for row in m for x in row])


def unpack_vec(p: jax.Array, d: int) -> list[jax.Array]:
    _check_slots(p, d)
    return [p[i:i + 1] for i in range(d)]


def pack_vec(v: list[jax.Array]) -> jax.Array:
    return jnp.concatenate(v)


def row_mask(mask: jax.Array, n_slots: int) -> jax.Array:
    """Broadcast a single (1, N) row mask across a packed [n_slots, N]
    array."""
    if n_slots == 1:
        return mask
    return jnp.concatenate([mask] * n_slots)


def sym_planes_to_dense(p: jax.Array, d: int) -> jax.Array:
    """Packed [n_slots, N] -> dense [N, d, d] (for oracles/inspection)."""
    rows = [jnp.stack([p[sym_slot(i, j)] for j in range(d)], axis=-1)
            for i in range(d)]
    return jnp.stack(rows, axis=-2)


def dense_to_sym_planes(a: jax.Array, d: int) -> jax.Array:
    """Dense [N, d, d] (symmetric) -> packed [n_slots, N]."""
    idx = SYM6_IDX if d == 6 else SYM3_IDX
    return jnp.stack([a[..., i, j] for (i, j) in idx])


def full_planes_to_dense(p: jax.Array, rows: int, cols: int) -> jax.Array:
    rr = [jnp.stack([p[i * cols + j] for j in range(cols)], axis=-1)
          for i in range(rows)]
    return jnp.stack(rr, axis=-2)


def dense_to_full_planes(a: jax.Array, rows: int, cols: int) -> jax.Array:
    return jnp.stack([a[..., i, j] for i in range(rows)
                      for j in range(cols)])


def vec_planes_to_dense(p: jax.Array) -> jax.Array:
    """[d, N] -> [N, d]."""
    return jnp.swapaxes(p, 0, 1)


def dense_to_vec_planes(a: jax.Array) -> jax.Array:
    """[N, d] -> [d, N]."""
    return jnp.swapaxes(a, 0, 1)


# ---------------------------------------------------------------------------
# elementary mat/vec algebra on plane lists (all unrolled, all elementwise)
# ---------------------------------------------------------------------------

def matvec(m: list[list[jax.Array]], v: list[jax.Array]) -> list[jax.Array]:
    d_out, d_in = len(m), len(v)
    out = []
    for i in range(d_out):
        acc = m[i][0] * v[0]
        for k in range(1, d_in):
            acc = acc + m[i][k] * v[k]
        out.append(acc)
    return out


def mat_t_vec(m: list[list[jax.Array]], v: list[jax.Array]) -> list[jax.Array]:
    rows, cols = len(m), len(m[0])
    out = []
    for j in range(cols):
        acc = m[0][j] * v[0]
        for k in range(1, rows):
            acc = acc + m[k][j] * v[k]
        out.append(acc)
    return out


def matmul(a: list[list[jax.Array]], b: list[list[jax.Array]]):
    rows, inner, cols = len(a), len(b), len(b[0])
    out = [[None] * cols for _ in range(rows)]
    for i in range(rows):
        for j in range(cols):
            acc = a[i][0] * b[0][j]
            for k in range(1, inner):
                acc = acc + a[i][k] * b[k][j]
            out[i][j] = acc
    return out


def vdot(a: list[jax.Array], b: list[jax.Array]) -> jax.Array:
    acc = a[0] * b[0]
    for k in range(1, len(a)):
        acc = acc + a[k] * b[k]
    return acc


def vsub(a: list[jax.Array], b: list[jax.Array]) -> list[jax.Array]:
    return [x - y for x, y in zip(a, b)]


def vadd(a: list[jax.Array], b: list[jax.Array]) -> list[jax.Array]:
    return [x + y for x, y in zip(a, b)]


# ---------------------------------------------------------------------------
# symmetric solves / inverses
# ---------------------------------------------------------------------------

def add_rel_jitter(m: list[list[jax.Array]], rel_eps: float):
    """Tikhonov jitter relative to the mean diagonal (cavity guard; the
    reference instead traps FP faults, ba/ba.cpp:888)."""
    if rel_eps <= 0.0:
        return m
    d = len(m)
    mean_diag = m[0][0]
    for i in range(1, d):
        mean_diag = mean_diag + m[i][i]
    jit = (rel_eps / d) * jnp.abs(mean_diag)
    out = [row[:] for row in m]
    for i in range(d):
        out[i][i] = out[i][i] + jit
    return out


def cholesky(m: list[list[jax.Array]]):
    """Lower-triangular Cholesky factor, unrolled (cf. the reference's LDL^T,
    ba/matlib.cpp:180-222)."""
    l, _, _ = cholesky_with_pivot(m)
    return l


def cholesky_with_pivot(m: list[list[jax.Array]]):
    """Cholesky factor, the minimum pivot (pre-sqrt), and the reciprocal
    diagonal of L.

    The pivots are the Sylvester minors' ratios: min_pivot > 0 iff the
    matrix is positive definite — the per-edge PSD check that lets the
    solver hold back a message instead of inverting an indefinite cavity
    (the reference faults on these via hardware FP traps, ba/ba.cpp:888).

    ``inv_diag`` (1/L[j][j], already computed for the sub-diagonal scaling)
    is returned so callers CAN multiply instead of divide in solves (the
    sweep's edge_math does not: its solves stay true divides, the same
    computation as :func:`solve_sym`).
    """
    d = len(m)
    l = [[None] * d for _ in range(d)]
    inv_diag = [None] * d
    min_pivot = None
    for j in range(d):
        s = m[j][j]
        for k in range(j):
            s = s - l[j][k] * l[j][k]
        min_pivot = s if min_pivot is None else jnp.minimum(min_pivot, s)
        # max() keeps the factorisation finite past a bad pivot; callers
        # discard those lanes via min_pivot
        diag = jnp.sqrt(jnp.maximum(s, 1e-30))
        l[j][j] = diag
        inv_d = 1.0 / diag
        inv_diag[j] = inv_d
        for i in range(j + 1, d):
            v = m[i][j]
            for k in range(j):
                v = v - l[i][k] * l[j][k]
            l[i][j] = v * inv_d
    return l, min_pivot, inv_diag


def sym3_posdef(m: list[list[jax.Array]]) -> jax.Array:
    """Sylvester positive-definiteness test for symmetric 3x3 (row of bool)."""
    m00, m01, m02 = m[0][0], m[0][1], m[0][2]
    m11, m12, m22 = m[1][1], m[1][2], m[2][2]
    det2 = m00 * m11 - m01 * m01
    det3 = (m00 * (m11 * m22 - m12 * m12)
            - m01 * (m01 * m22 - m12 * m02)
            + m02 * (m01 * m12 - m11 * m02))
    return (m00 > 0) & (det2 > 0) & (det3 > 0)


def chol_solve(l: list[list[jax.Array]], rhs: list[jax.Array],
               inv_diag: list[jax.Array] | None = None) -> list[jax.Array]:
    """Solve (L L^T) x = b given the Cholesky factor.

    With ``inv_diag`` (from :func:`cholesky_with_pivot`) the 2d per-RHS
    divides become multiplies."""
    d = len(l)

    def scale(s, i):
        return s * inv_diag[i] if inv_diag is not None else s / l[i][i]

    # forward: L y = b
    y = [None] * d
    for i in range(d):
        s = rhs[i]
        for k in range(i):
            s = s - l[i][k] * y[k]
        y[i] = scale(s, i)
    # backward: L^T x = y
    x = [None] * d
    for i in range(d - 1, -1, -1):
        s = y[i]
        for k in range(i + 1, d):
            s = s - l[k][i] * x[k]
        x[i] = scale(s, i)
    return x


def solve_sym(m: list[list[jax.Array]], rhs: list[jax.Array]) -> list[jax.Array]:
    return chol_solve(cholesky(m), rhs)


def inv_sym3(m: list[list[jax.Array]]) -> list[list[jax.Array]]:
    """Closed-form adjugate inverse of symmetric 3x3 (ba/matlib.cpp:143-161
    vectorised; symmetry halves the cofactor work)."""
    inv, _ = inv_sym3_posdef(m)
    return inv


def inv_sym3_posdef(m: list[list[jax.Array]]):
    """(inverse, positive-definite mask) of symmetric 3x3 in one pass.

    The Sylvester test reuses the adjugate's intermediates: the (2,2)
    cofactor IS the leading 2x2 minor and the determinant IS the third —
    fusing it with the inverse saves recomputing both (vs a separate
    :func:`sym3_posdef`)."""
    a, b, c = m[0][0], m[0][1], m[0][2]
    d, e = m[1][1], m[1][2]
    f = m[2][2]
    c00 = d * f - e * e
    c01 = c * e - b * f
    c02 = b * e - c * d
    c11 = a * f - c * c
    c12 = b * c - a * e
    c22 = a * d - b * b
    det = a * c00 + b * c01 + c * c02
    ok = (a > 0) & (c22 > 0) & (det > 0)
    inv_det = 1.0 / det
    return [
        [c00 * inv_det, c01 * inv_det, c02 * inv_det],
        [c01 * inv_det, c11 * inv_det, c12 * inv_det],
        [c02 * inv_det, c12 * inv_det, c22 * inv_det],
    ], ok


def inv_sym_from_chol(l: list[list[jax.Array]]) -> list[list[jax.Array]]:
    """A^-1 = L^-T L^-1 with L^-1 by forward substitution, symmetric out."""
    d = len(l)
    m = [[None] * d for _ in range(d)]     # m[i][j] = (L^-1)[i][j], i >= j
    for i in range(d):
        mii = 1.0 / l[i][i]
        m[i][i] = mii
        for j in range(i - 1, -1, -1):
            s = l[i][j] * m[j][j]
            for k in range(j + 1, i):
                s = s + l[i][k] * m[k][j]
            m[i][j] = -s * mii
    out = [[None] * d for _ in range(d)]
    for i in range(d):
        for j in range(i + 1):
            acc = None
            for k in range(i, d):   # k >= i >= j
                t = m[k][i] * m[k][j]
                acc = t if acc is None else acc + t
            out[i][j] = acc
            out[j][i] = acc
    return out


# ---------------------------------------------------------------------------
# SO(3) / projection measurement model in planes
# ---------------------------------------------------------------------------

_SMALL_THETA = 1e-6


def so3_exp(w: list[jax.Array]) -> list[list[jax.Array]]:
    """Rodrigues' formula, unrolled (cf. ops/lie.so3_exp; ba/bafuncs.cpp:30-55)."""
    theta_sq = w[0] * w[0] + w[1] * w[1] + w[2] * w[2]
    theta = jnp.sqrt(theta_sq)
    small = theta < _SMALL_THETA
    th = jnp.where(small, 1.0, theta)
    th_sq = jnp.where(small, 1.0, theta_sq)
    a = jnp.where(small, 1.0, jnp.sin(th) / th)
    b = jnp.where(small, 0.5, (1.0 - jnp.cos(th)) / th_sq)
    one = jnp.ones_like(w[0])
    wx, wy, wz = w
    # R = I + a*hat(w) + b*hat(w)^2
    xx, yy, zz = wx * wx, wy * wy, wz * wz
    xy, xz, yz = wx * wy, wx * wz, wy * wz
    return [
        [one - b * (yy + zz), -a * wz + b * xy, a * wy + b * xz],
        [a * wz + b * xy, one - b * (xx + zz), -a * wx + b * yz],
        [-a * wy + b * xz, a * wx + b * yz, one - b * (xx + yy)],
    ]


def hat(v: list[jax.Array]) -> list[list[jax.Array]]:
    zero = jnp.zeros_like(v[0])
    return [
        [zero, -v[2], v[1]],
        [v[2], zero, -v[0]],
        [-v[1], v[0], zero],
    ]


def w2c_apply(cam: list[jax.Array], y: list[jax.Array]):
    """y_cam = R y + t; returns (y_cf vec3, R)."""
    r = so3_exp(cam[3:6])
    y_cf = [matvec(r, y)[i] + cam[i] for i in range(3)]
    return y_cf, r


def project(cam: list[jax.Array], lmk: list[jax.Array], k: jax.Array,
            intr: list[jax.Array] | None = None):
    """(u, v) pixel planes + (y_cf, R) intermediates.

    ``intr`` = None: shared pinhole K (ba/bafuncs.cpp:82-103).
    ``intr`` = [f, k1, k2] per-edge planes: the Snavely/BAL camera model
    (per-camera focal + two radial-distortion coefficients, camera looks
    down -z): p = -y_cf / z, uv = f (1 + k1 |p|^2 + k2 |p|^4) p.
    """
    y_cf, r = w2c_apply(cam, lmk)
    inv_z = 1.0 / y_cf[2]
    if intr is None:
        u = k[0, 0] * y_cf[0] * inv_z + k[0, 2]
        v = k[1, 1] * y_cf[1] * inv_z + k[1, 2]
    else:
        f, d1, d2 = intr
        px = -y_cf[0] * inv_z
        py = -y_cf[1] * inv_z
        rho = px * px + py * py
        dist = 1.0 + rho * (d1 + d2 * rho)
        u = f * dist * px
        v = f * dist * py
    return (u, v), y_cf, r


def linearise(
    cam: list[jax.Array],        # 6 planes
    lmk: list[jax.Array],        # 3 planes
    k: jax.Array,                # [3,3] intrinsics (host constants)
    meas_u: jax.Array,           # [E]
    meas_v: jax.Array,           # [E]
    meas_var: jax.Array,         # [E]
    nstds: float,
    intr: list[jax.Array] | None = None,   # Snavely [f, k1, k2] planes
):
    """Fused reprojection-factor relinearisation in planes.

    Returns (eta_c[6], eta_l[3], lam_cc mat6, lam_cl mat6x3, lam_ll mat3,
    robust [E], y_cf vec3) — the body of RelineariseFactorVertex
    (ba/gbp_codelets.cpp:38-171) batched over all edges. With ``intr``
    the measurement head is the Snavely/BAL model (see :func:`project`);
    everything from j_proj down (pose/landmark chain rule, Huber,
    potential assembly) is model-independent. ``y_cf`` (the landmark in
    the camera frame) is returned so callers' depth guards reuse it
    instead of re-running Rodrigues (~80 ops + sin/cos/sqrt per edge).
    """
    (u, v), y_cf, r = project(cam, lmk, k, intr)
    inv_z = 1.0 / y_cf[2]
    inv_z2 = inv_z * inv_z
    zero = jnp.zeros_like(u)

    if intr is None:
        # d(u,v)/dy_cam (ba/bafuncs.cpp:134-140)
        fx, fy = k[0, 0], k[1, 1]
        j_proj = [
            [fx * inv_z, zero, -fx * y_cf[0] * inv_z2],
            [zero, fy * inv_z, -fy * y_cf[1] * inv_z2],
        ]
    else:
        # Snavely chain rule: uv = f dist(rho) p with p = -y/z,
        # rho = |p|^2, dist = 1 + k1 rho + k2 rho^2,
        # d uv/dy = f (dist dp/dy + p (k1 + 2 k2 rho) drho/dy)
        f, d1, d2 = intr
        px = -y_cf[0] * inv_z
        py = -y_cf[1] * inv_z
        rho = px * px + py * py
        dist = 1.0 + rho * (d1 + d2 * rho)
        g = d1 + 2.0 * d2 * rho
        dpx = [-inv_z, zero, y_cf[0] * inv_z2]
        dpy = [zero, -inv_z, y_cf[1] * inv_z2]
        drho = [2.0 * (px * dpx[i] + py * dpy[i]) for i in range(3)]
        j_proj = [
            [f * (dist * dpx[i] + px * g * drho[i]) for i in range(3)],
            [f * (dist * dpy[i] + py * g * drho[i]) for i in range(3)],
        ]

    # landmark block: J_proj @ R
    j_lmk = matmul(j_proj, r)

    # rotation block via the global axis-angle derivative
    # dRy/dw = -R hat(y) ((R^T - I) hat(w) + w w^T) / ||w||^2
    # with the exact w->0 limit -hat(y)   (ba/bafuncs.cpp:152-206)
    w = cam[3:6]
    theta_sq = w[0] * w[0] + w[1] * w[1] + w[2] * w[2]
    small = theta_sq < 1e-12
    denom = jnp.where(small, 1.0, theta_sq)
    w_hat = hat(w)
    y_hat = hat(lmk)
    one = jnp.ones_like(u)
    rt_minus_i = [[r[j][i] - (one if i == j else zero) for j in range(3)]
                  for i in range(3)]
    numer = matmul(rt_minus_i, w_hat)
    for i in range(3):
        for j in range(3):
            numer[i][j] = numer[i][j] + w[i] * w[j]
    r_yhat = matmul(r, y_hat)
    d_ry_dw_full = matmul(r_yhat, numer)
    d_ry_dw = [[jnp.where(small, -y_hat[i][j],
                          -d_ry_dw_full[i][j] / denom)
                for j in range(3)] for i in range(3)]
    j_rot = matmul(j_proj, d_ry_dw)

    # J_kf = [J_proj | J_rot]  (2 x 6)
    j_kf = [j_proj[0] + j_rot[0], j_proj[1] + j_rot[1]]

    # residual-side vector b = J x0 + z - h(x0)  (2 planes)
    jx0_u = vdot(j_kf[0], cam) + vdot(j_lmk[0], lmk)
    jx0_v = vdot(j_kf[1], cam) + vdot(j_lmk[1], lmk)
    b_u = jx0_u + meas_u - u
    b_v = jx0_v + meas_v - v

    # Huber variance inflation (ba/gbp_codelets.cpp:134-141)
    ru = meas_u - u
    rv = meas_v - v
    err = jnp.sqrt(ru * ru + rv * rv)
    sigma = jnp.sqrt(meas_var)
    robust = err > nstds * sigma
    denom_h = 2.0 * (nstds * sigma * err - 0.5 * nstds * nstds * meas_var)
    denom_h = jnp.where(robust, denom_h, 1.0)
    var = jnp.where(robust, meas_var * err * err / denom_h, meas_var)
    inv_var = 1.0 / var

    eta_c = [(j_kf[0][i] * b_u + j_kf[1][i] * b_v) * inv_var for i in range(6)]
    eta_l = [(j_lmk[0][i] * b_u + j_lmk[1][i] * b_v) * inv_var for i in range(3)]
    lam_cc = [[None] * 6 for _ in range(6)]
    for i in range(6):
        for j in range(i + 1):
            val = (j_kf[0][i] * j_kf[0][j] + j_kf[1][i] * j_kf[1][j]) * inv_var
            lam_cc[i][j] = val
            lam_cc[j][i] = val
    lam_ll = [[None] * 3 for _ in range(3)]
    for i in range(3):
        for j in range(i + 1):
            val = (j_lmk[0][i] * j_lmk[0][j] + j_lmk[1][i] * j_lmk[1][j]) * inv_var
            lam_ll[i][j] = val
            lam_ll[j][i] = val
    lam_cl = [[(j_kf[0][i] * j_lmk[0][j] + j_kf[1][i] * j_lmk[1][j]) * inv_var
               for j in range(3)] for i in range(6)]
    return eta_c, eta_l, lam_cc, lam_cl, lam_ll, robust, y_cf
