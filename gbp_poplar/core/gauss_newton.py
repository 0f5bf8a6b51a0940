"""Levenberg-Marquardt / Schur-complement bundle-adjustment baseline.

The reference cross-checks GBP only by eyeballing reprojection error
(ba/ba.cpp:1022-1028); BASELINE.md asks for a real Gauss-Newton /
Schur-complement cross-check solver. This is a Ceres-style *iterative Schur*
solver, designed for a dense accelerator:

  - No global sparse matrix is ever materialised. The reduced camera system
    ``S = A + P_c - W M^-1 W^T`` is applied **matrix-free**: every matvec is
    per-edge batched 6x3/3x3 work (gathers over ``cam_idx``/``lmk_idx`` +
    ``segment_sum``), exactly the data layout the GBP sweep uses.
  - Landmarks are marginalised in closed form per landmark (3x3 inverses,
    batched), cameras solved by preconditioned CG with the **exact block
    diagonal of S** as block-Jacobi preconditioner (each (cam, lmk) pair
    appears in at most one edge, so the diagonal correction
    ``segment_sum(W M^-1 W^T)`` is exact, not an approximation).
  - Huber robustness enters as IRLS reweighting with the same
    variance-inflation rule as the GBP factors (ops/projection.py,
    reference: ba/gbp_codelets.cpp:134-141).
  - The same per-variable Gaussian priors the GBP solver anneals to are
    added to the normal equations, so both solvers optimise the same MAP
    objective and their solutions are directly comparable.

Everything is jit-compatible; the LM accept/reject loop is a ``lax.scan``.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import GBPConfig
from ..ops import linalg, projection
from .factor_graph import GBPGraph


class GNPriors(NamedTuple):
    """Per-variable Gaussian priors (information form) for the MAP objective."""

    cam_lam: jax.Array  # [C] isotropic precision
    cam_mu: jax.Array   # [C, 6]
    lmk_lam: jax.Array  # [L] isotropic precision
    lmk_mu: jax.Array   # [L, 3]


class GNResult(NamedTuple):
    cam: jax.Array        # [C, 6] final poses
    lmk: jax.Array        # [L, 3] final landmarks
    cost: jax.Array       # [n_lm_iters] robust cost trace
    reproj_err: jax.Array  # [n_lm_iters] mean reprojection error (px)
    accepted: jax.Array   # [n_lm_iters] bool, LM step accepted
    lm_lambda: jax.Array  # final damping


def annealed_priors(
    graph: GBPGraph, cam_mu0: jax.Array, lmk_mu0: jax.Array,
    cam_lam0: jax.Array, lmk_lam0: jax.Array, cfg: GBPConfig,
) -> GNPriors:
    """The priors GBP ends up with after its annealing schedule.

    After `steps` applications of the per-variable scaling
    (utils/priors.build_priors): anchor keyframes end at
    1/first_cam_prior_std^2, all other variables are weakened by
    prior_std_weaker_factor^2 (reference: ba/ba.cpp:560-572).
    """
    c = cam_lam0.shape[0]
    anchor = jnp.arange(c) < cfg.num_anchor_cams
    weak = cfg.prior_std_weaker_factor ** 2
    cam_lam = jnp.where(anchor, 1.0 / cfg.first_cam_prior_std ** 2,
                        cam_lam0 / weak)
    lmk_lam = lmk_lam0 / weak
    return GNPriors(cam_lam=cam_lam, cam_mu=cam_mu0,
                    lmk_lam=lmk_lam, lmk_mu=lmk_mu0)


def _weights(r: jax.Array, meas_var: jax.Array, nstds: float) -> jax.Array:
    """IRLS weights 1/var' with the GBP Huber variance-inflation rule."""
    err = jnp.linalg.norm(r, axis=-1)
    var, _ = projection.huber_meas_var(err, meas_var, nstds)
    return 1.0 / var


def _robust_cost(
    r: jax.Array, meas_var: jax.Array, nstds: float
) -> jax.Array:
    """Sum of Huber losses (in whitened units) over edges."""
    err2 = jnp.sum(r * r, axis=-1) / meas_var
    err = jnp.sqrt(err2)
    k = nstds
    quad = 0.5 * err2
    lin = k * err - 0.5 * k * k
    return jnp.sum(jnp.where(err > k, lin, quad))


def _prior_cost(cam, lmk, priors: GNPriors) -> jax.Array:
    dc = cam - priors.cam_mu
    dl = lmk - priors.lmk_mu
    return 0.5 * (jnp.sum(priors.cam_lam[:, None] * dc * dc)
                  + jnp.sum(priors.lmk_lam[:, None] * dl * dl))


def map_cost(cam, lmk, graph: GBPGraph, priors: GNPriors,
             cfg: GBPConfig) -> jax.Array:
    """The MAP objective both solvers optimise (robust reprojection +
    Gaussian priors) at the given means — the cross-solver comparison
    metric for docs/VALIDATION.md. Evaluated in _GN_CHUNK_EDGES-edge
    chunks so it runs at >= 1M edges (the reference's cost print is
    ba/ba.cpp:1022-1028)."""
    e = graph.cam_idx.shape[0]
    ce = min(_GN_CHUNK_EDGES, e)
    n_ch = -(-e // ce)
    e_pad = n_ch * ce
    ci = _chunk_pad(graph.cam_idx, e_pad).reshape(n_ch, ce)
    li = _chunk_pad(graph.lmk_idx, e_pad).reshape(n_ch, ce)
    meas = _chunk_pad(graph.meas.T, e_pad).reshape(n_ch, ce, 2)
    mvar = _chunk_pad(graph.meas_var, e_pad, 1.0).reshape(n_ch, ce)
    valid = (jnp.arange(e_pad) < e).astype(cam.dtype).reshape(n_ch, ce)
    intr = (None if graph.intr is None
            else _chunk_pad(graph.intr.T, e_pad).reshape(n_ch, ce, 3))

    def body(acc, xs):
        ci_k, li_k, meas_k, mvar_k, val_k = xs[:5]
        intr_k = xs[5] if len(xs) > 5 else None
        r = meas_k - projection.project(cam[ci_k], lmk[li_k], graph.k,
                                        intr_k)
        err2 = jnp.sum(r * r, axis=-1) / mvar_k
        err = jnp.sqrt(err2)
        k = cfg.huber_nstds
        loss = jnp.where(err > k, k * err - 0.5 * k * k, 0.5 * err2)
        return acc + jnp.sum(loss * val_k), None

    xs = (ci, li, meas, mvar, valid) + (() if intr is None else (intr,))
    robust, _ = jax.lax.scan(body, jnp.zeros((), cam.dtype), xs)
    return robust + _prior_cost(cam, lmk, priors)


# ---------------------------------------------------------------------------
# Plane-major large-E path.
#
# The batched [E, d, d] formulation above is fine at TUM scale but is the
# repo's canonical layout trap at millions of edges: tiny minor dims
# ([E, 6, 3], [L, 3]) make every batched step a strided small-tile pass,
# and the [E, d, d] temporaries dominate device memory at the Venice
# shape. Above _GN_CHUNK_EDGES the solver switches to the plane layout the rest
# of the framework uses ([comp, N], edge axis minor), with the per-edge
# normal-equation blocks produced by ops/planes.linearise — the SAME
# single-source Jacobian/Huber code the GBP sweep runs, so the two
# solvers share their linearisation to the expression level. Per-edge
# work streams in chunks; only [comp, E]/[comp, L] planes and [C, *]
# arrays (C is always small) persist.
# ---------------------------------------------------------------------------


class _EdgeChunks(NamedTuple):
    """Static edge-chunking of the graph for the plane-major path."""

    n_ch: int
    ce: int
    ci: jax.Array      # [n_ch, ce]
    li: jax.Array      # [n_ch, ce]
    meas: jax.Array    # [n_ch, 2, ce]
    mvar: jax.Array    # [n_ch, ce]
    valid: jax.Array   # [n_ch, ce]
    intr: jax.Array | None   # [n_ch, 3, ce]


def _edge_chunks(graph: GBPGraph, dtype) -> _EdgeChunks:
    e = graph.cam_idx.shape[0]
    ce = min(_GN_CHUNK_EDGES, e)
    n_ch = -(-e // ce)
    e_pad = n_ch * ce
    return _EdgeChunks(
        n_ch=n_ch, ce=ce,
        ci=_chunk_pad(graph.cam_idx, e_pad).reshape(n_ch, ce),
        li=_chunk_pad(graph.lmk_idx, e_pad).reshape(n_ch, ce),
        meas=_chunk_pad(graph.meas.T, e_pad).reshape(n_ch, ce, 2)
        .transpose(0, 2, 1),
        mvar=_chunk_pad(graph.meas_var, e_pad, 1.0).reshape(n_ch, ce),
        valid=(jnp.arange(e_pad) < e).astype(dtype).reshape(n_ch, ce),
        intr=(None if graph.intr is None else
              _chunk_pad(graph.intr.T, e_pad).reshape(n_ch, ce, 3)
              .transpose(0, 2, 1)),
    )


def _ck_xs(ck: _EdgeChunks):
    xs = (ck.ci, ck.li, ck.meas, ck.mvar, ck.valid)
    return xs + (() if ck.intr is None else (ck.intr,))


class _NormalEqsP(NamedTuple):
    a_c: jax.Array        # [C, 6, 6] damped camera blocks (C is small)
    m_inv6: jax.Array     # [6, L] packed symmetric landmark inverses
    w18: jax.Array        # [n_ch, 18, ce] cross blocks, chunk-major
    b_c: jax.Array        # [C, 6]
    b_l3: jax.Array       # [3, L]
    s_diag_inv: jax.Array  # [C, 6, 6]


def _sym21_dense(a21: jax.Array) -> jax.Array:
    """[C, 21] packed symmetric -> [C, 6, 6] dense (C-sized: cheap)."""
    from ..ops import planes as pl
    c = a21.shape[0]
    out = jnp.zeros((c, 6, 6), a21.dtype)
    for s, (i, j) in enumerate(pl.SYM6_IDX):
        out = out.at[:, i, j].set(a21[:, s])
        if i != j:
            out = out.at[:, j, i].set(a21[:, s])
    return out


def _build_planes(
    camT, lmkT, graph: GBPGraph, priors: GNPriors, nstds: float,
    lm_lambda: jax.Array, ck: _EdgeChunks,
) -> _NormalEqsP:
    """Normal equations in plane layout, streamed per chunk.

    ``camT`` [6, C] / ``lmkT`` [3, L] are the current means as planes.
    Per-edge blocks come from ops/planes.linearise (eta = J^T W (J x0 +
    r0) at the linearisation point x0 = current means, so the GN rhs is
    b = eta - Lambda @ x0 exactly)."""
    from ..ops import planes as pl
    c, l = graph.n_keyframes, graph.n_points

    def body(carry, xs):
        a21, m_l6, b_c6, b_l3 = carry
        ci_k, li_k, meas_k, mvar_k, val_k = xs[:5]
        intr_k = xs[5] if len(xs) > 5 else None
        mu_c = [camT[i][ci_k] for i in range(6)]
        mu_l = [lmkT[i][li_k] for i in range(3)]
        intr_rows = None if intr_k is None else [intr_k[i] for i in range(3)]
        (eta_c, eta_l, lam_cc, lam_cl, lam_ll, _rob, _ycf) = pl.linearise(
            mu_c, mu_l, graph.k, meas_k[0], meas_k[1], mvar_k, nstds,
            intr_rows)
        b_c_rows = [eta_c[i]
                    - sum(lam_cc[i][j] * mu_c[j] for j in range(6))
                    - sum(lam_cl[i][j] * mu_l[j] for j in range(3))
                    for i in range(6)]
        b_l_rows = [eta_l[j]
                    - sum(lam_cl[i][j] * mu_c[i] for i in range(6))
                    - sum(lam_ll[j][j2] * mu_l[j2] for j2 in range(3))
                    for j in range(3)]

        def seg(rows, ids, n):
            cols = jnp.stack(rows, axis=-1) * val_k[:, None]
            return jax.ops.segment_sum(cols, ids, num_segments=n)

        a21 = a21 + seg([lam_cc[i][j] for (i, j) in pl.SYM6_IDX], ci_k, c)
        m_l6 = m_l6 + seg([lam_ll[i][j] for (i, j) in pl.SYM3_IDX],
                          li_k, l).T
        b_c6 = b_c6 + seg(b_c_rows, ci_k, c)
        b_l3 = b_l3 + seg(b_l_rows, li_k, l).T
        w_k = jnp.stack([lam_cl[i][j] for i in range(6) for j in range(3)])
        return (a21, m_l6, b_c6, b_l3), w_k * val_k[None]

    f = camT.dtype
    init = (jnp.zeros((c, 21), f), jnp.zeros((6, l), f),
            jnp.zeros((c, 6), f), jnp.zeros((3, l), f))
    (a21, m_l6, b_c, b_l3), w18 = jax.lax.scan(body, init, _ck_xs(ck))

    # priors + LM damping (additive Marquardt), then invert the landmark
    # blocks in plane form
    a_c = _sym21_dense(a21)
    eye6 = jnp.eye(6, dtype=f)
    a_c = a_c + priors.cam_lam[:, None, None] * eye6
    damp = 1.0 + lm_lambda
    a_c = a_c * jnp.where(eye6 > 0, damp, 1.0)
    b_c = b_c + priors.cam_lam[:, None] * (priors.cam_mu - camT.T)

    diag3 = [pl.sym_slot(i, i) for i in range(3)]
    m_l6 = m_l6.at[jnp.asarray(diag3)].add(priors.lmk_lam[None, :])
    m_l6 = m_l6.at[jnp.asarray(diag3)].multiply(damp)
    b_l3 = b_l3 + priors.lmk_lam[None, :] * (priors.lmk_mu.T - lmkT)
    m_inv6 = pl.pack_sym(pl.inv_sym3(pl.unpack_sym(m_l6, 3)), 3)

    # exact S block diagonal, chunked: wmw = W M^-1 W^T per edge
    def wbody(acc, xs):
        w_k, ci_k, li_k = xs
        mv_g = m_inv6[:, li_k]                   # [6, ce] gathered slots
        mv = [[mv_g[pl.sym_slot(i, j)] for j in range(3)]
              for i in range(3)]
        w_m = [[w_k[i * 3 + j] for j in range(3)] for i in range(6)]
        t = [[sum(w_m[i][k2] * mv[k2][j] for k2 in range(3))
              for j in range(3)] for i in range(6)]
        rows = [sum(t[i][j2] * w_m[j][j2] for j2 in range(3))
                for (i, j) in pl.SYM6_IDX]
        return acc + jax.ops.segment_sum(jnp.stack(rows, -1), ci_k,
                                         num_segments=c), None

    acc0 = jnp.zeros((c, 21), f)
    wmw21, _ = jax.lax.scan(wbody, acc0, (w18, ck.ci, ck.li))
    s_diag = a_c - _sym21_dense(wmw21)
    return _NormalEqsP(a_c, m_inv6, w18, b_c, b_l3,
                       linalg.inv6x6(s_diag))


def _wt_v_l3(ne: _NormalEqsP, ck: _EdgeChunks, v: jax.Array,
             l: int) -> jax.Array:
    """W^T v summed per landmark -> [3, L] (v: [C, 6])."""
    vT = v.T

    def body(acc, xs):
        w_k, ci_k, li_k = xs
        ve = [vT[i][ci_k] for i in range(6)]
        rows = [sum(w_k[i * 3 + j] * ve[i] for i in range(6))
                for j in range(3)]
        return acc + jax.ops.segment_sum(jnp.stack(rows, -1), li_k,
                                         num_segments=l).T, None

    acc0 = jnp.zeros((3, l), v.dtype)
    out, _ = jax.lax.scan(body, acc0, (ne.w18, ck.ci, ck.li))
    return out


def _w_z_c6(ne: _NormalEqsP, ck: _EdgeChunks, z3: jax.Array,
            c: int) -> jax.Array:
    """W z summed per camera -> [C, 6] (z3: [3, L])."""

    def body(acc, xs):
        w_k, ci_k, li_k = xs
        ze = [z3[j][li_k] for j in range(3)]
        rows = [sum(w_k[i * 3 + j] * ze[j] for j in range(3))
                for i in range(6)]
        return acc + jax.ops.segment_sum(jnp.stack(rows, -1), ci_k,
                                         num_segments=c), None

    acc0 = jnp.zeros((c, 6), z3.dtype)
    out, _ = jax.lax.scan(body, acc0, (ne.w18, ck.ci, ck.li))
    return out


def _minv_apply(ne: _NormalEqsP, y3: jax.Array) -> jax.Array:
    """M^-1 y per landmark, plane form: [3, L] -> [3, L]."""
    from ..ops import planes as pl
    return pl.pack_vec(pl.matvec(pl.unpack_sym(ne.m_inv6, 3),
                                 [y3[j] for j in range(3)]))


def _schur_matvec_p(ne: _NormalEqsP, ck: _EdgeChunks, graph: GBPGraph,
                    v: jax.Array) -> jax.Array:
    c, l = graph.n_keyframes, graph.n_points
    av = linalg.bmv(ne.a_c, v)
    z3 = _minv_apply(ne, _wt_v_l3(ne, ck, v, l))
    return av - _w_z_c6(ne, ck, z3, c)


def _residual_sums_planes(camT, lmkT, graph: GBPGraph, nstds: float,
                          ck: _EdgeChunks):
    """(sum of Huber losses, sum of residual norms) over real edges, in
    one chunked pass over planes (pl.project — the same projection rows
    the sweep uses)."""
    from ..ops import planes as pl

    def body(acc, xs):
        loss_acc, norm_acc = acc
        ci_k, li_k, meas_k, mvar_k, val_k = xs[:5]
        intr_k = xs[5] if len(xs) > 5 else None
        mu_c = [camT[i][ci_k] for i in range(6)]
        mu_l = [lmkT[i][li_k] for i in range(3)]
        intr_rows = None if intr_k is None else [intr_k[i] for i in range(3)]
        (u, v), _, _ = pl.project(mu_c, mu_l, graph.k, intr_rows)
        ru = meas_k[0] - u
        rv = meas_k[1] - v
        r2 = ru * ru + rv * rv
        err2 = r2 / mvar_k
        err = jnp.sqrt(err2)
        k = nstds
        loss = jnp.where(err > k, k * err - 0.5 * k * k, 0.5 * err2)
        return (loss_acc + jnp.sum(loss * val_k),
                norm_acc + jnp.sum(jnp.sqrt(r2) * val_k)), None

    z = jnp.zeros((), camT.dtype)
    (loss, norms), _ = jax.lax.scan(body, (z, z), _ck_xs(ck))
    return loss, norms


def _map_cost_planes(camT, lmkT, graph, priors: GNPriors, nstds: float,
                     ck: _EdgeChunks) -> jax.Array:
    loss, _ = _residual_sums_planes(camT, lmkT, graph, nstds, ck)
    dc = camT.T - priors.cam_mu
    dl = lmkT - priors.lmk_mu.T
    return loss + 0.5 * (jnp.sum(priors.cam_lam[:, None] * dc * dc)
                         + jnp.sum(priors.lmk_lam[None, :] * dl * dl))


def _mean_err_chunked(cam, lmk, graph: GBPGraph) -> jax.Array:
    """Mean per-edge residual norm, streamed like map_cost (diagnostic
    counterpart for the chunked large-E path)."""
    e = graph.cam_idx.shape[0]
    ce = min(_GN_CHUNK_EDGES, e)
    n_ch = -(-e // ce)
    e_pad = n_ch * ce
    ci = _chunk_pad(graph.cam_idx, e_pad).reshape(n_ch, ce)
    li = _chunk_pad(graph.lmk_idx, e_pad).reshape(n_ch, ce)
    meas = _chunk_pad(graph.meas.T, e_pad).reshape(n_ch, ce, 2)
    valid = (jnp.arange(e_pad) < e).astype(cam.dtype).reshape(n_ch, ce)
    intr = (None if graph.intr is None
            else _chunk_pad(graph.intr.T, e_pad).reshape(n_ch, ce, 3))

    def body(acc, xs):
        ci_k, li_k, meas_k, val_k = xs[:4]
        intr_k = xs[4] if len(xs) > 4 else None
        r = meas_k - projection.project(cam[ci_k], lmk[li_k], graph.k,
                                        intr_k)
        return acc + jnp.sum(jnp.linalg.norm(r, axis=-1) * val_k), None

    xs = (ci, li, meas, valid) + (() if intr is None else (intr,))
    total, _ = jax.lax.scan(body, jnp.zeros((), cam.dtype), xs)
    return total / e


class _NormalEqs(NamedTuple):
    a_c: jax.Array      # [C, 6, 6] camera diag blocks (incl prior + LM damping)
    m_inv: jax.Array    # [L, 3, 3] inverted landmark blocks
    w: jax.Array        # [E, 6, 3] cross blocks
    b_c: jax.Array      # [C, 6] camera rhs
    b_l: jax.Array      # [L, 3] landmark rhs
    s_diag_inv: jax.Array  # [C, 6, 6] inverse of exact S block diagonal


# Edge-chunk size for the normal-equation build at large E. The [E, 6, 6]
# batched block temporaries are the same non-plane-layout memory trap fixed
# in utils/priors.build_priors (round 4): at 5M edges jtj_cc + wmw alone
# request ~1.4 GB and the whole build several GB of HBM. Above this many
# edges the build streams 512k-edge chunks through a lax.scan, accumulating
# the per-variable segment sums in the carry — only the [E, 6, 3] cross
# blocks (needed by every CG matvec) stay whole. Reduction order changes
# (chunked partial sums), so small problems keep the single-shot path and
# the pinned oracle numbers.
_GN_CHUNK_EDGES = 1 << 19


def _build(
    cam, lmk, graph: GBPGraph, priors: GNPriors, nstds: float,
    lm_lambda: jax.Array,
) -> _NormalEqs:
    c, l = graph.n_keyframes, graph.n_points
    e = graph.cam_idx.shape[0]
    if e > _GN_CHUNK_EDGES:
        a_c, m_l, b_c, b_l, w_cl = _build_sums_chunked(
            cam, lmk, graph, nstds)
    else:
        cam_e = cam[graph.cam_idx]
        lmk_e = lmk[graph.lmk_idx]
        intr_e = None if graph.intr is None else graph.intr.T  # [E, 3]
        j_c, j_l = projection.reproj_jacobians(cam_e, lmk_e, graph.k, intr_e)
        r = graph.meas.T - projection.project(cam_e, lmk_e, graph.k, intr_e)
        w_e = _weights(r, graph.meas_var, nstds)[:, None, None]  # [E,1,1]

        jtj_cc = linalg.bmm(linalg.transpose(j_c), j_c) * w_e    # [E,6,6]
        jtj_ll = linalg.bmm(linalg.transpose(j_l), j_l) * w_e    # [E,3,3]
        w_cl = linalg.bmm(linalg.transpose(j_c), j_l) * w_e      # [E,6,3]
        jtr_c = linalg.bmv(linalg.transpose(j_c), r) * w_e[..., 0]
        jtr_l = linalg.bmv(linalg.transpose(j_l), r) * w_e[..., 0]

        a_c = jax.ops.segment_sum(jtj_cc, graph.cam_idx, num_segments=c)
        m_l = jax.ops.segment_sum(jtj_ll, graph.lmk_idx, num_segments=l)
        b_c = jax.ops.segment_sum(jtr_c, graph.cam_idx, num_segments=c)
        b_l = jax.ops.segment_sum(jtr_l, graph.lmk_idx, num_segments=l)

    eye6 = jnp.eye(6, dtype=cam.dtype)
    eye3 = jnp.eye(3, dtype=cam.dtype)
    # priors + LM damping (additive Marquardt: lambda * (diag + prior))
    a_c = a_c + (priors.cam_lam[:, None, None] * eye6)
    m_l = m_l + (priors.lmk_lam[:, None, None] * eye3)
    b_c = b_c + priors.cam_lam[:, None] * (priors.cam_mu - cam)
    b_l = b_l + priors.lmk_lam[:, None] * (priors.lmk_mu - lmk)
    damp = 1.0 + lm_lambda
    a_c = a_c * jnp.where(eye6 > 0, damp, 1.0)
    m_l = m_l * jnp.where(eye3 > 0, damp, 1.0)

    m_inv = linalg.inv3x3(m_l)

    # exact block diagonal of S: each (cam, lmk) pair occurs in one edge
    if e > _GN_CHUNK_EDGES:
        wmw_sum = _wmw_sum_chunked(w_cl, m_inv, graph, c)
    else:
        wmw = linalg.bmm(w_cl, linalg.bmm(m_inv[graph.lmk_idx],
                                          linalg.transpose(w_cl)))
        wmw_sum = jax.ops.segment_sum(wmw, graph.cam_idx, num_segments=c)
    s_diag = a_c - wmw_sum
    s_diag_inv = linalg.inv6x6(s_diag)
    return _NormalEqs(a_c, m_inv, w_cl, b_c, b_l, s_diag_inv)


def _chunk_pad(x, e_pad: int, fill=0):
    pad = e_pad - x.shape[0]
    if pad == 0:
        return x
    widths = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
    return jnp.pad(x, widths, constant_values=fill)


def _build_sums_chunked(cam, lmk, graph: GBPGraph, nstds: float):
    """Segment sums of the normal-equation blocks, streamed in
    _GN_CHUNK_EDGES-edge chunks through a lax.scan so no [E, d, d] batched
    temporary is ever materialised (unchunked, they exhaust device memory
    at 5M edges — the utils/priors.build_priors trap). Padding edges carry weight 0 and
    index 0, contributing exactly nothing to every sum; the [E, 6, 3]
    cross blocks are emitted per chunk and reshaped back (CG needs them
    every matvec)."""
    c, l = graph.n_keyframes, graph.n_points
    e = graph.cam_idx.shape[0]
    ce = _GN_CHUNK_EDGES
    n_ch = -(-e // ce)
    e_pad = n_ch * ce
    ci = _chunk_pad(graph.cam_idx, e_pad).reshape(n_ch, ce)
    li = _chunk_pad(graph.lmk_idx, e_pad).reshape(n_ch, ce)
    meas = _chunk_pad(graph.meas.T, e_pad).reshape(n_ch, ce, 2)
    mvar = _chunk_pad(graph.meas_var, e_pad, 1.0).reshape(n_ch, ce)
    valid = (jnp.arange(e_pad) < e).astype(cam.dtype).reshape(n_ch, ce)
    intr = (None if graph.intr is None
            else _chunk_pad(graph.intr.T, e_pad).reshape(n_ch, ce, 3))

    def body(carry, xs):
        a_c, m_l, b_c, b_l = carry
        ci_k, li_k, meas_k, mvar_k, val_k, intr_k = xs
        cam_e = cam[ci_k]
        lmk_e = lmk[li_k]
        j_c, j_l = projection.reproj_jacobians(cam_e, lmk_e, graph.k, intr_k)
        r = meas_k - projection.project(cam_e, lmk_e, graph.k, intr_k)
        w_e = (_weights(r, mvar_k, nstds) * val_k)[:, None, None]
        jtj_cc = linalg.bmm(linalg.transpose(j_c), j_c) * w_e
        jtj_ll = linalg.bmm(linalg.transpose(j_l), j_l) * w_e
        w_cl = linalg.bmm(linalg.transpose(j_c), j_l) * w_e
        jtr_c = linalg.bmv(linalg.transpose(j_c), r) * w_e[..., 0]
        jtr_l = linalg.bmv(linalg.transpose(j_l), r) * w_e[..., 0]
        a_c = a_c + jax.ops.segment_sum(jtj_cc, ci_k, num_segments=c)
        m_l = m_l + jax.ops.segment_sum(jtj_ll, li_k, num_segments=l)
        b_c = b_c + jax.ops.segment_sum(jtr_c, ci_k, num_segments=c)
        b_l = b_l + jax.ops.segment_sum(jtr_l, li_k, num_segments=l)
        return (a_c, m_l, b_c, b_l), w_cl

    f = cam.dtype
    init = (jnp.zeros((c, 6, 6), f), jnp.zeros((l, 3, 3), f),
            jnp.zeros((c, 6), f), jnp.zeros((l, 3), f))
    xs = (ci, li, meas, mvar, valid) + ((intr,) if intr is not None else ())
    if intr is None:
        (a_c, m_l, b_c, b_l), w_cl = jax.lax.scan(
            lambda cr, x: body(cr, x + (None,)), init, xs)
    else:
        (a_c, m_l, b_c, b_l), w_cl = jax.lax.scan(body, init, xs)
    return a_c, m_l, b_c, b_l, w_cl.reshape(e_pad, 6, 3)[:e]


def _wmw_sum_chunked(w_cl, m_inv, graph: GBPGraph, c: int):
    """segment_sum(W M^-1 W^T) over cameras, chunked like the build (the
    [E, 6, 6] wmw temporary is the largest single build buffer)."""
    e = graph.cam_idx.shape[0]
    ce = _GN_CHUNK_EDGES
    n_ch = -(-e // ce)
    e_pad = n_ch * ce
    # padding cross blocks are zero -> zero contribution at index 0
    w_p = _chunk_pad(w_cl, e_pad).reshape(n_ch, ce, 6, 3)
    ci = _chunk_pad(graph.cam_idx, e_pad).reshape(n_ch, ce)
    li = _chunk_pad(graph.lmk_idx, e_pad).reshape(n_ch, ce)

    def body(acc, xs):
        w_k, ci_k, li_k = xs
        wmw = linalg.bmm(w_k, linalg.bmm(m_inv[li_k],
                                         linalg.transpose(w_k)))
        return acc + jax.ops.segment_sum(wmw, ci_k, num_segments=c), None

    acc0 = jnp.zeros((c, 6, 6), w_cl.dtype)
    acc, _ = jax.lax.scan(body, acc0, (w_p, ci, li))
    return acc


def _schur_matvec(ne: _NormalEqs, graph: GBPGraph, v: jax.Array) -> jax.Array:
    """S v = (A - W M^-1 W^T) v, matrix-free over edges. v: [C, 6]."""
    c, l = graph.n_keyframes, graph.n_points
    av = linalg.bmv(ne.a_c, v)
    v_e = v[graph.cam_idx]                                    # [E, 6]
    y_l = jax.ops.segment_sum(
        linalg.bmv(linalg.transpose(ne.w), v_e), graph.lmk_idx,
        num_segments=l)                                       # [L, 3]
    z_l = linalg.bmv(ne.m_inv, y_l)
    u_e = linalg.bmv(ne.w, z_l[graph.lmk_idx])                # [E, 6]
    return av - jax.ops.segment_sum(u_e, graph.cam_idx, num_segments=c)


def _schur_rhs(ne: _NormalEqs, graph: GBPGraph) -> jax.Array:
    """b_c - W M^-1 b_l, the reduced-system right-hand side."""
    c = graph.n_keyframes
    z_l = linalg.bmv(ne.m_inv, ne.b_l)
    u_e = linalg.bmv(ne.w, z_l[graph.lmk_idx])
    return ne.b_c - jax.ops.segment_sum(u_e, graph.cam_idx, num_segments=c)


def _pcg(ne, graph: GBPGraph, rhs: jax.Array,
         n_iters: int, tol: float, matvec=None) -> jax.Array:
    """Block-Jacobi preconditioned CG on the reduced camera system.

    ``ne`` is either _NormalEqs (batched small-E layout) or _NormalEqsP
    (plane-major large-E layout) — both carry s_diag_inv; ``matvec``
    overrides the default batched Schur product for the plane path."""
    if matvec is None:
        matvec = lambda p: _schur_matvec(ne, graph, p)  # noqa: E731

    def precond(r):
        return linalg.bmv(ne.s_diag_inv, r)

    x0 = jnp.zeros_like(rhs)
    r0 = rhs
    z0 = precond(r0)
    p0 = z0
    rz0 = jnp.sum(r0 * z0)
    rhs_norm2 = jnp.maximum(jnp.sum(rhs * rhs), 1e-30)

    def body(carry, _):
        x, r, p, rz = carry
        ap = matvec(p)
        pap = jnp.sum(p * ap)
        converged = jnp.sum(r * r) / rhs_norm2 < tol * tol
        alpha = jnp.where(pap > 0, rz / jnp.maximum(pap, 1e-30), 0.0)
        alpha = jnp.where(converged, 0.0, alpha)
        x = x + alpha * p
        r = r - alpha * ap
        z = precond(r)
        rz_new = jnp.sum(r * z)
        beta = jnp.where(rz > 0, rz_new / jnp.maximum(rz, 1e-30), 0.0)
        p = z + beta * p
        return (x, r, p, rz_new), None

    (x, _, _, _), _ = jax.lax.scan(body, (x0, r0, p0, rz0),
                                   None, length=n_iters)
    return x


def _back_substitute(
    ne: _NormalEqs, graph: GBPGraph, dx_c: jax.Array
) -> jax.Array:
    """dx_l = M^-1 (b_l - W^T dx_c)."""
    l = graph.n_points
    wt_dx = jax.ops.segment_sum(
        linalg.bmv(linalg.transpose(ne.w), dx_c[graph.cam_idx]),
        graph.lmk_idx, num_segments=l)
    return linalg.bmv(ne.m_inv, ne.b_l - wt_dx)


def solve_lm(
    cam0: jax.Array,
    lmk0: jax.Array,
    graph: GBPGraph,
    priors: GNPriors,
    cfg: GBPConfig,
    n_lm_iters: int = 30,
    cg_iters: int = 50,
    cg_tol: float = 1e-6,
    lambda0: float = 1e-4,
) -> GNResult:
    """Levenberg-Marquardt with iterative-Schur steps. Jit-compatible.

    All batched matmuls run at HIGHEST precision (ops/linalg). NOTE: the
    COLD start from the prior means is fp32-rounding sensitive on the fr1
    sequences (two backends can land ~0.1 px apart); warm starts (e.g.
    polishing a GBP solution) are robust. Give cold starts >= 60 LM
    iterations when using this as an accuracy oracle.
    """
    nstds = cfg.huber_nstds
    e = graph.cam_idx.shape[0]
    chunked = e > _GN_CHUNK_EDGES

    intr_e = None if graph.intr is None else graph.intr.T

    def total_cost(cam, lmk):
        if chunked:
            # same [E, d, d]-temporary trap as _build: at 5M edges the
            # whole-E residual evaluation's intermediates crash the
            # compile helper — stream chunks instead (identical loss)
            return map_cost(cam, lmk, graph, priors, cfg)
        r = graph.meas.T - projection.project(
            cam[graph.cam_idx], lmk[graph.lmk_idx], graph.k, intr_e)
        return _robust_cost(r, graph.meas_var, nstds) + _prior_cost(
            cam, lmk, priors)

    def mean_err(cam, lmk):
        if chunked:
            return _mean_err_chunked(cam, lmk, graph)
        r = graph.meas.T - projection.project(
            cam[graph.cam_idx], lmk[graph.lmk_idx], graph.k, intr_e)
        return jnp.mean(jnp.linalg.norm(r, axis=-1))

    def body(carry, _):
        cam, lmk, lm_lambda, cost = carry
        ne = _build(cam, lmk, graph, priors, nstds, lm_lambda)
        rhs = _schur_rhs(ne, graph)
        dx_c = _pcg(ne, graph, rhs, cg_iters, cg_tol)
        dx_l = _back_substitute(ne, graph, dx_c)
        cam_new = cam + dx_c
        lmk_new = lmk + dx_l
        cost_new = total_cost(cam_new, lmk_new)
        accept = (cost_new < cost) & jnp.isfinite(cost_new)
        cam = jnp.where(accept, cam_new, cam)
        lmk = jnp.where(accept, lmk_new, lmk)
        cost = jnp.where(accept, cost_new, cost)
        lm_lambda = jnp.where(accept, jnp.maximum(lm_lambda / 3.0, 1e-9),
                              jnp.minimum(lm_lambda * 5.0, 1e6))
        return (cam, lmk, lm_lambda, cost), (cost, mean_err(cam, lmk), accept)

    if chunked:
        # Large E: the plane-major path (landmarks as [3, L] planes, the
        # per-edge blocks from ops/planes.linearise), host-looped over ONE
        # jitted LM step. Scanning the whole LM loop builds one program
        # nesting the build scan + the CG scan + the cost scans, which is
        # slow to compile at the 5M-edge shape; the step compiles once and
        # each dispatch is short.
        c, l = graph.n_keyframes, graph.n_points
        ck = _edge_chunks(graph, cam0.dtype)
        n_real = graph.cam_idx.shape[0]

        def body_p(carry):
            cam, lmkT, lm_lambda, cost = carry
            camT = cam.T
            ne = _build_planes(camT, lmkT, graph, priors, nstds,
                               lm_lambda, ck)
            rhs = ne.b_c - _w_z_c6(ne, ck, _minv_apply(ne, ne.b_l3), c)
            dx_c = _pcg(ne, graph, rhs, cg_iters, cg_tol,
                        matvec=lambda p: _schur_matvec_p(ne, ck, graph, p))
            dx_l3 = _minv_apply(ne, ne.b_l3 - _wt_v_l3(ne, ck, dx_c, l))
            cam_new = cam + dx_c
            lmkT_new = lmkT + dx_l3
            cost_new = _map_cost_planes(cam_new.T, lmkT_new, graph,
                                        priors, nstds, ck)
            accept = (cost_new < cost) & jnp.isfinite(cost_new)
            cam = jnp.where(accept, cam_new, cam)
            lmkT = jnp.where(accept, lmkT_new, lmkT)
            cost = jnp.where(accept, cost_new, cost)
            lm_lambda = jnp.where(accept,
                                  jnp.maximum(lm_lambda / 3.0, 1e-9),
                                  jnp.minimum(lm_lambda * 5.0, 1e6))
            _, norms = _residual_sums_planes(cam.T, lmkT, graph, nstds, ck)
            return ((cam, lmkT, lm_lambda, cost),
                    (cost, norms / n_real, accept))

        lmkT0 = jnp.asarray(lmk0).T
        cost0 = _map_cost_planes(jnp.asarray(cam0).T, lmkT0, graph,
                                 priors, nstds, ck)
        step = jax.jit(body_p)
        carry = (cam0, lmkT0, jnp.asarray(lambda0, cam0.dtype), cost0)
        ys = []
        for _ in range(n_lm_iters):
            carry, y = step(carry)
            ys.append(y)
        cam, lmkT, lm_lambda, _ = carry
        costs, errs, accepted = (jnp.stack([y[j] for y in ys])
                                 for j in range(3))
        return GNResult(cam=cam, lmk=lmkT.T, cost=costs, reproj_err=errs,
                        accepted=accepted, lm_lambda=lm_lambda)

    cost0 = total_cost(cam0, lmk0)
    carry0 = (cam0, lmk0, jnp.asarray(lambda0, cam0.dtype), cost0)
    (cam, lmk, lm_lambda, _), (costs, errs, accepted) = jax.lax.scan(
        body, carry0, None, length=n_lm_iters)
    return GNResult(cam=cam, lmk=lmk, cost=costs, reproj_err=errs,
                    accepted=accepted, lm_lambda=lm_lambda)


def solve_problem(problem, cfg: GBPConfig, dtype=jnp.float32, **kw) -> GNResult:
    """Convenience wrapper: build graph + annealed priors from a BAProblem."""
    from ..utils import priors as priors_lib
    from .factor_graph import build_graph

    graph = build_graph(problem, cfg, dtype)
    cam_lam0, lmk_lam0 = priors_lib.prior_lambdas(problem, cfg.meas_var, dtype)
    cam0 = jnp.asarray(problem.cam_means, dtype)
    lmk0 = jnp.asarray(problem.lmk_means, dtype)
    pri = annealed_priors(graph, cam0, lmk0, cam_lam0, lmk_lam0, cfg)
    return solve_lm(cam0, lmk0, graph, pri, cfg, **kw)
