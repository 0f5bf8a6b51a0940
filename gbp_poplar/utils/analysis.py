"""Offline analysis utilities: Gaussian KL divergences, message/belief traces.

Batched equivalents of the reference's (unused-by-drivers) analysis hooks:
KL_divergence / symmetricKL between information-form Gaussians
(ba/util.cpp:225-250), belief/mean dumps (ba/dataio.cpp:165-260), and the
per-edge message-norm traces of save_message_KL (ba/dataio.cpp:262-327,
implemented without its out-of-bounds indexing bug). All batched.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import linalg

if TYPE_CHECKING:  # avoid utils <-> core import cycle at runtime
    from ..core.factor_graph import GBPState


def kl_divergence(
    eta0: jax.Array, lam0: jax.Array, eta1: jax.Array, lam1: jax.Array
) -> jax.Array:
    """KL(N0 || N1) for information-form Gaussians, batched.

    (reference: ba/util.cpp:225-242)
    """
    d = eta0.shape[-1]
    mu0, sig0 = linalg.inf_to_mean(eta0, lam0)
    mu1, sig1 = linalg.inf_to_mean(eta1, lam1)
    dmu = mu1 - mu0
    hi = jax.lax.Precision.HIGHEST
    tr = jnp.einsum("...ij,...ji->...", lam1, sig0, precision=hi)
    quad = jnp.einsum("...i,...ij,...j->...", dmu, lam1, dmu, precision=hi)
    _, logdet0 = jnp.linalg.slogdet(sig0)
    _, logdet1 = jnp.linalg.slogdet(sig1)
    return 0.5 * (tr + quad - d + logdet1 - logdet0)


def symmetric_kl(
    eta0: jax.Array, lam0: jax.Array, eta1: jax.Array, lam1: jax.Array
) -> jax.Array:
    """0.5 * (KL(N0||N1) + KL(N1||N0)) (reference: ba/util.cpp:244-250)."""
    return 0.5 * (kl_divergence(eta0, lam0, eta1, lam1)
                  + kl_divergence(eta1, lam1, eta0, lam0))


def belief_means(state: GBPState) -> tuple[np.ndarray, np.ndarray]:
    """(cam_mu [C,6], lmk_mu [L,3]) from current plane-layout beliefs
    (reference: ba/dataio.cpp:193-260 save_cam_means/save_lmk_means)."""
    from ..ops import planes as pl

    cam_mu = pl.pack_vec(pl.solve_sym(pl.unpack_sym(state.cam_lam, 6),
                                      pl.unpack_vec(state.cam_eta, 6)))
    lmk_mu = pl.pack_vec(pl.matvec(
        pl.inv_sym3(pl.unpack_sym(state.lmk_lam, 3)),
        pl.unpack_vec(state.lmk_eta, 3)))
    return np.asarray(cam_mu.T), np.asarray(lmk_mu.T)


def message_norms(state: GBPState) -> dict[str, np.ndarray]:
    """Per-edge eta-message norms in both directions — the convergence trace
    the reference's save_message_KL computes (ba/dataio.cpp:262-327)."""
    return {
        "to_cam": np.asarray(jnp.linalg.norm(state.msg_c_eta, axis=0)),
        "to_lmk": np.asarray(jnp.linalg.norm(state.msg_l_eta, axis=0)),
    }


def message_kl_trace(
    prev_state: GBPState, state: GBPState
) -> dict[str, np.ndarray]:
    """Symmetric KL between consecutive messages per edge — measures message
    convergence exactly (not just norm deltas)."""
    from ..ops import planes as pl

    eps = 1e-6

    def _dense(lam_planes, d):
        dense = pl.sym_planes_to_dense(lam_planes, d)
        return dense + eps * jnp.eye(d, dtype=dense.dtype)

    kl_cam = symmetric_kl(
        prev_state.msg_c_eta.T, _dense(prev_state.msg_c_lam, 6),
        state.msg_c_eta.T, _dense(state.msg_c_lam, 6))
    kl_lmk = symmetric_kl(
        prev_state.msg_l_eta.T, _dense(prev_state.msg_l_lam, 3),
        state.msg_l_eta.T, _dense(state.msg_l_lam, 3))
    return {"to_cam": np.asarray(kl_cam), "to_lmk": np.asarray(kl_lmk)}


def save_beliefs(path: str, state: GBPState) -> None:
    """Dump beliefs (eta, Lambda) for offline comparison
    (reference: ba/dataio.cpp:165-190 saveBeliefs)."""
    np.savez(
        path,
        cam_eta=np.asarray(state.cam_eta),
        cam_lam=np.asarray(state.cam_lam),
        lmk_eta=np.asarray(state.lmk_eta),
        lmk_lam=np.asarray(state.lmk_lam),
    )
