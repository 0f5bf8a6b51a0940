"""Factor-graph data structures: static graph arrays + the solver state pytree.

The reference scatters per-node state across IPU tiles and wires vertices to
remote tensor slices (reference: ba/ba.cpp:663-834). The design here is
dense structure-of-arrays batching in **plane layout** (ops/planes.py):

  - static graph structure (``GBPGraph``): edge->variable index arrays that
    drive gathers (replacing Poplar ``graph.connect`` to remote slices) and
    segment-sums (replacing ``popops::reduceWithOutput``, ba/ba.cpp:104-139);
  - mutable solver state (``GBPState``): one pytree of plane arrays —
    beliefs, priors, factor potentials, messages, and the damping/
    relinearisation state machine. The whole pytree lives on device for the
    full solve; it is also the checkpoint format.

Layout conventions (E = edges, C = keyframes, L = landmarks):
  - per-edge vectors: [d, E]; symmetric matrices packed lower-triangular
    row-major: 6x6 -> [21, E], 3x3 -> [6, E]; the 6x3 cross block is full
    row-major [18, E]
  - per-variable arrays mirror this with C/L as the trailing (contiguous)
    axis
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import GBPConfig
from ..ops import planes as pl
from ..utils import priors as priors_lib
from ..utils.balio import BAProblem
from ..utils.flags import SlamFlags, ba_flags

CAM_DOF = 6
LMK_DOF = 3


class GBPGraph(NamedTuple):
    """Static per-problem arrays (device-resident, never mutated)."""

    cam_idx: jax.Array      # [E] int32 — keyframe id per edge
    lmk_idx: jax.Array      # [E] int32 — landmark id per edge
    meas: jax.Array         # [2, E] — observed pixel coords (u, v planes)
    meas_var: jax.Array     # [E] — base measurement variance (pre-Huber)
    k: jax.Array            # [3, 3] shared intrinsics
    intr: jax.Array | None  # [3, E] per-edge Snavely/BAL intrinsics
                            # (f, k1, k2 planes, gathered per camera at
                            # build) — present iff the problem uses the
                            # Snavely camera model; None selects the shared
                            # pinhole K everywhere (static under jit)
    cam_scaling: jax.Array  # [C] prior-annealing scaling per keyframe
    lmk_scaling: jax.Array  # [L] prior-annealing scaling per landmark
    first_kf: jax.Array     # [L] int32 — first keyframe observing each
                            # landmark (n_keyframes if never observed); drives
                            # on-device SLAM keyframe insertion (core/slam.py)
    first_uv: jax.Array     # [2, L] — pixel of each landmark's first
                            # observation (0 if never observed); SLAM
                            # insertion back-projects new landmarks along
                            # this measured ray instead of the optic axis

    @property
    def n_keyframes(self) -> int:
        return self.cam_scaling.shape[0]

    @property
    def n_points(self) -> int:
        return self.lmk_scaling.shape[0]

    @property
    def n_edges(self) -> int:
        return self.cam_idx.shape[0]


class GBPState(NamedTuple):
    """Mutable solver state (one pytree; the checkpointable unit).

    Message buffers hold the messages computed in the most recent sweep; they
    double as the "previous messages" of the next sweep (the reference keeps
    explicit p*_messages copies, ba/ba.cpp:902-905 — functionally identical).
    """

    # beliefs (plane layout, variable axis last)
    cam_eta: jax.Array        # [6, C]
    cam_lam: jax.Array        # [21, C] packed sym
    lmk_eta: jax.Array        # [3, L]
    lmk_lam: jax.Array        # [6, L] packed sym
    # priors (slot 0 of the reference's message tensor, ba/ba.cpp:880-883)
    cam_prior_eta: jax.Array  # [6, C]
    cam_prior_lam: jax.Array  # [21, C]
    lmk_prior_eta: jax.Array  # [3, L]
    lmk_prior_lam: jax.Array  # [6, L]
    # linearised factor potentials, blockwise (gbp_codelets.cpp:30-34)
    f_eta_c: jax.Array        # [6, E]
    f_eta_l: jax.Array        # [3, E]
    f_lam_cc: jax.Array       # [21, E] packed sym
    f_lam_cl: jax.Array       # [18, E] full 6x3 row-major
    f_lam_ll: jax.Array       # [6, E] packed sym
    # factor -> variable messages (latest sent)
    msg_c_eta: jax.Array      # [6, E]
    msg_c_lam: jax.Array      # [21, E]
    msg_l_eta: jax.Array      # [3, E]
    msg_l_lam: jax.Array      # [6, E]
    # per-factor damping / relinearisation state machine
    damping: jax.Array        # [E] float
    damping_count: jax.Array  # [E] int32
    mu: jax.Array             # [9, E] previous-iteration belief means (cam, lmk)
    lin_mu: jax.Array         # [9, E] linearisation-point means (drift relin)
    robust: jax.Array         # [E] bool — Huber active at last relin
    active: jax.Array         # [E] int32 — edge participates in GBP
    # prior-annealing flags
    cam_weaken: jax.Array     # [C] int32
    lmk_weaken: jax.Array     # [L] int32


# Edge-axis fields and the position of the edge axis (all trailing).
STATE_EDGE_FIELDS = (
    "f_eta_c", "f_eta_l", "f_lam_cc", "f_lam_cl", "f_lam_ll",
    "msg_c_eta", "msg_c_lam", "msg_l_eta", "msg_l_lam",
    "damping", "damping_count", "mu", "lin_mu", "robust", "active",
)
GRAPH_EDGE_FIELDS = ("cam_idx", "lmk_idx", "meas", "meas_var", "intr")


def edge_order(problem: BAProblem) -> np.ndarray:
    """Canonical edge order: sorted by (landmark, keyframe).

    Every per-edge array in GBPGraph/GBPState uses this order (build_graph
    and init_state apply it consistently). Sorting by landmark keeps the
    landmark-side gather and scatter of neighbouring edges on neighbouring
    addresses. BAL-file order (sorted by camera) is NOT assumed anywhere
    downstream.
    """
    return np.lexsort((np.asarray(problem.cam_idx),
                       np.asarray(problem.lmk_idx)))


def bad_edge_mask(problem: BAProblem, bad_ids) -> np.ndarray:
    """[E] bool mask of known-bad data associations in the CANONICAL
    graph edge order, from original-problem edge indices.

    The reference keeps a ``bad_associations`` index list that its host
    error eval skips (ba/util.cpp:100, include/util.h:21, default empty);
    here the per-edge arrays are reordered by ``edge_order`` at build time,
    so the hook takes original BAL-file edge ids and returns the mask the
    on-device eval (core/gbp.reprojection_error) consumes.
    """
    ids = np.asarray(list(bad_ids), np.int64)
    if ids.size and (ids.min() < 0 or ids.max() >= problem.n_edges):
        raise ValueError(
            f"bad association ids must be in [0, {problem.n_edges})")
    orig = np.zeros(problem.n_edges, bool)
    orig[ids] = True
    return orig[edge_order(problem)]


def build_graph(
    problem: BAProblem, cfg: GBPConfig, dtype=jnp.float32
) -> GBPGraph:
    """Build the static graph arrays in canonical edge order."""
    pr = priors_lib.build_priors(problem, cfg, dtype)
    first_kf = np.full(problem.n_points, problem.n_keyframes, np.int32)
    np.minimum.at(first_kf, problem.lmk_idx.astype(np.int64),
                  problem.cam_idx.astype(np.int32))
    # pixel of each landmark's first observation (first_kf is the MIN
    # observing camera, so take the measurement of the (lmk, cam)-sorted
    # first edge of each landmark)
    lk = np.asarray(problem.lmk_idx)
    srt = np.lexsort((np.asarray(problem.cam_idx), lk))
    pos = np.minimum(np.searchsorted(lk[srt], np.arange(problem.n_points)),
                     problem.n_edges - 1)
    first_edge = srt[pos]
    seen = np.bincount(lk, minlength=problem.n_points) > 0
    first_uv = np.where(seen[:, None],
                        np.asarray(problem.measurements)[first_edge], 0.0).T
    order = edge_order(problem)
    cam_idx = np.asarray(problem.cam_idx)[order].astype(np.int32)
    lmk_idx = np.asarray(problem.lmk_idx)[order].astype(np.int32)
    meas = np.asarray(problem.measurements)[order].T
    intr = None
    if getattr(problem, "intrinsics", None) is not None:
        # Snavely model: per-edge (f, k1, k2) planes
        intr = jnp.asarray(np.asarray(problem.intrinsics)[cam_idx].T,
                           dtype)                           # [3, E]
    return GBPGraph(
        cam_idx=jnp.asarray(cam_idx),
        lmk_idx=jnp.asarray(lmk_idx),
        meas=jnp.asarray(meas, dtype),
        meas_var=jnp.full((problem.n_edges,), cfg.meas_var, dtype),
        k=jnp.asarray(problem.k, dtype),
        intr=intr,
        cam_scaling=pr["cam_scaling"],
        lmk_scaling=pr["lmk_scaling"],
        first_kf=jnp.asarray(first_kf),
        first_uv=jnp.asarray(first_uv, dtype),
    )


def init_state(
    problem: BAProblem,
    cfg: GBPConfig,
    flags: SlamFlags | None = None,
    dtype=jnp.float32,
) -> GBPState:
    """Initial solver state: beliefs zero (set by the first belief update),
    messages zero, damping state at the reference's defaults
    (reference: ba/ba.cpp:580-590)."""
    if flags is None:
        flags = ba_flags(problem, cfg.steps)
    pr = priors_lib.build_priors(problem, cfg, dtype)
    c, l, e = problem.n_keyframes, problem.n_points, problem.n_edges
    # per-edge flags follow the canonical (landmark, keyframe) edge order
    # that build_graph applies to every per-edge graph array
    active = flags.active_flag.astype(np.int32)[edge_order(problem)]
    f = dtype
    return GBPState(
        cam_eta=jnp.zeros((CAM_DOF, c), f),
        cam_lam=jnp.zeros((pl.N_SYM6, c), f),
        lmk_eta=jnp.zeros((LMK_DOF, l), f),
        lmk_lam=jnp.zeros((pl.N_SYM3, l), f),
        cam_prior_eta=pr["cam_prior_eta"],
        cam_prior_lam=pr["cam_prior_lam"],
        lmk_prior_eta=pr["lmk_prior_eta"],
        lmk_prior_lam=pr["lmk_prior_lam"],
        f_eta_c=jnp.zeros((CAM_DOF, e), f),
        f_eta_l=jnp.zeros((LMK_DOF, e), f),
        f_lam_cc=jnp.zeros((pl.N_SYM6, e), f),
        f_lam_cl=jnp.zeros((CAM_DOF * LMK_DOF, e), f),
        f_lam_ll=jnp.zeros((pl.N_SYM3, e), f),
        msg_c_eta=jnp.zeros((CAM_DOF, e), f),
        msg_c_lam=jnp.zeros((pl.N_SYM6, e), f),
        msg_l_eta=jnp.zeros((LMK_DOF, e), f),
        msg_l_lam=jnp.zeros((pl.N_SYM3, e), f),
        damping=jnp.zeros((e,), f),
        damping_count=jnp.full((e,), -cfg.iters_before_damping, jnp.int32),
        mu=jnp.zeros((CAM_DOF + LMK_DOF, e), f),
        lin_mu=jnp.zeros((CAM_DOF + LMK_DOF, e), f),
        robust=jnp.zeros((e,), jnp.bool_),
        active=jnp.asarray(active),
        cam_weaken=jnp.asarray(flags.cam_weaken_flag.astype(np.int32)),
        lmk_weaken=jnp.asarray(flags.lmk_weaken_flag.astype(np.int32)),
    )
