"""gbp_poplar — Gaussian Belief Propagation bundle adjustment and
incremental SLAM in JAX.

A from-scratch JAX/XLA framework with the capabilities of the CVPR 2020
"Bundle Adjustment on a Graph Processor" reference (joeaortiz/gbp-poplar):
reprojection factor graphs solved by synchronous GBP in information form, with
Huber robustification, message damping, per-factor relinearisation, prior
annealing, and incremental keyframe insertion — re-designed for accelerators
as dense batched tensor ops over the edge/variable axes, sharded across device meshes
with jax.sharding.
"""

from .config import GBPConfig, InitConfig  # noqa: F401

__version__ = "0.1.0"


def load_bal(path_or_name: str):
    """Load a BAL-format problem (file path or sequence name)."""
    from .utils import balio

    return balio.load_bal(path_or_name)


def solve_ba(problem, cfg: GBPConfig | None = None, n_iters: int = 1000):
    """One-call batch bundle adjustment.

    Returns (cam_means [C,6], lmk_means [L,3], per-iteration mean
    reprojection error [n_iters]).
    """
    import jax
    import numpy as np

    from .core import build_graph, gbp, init_state
    from .utils import analysis

    cfg = cfg or GBPConfig()
    graph = build_graph(problem, cfg)
    state = init_state(problem, cfg)
    final, diag = jax.jit(
        lambda s: gbp.solve(s, graph, cfg, n_iters=n_iters))(state)
    cam_mu, lmk_mu = analysis.belief_means(final)
    return cam_mu, lmk_mu, np.asarray(diag.reproj_err)


def solve_slam(problem, cfg: GBPConfig | None = None,
               iters_between_kfs: int = 700, av_depth: float = 1.0):
    """One-call incremental SLAM (keyframe-at-a-time).

    Returns (cam_means, lmk_means, per-segment reprojection error
    [n_keyframes-1, iters_between_kfs]).
    """
    import dataclasses

    from .core import build_graph, init_state, slam
    from .utils import analysis, flags as flags_lib

    cfg = cfg or dataclasses.replace(
        GBPConfig(), relin_drift_threshold=0.05, lambda_damping=True)
    graph = build_graph(problem, cfg)
    flags = flags_lib.create_flags(problem, cfg.steps)
    state = init_state(problem, cfg, flags=flags)
    result = slam.solve_slam(state, graph, cfg,
                             iters_between_kfs=iters_between_kfs,
                             av_depth=av_depth)
    cam_mu, lmk_mu = analysis.belief_means(result.state)
    return cam_mu, lmk_mu, result.reproj_err
