"""Debug introspection helpers.

Replacement for the reference's (commented-out, IPUModel-only)
``PrintVertex`` (ba/gbp_codelets.cpp:200-213): dump one edge's complete
factor state — potentials, messages, adjacent beliefs, damping machine —
as dense NumPy for inspection. Works on any backend since the state pytree
is host-fetchable at any point.
"""

from __future__ import annotations

import numpy as np

from ..ops import planes as pl


def dump_edge(state, graph, e: int) -> dict:
    """All solver quantities for edge ``e`` as dense NumPy arrays."""
    c = int(np.asarray(graph.cam_idx)[e])
    l = int(np.asarray(graph.lmk_idx)[e])

    def sym(p, d, col):
        return np.asarray(pl.sym_planes_to_dense(p[:, col:col + 1], d))[0]

    return {
        "edge": e,
        "cam": c,
        "lmk": l,
        "meas": np.asarray(graph.meas)[:, e],
        "active": int(np.asarray(state.active)[e]),
        "damping": float(np.asarray(state.damping)[e]),
        "damping_count": int(np.asarray(state.damping_count)[e]),
        "robust": bool(np.asarray(state.robust)[e]),
        "f_eta_c": np.asarray(state.f_eta_c)[:, e],
        "f_eta_l": np.asarray(state.f_eta_l)[:, e],
        "f_lam_cc": sym(state.f_lam_cc, 6, e),
        "f_lam_cl": np.asarray(
            pl.full_planes_to_dense(state.f_lam_cl[:, e:e + 1], 6, 3))[0],
        "f_lam_ll": sym(state.f_lam_ll, 3, e),
        "msg_to_cam_eta": np.asarray(state.msg_c_eta)[:, e],
        "msg_to_cam_lam": sym(state.msg_c_lam, 6, e),
        "msg_to_lmk_eta": np.asarray(state.msg_l_eta)[:, e],
        "msg_to_lmk_lam": sym(state.msg_l_lam, 3, e),
        "lin_mu": np.asarray(state.lin_mu)[:, e],
        "belief_cam_eta": np.asarray(state.cam_eta)[:, c],
        "belief_cam_lam": sym(state.cam_lam, 6, c),
        "belief_lmk_eta": np.asarray(state.lmk_eta)[:, l],
        "belief_lmk_lam": sym(state.lmk_lam, 3, l),
    }


def print_edge(state, graph, e: int) -> None:
    """Pretty-print dump_edge (the PrintVertex experience, host-side)."""
    info = dump_edge(state, graph, e)
    np.set_printoptions(precision=5, suppress=True)
    print(f"edge {info['edge']}: cam {info['cam']} <-> lmk {info['lmk']}  "
          f"active={info['active']} damping={info['damping']:.2f} "
          f"count={info['damping_count']} robust={info['robust']}")
    for k in ("meas", "f_eta_c", "f_eta_l", "msg_to_cam_eta",
              "msg_to_lmk_eta", "lin_mu"):
        print(f"  {k:16s} {info[k]}")
    for k in ("f_lam_cc", "f_lam_cl", "f_lam_ll", "msg_to_cam_lam",
              "msg_to_lmk_lam", "belief_cam_lam", "belief_lmk_lam"):
        print(f"  {k}:\n{np.array2string(info[k], prefix='    ')}")
