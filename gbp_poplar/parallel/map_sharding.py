"""Map-partitioned multi-chip mode: landmark blocks sharded, keyframes as
replicated boundary variables.

This is the scaling design from the BASELINE north star ("partition
keyframes and landmark map blocks, exchange boundary messages"):

  - landmarks are split into contiguous blocks of equal size; each mesh
    device owns one block's beliefs/priors/flags AND every edge observing
    one of its landmarks (a reprojection edge touches exactly one landmark,
    so the landmark side has zero cut);
  - landmark belief reductions are purely shard-local;
  - keyframes are the boundary variables (observed from many shards):
    their beliefs stay replicated and partial message sums are combined
    with one ``psum`` per sweep — payload O(27*C) floats, independent of
    the number of landmarks/edges.

Compared to the edge-sharded mode (sharding.py), the collective volume
drops by the O(9*L) landmark term — the dominant term at Ladybug scale —
and per-shard landmark state memory shrinks by the mesh size.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import GBPConfig
from ..core import gbp
from ..core.factor_graph import (
    GBPGraph, GBPState, GRAPH_EDGE_FIELDS, STATE_EDGE_FIELDS,
)
from .sharding import EDGE_AXIS, _EDGE_1D_FIELDS, expand_specs

# landmark-axis fields (sharded in map mode; trailing variable axis)
_STATE_LMK_FIELDS = ("lmk_eta", "lmk_lam", "lmk_prior_eta", "lmk_prior_lam",
                     "lmk_weaken")
_GRAPH_LMK_FIELDS = ("lmk_scaling", "first_kf", "first_uv")
_LMK_1D_FIELDS = frozenset({"lmk_weaken", "lmk_scaling", "first_kf"})


def _spec(field: str, sharded_fields, one_d_fields) -> P:
    if field in sharded_fields:
        return P(EDGE_AXIS) if field in one_d_fields else P(None, EDGE_AXIS)
    return P()


def map_graph_specs() -> GBPGraph:
    return GBPGraph(**{
        f: _spec(f, set(GRAPH_EDGE_FIELDS) | set(_GRAPH_LMK_FIELDS),
                 _EDGE_1D_FIELDS | _LMK_1D_FIELDS)
        for f in GBPGraph._fields
    })


def map_state_specs() -> GBPState:
    return GBPState(**{
        f: _spec(f, set(STATE_EDGE_FIELDS) | set(_STATE_LMK_FIELDS),
                 _EDGE_1D_FIELDS | _LMK_1D_FIELDS)
        for f in GBPState._fields
    })


def partition_by_landmark(
    graph: GBPGraph, state: GBPState, n_shards: int,
) -> tuple[GBPGraph, GBPState]:
    """Repartition (host-side) so shard s owns landmark block s and all of
    its edges; landmark indices become block-local.

    Edge blocks are padded to a common length with inert edges; the
    landmark axis is padded to a multiple of n_shards with dummy landmarks
    (identity priors, never observed).
    """
    lmk_idx = np.asarray(graph.lmk_idx)
    e = graph.n_edges
    l = graph.n_points
    l_blk = -(-l // n_shards)
    l_pad = n_shards * l_blk - l

    shard = np.minimum(lmk_idx // l_blk, n_shards - 1)
    active = np.asarray(state.active)
    counts = np.bincount(shard, minlength=n_shards)
    e_blk = int(counts.max())
    order = np.argsort(shard, kind="stable")          # preserves cam order

    # destination position of each (sorted) edge inside its shard block
    starts = np.zeros(n_shards + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    rank = np.arange(e) - starts[shard[order]]
    dest = shard[order] * e_blk + rank                # [e] positions

    def place_edge(x, fill=0.0):
        x = np.asarray(x)
        out_shape = x.shape[:-1] + (n_shards * e_blk,)
        out = np.full(out_shape, fill, x.dtype)
        out[..., dest] = x[..., order]
        return jnp.asarray(out)

    lmk_local = (lmk_idx - shard * l_blk).astype(np.int32)

    graph_fields = dict(
        cam_idx=place_edge(graph.cam_idx),
        lmk_idx=place_edge(lmk_local),
        meas=place_edge(graph.meas),
        meas_var=place_edge(graph.meas_var, fill=1.0),
        intr=(None if graph.intr is None
              else place_edge(graph.intr, fill=1.0)),
    )

    def pad_lmk(x, fill=0.0):
        x = np.asarray(x)
        widths = [(0, 0)] * (x.ndim - 1) + [(0, l_pad)]
        return jnp.asarray(np.pad(x, widths, constant_values=fill))

    graph_fields["lmk_scaling"] = pad_lmk(graph.lmk_scaling, fill=1.0)
    graph_fields["first_kf"] = pad_lmk(graph.first_kf,
                                       fill=graph.n_keyframes)
    graph_fields["first_uv"] = pad_lmk(graph.first_uv)
    graph = graph._replace(**graph_fields)

    state_fields = {}
    for f in STATE_EDGE_FIELDS:
        if f == "active":
            state_fields[f] = place_edge(active, fill=0)
        else:
            state_fields[f] = place_edge(getattr(state, f))
    for f in _STATE_LMK_FIELDS:
        state_fields[f] = pad_lmk(getattr(state, f))
    # dummy landmarks need invertible priors (identity Lambda)
    if l_pad:
        from ..ops import planes as pl
        diag_slots = np.asarray([pl.sym_slot(i, i) for i in range(3)])
        lam = np.array(state_fields["lmk_prior_lam"])   # writable copy
        lam[np.ix_(diag_slots, np.arange(l, l + l_pad))] = 1.0
        state_fields["lmk_prior_lam"] = jnp.asarray(lam)
    return graph, state._replace(**state_fields)


@dataclasses.dataclass(frozen=True)
class MapShardedSolver:
    """Map-partitioned solver entry points bound to one (mesh, cfg)."""

    mesh: Mesh
    cfg: GBPConfig
    solve: callable
    run: callable
    initialise: callable
    insert_keyframe: callable   # (state, graph, new_kf, av_depth) -> state

    def prepare(self, graph: GBPGraph, state: GBPState):
        graph, state = partition_by_landmark(graph, state, self.mesh.size)
        gspec = expand_specs(graph, map_graph_specs())
        gs = jax.tree.map(lambda s: NamedSharding(self.mesh, s), gspec)
        ss = jax.tree.map(lambda s: NamedSharding(self.mesh, s),
                          map_state_specs())
        return (jax.tree.map(jax.device_put, graph, gs),
                jax.tree.map(jax.device_put, state, ss))


def make_map_sharded_solver(mesh: Mesh, cfg: GBPConfig) -> MapShardedSolver:
    gspec = map_graph_specs()
    sspec = map_state_specs()
    rep = P()
    diag_spec = gbp.Diagnostics(rep, rep, rep, rep)

    def smap(f, out_specs, in_specs):
        return jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                             out_specs=out_specs, check_vma=False)

    @partial(jax.jit, static_argnums=2)
    def solve_fn(state, graph, n_iters):
        f = smap(
            lambda s, g: gbp.solve(s, g, cfg, n_iters,
                                   axis_name=EDGE_AXIS, lmk_sharded=True),
            out_specs=(sspec, diag_spec), in_specs=(sspec, gspec))
        return f(state, graph)

    @partial(jax.jit, static_argnums=(2, 4))
    def run_fn(state, graph, n_iters, iter_offset=0, warm=None):
        f = smap(
            lambda s, g, off: gbp.run_gbp(
                s, g, cfg, n_iters, iter_offset=off,
                axis_name=EDGE_AXIS, lmk_sharded=True, warm=warm),
            out_specs=(sspec, diag_spec), in_specs=(sspec, gspec, rep))
        return f(state, graph, jnp.asarray(iter_offset, jnp.int32))

    @jax.jit
    def init_fn(state, graph):
        f = smap(
            lambda s, g: gbp.initialise(s, g, cfg, axis_name=EDGE_AXIS,
                                        lmk_sharded=True),
            out_specs=sspec, in_specs=(sspec, gspec))
        return f(state, graph)

    @partial(jax.jit, static_argnums=3)
    def insert_fn(state, graph, new_kf, av_depth=1.0):
        from ..core import slam

        f = smap(
            lambda s, g, k: slam.insert_keyframe(
                s, g, cfg, k, av_depth, axis_name=EDGE_AXIS,
                lmk_sharded=True),
            out_specs=sspec, in_specs=(sspec, gspec, rep))
        return f(state, graph, jnp.asarray(new_kf, jnp.int32))

    return MapShardedSolver(mesh=mesh, cfg=cfg, solve=solve_fn,
                            run=run_fn, initialise=init_fn,
                            insert_keyframe=insert_fn)
