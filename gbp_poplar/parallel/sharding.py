"""Multi-device sharding of the GBP solver over a device mesh.

The reference scales by enlarging the IPU tile pool (``--ipus N``,
reference: ba/ba.cpp:614-623) and letting Poplar's exchange fabric move
messages between tiles/chips transparently. The equivalent here is
explicit SPMD over a ``jax.sharding.Mesh``:

  - the **edge axis is sharded** across the ``"edges"`` mesh axis — all
    per-factor work (relinearisation, marginalisation, damping state) is
    embarrassingly parallel over edges;
  - **variable beliefs/priors are replicated** — each shard computes a
    partial segment-sum of its local messages and the partials are combined
    with one ``psum`` per sweep (see ``core/gbp.update_beliefs``), the
    analogue of the reference's cross-tile ``reduceWithOutput``
    (ba/ba.cpp:104-139).

Replicating variables is the right trade at BA scale: even Ladybug-1723
(~150k landmarks) is ~6 MB of replicated belief state, while the per-edge
message work (the O(E) term, with 6x6 inverses per edge) dominates compute.
The psum payload per sweep is O(C*36 + L*9) floats, independent of E, so
scaling efficiency improves as problems grow.

Edges are padded to a multiple of the shard count with inactive edges
(``active == 0``), which emit exactly-zero messages and never relinearise,
so padding does not perturb the solve.
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
from ..core.factor_graph import GBPGraph, GBPState

EDGE_AXIS = "edges"

# Edge-axis fields (edge axis is always TRAILING in plane layout; 1-D fields
# are [E]). Everything else (beliefs, priors, weaken flags — all
# per-variable) is replicated.
_GRAPH_EDGE_FIELDS = frozenset(GBPGraph._fields) & frozenset(
    ("cam_idx", "lmk_idx", "meas", "meas_var", "intr"))
_STATE_EDGE_FIELDS = frozenset({
    "f_eta_c", "f_eta_l", "f_lam_cc", "f_lam_cl", "f_lam_ll",
    "msg_c_eta", "msg_c_lam", "msg_l_eta", "msg_l_lam",
    "damping", "damping_count", "mu", "lin_mu", "robust", "active",
})
# 1-D edge fields ([E]); all other edge fields are [comp, E] planes.
_EDGE_1D_FIELDS = frozenset({
    "cam_idx", "lmk_idx", "meas_var",
    "damping", "damping_count", "robust", "active",
})


def _edge_spec(field: str) -> P:
    return P(EDGE_AXIS) if field in _EDGE_1D_FIELDS else P(None, EDGE_AXIS)


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A 1-D device mesh over the edge axis."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (EDGE_AXIS,))


def graph_specs(mesh: Mesh) -> GBPGraph:
    """Sharding specs for the graph pytree."""
    del mesh
    return GBPGraph(**{
        f: _edge_spec(f) if f in _GRAPH_EDGE_FIELDS else P()
        for f in GBPGraph._fields
    })


def expand_specs(template, specs):
    """Spec tree matching ``template``: fields that are None there (an
    absent ``intr``) are None in the result too, as jax.device_put wants
    exact trees while shard_map accepts prefixes."""
    return type(template)(**{
        f: None if getattr(template, f) is None else getattr(specs, f)
        for f in type(template)._fields
    })


def state_specs(mesh: Mesh) -> GBPState:
    del mesh
    return GBPState(**{
        f: _edge_spec(f) if f in _STATE_EDGE_FIELDS else P()
        for f in GBPState._fields
    })


def _pad_edge_array(x: jax.Array, pad: int) -> jax.Array:
    # edge axis is trailing ([E] or [comp, E])
    widths = [(0, 0)] * (x.ndim - 1) + [(0, pad)]
    return jnp.pad(x, widths)


def pad_edges(
    graph: GBPGraph, state: GBPState, n_shards: int,
) -> tuple[GBPGraph, GBPState, int]:
    """Pad the edge axis to a multiple of ``n_shards`` with inactive edges.

    Padding edges point at variable 0 / landmark 0 (valid gather targets),
    carry ``meas_var = 1`` (any positive value; they never contribute), and
    ``active = 0`` so every message they emit is forced to zero.

    Returns (graph, state, n_padded_edges).
    """
    e = graph.n_edges
    pad = (-e) % n_shards
    if pad == 0:
        return graph, state, 0
    if graph.intr is None:
        intr_pad = None
    else:
        # padding edges carry cam_idx == 0, so they must carry CAMERA 0's
        # intrinsics (not edge 0's camera's): the intrinsics refit's
        # per-camera segment_max would otherwise absorb a foreign value
        # into camera 0's row
        ci = np.asarray(graph.cam_idx)
        i0 = int(np.argmax(ci == 0)) if (ci == 0).any() else 0
        intr_pad = jnp.concatenate(
            [graph.intr,
             jnp.broadcast_to(graph.intr[:, i0:i0 + 1], (3, pad))], axis=1)
    graph = graph._replace(
        cam_idx=_pad_edge_array(graph.cam_idx, pad),
        lmk_idx=_pad_edge_array(graph.lmk_idx, pad),
        meas=_pad_edge_array(graph.meas, pad),
        meas_var=jnp.concatenate(
            [graph.meas_var, jnp.ones((pad,), graph.meas_var.dtype)]),
        intr=intr_pad,
    )
    state = state._replace(**{
        f: _pad_edge_array(getattr(state, f), pad) for f in _STATE_EDGE_FIELDS
    })
    return graph, state, pad


def device_put_sharded(
    mesh: Mesh, graph: GBPGraph, state: GBPState
) -> tuple[GBPGraph, GBPState]:
    """Place graph/state on the mesh with their canonical shardings."""
    gspec = expand_specs(graph, graph_specs(mesh))
    gs = jax.tree.map(lambda s: NamedSharding(mesh, s), gspec)
    ss = jax.tree.map(lambda s: NamedSharding(mesh, s), state_specs(mesh))
    return (
        jax.tree.map(jax.device_put, graph, gs),
        jax.tree.map(jax.device_put, state, ss),
    )


@dataclasses.dataclass(frozen=True)
class ShardedSolver:
    """Jitted sharded entry points bound to one (mesh, cfg) pair.

    Build with :func:`make_sharded_solver`; feed it (graph, state) that have
    been padded with :func:`pad_edges` (shapes must divide the mesh).
    """

    mesh: Mesh
    cfg: GBPConfig
    solve: callable          # (state, graph, n_iters) -> (state, Diagnostics)
    sweep: callable          # (state, graph) -> state
    initialise: callable     # (state, graph) -> state
    run: callable   # (state, graph, n_iters, iter_offset, warm) -> (state, diag)

    def prepare(self, graph: GBPGraph, state: GBPState):
        graph, state, _ = pad_edges(graph, state, self.mesh.size)
        return device_put_sharded(self.mesh, graph, state)


def make_sharded_solver(mesh: Mesh, cfg: GBPConfig) -> ShardedSolver:
    """Build jitted shard_map'd solver entry points for a mesh.

    The body run per shard is *identical code* to the single-chip solver
    (core/gbp.py) with ``axis_name=EDGE_AXIS`` threading one psum into the
    belief reduction — no separate distributed implementation to keep in
    sync.
    """
    gspec = graph_specs(mesh)
    sspec = state_specs(mesh)
    rep = P()

    def smap(f, out_specs, in_specs):
        return jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                             out_specs=out_specs, check_vma=False)

    diag_spec = gbp.Diagnostics(rep, rep, rep, rep)

    @partial(jax.jit, static_argnums=2)
    def solve_fn(state, graph, n_iters):
        f = smap(
            lambda s, g: gbp.solve(s, g, cfg, n_iters, axis_name=EDGE_AXIS),
            out_specs=(sspec, diag_spec), in_specs=(sspec, gspec))
        return f(state, graph)

    @jax.jit
    def sweep_fn(state, graph):
        f = smap(
            lambda s, g: gbp.gbp_sweep(s, g, cfg, axis_name=EDGE_AXIS),
            out_specs=sspec, in_specs=(sspec, gspec))
        return f(state, graph)

    @jax.jit
    def init_fn(state, graph):
        f = smap(
            lambda s, g: gbp.initialise(s, g, cfg, axis_name=EDGE_AXIS),
            out_specs=sspec, in_specs=(sspec, gspec))
        return f(state, graph)

    @partial(jax.jit, static_argnums=(2, 4))
    def run_fn(state, graph, n_iters, iter_offset=0, warm=None):
        f = smap(
            lambda s, g, off: gbp.run_gbp(
                s, g, cfg, n_iters, iter_offset=off, axis_name=EDGE_AXIS,
                warm=warm),
            out_specs=(sspec, diag_spec), in_specs=(sspec, gspec, rep))
        return f(state, graph, jnp.asarray(iter_offset, jnp.int32))

    return ShardedSolver(mesh=mesh, cfg=cfg, solve=solve_fn, sweep=sweep_fn,
                         initialise=init_fn, run=run_fn)
