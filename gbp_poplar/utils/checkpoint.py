"""Checkpoint / resume of the full solver state.

The reference has no checkpointing; its READ_PRIORS/saveBeliefs hooks show
the state is round-trippable (SURVEY.md §5). Here the *entire* solver state
— beliefs, priors, factor potentials, messages, damping state machine, flags
— is one pytree (`GBPState`), so a checkpoint is a lossless dump of that
pytree plus the static graph arrays; resuming mid-solve is bit-exact.

Plain .npz is the format (no extra deps, portable); field names are the
NamedTuple fields.
"""

from __future__ import annotations

import json
import os

import jax.numpy as jnp
import numpy as np

from ..config import GBPConfig


def _graph_state_types():
    # deferred import: utils is imported by core.factor_graph (priors), so a
    # module-level import here would be circular
    from ..core.factor_graph import GBPGraph, GBPState
    return GBPGraph, GBPState

_META_KEY = "__meta__"
_FORMAT_VERSION = 1


def save_checkpoint(
    path: str,
    state: GBPState,
    graph: GBPGraph | None = None,
    step: int = 0,
    cfg: GBPConfig | None = None,
) -> None:
    """Write state (and optionally graph + config) to one .npz file."""
    GBPGraph, GBPState = _graph_state_types()
    arrays: dict[str, np.ndarray] = {}
    for f in GBPState._fields:
        arrays[f"state.{f}"] = np.asarray(getattr(state, f))
    if graph is not None:
        for f in GBPGraph._fields:
            val = getattr(graph, f)
            if val is not None:     # intr is None for pinhole problems
                arrays[f"graph.{f}"] = np.asarray(val)
    meta = {"version": _FORMAT_VERSION, "step": int(step)}
    if cfg is not None:
        meta["config"] = {k: getattr(cfg, k)
                          for k in cfg.__dataclass_fields__}
    arrays[_META_KEY] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8)
    tmp = path + ".tmp"
    np.savez(tmp, **arrays)
    # np.savez appends .npz to paths without it
    tmp_real = tmp if tmp.endswith(".npz") else tmp + ".npz"
    os.replace(tmp_real, path)


def load_checkpoint(
    path: str,
) -> tuple[GBPState, GBPGraph | None, dict]:
    """Read (state, graph-or-None, meta) from a checkpoint file."""
    GBPGraph, GBPState = _graph_state_types()
    with np.load(path) as z:
        meta = json.loads(bytes(z[_META_KEY]).decode())
        if meta.get("version") != _FORMAT_VERSION:
            raise ValueError(
                f"unsupported checkpoint version {meta.get('version')}")
        state = GBPState(**{
            f: jnp.asarray(z[f"state.{f}"]) for f in GBPState._fields})
        graph = None
        if f"graph.{GBPGraph._fields[0]}" in z:
            graph = GBPGraph(**{
                f: (jnp.asarray(z[f"graph.{f}"])
                    if f"graph.{f}" in z else None)
                for f in GBPGraph._fields})
    return state, graph, meta


def load_config(meta: dict) -> GBPConfig | None:
    """Reconstruct the GBPConfig stored in checkpoint metadata, if any
    (keys that are no longer GBPConfig fields are ignored)."""
    if "config" not in meta:
        return None
    fields = GBPConfig.__dataclass_fields__
    return GBPConfig(**{k: v for k, v in meta["config"].items()
                        if k in fields})
