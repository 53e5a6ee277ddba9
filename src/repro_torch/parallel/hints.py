"""Ambient activation-sharding hints.

Model code is mesh-agnostic; a launcher installs a mesh here and the
model calls ``constrain_tokens3d`` at the reference's anchor points (the
embedding output, each stacked layer's output, the hybrid's super-block
output).  Outside a hints context every call returns its input, and so
does a call on a plain tensor inside one: the mesh steps compute on
local tensors, gathered (the fused path) or each rank's shards (the
partitioned route, parallel/partition.py, whose residual reaches each
anchor already sequence-sharded over "model": under "tp" the
row-parallel products reduce-scatter into it, under "sp" each rank
computes on its own positions).  A DTensor
is redistributed to the hinted placements.  Every axis is
divisibility-guarded.

Strategies (ArchConfig.strategy):
  tp — tensor parallel: activations (dp, None, ...), weights TP+FSDP.
  sp — sequence parallel: activations (dp, "model", ...) on the seq dim,
       for small models whose head counts don't divide the model axis
       (whisper-base).
"""
from __future__ import annotations

import contextlib
import threading

from torch.distributed.tensor import DTensor

from repro_torch.parallel.sharding import P, _placements, axis_sizes

_state = threading.local()


@contextlib.contextmanager
def use_mesh_hints(mesh):
    prev = getattr(_state, "mesh", None)
    _state.mesh = mesh
    try:
        yield
    finally:
        _state.mesh = prev


def current_mesh():
    return getattr(_state, "mesh", None)


def _resolve(dim: int, axis, sizes):
    if axis is None:
        return None
    if isinstance(axis, tuple):
        n = 1
        for a in axis:
            if a not in sizes:
                return None
            n *= sizes[a]
        return axis if dim % n == 0 else None
    if axis not in sizes:
        return None
    return axis if dim % sizes[axis] == 0 else None


def constrain(x, *axes):
    """``x`` redistributed to the spec ``axes`` when it is a DTensor under
    a mesh, guarded by per-dim divisibility; ``axes`` may use "dp"
    (("pod", "data") when the mesh has a pod axis).  Anything else comes
    back as it is."""
    mesh = current_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    sizes = axis_sizes(mesh)
    resolved = []
    for dim, ax in zip(x.shape, axes):
        if ax == "dp":
            ax = ("pod", "data") if "pod" in sizes else "data"
        resolved.append(_resolve(dim, ax, sizes))
    return x.redistribute(mesh, _placements(P(*resolved), x.dim(), mesh))


def constrain_tokens3d(x, cfg):
    """Anchor for [B, S, D] residual-stream activations: stored
    sequence-sharded over the model axis under both strategies (for "sp"
    the compute layout, for "tp" the saved carry of each layer)."""
    return constrain(x, "dp", "model", None)
