"""Carry parameters across from the JAX reference.

``from_jax_params(tree)`` takes the reference's params tree with every
leaf already a numpy array (layers stacked on axis 0, as its ``init``
builds them) and returns the port's params (layers as a list), so that
both compute the same function.  ``from_jax_opt_state(state)`` carries
the optimizer state the same way: Adam's ``m``/``v`` and SGD's ``mom``
trees mirror the params (their 0-d placeholders for the integer pattern
leaves stay unstacked).  A quantized tree (int8 or fxp codes and their
leaves) carries across the same way.  ``from_jax_population`` carries a population's
params (a list of junction dicts, search/population.py).
``from_jax_paper_params`` carries the paper network's params (``{"junctions": [{w, b, idx, rev_j, rev_f},
...]}``, core/paper_net.py).  Only numpy crosses the boundary.
"""
from __future__ import annotations

import numpy as np
import torch


def _tensor(a, device):
    """One leaf as a tensor on ``device``.  Integer leaves keep their width
    (int32 patterns and fxp codes, int8 weight codes) except int64, which
    narrows to int32 as the kernels take their integer operands."""
    a = np.asarray(a)
    if a.dtype == np.int64:
        a = a.astype(np.int32)
    return torch.tensor(a, device=device)    # a copy: the source may be read-only


def _convert(tree, device):
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    return _tensor(tree, device)


def _unstack(tree, i):
    if isinstance(tree, dict):
        return {k: _unstack(v, i) for k, v in tree.items()}
    a = np.asarray(tree)
    return a if a.ndim == 0 else a[i]


def from_jax_params(tree: dict, device="cpu") -> dict:
    """Reference params (numpy leaves, ``tree["layers"]`` stacked on axis
    0) -> the port's params on ``device``."""
    out = {k: _convert(v, device) for k, v in tree.items() if k != "layers"}
    n_layers = len(np.asarray(tree["layers"]["norm1"]["scale"]))
    out["layers"] = [_convert(_unstack(tree["layers"], i), device)
                     for i in range(n_layers)]
    return out


def from_jax_opt_state(state, device="cpu"):
    """Reference optimizer state (numpy leaves): () for plain SGD, or a
    dict of params-mirroring trees -> the port's state on ``device``."""
    if isinstance(state, tuple) and not state:
        return ()
    return {k: from_jax_params(v, device) for k, v in state.items()}


def from_jax_paper_params(tree: dict, device="cpu") -> dict:
    """The reference's paper-network params (numpy leaves) -> the port's,
    on ``device``: ``{"junctions": [{w, b, idx, rev_j, rev_f}, ...]}``."""
    return {"junctions": [_convert(jp, device) for jp in tree["junctions"]]}


def from_jax_population(layers, device="cpu") -> list:
    """A reference population (a list of junction dicts with numpy
    leaves: E-leading ``w`` / ``b``, shared pattern leaves) -> the port's
    on ``device``."""
    return [_convert(layer, device) for layer in layers]
