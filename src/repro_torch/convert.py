"""Carry parameters across from the JAX reference.

``from_jax_params(tree)`` takes the reference's params tree with every
leaf already a numpy array (layers stacked on axis 0, as its ``init``
builds them, a MoE model's ``dense_layers`` too; the hybrid's on axes 0
and 1, [n_super, ev, ...]) and returns the port's params (layers as a
list; the hybrid's a list of lists, its ``shared_attn`` block as it
is; whisper's encoder layers a list too), so that both compute the same
function.  ``from_jax_opt_state(state)`` carries the optimizer state
the same way: Adam's ``m``/``v`` and SGD's ``mom`` trees mirror the
params (their 0-d placeholders for the integer pattern leaves stay
unstacked), and a compressed optimizer's ``{"base", "err"}`` nests the
wrapped optimizer's state one level deeper.  A quantized tree (int8 or fxp codes and their
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


def _depth(tree) -> int:
    """The stacked length of a layer tree: the leading axis of its first
    leaf that has one (an optimizer state's 0-d placeholders have none)."""
    if isinstance(tree, dict):
        for v in tree.values():
            n = _depth(v)
            if n:
                return n
        return 0
    a = np.asarray(tree)
    return a.shape[0] if a.ndim else 0


def _layers(tree, stacked: int, device):
    """``stacked`` leading axes of layers (1, or 2 for the hybrid's
    [n_super, ev]) as nested lists of converted layer trees."""
    if not stacked:
        return _convert(tree, device)
    return [_layers(_unstack(tree, i), stacked - 1, device)
            for i in range(_depth(tree))]


def from_jax_params(tree: dict, device="cpu") -> dict:
    """Reference params (numpy leaves, ``tree["layers"]`` and
    ``tree["dense_layers"]`` stacked on axis 0, the hybrid's layers on
    axes 0 and 1, whisper's ``tree["encoder"]["layers"]`` on axis 0) ->
    the port's params on ``device``, in the reference's key order."""
    stacked = {"layers": 2 if "shared_attn" in tree else 1,
               "dense_layers": 1}
    out = {}
    for k, v in tree.items():
        if k in stacked:
            out[k] = _layers(v, stacked[k], device)
        elif k == "encoder":
            out[k] = {ek: _layers(ev, 1, device) if ek == "layers"
                      else _convert(ev, device) for ek, ev in v.items()}
        else:
            out[k] = _convert(v, device)
    return out


def from_jax_opt_state(state, device="cpu"):
    """Reference optimizer state (numpy leaves): () for plain SGD, or a
    dict whose values mirror the params (Adam's ``m`` / ``v`` and, with
    ``master_copy``, its fp32 ``master``; SGD's ``mom``) or are such
    states themselves, one level deeper
    (``train/grad_compress.compressed``'s {"base": <the wrapped
    optimizer's state>, "err": <params tree>}) -> the port's state on
    ``device``."""
    if isinstance(state, tuple) and not state:
        return ()
    return {k: from_jax_opt_state(v, device) if k == "base"
            else from_jax_params(v, device) for k, v in state.items()}


def from_jax_paper_params(tree: dict, device="cpu") -> dict:
    """The reference's paper-network params (numpy leaves) -> the port's,
    on ``device``: ``{"junctions": [{w, b, idx, rev_j, rev_f}, ...]}``."""
    return {"junctions": [_convert(jp, device) for jp in tree["junctions"]]}


def from_jax_population(layers, device="cpu") -> list:
    """A reference population (a list of junction dicts with numpy
    leaves: E-leading ``w`` / ``b``, shared pattern leaves) -> the port's
    on ``device``."""
    return [_convert(layer, device) for layer in layers]
