"""int8 gradient compression with error feedback.

Each trainable gradient leaf, plus the residual its last compression
left, is quantized to int8 codes with one scale (``scale = max|g| / 127
+ 1e-12``; round half to even, then clip to +-127) and restored; the
optimizer steps on the restored gradient and the residual (``corrected -
restored``, fp32) carries into the next step.  Compressed gradients are
what a slow link between replicas would carry: a quarter of fp32's
bytes.  Every quotient divides by a tensor, so that the card rounds as
the CPU does.

A scale spans a leaf's whole stack: the reference stacks a model's
repeated layers on a leading axis and takes one scale a stacked leaf,
so here the leaves whose paths differ only in their list indices (the
same weight of every layer of ``layers``, ``dense_layers``, the
hybrid's [n_super][ev] lists, whisper's encoder layers) share the max
over all of them.

``compressed(base)`` wraps an optimizer; its state is ``{"base": <base's
state>, "err": <a params-mirroring tree: an fp32 residual a trainable
leaf, a 0-d placeholder elsewhere>}``.  It is a plain ``Optimizer``, so
a train step that takes it is the two-pass one (``train/steps``): the
compression comes first, then ``base.update`` (its clipping included).
"""
from __future__ import annotations

import collections

import torch

from repro_torch.kernels.block_sparse_matmul import true_div
from repro_torch.optim.optimizers import (Optimizer, _is_trainable,
                                          _zeros_like_state)
from repro_torch.tree import tree_items, tree_map, tree_unflatten_like


def int8_scale(*gs: torch.Tensor) -> torch.Tensor:
    """The fp32 0-d scale max|g| / 127 + 1e-12 over every element of
    ``gs``."""
    peak = torch.stack([torch.amax(torch.abs(g)) for g in gs]).amax()
    return true_div(peak, 127.0) + 1e-12


def quantize_int8(g: torch.Tensor, scale: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(int8 codes, the scale) of fp32 ``g``; the scale ``g``'s own unless
    given."""
    if scale is None:
        scale = int8_scale(g)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_decompress(g: torch.Tensor, err: torch.Tensor):
    """(the compressed-then-restored gradient, the new residual), fp32."""
    corrected = g.float() + err
    restored = dequantize_int8(*quantize_int8(corrected))
    return restored, corrected - restored


def _stack_key(path: str) -> str:
    """A leaf path with its list indices wildcarded: the leaves of one
    stack of layers share it."""
    return "/".join("*" if part.isdigit() else part
                    for part in path.split("/"))


def compress_tree(params, grads, err):
    """(restored gradients, new residuals), both shaped like ``params``:
    every trainable leaf's gradient plus its residual compressed with its
    stack's scale and restored; the other leaves pass as they are."""
    items = list(tree_items(params))
    out_g = [t for _, t in tree_items(grads)]
    out_e = [t for _, t in tree_items(err)]
    stacks = collections.defaultdict(list)
    corrected = {}
    for i, (path, p) in enumerate(items):
        if _is_trainable(p):
            corrected[i] = out_g[i].float() + out_e[i]
            stacks[_stack_key(path)].append(i)
    for members in stacks.values():
        scale = int8_scale(*(corrected[i] for i in members))
        for i in members:
            out_g[i] = dequantize_int8(*quantize_int8(corrected[i], scale))
            out_e[i] = corrected[i] - out_g[i]
    return (tree_unflatten_like(params, out_g),
            tree_unflatten_like(params, out_e))


def compressed(base: Optimizer) -> Optimizer:
    """``base`` stepping on int8-compressed gradients with error feedback."""
    def init(params):
        return {"base": base.init(params),
                "err": tree_map(_zeros_like_state, params)}

    def update(grads, state, params, step):
        restored, err = compress_tree(params, grads, state["err"])
        new_params, new_base = base.update(restored, state["base"], params,
                                           step)
        return new_params, {"base": new_base, "err": err}

    return Optimizer(init, update)
