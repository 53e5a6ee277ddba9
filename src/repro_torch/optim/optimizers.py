"""Optimizers as (init, update) pairs over trees of tensors.

Integer leaves (the sparsity patterns) are structural, not trainable,
and are skipped.  ``update(grads, state, params, step)`` returns new
trees and leaves its inputs as they were; the fused path
(``FusedOptimizer``) instead finds the junction weights and their slots
already updated in place by the backward kernels and applies the same
formula to every other leaf in ``merge``.

The updates are element-wise, so on the partitioned mesh steps they run
on a rank's local shards as they are; only the clip's global norm needs
every rank, and ``sharded_norm`` supplies it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Callable

import torch

from repro_torch.core import sparse_linear as sl
from repro_torch.kernels import block_sparse_matmul as bsm
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten_like


def _is_trainable(leaf) -> bool:
    return torch.is_tensor(leaf) and leaf.is_floating_point()


def trainable_mask(params):
    return tree_map(_is_trainable, params)


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32)


def _zeros_like_state(p):
    return (torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            if _is_trainable(p) else torch.zeros((), dtype=torch.float32))


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, int], tuple[Any, Any]]
    # update(grads, state, params, step) -> (new_params, new_state)


_norm = threading.local()


@contextlib.contextmanager
def sharded_norm(sq_sum: Callable):
    """Within it, the clip's squared global norm is ``sq_sum(grads)``
    (a gradient tree of a rank's local shards -> the squared norm of the
    whole tree, ``parallel/partition.Partition.sq_sum``)."""
    prev = getattr(_norm, "sq_sum", None)
    _norm.sq_sum = sq_sum
    try:
        yield
    finally:
        _norm.sq_sum = prev


def global_norm_scale(grads, max_norm: float):
    """(scale, global_norm) of the trainable leaves: the clip formula
    shared by ``clip_by_global_norm`` and the fused path's norm pre-pass,
    so the two paths cannot drift."""
    sq_sum = getattr(_norm, "sq_sum", None)
    if sq_sum is not None:
        gn = torch.sqrt(sq_sum(grads))
        return torch.clamp(max_norm / (gn + 1e-9), max=1.0), gn
    leaves = [g for g in tree_leaves(grads) if _is_trainable(g)]
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves))
    return torch.clamp(max_norm / (gn + 1e-9), max=1.0), gn


def clip_by_global_norm(grads, max_norm: float):
    scale, gn = global_norm_scale(grads, max_norm)
    return tree_map(lambda g: g * scale if _is_trainable(g) else g,
                    grads), gn


def sgd(lr_fn: Callable) -> Optimizer:
    """Plain gradient descent, the paper's eq. (3): p - lr * g in fp32,
    stored back in p's dtype."""
    def init(params):
        return ()

    def update(grads, state, params, step):
        lr = lr_fn(step)
        return tree_map(
            lambda p, g: (p.float() - lr * g.float()).to(p.dtype)
            if _is_trainable(p) else p, params, grads), state
    return Optimizer(init, update)


@dataclasses.dataclass(frozen=True)
class FusedOptimizer(Optimizer):
    """An optimizer that can run inside the junctions' backward.

    ``update`` is the two-pass reference over materialised gradients.  A
    fused train step (train/steps.py) instead streams :meth:`hyp`'s
    ``(HYP_K,)`` row into the update kernels, injects :meth:`slots`'
    trees into the junction dicts, and calls :meth:`merge`, which keeps
    the junction weights and slots the kernels updated in place and
    applies the reference formula to every other trainable leaf."""
    lr_fn: Callable = None
    grad_clip: float | None = None

    def slot_keys(self) -> tuple[str, ...]:
        """State keys of the in-kernel slot trees, in the kernels' slot
        order (slot 0: SGD momentum / Adam m, slot 1: Adam v)."""
        raise NotImplementedError

    def slots(self, state) -> tuple:
        return tuple(state[k] for k in self.slot_keys())

    def hyp(self, step) -> torch.Tensor:
        """The (HYP_K,) fp32 hyp row of this step."""
        raise NotImplementedError

    def _dense_fn(self, step, lr_scale, grad_scale):
        """leaf(p, g, slot_vals) -> (p', *slot_vals'): the reference step
        for the leaves outside the junctions."""
        raise NotImplementedError

    def merge(self, grads, state, params, step, lr_scale=None,
              grad_scale=None):
        """``grads`` mirrors the params (extra keys ignored) with the
        gradients of the leaves outside the junctions; ``lr_scale`` and
        ``grad_scale`` must match the factors folded into the hyp row's
        lr and gs columns, so that every leaf moves alike."""
        keys = self.slot_keys()
        ms = tuple(state[k] for k in keys)
        dense = self._dense_fn(step, lr_scale, grad_scale)
        out = _merge(grads, params, ms, dense)
        if not keys:
            return out[0], state
        new_state = dict(state)
        for i, k in enumerate(keys):
            new_state[k] = out[1 + i]
        return out[0], new_state


def _merge(g, p, ms, dense):
    """(new p, *new slot trees) of ``FusedOptimizer.merge``: junction
    weights and slots as the kernels left them, ``dense`` elsewhere."""
    n = len(ms)
    if isinstance(p, dict):
        junction = sl.is_junction(p)
        new_p, new_ms = {}, tuple({} for _ in range(n))
        for k, v in p.items():
            mks = tuple(m[k] for m in ms)
            if isinstance(v, (dict, list, tuple)):
                out = _merge(g[k], v, mks, dense)
            elif junction and k in sl.FUSED_MOM and _is_trainable(v):
                out = (v,) + mks              # updated in place already
            else:
                out = dense(v, g[k], mks)
            new_p[k] = out[0]
            for i in range(n):
                new_ms[i][k] = out[1 + i]
        return (new_p,) + new_ms
    if isinstance(p, (list, tuple)):
        subs = [_merge(g[i], v, tuple(m[i] for m in ms), dense)
                for i, v in enumerate(p)]
        return (type(p)(s[0] for s in subs),) + tuple(
            type(p)(s[1 + i] for s in subs) for i in range(n))
    return dense(p, g, ms)


def _hyp_row(**cols) -> torch.Tensor:
    row = torch.zeros((bsm.HYP_K,), dtype=torch.float32)
    for name, v in cols.items():
        row[bsm.HYP_COLS.index(name)] = _f32(v)
    return row


@dataclasses.dataclass(frozen=True)
class FusedSGD(FusedOptimizer):
    """SGD(+momentum), in fp32: m' = momentum * m + gs * g,
    p' = (p - lr * m').astype(p.dtype)."""
    momentum: float = 0.0

    def slot_keys(self):
        return ("mom",) if self.momentum else ()

    def hyp(self, step) -> torch.Tensor:
        return _hyp_row(lr=self.lr_fn(step), b1=self.momentum, gs=1.0)

    def _dense_fn(self, step, lr_scale, grad_scale):
        lr = self.lr_fn(step)
        if lr_scale is not None:
            lr = lr * lr_scale

        def dense(p, g, ms):
            if not _is_trainable(p):
                return (p,) + ms
            mv = g.float()
            if grad_scale is not None:
                mv = grad_scale * mv
            if self.momentum:
                mv = self.momentum * ms[0] + mv
                return (p.float() - lr * mv).to(p.dtype), mv
            return ((p.float() - lr * mv).to(p.dtype),)
        return dense


def fused_sgd(lr_fn: Callable, momentum: float = 0.0,
              grad_clip: float | None = None) -> FusedSGD:
    """SGD with optional momentum, fusable into the backward kernels;
    fp32 momentum even for bf16 params."""
    def init(params):
        if not momentum:
            return ()
        return {"mom": tree_map(_zeros_like_state, params)}

    def update(grads, state, params, step):
        if grad_clip is not None:
            grads, _ = clip_by_global_norm(grads, grad_clip)
        lr = lr_fn(step)
        if momentum:
            mv = tree_map(lambda m, g: momentum * m + g.float()
                          if _is_trainable(g) else m, state["mom"], grads)
            new_params = tree_map(
                lambda p, m: (p.float() - lr * m).to(p.dtype)
                if _is_trainable(p) else p, params, mv)
            return new_params, {"mom": mv}
        new_params = tree_map(
            lambda p, g: (p.float() - lr * g.float()).to(p.dtype)
            if _is_trainable(p) else p, params, grads)
        return new_params, state
    return FusedSGD(init=init, update=update, lr_fn=lr_fn,
                    momentum=momentum, grad_clip=grad_clip)


@dataclasses.dataclass(frozen=True)
class FusedAdam(FusedOptimizer):
    """Adam on the fused contract: slot 0 is m, slot 1 is v, both fp32;
    the hyp row carries the bias-correction time t = step + 1 and the
    decoupled weight decay ``step += wd * p``."""
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0

    def slot_keys(self):
        return ("m", "v")

    def hyp(self, step) -> torch.Tensor:
        return _hyp_row(lr=self.lr_fn(step), b1=self.b1, b2=self.b2,
                        eps=self.eps, wd=self.weight_decay,
                        t=_f32(step) + 1.0, gs=1.0)

    def _dense_fn(self, step, lr_scale, grad_scale):
        lr = self.lr_fn(step)
        if lr_scale is not None:
            lr = lr * lr_scale
        t = _f32(step) + 1.0
        c1 = 1.0 - torch.pow(_f32(self.b1), t)
        c2 = 1.0 - torch.pow(_f32(self.b2), t)

        def dense(p, g, ms):
            if not _is_trainable(p):
                return (p,) + ms
            gf = g.float()
            if grad_scale is not None:
                gf = grad_scale * gf
            m = self.b1 * ms[0] + (1 - self.b1) * gf
            v = self.b2 * ms[1] + (1 - self.b2) * torch.square(gf)
            ref = p.float()
            step_ = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            if self.weight_decay:
                step_ = step_ + self.weight_decay * ref
            return (ref - lr * step_).to(p.dtype), m, v
        return dense


def fused_adam(lr_fn, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.0,
               grad_clip: float | None = None) -> FusedAdam:
    """Adam, fusable into the backward kernels; ``update`` is the two-pass
    :func:`adam` (note ``grad_clip`` defaults to None here, 1.0 there)."""
    ref = adam(lr_fn, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
               grad_clip=grad_clip, master_copy=False)
    return FusedAdam(init=ref.init, update=ref.update, lr_fn=lr_fn,
                     grad_clip=grad_clip, b1=b1, b2=b2, eps=eps,
                     weight_decay=weight_decay)


def adam(lr_fn, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.0,
         grad_clip: float | None = 1.0,
         master_copy: bool = False) -> Optimizer:
    """Adam with fp32 moments, the update computed in fp32 and stored in
    each parameter's dtype.  With ``master_copy`` the state also holds
    ``master``, an fp32 copy of each trainable leaf: the step (weight decay
    included) starts from the master, writes the new master back into the
    state and returns it rounded to the param's dtype, so bf16-resident
    params keep fp32 accuracy across steps."""
    def init(params):
        st = {"m": tree_map(_zeros_like_state, params),
              "v": tree_map(_zeros_like_state, params)}
        if master_copy:
            st["master"] = tree_map(
                lambda p: p.detach().to(torch.float32, copy=True)
                if _is_trainable(p) else _zeros_like_state(p), params)
        return st

    def update(grads, state, params, step):
        if grad_clip is not None:
            grads, _ = clip_by_global_norm(grads, grad_clip)
        lr = lr_fn(step)
        t = _f32(step) + 1.0
        c1 = 1.0 - torch.pow(_f32(b1), t)
        c2 = 1.0 - torch.pow(_f32(b2), t)

        def upd(p, g, m, v, master):
            if not _is_trainable(p):
                return p, m, v, master
            gf = g.float()
            m = b1 * m + (1 - b1) * gf
            v = b2 * v + (1 - b2) * torch.square(gf)
            ref = master if master_copy else p.float()
            step_ = (m / c1) / (torch.sqrt(v / c2) + eps)
            if weight_decay:
                step_ = step_ + weight_decay * ref
            new_master = ref - lr * step_
            return (new_master.to(p.dtype), m, v,
                    new_master if master_copy else master)

        flat_p = tree_leaves(params)
        flat_ma = (tree_leaves(state["master"]) if master_copy
                   else [None] * len(flat_p))
        out = [upd(*leaves) for leaves in zip(
            flat_p, tree_leaves(grads), tree_leaves(state["m"]),
            tree_leaves(state["v"]), flat_ma)]
        new = [tree_unflatten_like(params, [o[i] for o in out])
               for i in range(3 + master_copy)]
        new_st = {"m": new[1], "v": new[2]}
        if master_copy:
            new_st["master"] = new[3]
        return new[0], new_st
    return Optimizer(init, update)
