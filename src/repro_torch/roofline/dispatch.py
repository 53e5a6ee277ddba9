"""Counts of the aten ops one call dispatches: dot FLOPs, bytes, collective
traffic.

The port's counterpart of ``src/repro/roofline/hlo.py``.  The reference
walks XLA's optimized HLO text; eager PyTorch has no such module, so
``DispatchCounter`` (a ``TorchDispatchMode``) sees every op the call runs,
below autograd, the backward included.  On ``meta`` tensors the ops carry
shapes only, so a full-size cell is counted without allocating.

Counted over the call, per rank (each process counts its own ops):
  * dot_flops  — the matmul-family ops (mm, bmm, addmm, baddbmm,
                 convolution, scaled-dot-product attention) by the
                 formulas of ``torch.utils.flop_counter``'s registry.
                 Elementwise FLOPs are excluded, as in the reference.
  * mem_bytes  — input plus output bytes of every op that does not return
                 a view (an op that writes nothing and whose outputs all
                 share an input's storage) and is not a bare allocation.
                 Eager PyTorch materialises each such op, so this is the
                 eager program's HBM traffic: an upper estimate of what
                 fused kernels must move.  The compute term is the bound
                 proper.
  * coll_bytes — output bytes of every collective (``c10d`` and
                 ``_c10d_functional``: all-reduce, all-gather,
                 reduce-scatter, all-to-all, send / recv); all-reduce
                 costs 2x (reduce-scatter + all-gather on a ring), as in
                 the reference.  ``coll_detail`` holds (bytes, count) per
                 kind.
  * peak_bytes — the largest sum of live storage bytes during the call:
                 each storage an op returns counts once, from that op
                 until it dies (a ``weakref.finalize`` on its
                 ``untyped_storage()``); the tensors ``held`` at entry (the
                 call's arguments) count from the start.  On ``meta``
                 tensors this is the eager program's peak without
                 allocating; the caching allocator's rounding and the
                 kernels' workspaces are not in it.
There are no loops to multiply out: every dispatched op is counted once
for each time it runs.
"""
from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import (
    TorchDispatchMode, is_traceable_wrapper_subclass)
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

_aten = torch.ops.aten
# ops that allocate and write nothing
_NO_TRAFFIC = {_aten.empty, _aten.empty_like, _aten.empty_strided,
               _aten.new_empty, _aten.new_empty_strided}
_COLLECTIVES = {
    "all-reduce": ("allreduce_", "allreduce_coalesced_", "all_reduce",
                   "all_reduce_", "all_reduce_coalesced",
                   "all_reduce_coalesced_"),
    "all-gather": ("allgather_", "_allgather_base_", "allgather_coalesced_",
                   "allgather_into_tensor_coalesced_",
                   "all_gather_into_tensor", "all_gather_into_tensor_out",
                   "all_gather_into_tensor_coalesced"),
    "reduce-scatter": ("reduce_scatter_", "_reduce_scatter_base_",
                       "reduce_scatter_tensor_coalesced_",
                       "reduce_scatter_tensor",
                       "reduce_scatter_tensor_coalesced"),
    "all-to-all": ("alltoall_", "alltoall_base_", "all_to_all_single"),
    "send-recv": ("send", "recv_", "recv_any_source_"),
}
_COLL_KIND = {(ns, op): kind for kind, ops in _COLLECTIVES.items()
              for op in ops for ns in ("c10d", "_c10d_functional")}


def type_bytes(x) -> int:
    """Bytes of a tensor, or of every tensor in a (nested) tuple or list;
    the size of one element for a dtype (bf16 2, int8 1, fp32 4, bool 1)."""
    if isinstance(x, torch.dtype):
        return x.itemsize
    return sum(t.numel() * t.element_size() for t in tree_leaves(x)
               if torch.is_tensor(t))


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_leaves(tree) if torch.is_tensor(t)]


def _writes(func) -> bool:
    return any(a.alias_info is not None and a.alias_info.is_write
               for a in func._schema.arguments)


def _is_view(func, ins, outs) -> bool:
    if func.is_view:
        return True
    if _writes(func) or not outs:
        return False
    held = {t.untyped_storage()._cdata for t in ins}
    return all(t.untyped_storage()._cdata in held for t in outs)


class DispatchCounter(TorchDispatchMode):
    """``with DispatchCounter(held) as c: fn(...)`` leaves the counts of
    the ops ``fn`` dispatched in ``c``; ``held`` (a tree of tensors, the
    call's arguments) is live from entry for ``peak_bytes``."""

    def __init__(self, held=()):
        super().__init__()
        self.dot_flops = 0
        self.mem_bytes = 0
        self.coll_bytes = 0
        self.coll_detail: dict[str, tuple[int, int]] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: dict[int, int] = {}
        for t in _tensors(held):
            self._track(t)

    def _track(self, t: torch.Tensor) -> None:
        if is_traceable_wrapper_subclass(t):   # a DTensor: its local shard
            for inner in _tensors([getattr(t, name) for name in
                                   t.__tensor_flatten__()[0]]):
                self._track(inner)
            return
        st = t.untyped_storage()
        if st._cdata in self._live:
            return
        key, nbytes = st._cdata, st.nbytes()
        self._live[key] = nbytes
        self.live_bytes += nbytes
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._release, key).atexit = False

    def _release(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        for t in _tensors(out):
            self._track(t)
        packet = func.overloadpacket
        if packet in flop_registry:
            self.dot_flops += flop_registry[packet](*args, **kwargs,
                                                    out_val=out)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        ns, _, name = func._schema.name.partition("::")
        kind = _COLL_KIND.get((ns, name))
        if kind is not None:
            # the tensors a collective returns are the ones it filled; a
            # send (or a recv that returns only its work) moves its first
            # argument's tensors
            moved = type_bytes(outs) or type_bytes(args[0])
            b = (2 if kind == "all-reduce" else 1) * moved
            self.coll_bytes += b
            b0, c0 = self.coll_detail.get(kind, (0, 0))
            self.coll_detail[kind] = (b0 + b, c0 + 1)
        if kind is not None or (packet not in _NO_TRAFFIC
                                and not _is_view(func, ins, outs)):
            self.mem_bytes += type_bytes(ins) + type_bytes(outs)
        return out
