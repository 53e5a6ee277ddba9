"""The partitioned mesh steps: compute follows the specs.

``sharding.param_specs`` places each leaf; a rank computes what its
shards allow, as the reference's partitioned program does.  For each dim
of a leaf:

* split over "model": the work along that dim is divided over the model
  ranks (tensor parallelism: column-parallel products where the out dim
  is split, row-parallel ones where the in dim is, a block-sparse
  junction over the rank's output blocks, attention over the rank's
  heads, the embedding and unembedding over the rank's vocab rows, a
  MoE's experts over the rank's experts, routed over every row group:
  ``rows_gather``, ``row_mean``; a state-space mixer over the rank's
  channels or heads, the columns it needs moved to it by ``regroup``);
* split over the dp axes ("pod", "data"): FSDP.  ``Partition.gather``
  all-gathers a layer's leaves over those axes only, just before the
  layer runs (the model shard stays local); the layer is recomputed in
  the backward, gathering again (a unit run once and kept, ``kept``,
  gathers only the leaves its backward reads), and each gradient is
  reduce-scattered back to the shard.  A unit that runs more than once in a step (the
  hybrid's shared block) sums its uses' gradients before that
  (``SharedUses``);
* replicated: the work is replicated.

Activations: the residual stream is stored sequence-sharded over "model"
(``Partition.residual``: a row-parallel product's partial sums are
reduce-scattered into it) and all-gathered over "model" before the
products that need every position (``Partition.tokens``).  A sequence
that does not divide the axis (a decode step's one token) keeps the
residual replicated, and partial sums are all-reduced instead.  Under
the "sp" strategy (whisper) no spec splits a leaf over "model": each
rank runs every product on its own positions of the residual
(``seq_shard``), attention gathers k / v of every position over "model"
(``tokens``), and the loss, a sum over the rank's positions, is
all-reduced over "model" (``sum_over_model``), so that every model rank
holds it as the convention below has a replicated loss.

Gradients follow one convention: a tensor that every model rank holds
alike (a replicated activation or leaf) carries on each rank a partial
gradient, the sum of which over the ranks is the true one; a tensor one
rank holds alone carries its true gradient.  So an all-gather's adjoint
is a reduce-scatter, a reduce-scatter's an all-gather, an all-reduce's
an all-reduce, the replicated loss is seeded with 1 / model, and a leaf
that "model" does not split has its gradient all-reduced over "model".
Every leaf's gradient is summed over the dp axes (reduce-scattered over
those its spec splits, all-reduced over the others) and divided by
their ranks: the mean over the batch rows, as ``steps.make_dp_train_step``
takes it.  Every sum over ranks is fp32: a row-parallel product's
partial sums are fp32 (``sparse_linear.apply_tp``) and round to the
compute dtype once summed, as one rank's product rounds once; gradients
are summed in fp32 and rounded back.

A fused BP+UP step (its junction dicts carrying the update context) has
no weight gradient to reduce: each fused junction reads the rank's model
shard of its weight, bias and slots through a ``HeldJunction``, which
gathers them over the dp axes only inside the junction's forward and
backward, and its update sums over every row of the batch, as the
reference's partitioner runs ``update_dw`` on operands gathered over the
batch; every dp rank of a model column makes the same update.  A MoE's
experts (nothing split over the dp axes) update over every row group's
capacity slots, each slot once, in global group order
(``_fused_experts``; windows of groups that cross the row groups folded
by ``fold_windows``); whisper's junctions on "sp" over the rows of every
rank of the row axes and, where the unit's rows split over it,
"model".

``MeshComm`` issues the collectives on a ``DeviceMesh`` (the functional
collectives, one axis at a time, the last mesh axis first when
gathering, as DTensor does); ``ReckonedComm`` reckons the same calls on
an ``AbstractMesh`` as rank 0 would issue them and returns ``meta``
tensors of their shapes, for ``launch/dryrun.py``.  With one rank on an
axis nothing is issued along it, so on a 1 x 1 mesh the partitioned step
runs the same ops as the plain step.
"""
from __future__ import annotations

import contextlib
import copy
import math
import threading

import torch

from repro_torch.core import sparse_linear as sl
from repro_torch.parallel import sharding as sh
from repro_torch.tree import tree_items, tree_map

_state = threading.local()


@contextlib.contextmanager
def use(part):
    """Run the model's partitioned route under ``part``."""
    prev = getattr(_state, "part", None)
    _state.part = part
    try:
        yield part
    finally:
        _state.part = prev


def current():
    return getattr(_state, "part", None)


# ------------------------------------------------------------ collectives
class MeshComm:
    """One rank's collectives over the named axes of a ``DeviceMesh``.
    ``axes`` is a tuple of axis names, outer first; an axis of one rank
    is skipped."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.sizes = sh.axis_sizes(mesh)

    def local_rank(self, axis: str) -> int:
        return self.mesh.get_local_rank(axis)

    def index(self, axes: tuple) -> int:
        """This rank's position along ``axes`` (outer first)."""
        at = 0
        for a in axes:
            at = at * self.sizes[a] + self.local_rank(a)
        return at

    def size(self, axes: tuple) -> int:
        return math.prod(self.sizes[a] for a in axes)

    def all_gather(self, t, axes: tuple, dim: int):
        for a in reversed(axes):
            if self.sizes[a] > 1:
                t = self._gather(t, a, dim)
        return t

    def reduce_scatter(self, t, axes: tuple, dim: int):
        for a in axes:
            if self.sizes[a] > 1:
                t = self._scatter(t, a, dim)
        return t

    def all_reduce(self, t, axes: tuple, op: str = "sum"):
        for a in axes:
            if self.sizes[a] > 1:
                t = self._reduce(t, a, op)
        return t

    def all_to_all(self, t, axis: str, out_splits: list, in_splits: list):
        """Along dim 0 of ``t`` over ``axis``: ``in_splits[q]`` rows to
        rank q, ``out_splits[q]`` rows from rank q, in rank order."""
        if self.sizes[axis] == 1:
            return t
        return self._all_to_all(t, axis, out_splits, in_splits)

    # one axis, through the functional collectives (the names PyTorch
    # 2.13 gives them, or the older ones)
    def _gather(self, t, axis, dim):
        fn = _funcol("all_gather_single", "all_gather_tensor")
        return _waited(fn(t.contiguous(), dim % t.dim(),
                          self.mesh.get_group(axis)))

    def _scatter(self, t, axis, dim):
        fn = _funcol("reduce_scatter_single", "reduce_scatter_tensor")
        return _waited(fn(t.contiguous(), "sum", dim % t.dim(),
                          self.mesh.get_group(axis)))

    def _reduce(self, t, axis, op):
        fn = _funcol("all_reduce", "all_reduce")
        return _waited(fn(t.contiguous(), op, self.mesh.get_group(axis)))

    def _all_to_all(self, t, axis, out_splits, in_splits):
        fn = _funcol("all_to_all_single", "all_to_all_single")
        return _waited(fn(t.contiguous(), list(out_splits), list(in_splits),
                          self.mesh.get_group(axis)))


def _funcol(name: str, old: str):
    from torch.distributed import _functional_collectives as funcol
    return getattr(funcol, name, None) or getattr(funcol, old)


def _waited(t):
    return t.wait() if hasattr(t, "wait") else t


class ReckonedComm(MeshComm):
    """``MeshComm``'s calls reckoned, not issued, as rank 0 of ``mesh``
    (an ``AbstractMesh``) issues them: ``detail`` holds {kind: (bytes,
    count)} under ``roofline/dispatch.py``'s conventions (an all-gather,
    a reduce-scatter and an all-to-all count their output bytes, an
    all-reduce twice its bytes), and each call returns an empty tensor
    of the collective's output shape."""

    def __init__(self, mesh):
        super().__init__(mesh)
        self.detail: dict[str, tuple[int, int]] = {}

    def local_rank(self, axis: str) -> int:
        return 0

    def _add(self, kind: str, t, factor: int = 1) -> None:
        b, n = self.detail.get(kind, (0, 0))
        self.detail[kind] = (b + factor * t.numel() * t.element_size(),
                             n + 1)

    def _resized(self, t, dim, scale):
        shape = list(t.shape)
        shape[dim] = int(shape[dim] * scale)
        return t.new_empty(shape)

    def _gather(self, t, axis, dim):
        out = self._resized(t, dim, self.sizes[axis])
        self._add("all-gather", out)
        return out

    def _scatter(self, t, axis, dim):
        out = self._resized(t, dim, 1 / self.sizes[axis])
        self._add("reduce-scatter", out)
        return out

    def _reduce(self, t, axis, op):
        out = torch.empty_like(t)
        self._add("all-reduce", out, 2)
        return out

    def _all_to_all(self, t, axis, out_splits, in_splits):
        out = t.new_empty((sum(out_splits), *t.shape[1:]))
        self._add("all-to-all", out)
        return out


class _Gather(torch.autograd.Function):
    """All-gather over ``axes`` along ``dim``; the adjoint reduce-scatters."""

    @staticmethod
    def forward(ctx, t, comm, axes, dim):
        ctx.comm, ctx.axes, ctx.dim = comm, axes, dim
        return comm.all_gather(t, axes, dim)

    @staticmethod
    def backward(ctx, g):
        got = ctx.comm.reduce_scatter(g.float(), ctx.axes, ctx.dim)
        return got.to(g.dtype), None, None, None


class _Scatter(torch.autograd.Function):
    """Reduce-scatter (sum) over ``axes`` along ``dim``; the adjoint
    all-gathers."""

    @staticmethod
    def forward(ctx, t, comm, axes, dim):
        ctx.comm, ctx.axes, ctx.dim = comm, axes, dim
        return comm.reduce_scatter(t, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_gather(g, ctx.axes, ctx.dim), None, None, None


class _Reduce(torch.autograd.Function):
    """All-reduce (sum) over ``axes``; the adjoint all-reduces."""

    @staticmethod
    def forward(ctx, t, comm, axes):
        ctx.comm, ctx.axes = comm, axes
        return comm.all_reduce(t, axes)

    @staticmethod
    def backward(ctx, g):
        got = ctx.comm.all_reduce(g.float(), ctx.axes)
        return got.to(g.dtype), None, None


class _Regroup(torch.autograd.Function):
    """Columns of the last dim moved over "model" (``Partition.regroup``):
    ``send`` the rank's local columns for each rank in turn, ``in_splits``
    / ``out_splits`` the counts to and from each rank.  The adjoint sends
    each received column's gradient back and sums, in fp32, the gradients
    of a column that several ranks received."""

    @staticmethod
    def forward(ctx, t, comm, send, in_splits, out_splits):
        ctx.comm, ctx.send, ctx.splits = comm, send, (in_splits, out_splits)
        ctx.n = t.shape[-1]
        rows = t.movedim(-1, 0).index_select(0, send)
        got = comm.all_to_all(rows, "model", out_splits, in_splits)
        return got.movedim(0, -1)

    @staticmethod
    def backward(ctx, g):
        in_splits, out_splits = ctx.splits
        back = ctx.comm.all_to_all(g.float().movedim(-1, 0), "model",
                                   in_splits, out_splits)
        out = back.new_zeros((ctx.n, *back.shape[1:]))
        out.index_add_(0, ctx.send, back)
        return out.movedim(0, -1).to(g.dtype), None, None, None, None


class SharedUses:
    """The gradients of a unit that a step runs ``uses`` times (the
    hybrid's shared block), summed in fp32 over its uses: each leaf's
    FSDP adjoint reduces the sum once, at the last use's backward; the
    earlier uses pass no gradient on."""

    def __init__(self, uses: int):
        self.uses, self.acc = uses, {}

    def add(self, key, g):
        n, total = self.acc.get(key, (0, None))
        total = g if total is None else total + g
        if n + 1 < self.uses:
            self.acc[key] = (n + 1, total)
            return None
        self.acc.pop(key, None)
        return total


class _LeafGather(torch.autograd.Function):
    """A leaf's FSDP gather: an all-gather over the dp axes its spec
    splits (the model shard stays local).  The adjoint sums the gradient
    in fp32 over every dp axis (a reduce-scatter over the split ones, an
    all-reduce over the others), over "model" where the spec does not
    split the leaf, and divides by the dp ranks.  A leaf of a unit that
    runs more than once (``shared``, a ``SharedUses``; ``key`` the leaf's)
    reduces the sum of its uses' gradients once."""

    @staticmethod
    def forward(ctx, t, part, plan, shared=None, key=None):
        ctx.part, ctx.plan, ctx.shared, ctx.key = part, plan, shared, key
        if plan.dp:
            out = part.comm.all_gather(t, plan.dp, plan.dp_dim)
            part.note_gather(out)
            if part.regather is not None:
                part.regather.held[out.untyped_storage()._cdata] = (
                    t.detach(), plan)
            return out
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        part, plan = ctx.part, ctx.plan
        dtype, comm = g.dtype, part.comm
        g = g.float()
        if ctx.shared is not None:
            g = ctx.shared.add(ctx.key, g)
            if g is None:       # an earlier use: the last one reduces
                return None, None, None, None, None
        if plan.dp:
            g = comm.reduce_scatter(g, plan.dp, plan.dp_dim)
        g = comm.all_reduce(g, plan.dp_rest)
        if plan.model_rep:
            g = comm.all_reduce(g, ("model",))
        if part.n_dp > 1:
            g = g / part.n_dp
        return g.to(dtype), None, None, None, None


class _Regather:
    """``saved_tensors_hooks`` of a unit run without recomputation
    (``Partition.kept``): a tensor that autograd saves whose storage is
    one of the unit's gathered leaves (``held``: its shard and plan, by
    storage) is packed as the recipe to gather it again, so the gathered
    leaf dies with the forward; unpacking gathers it once more over the
    dp axes and takes the saved view of it."""

    def __init__(self, part):
        self.part, self.held = part, {}

    def pack(self, t):
        got = self.held.get(t.untyped_storage()._cdata)
        if got is None:
            return t
        return got, tuple(t.shape), t.stride(), t.storage_offset()

    def unpack(self, saved):
        if torch.is_tensor(saved):
            return saved
        (shard, plan), shape, stride, offset = saved
        full = self.part.comm.all_gather(shard, plan.dp, plan.dp_dim)
        self.part.note_gather(full)
        return full.as_strided(shape, stride, offset)


class HeldJunction:
    """A fused junction's weights, bias and optimizer slots as a rank of
    the partitioned route holds them: its shards (``leaves``, each with
    its ``_Plan``; a slot takes its weight's), which
    ``ops.junction_train_update`` reads through this holder.  ``names``
    are the weight leaves the kernels read: ("w", "b") of a single
    junction, ("wg", "wi") of a MoE expert gate, ("wo", None) of its
    out junction; their slots are ``sparse_linear.FUSED_MOM`` /
    ``FUSED_VEL``'s names of them.  Each read gathers them over the dp
    axes anew (the forward, then the backward's dx and update), so no
    gathered copy outlives its use, however long the autograd graph
    keeps the holder.

    The update runs over every row of the batch, as the reference's
    partitioner runs the kernel on operands gathered over the batch: its
    row-major operands ((x, dy, the residual), or the gate's (x, dh, g,
    u)) are all-gathered over ``axes`` (the row axes, and "model" where
    the unit's rows, whisper's positions or frames on "sp", are split
    over it) in rank order; where dy is partial on each model rank
    (``reduce_model``: a "rep" junction that every model rank runs on the
    same rows, or experts replicated over "model") it is all-reduced
    over "model" in fp32 first.  MoE experts whose dispatch groups cross
    the row groups run on windows of whole groups (``windowed``): the
    windows are gathered and folded onto their global groups.  Every dp
    rank of a model column so makes the same update; the rank's piece of
    each updated tensor is then copied back into its shard.  With one
    rank on the axes nothing is issued and the kernels update the shards
    themselves."""

    def __init__(self, part, tree, spec_tree, names: tuple,
                 reduce_model: bool, axes: tuple):
        self.part, self.names = part, names
        self.slot_names = (tuple(sl.FUSED_MOM.get(n) for n in names)
                           + tuple(sl.FUSED_VEL.get(n) for n in names))
        of = {n: n for n in names if n is not None} | {
            s: n for s, n in zip(self.slot_names, names + names)
            if s is not None}
        self.leaves = {k: tree[k] for k in of if k in tree}
        self.plans = {k: _Plan(spec_tree[of[k]], part) for k in self.leaves}
        self.reduce_model, self.axes = reduce_model, axes
        self.fold = None

    def windowed(self, T: int, g: int, C: int):
        """This holder for experts run on windows of whole dispatch groups
        (``moe.moe_apply_tp`` where a group crosses the row groups): each
        row group holds ``T`` tokens, a group ``g`` tokens and an expert
        ``C`` capacity slots a group.  The operands' slots of a window
        are folded onto their global groups by exact sums: another row
        group's slot holds an exact zero there."""
        out = copy.copy(self)
        wins = [group_window(q * T, T, g) for q in range(self.part.n_rows)]
        out.fold = ([(a // g * C, n // g * C) for a, n in wins],
                    self.part.n_rows * T // g * C)
        return out

    def _gathered(self, name):
        t = self.leaves.get(name)
        plan = self.plans.get(name)
        if t is None or not plan.dp:
            return t
        out = self.part.comm.all_gather(t, plan.dp, plan.dp_dim)
        self.part.note_gather(out)
        return out

    def weights(self):
        return tuple(self._gathered(n) for n in self.names)

    def slots(self):
        return tuple(self._gathered(k) for k in self.slot_names)

    def update_operands(self, *ops):
        part, comm = self.part, self.part.comm
        dy = ops[1]
        if self.reduce_model and part.m > 1:
            dy = comm.all_reduce(dy.float(), ("model",)).to(dy.dtype)
        ops = (ops[0], dy) + ops[2:]
        if comm.size(self.axes) == 1:
            return ops
        got = tuple(None if t is None else self._rows(t) for t in ops)
        part.note_rows(got)
        return got

    def _rows(self, t):
        """``t``'s rows (dim 1) of every rank of ``axes``."""
        comm = self.part.comm
        if self.fold is None:
            return comm.all_gather(t, self.axes, 1)
        wins, total = self.fold
        L = max(n for _, n in wins)
        if t.shape[1] < L:      # windows differ in length: pad to the most
            t = torch.cat([t, t.new_zeros((t.shape[0], L - t.shape[1],
                                           *t.shape[2:]))], 1)
        got = comm.all_gather(t, self.axes, 1)
        return fold_windows(got, wins, L, total)

    def commit(self, weights, slots):
        got = dict(zip(self.names + self.slot_names, weights + slots))
        for name, shard in self.leaves.items():
            plan = self.plans[name]
            if plan.dp and got[name] is not shard:
                n = shard.shape[plan.dp_dim]
                at = self.part.comm.index(plan.dp)
                shard.copy_(got[name].narrow(plan.dp_dim, at * n, n))


def group_window(o: int, T: int, g: int) -> tuple[int, int]:
    """(a, n): the dispatch groups of ``g`` tokens that the tokens [o, o +
    T) lie in, as the token range [a, a + n)."""
    a = o // g * g
    return a, -(-(o + T) // g) * g - a


def fold_windows(got, wins: list, L: int, total: int):
    """The windows of every row group, gathered in rank order along dim 1
    (``got``: each ``L`` slots long, padded at the end), folded onto the
    ``total`` global slots: window q's first ``wins[q][1]`` slots added at
    slot ``wins[q][0]``.  Each slot is one token's at most, and every
    other window holds an exact zero there, so the sums are exact."""
    out = got.new_zeros((got.shape[0], total, *got.shape[2:]))
    for q, (s, n) in enumerate(wins):
        out[:, s:s + n] += got[:, q * L:q * L + n]
    return out


class _Plan:
    """How one leaf is gathered and its gradient reduced."""
    __slots__ = ("dp", "dp_dim", "dp_rest", "model_rep")

    def __init__(self, spec, part):
        self.dp, self.dp_dim = (), None
        named = set()
        for d, e in enumerate(spec):
            axes = sh.spec_axes(e)
            named.update(axes)
            if axes and "model" not in axes:
                self.dp, self.dp_dim = axes, d
        self.dp_rest = tuple(a for a in part.dp_axes if a not in named)
        self.model_rep = "model" not in named and part.m > 1

    def idle(self, part) -> bool:
        return not (self.dp or self.model_rep or part.n_dp > 1)


# ------------------------------------------------------------ the context
class Partition:
    """One rank's view of a partitioned step: the model config, the
    collectives (``MeshComm`` or ``ReckonedComm``), the param specs
    (mirroring the params as ``sharding.param_specs`` gives them), the
    dp axes the batch rows split over (``row_axes``), and whether the
    KV cache's sequence is split over "model" (``cache_seq_split``, set
    by the decode step).  ``n_rows`` is the number of row groups and
    ``row_at`` this rank's (outer first)."""

    def __init__(self, cfg, comm, specs, row_axes: tuple = ()):
        self.cfg, self.comm, self.specs = cfg, comm, specs
        sizes = comm.sizes
        self.m = sizes["model"]
        self.r = comm.index(("model",))
        self.dp_axes = tuple(a for a in ("pod", "data") if a in sizes)
        self.n_dp = comm.size(self.dp_axes)
        self.row_axes = tuple(row_axes)
        self.n_rows = comm.size(self.row_axes)
        self.row_at = comm.index(self.row_axes)
        self.cache_seq_split = False
        self.regather = None

    # ---- the gathers of a unit's leaves
    def note_gather(self, t) -> None:
        """Called with each leaf gather's output: a hook for tests that
        record what a rank holds gathered."""

    def note_rows(self, got) -> None:
        """Called with a fused junction's update operands gathered over
        the row axes (x, dy, the residual or None): a hook for the dry
        run, which records the largest."""

    def gather(self, tree, spec_tree, shared: SharedUses | None = None,
               rows_over_model: bool = False):
        """A unit (a layer, the embedding, a norm) ready to run: each
        float leaf through its FSDP gather, each linear container tagged
        with its tensor-parallel kind ``"_tp"`` ("col", "row", "rep") and
        whether its bias is split over "model" (``"_b_split"``).  The
        pattern leaves pass through (the step placed the rank's junction
        views in them, ``sharding.with_junction_views``).  ``shared``:
        the unit runs that many times a step and its leaves' gradients
        are summed over the uses before they are reduced.  A junction
        dict that carries the fused update's context is not gathered
        here: ``_fused_junction`` (a MoE expert pair: ``_fused_experts``);
        ``rows_over_model``: the unit runs on the rank's share of its rows
        (whisper's positions or frames split over "model" on "sp")."""
        if isinstance(tree, dict):
            if sl.UPDATE_HYP_LEAF in tree:
                if "idx_in" in tree:
                    return self._fused_experts(tree, spec_tree, shared)
                return self._fused_junction(tree, spec_tree, rows_over_model)
            out = {k: self.gather(v, spec_tree[k], shared, rows_over_model)
                   for k, v in tree.items()}
            if "w" in tree and torch.is_tensor(tree["w"]):
                out["_tp"] = tp_kind(spec_tree["w"])
                out["_b_split"] = ("b" in tree and "model" in
                                   sh.spec_axes(spec_tree["b"][0]))
            return out
        if isinstance(tree, (list, tuple)):
            return type(tree)(self.gather(v, s, shared, rows_over_model)
                              for v, s in zip(tree, spec_tree))
        if not (torch.is_tensor(tree) and tree.is_floating_point()):
            return tree
        plan = _Plan(spec_tree, self)
        if plan.idle(self):
            return tree
        return _LeafGather.apply(tree, self, plan, shared, id(tree))

    def _fused_junction(self, tree, spec_tree, rows_over_model: bool):
        """A junction dict that carries the fused update's context
        (``sparse_linear.inject_update_ctx``), ready to run: its shards,
        pattern views, hyp row and health leaf as they are, tagged as
        ``gather`` tags a linear container, and its holder under
        ``"_held"`` (``HeldJunction``), through which the kernels gather
        and update it.  Its update's rows: over the row axes, and over
        "model" where the unit's rows are split over it
        (``rows_over_model``); else a "rep" junction's dy, partial on each
        model rank, is all-reduced over "model" first."""
        kind = tp_kind(spec_tree["w"])
        b_split = "b" in tree and "model" in sh.spec_axes(spec_tree["b"][0])
        if "b" in tree and b_split != (kind == "col"):
            raise ValueError("a fused junction's bias must split over "
                             "\"model\" as its output blocks do")
        held = HeldJunction(
            self, tree, spec_tree, ("w", "b"),
            kind == "rep" and not rows_over_model,
            self.row_axes + (("model",) if rows_over_model else ()))
        return dict(tree, _tp=kind, _b_split=b_split, _held=held)

    def _fused_experts(self, tree, spec_tree, shared):
        """A MoE dict that carries the fused update's context, ready to
        run: the router and the shared experts through ``gather``, the
        expert weights and their slots as the rank holds them (its E /
        model experts, nothing split over the dp axes), and a holder for
        the gate (``"_held_in"``: wg, wi) and for wo (``"_held_out"``),
        whose update runs over every row group's capacity slots; where
        the experts are replicated over "model" every model rank runs
        them all on the same rows, its dh partial."""
        if sl.is_quantized(tree):
            raise ValueError("quantized experts inside a fused train step: "
                             "the int8 datapath is inference only")
        out = {k: v if sl.fused_owned(k) else
               self.gather(v, spec_tree[k], shared)
               for k, v in tree.items()}
        rep = "model" not in sh.spec_axes(spec_tree["wg"][0])
        out["_held_in"] = HeldJunction(self, tree, spec_tree, ("wg", "wi"),
                                       rep, self.row_axes)
        out["_held_out"] = HeldJunction(self, tree, spec_tree, ("wo", None),
                                        rep, self.row_axes)
        return out

    @contextlib.contextmanager
    def kept(self):
        """Run a unit once under grad, not recomputed (a MoE model's dense
        first layers, as the reference runs them): its activations are
        kept for the backward, its gathered leaves are not, the backward
        gathering each again where it needs it (``_Regather``)."""
        self.regather = hooks = _Regather(self)
        try:
            with torch.autograd.graph.saved_tensors_hooks(hooks.pack,
                                                          hooks.unpack):
                yield
        finally:
            self.regather = None
            hooks.held = {}

    # ---- feature layouts ("full": every feature on every rank, "split":
    # the rank's contiguous share of the last dim, "partial": partial sums)
    def full(self, x, layout: str):
        if layout == "full" or self.m == 1:
            return x
        if layout == "split":
            return _Gather.apply(x, self.comm, ("model",), -1)
        return _Reduce.apply(x, self.comm, ("model",)).to(
            self.cfg.compute_dtype)

    def regroup(self, x, held: list, want: list):
        """Columns of ``x``'s last dim moved between the model ranks: rank
        q holds the global columns [held[q][0], held[q][1]) (``x`` is this
        rank's) and receives the columns of the sorted, disjoint ranges
        ``want[q]``, in global order (a column may go to several ranks).
        One all-to-all over "model"; its adjoint sends the gradients
        back and sums each column's (``_Regroup``).  With one model rank
        ``want[0]`` must be everything ``held[0]`` holds."""
        if self.m == 1:
            return x
        lo, hi = held[self.r]
        send, in_splits, out_splits = [], [], []
        for q in range(self.m):
            got = _overlaps(lo, hi, want[q])
            send += [c - lo for a, b in got for c in range(a, b)]
            in_splits.append(sum(b - a for a, b in got))
            out_splits.append(sum(b - a for a, b in _overlaps(
                *held[q], want[self.r])))
        send = torch.tensor(send, dtype=torch.long, device=x.device)
        return _Regroup.apply(x, self.comm, send, in_splits, out_splits)

    def split(self, x, layout: str):
        """The rank's share of the last dim of a full ``x``."""
        if layout == "split" or self.m == 1:
            return x
        if layout != "full":
            raise ValueError(f"cannot split a {layout} tensor")
        n = x.shape[-1] // self.m
        return x.narrow(-1, self.r * n, n)

    # ---- the residual stream [B, S, D]
    def seq_split(self, S: int) -> bool:
        return self.m > 1 and S % self.m == 0

    def seq_shard(self, t, S: int, dim: int = 1):
        """The rank's positions of ``t`` (all ``S`` along ``dim``): a
        view of its share where the sequence splits, else ``t``."""
        if not self.seq_split(S):
            return t
        n = S // self.m
        return t.narrow(dim, self.r * n, n)

    def tokens(self, h, S: int):
        """The residual layout -> every position on every rank."""
        if not self.seq_split(S):
            return h
        return _Gather.apply(h, self.comm, ("model",), 1)

    def residual(self, y, layout: str, S: int):
        """A [B, S, D] product in ``layout`` -> the residual layout:
        partial sums reduce-scattered over the sequence (all-reduced
        where it does not divide), a full tensor cut to the rank's
        positions, a feature-split one gathered first."""
        if self.m == 1:
            return y
        if layout == "partial":     # fp32 sums, rounded once summed
            if self.seq_split(S):
                y = _Scatter.apply(y, self.comm, ("model",), 1)
            else:
                y = _Reduce.apply(y, self.comm, ("model",))
            return y.to(self.cfg.compute_dtype)
        return self.seq_shard(self.full(y, layout), S)

    def last_position(self, x, S: int):
        """x[:, -1:] of the residual: the last rank's last position,
        gathered (each rank sends its own last)."""
        if not self.seq_split(S):
            return x[:, -1:]
        got = self.comm.all_gather(x[:, -1:].contiguous(), ("model",), 1)
        return got[:, -1:]

    # ---- reductions over "model" that carry no gradient
    def max_over_model(self, t):
        with torch.no_grad():
            return self.comm.all_reduce(t, ("model",), "max")

    def sum_over_model(self, t):
        return _Reduce.apply(t, self.comm, ("model",)) if self.m > 1 else t

    # ---- MoE routing over the batch rows of every row group
    def rows_gather(self, t):
        """``t`` [T, ...] of every row group, in rank order along dim 0
        (the global token order): no gradient (top-k indices)."""
        with torch.no_grad():
            return self.comm.all_gather(t, self.row_axes, 0)

    def row_mean(self, t):
        """The fp32 mean of ``t`` over the row groups (each rank's ``t`` a
        mean over as many tokens), all-reduced; the adjoint all-reduces,
        so each rank's loss, which holds the mean alike, carries the
        gradient of every rank's share to it."""
        if not self.row_axes:
            return t
        return _Reduce.apply(t.float(), self.comm, self.row_axes) / \
            self.n_rows

    # ---- the train step's reductions
    def dp_mean(self, t):
        """The fp32 mean of ``t`` over the row axes (no-op without)."""
        t = t.float()
        if not self.row_axes:
            return t
        return self.comm.all_reduce(t, self.row_axes) / self.comm.size(
            self.row_axes)

    def sq_sum(self, grads):
        """The squared global norm of a gradient tree of local shards:
        each shard's squares divided by its copies (the ranks of the mesh
        axes its spec does not name), summed over every rank."""
        specs = dict(sh.spec_items(self.specs))
        total = None
        for path, g in tree_items(grads):
            if not (torch.is_tensor(g) and g.is_floating_point()):
                continue
            named = {a for e in specs[path] for a in sh.spec_axes(e)}
            copies = math.prod(n for a, n in self.comm.sizes.items()
                               if a not in named)
            s = torch.sum(torch.square(g.float()))
            if copies > 1:
                s = s / copies
            total = s if total is None else total + s
        return self.comm.all_reduce(total, tuple(self.comm.sizes))

    def any_over_ranks(self, flags):
        """Element-wise max of a float flag vector over every rank."""
        return self.comm.all_reduce(flags, tuple(self.comm.sizes), "max")


def _overlaps(lo: int, hi: int, ranges: list) -> list:
    """The parts of the sorted ``ranges`` that lie in [lo, hi)."""
    got = [(max(a, lo), min(b, hi)) for a, b in ranges]
    return [(a, b) for a, b in got if a < b]


def tp_kind(spec) -> str:
    """A linear weight's tensor-parallel kind from its spec: "col" (the
    out dim, or a junction's output blocks, split over "model"), "row"
    (a dense weight's in dim split), "rep" (neither)."""
    axes = [sh.spec_axes(e) for e in spec]
    if len(spec) == 4:
        return "col" if "model" in axes[0] else "rep"
    if "model" in axes[-1]:
        return "col"
    return "row" if "model" in axes[0] else "rep"


def local_tree(tree):
    """Each DTensor leaf's local shard, other leaves as they are.  A leaf
    that needs no gradient gives its shard itself, without
    ``to_local``'s autograd node (a step unwraps every leaf of its params
    and optimizer state)."""
    from torch.distributed.tensor import DTensor

    def one(t):
        if not isinstance(t, DTensor):
            return t
        return t.to_local() if t.requires_grad else t._local_tensor
    return tree_map(one, tree)
