"""Logical-axis sharding rules -> per-leaf specs, and DTensor placement.

Two production mesh layouts (launch/mesh.py):
  single-pod  (data=16, model=16)
  multi-pod   (pod=2, data=16, model=16)  — "pod" is hierarchical DP.

Parameters are 2-D sharded (TP on "model" + FSDP on "data") so the
104B-param arch fits: per-device bytes = total/(data*model).  Every rule is
guarded by divisibility — a dim that doesn't divide its mesh axis is
replicated instead (whisper's 8 heads vs model=16, batch=1 long-context).
The KV cache shards its *sequence* dim over "model".

A spec (``P``) names a mesh axis (or a tuple of axes, outer first) or
None for each tensor dim.  The port's params hold layers as lists, so a
layer leaf's spec has no stack dims: it is the reference's spec with its
one (the hybrid: two) leading None taken off.  The cache stacks its
layers, so ``cache_specs`` keeps them.  The rules read a mesh's
``mesh_dim_names`` and ``shape``: a ``DeviceMesh`` or an
``AbstractMesh``.

``to_shardings`` turns specs into DTensor placements; ``place`` puts a
tree of full tensors on a mesh (each rank keeps only its shard),
``gather`` makes full tensors again, ``place_like`` places new full
tensors as the leaves of an earlier placed tree were and ``place_rows``
places tensors that hold only this rank's rows.  ``attach`` gives each
leaf's per-rank shard as a ``meta`` tensor, on either kind of mesh.

For the partitioned mesh steps (parallel/partition.py): ``junction_view``
gives a rank the rows of a junction's pattern for its output blocks and
reverse tables of its own, ``with_junction_views`` puts them in a tree
of local shards, and ``wrap_local`` / ``wrap_like`` make DTensors of
tensors that already hold a rank's shard.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs.base import ArchConfig
from repro_torch.core.sparse_linear import MOE_PATTERN_LEAVES, PATTERN_LEAVES
from repro_torch.tree import tree_leaves, tree_map


class P(tuple):
    """A partition spec: one entry a tensor dim (an axis name, a tuple of
    axis names, or None)."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


# linear containers whose w is [in, out]: out-dim -> "model", in-dim -> "data"
_OUT_MODEL = {"wq", "wk", "wv", "wi", "wg", "in_proj", "wkv_b",
              "in_z", "in_xbc", "in_dt", "dt_proj"}
# every other linear container (wo, out_proj): out-dim -> "data", in-dim
# -> "model"
# replicated small projections
_REPL = {"wkv_a", "x_proj"}


def axis_sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _fit(dim: int, axis, mesh):
    """Use axis only if dim divides its size."""
    if axis is None:
        return None
    sizes = axis_sizes(mesh)
    ax = sizes.get(axis)
    if isinstance(axis, tuple):
        ax = 1
        for a in axis:
            ax *= sizes[a]
    return axis if ax and dim % ax == 0 else None


def dp_axes(mesh):
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else "data"


def _dp_fit(dim: int, mesh):
    sizes = axis_sizes(mesh)
    axes = dp_axes(mesh)
    if isinstance(axes, tuple):
        total = 1
        for a in axes:
            total *= sizes[a]
        if dim % total == 0:
            return axes
        # fall back to the inner data axis alone
        return "data" if dim % sizes["data"] == 0 else None
    return axes if dim % sizes[axes] == 0 else None


def _linear_spec(parent: str, leaf: str, lshape: tuple, mesh,
                 head_aligned: bool = True):
    """Spec for one leaf of a linear container (no stack dims).

    head_aligned=False (attention projections whose head count doesn't
    divide the model axis, e.g. whisper's 8 heads on model=16) forces the
    head-fused dim to replicate: sharding it would misalign the
    [.., H, hd] reshape."""
    nd = len(lshape)
    if leaf in PATTERN_LEAVES:
        return (None,) * nd
    if parent in _REPL:
        return ((_fit(lshape[0], "data", mesh),) + (None,) * (nd - 1)
                if nd >= 1 else ())
    if leaf == "b":
        axis = "model" if parent in _OUT_MODEL else "data"
        if not head_aligned:
            axis = None
        return (_fit(lshape[0], axis, mesh),)
    # weights
    if nd == 2:  # dense [in, out]
        if parent in _OUT_MODEL:
            return (_fit(lshape[0], "data", mesh),
                    _fit(lshape[1], "model", mesh) if head_aligned else None)
        return (_fit(lshape[0], "model", mesh) if head_aligned else None,
                _fit(lshape[1], "data", mesh))
    if nd == 4:  # block-sparse [nob, kb, bs, bs]
        return (_fit(lshape[0], "model", mesh), None,
                _fit(lshape[2], "data", mesh), None)
    return (None,) * nd


def _leaf_spec(path: list, lshape: tuple, mesh, cfg: ArchConfig | None = None):
    leaf = path[-1]
    parent = path[-2] if len(path) > 1 else ""
    grandparent = path[-3] if len(path) > 2 else ""
    nd = len(lshape)
    model_size = axis_sizes(mesh)["model"]
    # attention projections: shardable only when head counts divide "model"
    head_aligned = True
    if cfg is not None and grandparent in ("attn", "cross", "shared_attn"):
        if parent in ("wq", "wo", "wkv_b"):
            head_aligned = cfg.n_heads % model_size == 0
        elif parent in ("wk", "wv"):
            head_aligned = cfg.kv_heads % model_size == 0
    # norms / small vectors
    if leaf in ("scale",) or (leaf == "bias" and nd == 1
                              and parent.startswith("norm")):
        return (None,) * nd
    if parent in ("kv_norm", "final_norm") or leaf == "pos":
        return (None,) * nd
    # embeddings
    if leaf == "tok":
        return (_fit(lshape[0], "model", mesh), _fit(lshape[1], "data", mesh))
    if leaf == "out" and nd == 2:
        return (_fit(lshape[0], "data", mesh), _fit(lshape[1], "model", mesh))
    # moe
    if leaf == "router":
        return (_fit(lshape[0], "data", mesh), _fit(lshape[1], "model", mesh))
    if leaf in MOE_PATTERN_LEAVES:
        return (None,) * nd
    if parent == "moe" or (nd in (3, 5) and leaf in ("wi", "wg", "wo")):
        if nd == 5:        # sparse experts [E, nob, kb, bs, bs]: EP only
            return (_fit(lshape[0], "model", mesh), None, None, None, None)
        if leaf in ("wi", "wg"):  # [E, D, F]
            return (_fit(lshape[0], "model", mesh),
                    _fit(lshape[1], "data", mesh), None)
        if leaf == "wo":          # [E, F, D]
            return (_fit(lshape[0], "model", mesh), None,
                    _fit(lshape[2], "data", mesh))
    # ssm extras
    if leaf == "conv_w":
        return (None, _fit(lshape[1], "model", mesh))
    if leaf in ("conv_b", "D", "dt_bias"):
        return (_fit(lshape[0], "model", mesh),)
    if leaf == "A_log":
        return (_fit(lshape[0], "model", mesh),) + (None,) * (nd - 1)
    # linear containers
    if len(path) >= 2:
        return _linear_spec(parent, leaf, lshape, mesh, head_aligned)
    return (None,) * nd


def param_specs(cfg: ArchConfig, params_tree: Any, mesh):
    """A spec tree mirroring ``params_tree`` (tensors of any device, the
    ``meta`` one included).  A path names dict keys only, so a layer's
    leaves read as the reference's stacked ones do."""
    sp_strategy = cfg.strategy == "sp"

    def rec(tree, path):
        if isinstance(tree, dict):
            return {k: rec(v, path + [k]) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(rec(v, path) for v in tree)
        spec = _leaf_spec(path, tuple(tree.shape), mesh, cfg)
        if sp_strategy:  # "model" carries the sequence dim: weights FSDP-only
            spec = tuple(None if s == "model" else s for s in spec)
        return P(*spec)

    return rec(params_tree, [])


def batch_specs(cfg: ArchConfig, batch_tree: Any, mesh):
    """Batch rows over the dp axes; under "sp" the sequence over
    "model"."""
    seq_ax = "model" if cfg.strategy == "sp" else None

    def leaf(t):
        nd = len(t.shape)
        if nd == 0:
            return P()
        spec = [_dp_fit(t.shape[0], mesh)] + [None] * (nd - 1)
        if nd >= 2 and seq_ax:
            spec[1] = _fit(t.shape[1], seq_ax, mesh)
        return P(*spec)
    return tree_map(leaf, batch_tree)


def cache_specs(cfg: ArchConfig, cache_tree: Any, mesh, rows: int = 1):
    """Cache leaves all carry >= 1 stack dims then [B, S|state...].

    Rule: first dim(s) = layer stacks -> None; batch -> dp; the sequence /
    d_inner dim -> "model" (seq-sharded KV cache / channel-sharded SSM
    state).  ``rows`` > 1: the tree holds one of ``rows`` row groups of
    the batch (a rank's rows), and the batch dims are placed as the whole
    batch's would be."""
    def dp(b):
        return _dp_fit(b * rows, mesh)

    def rec(tree, path):
        if isinstance(tree, dict):
            return {k: rec(v, path + [k]) for k, v in tree.items()}
        shape = tuple(tree.shape)
        leaf = path[-1]
        if leaf in ("k", "v", "ck", "cv"):          # [L,B,S,H,hd]
            b, s = shape[1], shape[2]
            return P(None, dp(b), _fit(s, "model", mesh), None, None)
        if leaf in ("latent", "k_rope"):            # [L,B,S,r]
            b, s = shape[1], shape[2]
            return P(None, dp(b), _fit(s, "model", mesh), None)
        if leaf == "conv":                          # [...,B,K-1,C]
            ns = len(shape) - 3
            return P(*([None] * ns), dp(shape[-3]), None,
                     _fit(shape[-1], "model", mesh))
        if leaf == "ssm":
            if len(shape) >= 4 and cfg.ssm_kind == "mamba1":  # [L,B,di,N]
                return P(None, dp(shape[1]), _fit(shape[2], "model", mesh),
                         None)
            # mamba2 [ns(,ev),B,H,hd,N]
            ns = len(shape) - 4
            return P(*([None] * ns), dp(shape[-4]),
                     _fit(shape[-3], "model", mesh), None, None)
        return P(*([None] * len(shape)))

    return rec(cache_tree, [])


def logits_spec(cfg: ArchConfig, batch: int, mesh):
    if cfg.strategy == "sp":  # [B, S, V], seq on model (decode: S=1 -> repl)
        return P(_dp_fit(batch, mesh), None, None)
    vocab_ax = "model" if cfg.vocab % axis_sizes(mesh)["model"] == 0 else None
    return P(_dp_fit(batch, mesh), None, vocab_ax)


def _placements(spec, ndim: int, mesh) -> tuple:
    """One placement a mesh dim: Shard(d) where the spec names that axis
    at tensor dim d (alone or in a tuple), else Replicate.  A leaf of
    lower rank than its spec (an optimizer state's 0-d placeholder) is
    replicated."""
    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, ax in enumerate(spec)
                if ax == name or (isinstance(ax, tuple) and name in ax)]
        out.append(Shard(dims[0]) if dims and len(spec) <= ndim
                   else Replicate())
    return tuple(out)


def _spec_map(fn, spec_tree):
    if isinstance(spec_tree, P):
        return fn(spec_tree)
    if isinstance(spec_tree, dict):
        return {k: _spec_map(fn, v) for k, v in spec_tree.items()}
    return type(spec_tree)(_spec_map(fn, v) for v in spec_tree)


def spec_items(spec_tree, prefix: str = ""):
    """(path, spec) pairs of a spec tree, paths as ``tree_items`` writes
    them (a spec is a tuple: a leaf here)."""
    if isinstance(spec_tree, P):
        yield prefix.rstrip("/"), spec_tree
    elif isinstance(spec_tree, dict):
        for k, v in spec_tree.items():
            yield from spec_items(v, f"{prefix}{k}/")
    else:
        for i, v in enumerate(spec_tree):
            yield from spec_items(v, f"{prefix}{i}/")


def to_shardings(spec_tree, mesh):
    """Each spec's DTensor placements on ``mesh`` (for a leaf of the
    spec's rank)."""
    return _spec_map(lambda s: _placements(s, len(s), mesh), spec_tree)


def _shard(t: torch.Tensor, mesh, placements) -> DTensor:
    """This rank's shard of the full tensor ``t`` (every rank holds the
    same ``t``), copied so that the full tensor can be freed."""
    local = t
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard):
            n, at = mesh.size(i), mesh.get_local_rank(i)
            local = local.chunk(n, dim=pl.dim)[at]
    return DTensor.from_local(local.clone(), mesh, placements,
                              run_check=False, shape=t.shape,
                              stride=t.stride())


def place(tree, spec_tree, mesh):
    """Full tensors -> DTensors placed by ``spec_tree`` (a spec at each
    tensor leaf): each rank keeps only its shard of each leaf.  Specs
    must divide their dims (the rules guarantee it)."""
    return tree_map(lambda t, spec: _shard(
        t.detach().contiguous(), mesh, _placements(spec, t.dim(), mesh))
        if torch.is_tensor(t) else t, tree, spec_tree)


def gather(tree):
    """DTensor leaves -> full tensors (an all-gather over each sharded
    mesh dim; every rank calls it, in the same order)."""
    return tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor)
                    else t, tree)


def place_as(t: torch.Tensor, like):
    """``t`` (full) placed as ``like`` is, when ``like`` is a DTensor."""
    if not isinstance(like, DTensor):
        return t
    return _shard(t.contiguous(), like.device_mesh, like.placements)


def place_like(tree, like_tree):
    """New full tensors placed as the matching leaves of ``like_tree``."""
    return tree_map(lambda t, like: place_as(t, like)
                    if torch.is_tensor(t) else t, tree, like_tree)


def state_specs(state, spec_tree):
    """The specs of an optimizer state whose leaves mirror the params: ()
    (plain SGD), or a dict whose values mirror the params (Adam's m / v
    and fp32 master, SGD's mom, a compressed optimizer's err) or nest such
    a state one level deeper ("base").  A leaf takes its param's spec, a
    0-d placeholder (the state of an integer pattern leaf) ``P()``."""
    if isinstance(state, tuple) and not state:
        return state
    return {k: state_specs(v, spec_tree) if k == "base"
            else tree_map(lambda t, s: P() if torch.is_tensor(t)
                          and t.dim() == 0 else s, v, spec_tree)
            for k, v in state.items()}


def place_state(state, spec_tree, mesh):
    """An optimizer state placed as its params (``state_specs``)."""
    return place(state, state_specs(state, spec_tree), mesh)


def spec_axes(entry) -> tuple:
    """The mesh axes one spec entry names, outer first."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def shard_shape(shape, spec, mesh) -> tuple:
    """The per-rank shape of a ``shape`` placed by ``spec``: each dim over
    the product of the mesh axes its entry names (a spec shorter than the
    shape leaves the trailing dims whole).  A dim that does not divide, or
    a spec longer than the shape, raises."""
    shape, sizes = tuple(shape), axis_sizes(mesh)
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than shape {shape}")
    out = []
    for d, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        n = 1
        for a in spec_axes(entry):
            n *= sizes[a]
        if d % n:
            raise ValueError(f"dim {d} of {shape} does not divide over "
                             f"{entry} ({n} ranks): spec {spec}")
        out.append(d // n)
    return tuple(out)


def attach(shape_tree, spec_tree, mesh):
    """Tensor tree + spec tree -> ``meta`` tensors of each leaf's per-rank
    shard shape (``shard_shape``), dtype kept; a non-tensor leaf passes
    through.  ``mesh`` is a ``DeviceMesh`` or a ``launch/mesh.AbstractMesh``.

    The reference attaches a ``NamedSharding`` to a global
    ``ShapeDtypeStruct`` and lets XLA partition the program.  PyTorch has
    no abstract sharded tensor (a ``DTensor`` needs a process group of the
    mesh's size), and the dry run counts one rank's ops, so this returns
    the shard itself: what one rank holds of each leaf at rest."""
    return tree_map(lambda t, s: torch.empty(
        shard_shape(t.shape, s, mesh), dtype=t.dtype, device="meta")
        if torch.is_tensor(t) else t, shape_tree, spec_tree)


def place_rows(tree, spec_tree, mesh, rows_axes: tuple):
    """Tensors that hold only this rank's rows (its share along the mesh
    axes ``rows_axes``, as ``train/steps.dp_split`` cuts a batch) ->
    DTensors placed by ``spec_tree``: each leaf is cut along the other
    mesh dims its spec shards, as ``place`` cuts a full tensor, and its
    global shape is its rows' times the ranks along ``rows_axes``."""
    def one(t, spec):
        pls = _placements(spec, t.dim(), mesh)
        shape, local = list(t.shape), t.detach().contiguous()
        for i, (name, pl) in enumerate(zip(mesh.mesh_dim_names, pls)):
            if not isinstance(pl, Shard):
                continue
            n = mesh.size(i)
            if name in rows_axes:
                shape[pl.dim] *= n
            else:
                local = local.chunk(n, dim=pl.dim)[mesh.get_local_rank(i)]
        stride = torch.empty(shape, device="meta").stride()
        return DTensor.from_local(local.clone(), mesh, pls, run_check=False,
                                  shape=torch.Size(shape), stride=stride)
    return tree_map(lambda t, s: one(t, s) if torch.is_tensor(t) else t,
                    tree, spec_tree)


def held_bytes(tree) -> tuple[int, int]:
    """(bytes this rank holds of ``tree``, bytes of the full tree)."""
    local = full = 0
    for t in tree_leaves(tree):
        if torch.is_tensor(t):
            loc = t.to_local() if isinstance(t, DTensor) else t
            local += loc.numel() * loc.element_size()
            full += t.numel() * t.element_size()
    return local, full


def junction_view(idx, rev_ob, rev_t, rev_cnt, n: int, at: int):
    """A block-sparse junction's pattern as rank ``at`` of ``n`` sees it
    when its output blocks are split over ``n`` ranks: (its rows of
    ``idx``, and reverse tables of its output blocks only: for each input
    block the (local output block, slot) pairs that read it, in the full
    tables' order, padded as the full ones are, with (0, 0) to their
    width, and their count; an input block no local output block reads
    has a count of 0).  On ``meta`` the shapes alone."""
    nob, kb = idx.shape
    nl = nob // n
    if idx.device.type == "meta":
        return (idx.new_empty((nl, kb)), rev_ob.new_empty(rev_ob.shape),
                rev_t.new_empty(rev_t.shape), rev_cnt.new_empty(
                    rev_cnt.shape))
    o0 = at * nl
    fb = rev_ob.shape[1]
    f = torch.arange(fb, device=idx.device)
    ob = rev_ob.long()
    keep = ((f[None, :] < rev_cnt[:, None].long()) & (ob >= o0)
            & (ob < o0 + nl))
    order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
    cnt = keep.sum(dim=1)
    valid = f[None, :] < cnt[:, None]
    new_ob = torch.where(valid, torch.gather(ob - o0, 1, order), 0)
    new_t = torch.where(valid, torch.gather(rev_t.long(), 1, order), 0)
    return (idx[o0:o0 + nl].contiguous(), new_ob.to(rev_ob.dtype),
            new_t.to(rev_t.dtype), cnt.to(rev_cnt.dtype))


def with_junction_views(tree, spec_tree, mesh, at: int, cache=None):
    """A tree of local shards with the pattern leaves of each junction
    whose output blocks are split over "model" replaced by rank ``at``'s
    ``junction_view``.  ``cache`` (a dict) keeps the views across calls,
    keyed by where the pattern's storage lies (it holds the pattern, so
    the key stays the pattern's)."""
    n = axis_sizes(mesh)["model"]

    def rec(t, s):
        if isinstance(t, dict):
            out = {k: rec(v, s[k]) for k, v in t.items()}
            if "idx" in t and "model" in spec_axes(s["w"][0]) and n > 1:
                key = (t["idx"].device, t["idx"].data_ptr())
                hit = cache.get(key) if cache is not None else None
                if hit is None:
                    hit = (t["idx"], junction_view(
                        *(t[k] for k in PATTERN_LEAVES), n, at))
                    if cache is not None:
                        cache[key] = hit
                out.update(zip(PATTERN_LEAVES, hit[1]))
            return out
        if isinstance(t, (list, tuple)):
            return type(t)(rec(v, x) for v, x in zip(t, s))
        return t
    return rec(tree, spec_tree)


def wrap_local(tree, spec_tree, mesh):
    """Tensors that hold this rank's shard of each leaf -> DTensors
    placed by ``spec_tree`` (each dim's global size is the shard's times
    the ranks of the axes its entry names)."""
    sizes = axis_sizes(mesh)

    def one(t, spec):
        shape = list(t.shape)
        if len(spec) <= t.dim():
            for d, e in enumerate(spec):
                for a in spec_axes(e):
                    shape[d] *= sizes[a]
        stride = torch.empty(shape, device="meta").stride()
        return DTensor.from_local(t, mesh, _placements(spec, t.dim(), mesh),
                                  run_check=False, shape=torch.Size(shape),
                                  stride=stride)
    return tree_map(lambda t, s: one(t, s) if torch.is_tensor(t) else t,
                    tree, spec_tree)


def wrap_like(tree, like_tree):
    """New local shards placed as the matching DTensor leaves of
    ``like_tree``; a leaf that is not floating point (a pattern leaf,
    never updated) is ``like``'s own.  A shard of ``like``'s dtype that
    needs no gradient takes ``like``'s placement record as it is: a step
    wraps every leaf of its params and optimizer state (777 of them for
    whisper-base), and ``DTensor.from_local`` builds a record and an
    autograd node for each."""
    def one(t, like):
        if not isinstance(like, DTensor):
            return t
        if not t.is_floating_point():
            return like
        if t.dtype == like.dtype and not t.requires_grad:
            return DTensor(t, like._spec, requires_grad=False)
        return DTensor.from_local(t, like.device_mesh, like.placements,
                                  run_check=False, shape=like.shape,
                                  stride=like.stride())
    return tree_map(lambda t, like: one(t, like) if torch.is_tensor(t)
                    else t, tree, like_tree)
