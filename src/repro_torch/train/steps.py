"""Train, eval and static serving step functions.

``make_prefill_step(cfg)`` and ``make_decode_step(cfg)`` are the static
engine's (serve/engine.Engine): a prompt batch's last logits, its
cache and its length, then one step-locked decode step.  ``make_train_step(cfg,
optimizer)`` returns
``train_step(params, opt_state, batch, step[, lr_scale]) ->
(params, opt_state, metrics)``, and ``make_mesh_train_step(cfg,
optimizer, mesh)`` that step on params and state placed on a device
mesh; the batch goes to ``M.loss_fn`` as the pipeline made it (a vlm's
patches with its tokens).  The two-pass step materialises the
gradients (junctions through the dx and dw kernels) and applies
``optimizer.update``; it leaves its input trees as they were.  The fused
BP+UP step injects the optimizer's slots and hyp row into the junction
dicts, so the junctions' backward updates their weights and slots in
place through the update_dw kernel, and ``optimizer.merge`` steps the
other leaves: the input params and opt_state are consumed (their junction
tensors now hold the updated values).

The mesh steps (``make_mesh_train_step``, ``make_mesh_prefill_step``,
``make_mesh_decode_step``) run one of two routes, chosen by the config
(``partitioned``), never by a flag.  The dense family (full attention),
the vlm (its sliding window), the moe family (full attention or MLA),
the ssm family and the hybrid on the "tp" strategy, and the audio family
on the "sp" strategy, take the partitioned route (parallel/partition.py):
each rank computes on its local shards as the specs divide the work (a
MoE's experts over "model", its routing global over the batch rows; a
Mamba mixer over the rank's channels or heads; under "sp" the sequence
over "model"), gathers a layer's
leaves over the dp axes only while the layer runs, reduce-scatters the
gradients back to its shards, updates its shards alone, and decodes on
its shard of the cache (the attention cache's sequence shard, a ring's
slots, the state's channels or heads, whisper's frames).  The fused
BP+UP step takes the partitioned route too: each fused junction updates
the rank's model shard of its weight and slots, gathered over the dp
axes only while it runs, over every row of the batch
(``partition.HeldJunction``; a MoE's experts, the rank's, over every row
group's capacity slots).  A config outside the route takes the gathered
one: every leaf gathered whole, the result placed again.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig
from repro_torch.core import sparse_linear as sl
from repro_torch.kernels import block_sparse_matmul as bsm
from repro_torch.kernels import ops
from repro_torch.models import model as M
from repro_torch.optim import FusedOptimizer, Optimizer, global_norm_scale
from repro_torch.optim.optimizers import sharded_norm
from repro_torch.parallel import partition
from repro_torch.parallel import sharding as sh
from repro_torch.tree import tree_leaves, tree_map


def fused_update_eligible(cfg: ArchConfig, optimizer: Optimizer,
                          microbatches: int = 1) -> tuple[bool, str]:
    """(ok, reason): whether the fused BP+UP path serves this step.  Every
    refusal keeps the two-pass path; none changes the numerics silently.
    Grad clipping runs fused through a norm pre-pass folded into the gs
    column; microbatches > 1 run fused as the full batch (the mean of
    equal-sized microbatch means is the full-batch mean)."""
    if not cfg.fused_update:
        return False, "ArchConfig.fused_update is off"
    if ops.resolve_engine(cfg.engine) != "pallas":
        return False, "engine is not pallas (jnp keeps the two-pass reference)"
    if not isinstance(optimizer, FusedOptimizer):
        return False, ("optimizer is not a FusedOptimizer "
                       "(optim.fused_sgd / optim.fused_adam)")
    if cfg.family == "hybrid":
        return False, ("hybrid shares one attn/MLP block across "
                       "super-layers — reused junction weights break the "
                       "updated-params contract")
    if cfg.cast_params_once:
        return False, "cast_params_once re-materializes the weights"
    if cfg.param_dtype != cfg.dtype:
        return False, ("fused update requires param_dtype == dtype (the "
                       "kernels update the compute-dtype weights in place)")
    return True, "fused"


def _is_trainable(t) -> bool:
    return torch.is_tensor(t) and t.is_floating_point()


def _alias(p, fused: bool, live: list):
    """``p`` with each trainable leaf replaced by a grad-requiring alias
    (appended to ``live``); with ``fused`` the leaves of a junction dict
    that the fused update owns (``sl.fused_owned``) stay as they are.
    Module-level, not a closure: a recursive closure is a reference cycle
    that would keep ``live``, and the old params, alive until the garbage
    collector runs."""
    if isinstance(p, dict):
        own = fused and sl.is_junction(p)
        return {k: v if own and sl.fused_owned(k) else _alias(v, fused, live)
                for k, v in p.items()}
    if isinstance(p, (list, tuple)):
        return type(p)(_alias(v, fused, live) for v in p)
    if _is_trainable(p):
        a = p.detach().requires_grad_(True)
        live.append(a)
        return a
    return p


def _regrad(p, fused: bool, got):
    """A tree shaped like ``p`` holding the gradients of ``got`` (in
    ``_alias``'s order) at trainable leaves, None elsewhere."""
    if isinstance(p, dict):
        own = fused and sl.is_junction(p)
        return {k: None if own and sl.fused_owned(k)
                else _regrad(v, fused, got) for k, v in p.items()}
    if isinstance(p, (list, tuple)):
        return type(p)(_regrad(v, fused, got) for v in p)
    return next(got) if _is_trainable(p) else None


def _value_and_grad(cfg: ArchConfig, tree, batch, *, fused: bool = False,
                    seed=None):
    """(loss, metrics, grads) of ``M.loss_fn`` at ``tree``.  grads mirrors
    ``tree`` with None at non-trainable leaves; with ``fused`` the
    junction dicts are left out of the differentiation (their backward
    updates them in place instead).  ``seed``: the loss's gradient, a
    float (1 by default)."""
    live: list = []
    params = _alias(tree, fused, live)
    if cfg.cast_params_once:
        params = tree_map(lambda p: p.to(torch.bfloat16)
                          if _is_trainable(p) and p.dtype == torch.float32
                          else p, params)
    with torch.enable_grad():
        loss, metrics = M.loss_fn(cfg, params, batch)
        got = torch.autograd.grad(
            loss, live, allow_unused=True, grad_outputs=None if seed is None
            else torch.full_like(loss, seed))
    grads = _regrad(tree, fused, iter([torch.zeros_like(a) if g is None else g
                                       for a, g in zip(live, got)]))
    metrics = {k: (v.detach() if torch.is_tensor(v) else v)
               for k, v in metrics.items()}
    return loss.detach(), metrics, grads


def _health_leaves(t, found: list):
    if isinstance(t, dict):
        for k, v in t.items():
            if k in sl.HEALTH_LEAVES and torch.is_tensor(v):
                found.append(v.float().sum())
            elif isinstance(v, (dict, list, tuple)):
                _health_leaves(v, found)
    elif isinstance(t, (list, tuple)):
        for v in t:
            _health_leaves(v, found)


def collect_junction_health(aug) -> torch.Tensor:
    """Sum of the health leaves of a fused step's injected tree: the
    update kernels' count of (e, o) tiles that went non-finite (a 0-dim
    float32 tensor on the params' device; reading it waits for the card)."""
    found: list = []
    _health_leaves(aug, found)
    return torch.stack(found).sum() if found else torch.zeros(())


def count_nonfinite_grads(grads) -> torch.Tensor:
    """Two-pass detector: the number of gradient leaves holding any
    non-finite value (> 0: this update would poison the parameters)."""
    flags = [(~torch.isfinite(g)).any() for g in tree_leaves(grads)
             if _is_trainable(g)]
    return torch.stack(flags).sum().float() if flags else torch.zeros(())


def scale_params_delta(params, new_params, lr_scale):
    """p' = p + s * (p_new - p), in fp32: the exact lr backoff of a
    first-order update already applied (the optimizer state is lr-free)."""
    def blend(p0, p1):
        if not _is_trainable(p1):
            return p1
        d = p1.float() - p0.float()
        return (p0.float() + lr_scale * d).to(p1.dtype)
    return tree_map(blend, params, new_params)


def _split(batch, microbatches):
    return [{k: v[i * (len(v) // microbatches):(i + 1) * (len(v)
                                                       // microbatches)]
             for k, v in batch.items()} for i in range(microbatches)]


def _make_fused_train_step(cfg: ArchConfig, optimizer: FusedOptimizer):
    """The fused BP+UP step.  ``lr_scale`` multiplies the hyp row's lr
    column; ``grad_clip`` runs a plain backward first (the norm pre-pass,
    through dx and dw) and folds its clip scale into the gs column and
    into merge.  metrics["nonfinite"] sums the junctions' health counts."""
    def train_step(params, opt_state, batch, step, lr_scale=None):
        dev = params["embed"]["tok"].device
        hyp = optimizer.hyp(step).to(dev)
        grad_scale = None
        if optimizer.grad_clip is not None:
            _, _, raw = _value_and_grad(cfg, params, batch)
            grad_scale, _ = global_norm_scale(raw, optimizer.grad_clip)
            del raw
            hyp[bsm.COL_GS] *= grad_scale
        if lr_scale is not None:
            hyp[bsm.COL_LR] *= float(lr_scale)
        aug = sl.inject_update_ctx(params, optimizer.slots(opt_state), hyp)
        loss, metrics, grads = _value_and_grad(cfg, aug, batch, fused=True)
        new_params, new_opt = optimizer.merge(grads, opt_state, params, step,
                                              lr_scale=lr_scale,
                                              grad_scale=grad_scale)
        metrics = dict(metrics, loss=loss,
                       nonfinite=collect_junction_health(aug))
        return new_params, new_opt, metrics

    return train_step


def make_train_step(cfg: ArchConfig, optimizer: Optimizer,
                    microbatches: int = 1):
    """train_step(params, opt_state, batch, step[, lr_scale]) ->
    (params, opt_state, metrics): fused when ``fused_update_eligible``,
    else two-pass.  ``lr_scale`` (the guardian's backoff) scales this
    step's learning rate: folded into the hyp row on the fused path, the
    applied delta rescaled on the two-pass path.  With microbatches > 1
    the two-pass path splits the batch and averages fp32 gradients; the
    fused path runs the full batch."""
    fused, _ = fused_update_eligible(cfg, optimizer, microbatches)
    if fused:
        return _make_fused_train_step(cfg, optimizer)
    return _make_two_pass_step(cfg, optimizer, microbatches)


def _batch_grads(cfg: ArchConfig, params, batch, microbatches: int,
                 seed=None):
    """(loss, metrics, grads) of the batch: one backward, or the fp32 mean
    of ``microbatches`` equal splits."""
    if microbatches == 1:
        return _value_and_grad(cfg, params, batch, seed=seed)
    loss, grads = 0.0, None
    for mb in _split(batch, microbatches):
        l, metrics, g = _value_and_grad(cfg, params, mb, seed=seed)
        g = tree_map(lambda t: t.float() if t is not None else None, g)
        grads = g if grads is None else tree_map(
            lambda a, b: a + b if a is not None else None, grads, g)
        loss = loss + l
    grads = tree_map(lambda t: t / microbatches if t is not None else None,
                     grads)
    return loss / microbatches, metrics, grads


def _make_two_pass_step(cfg: ArchConfig, optimizer: Optimizer,
                        microbatches: int, reduce=None):
    """The two-pass step; ``reduce(loss, metrics, grads)``, when given,
    combines the gradients of several ranks' rows before the update."""
    def train_step(params, opt_state, batch, step, lr_scale=None):
        loss, metrics, grads = _batch_grads(cfg, params, batch, microbatches)
        if reduce is not None:
            loss, metrics, grads = reduce(loss, metrics, grads)
        new_params, new_opt = optimizer.update(grads, opt_state, params, step)
        if lr_scale is not None:
            new_params = scale_params_delta(params, new_params, lr_scale)
        metrics = dict(metrics, loss=loss,
                       nonfinite=count_nonfinite_grads(grads))
        return new_params, new_opt, metrics

    return train_step


def dp_split(cfg: ArchConfig, batch, mesh) -> tuple[tuple, int]:
    """(the dp axes ``sharding.batch_specs`` cuts ``batch``'s rows over,
    the number of row groups they make): ((), 1) where the rows do not
    divide them.  Reads axis sizes only: an ``AbstractMesh`` will do."""
    axes = sh.spec_axes(sh.batch_specs(cfg, batch, mesh)["tokens"][0])
    sizes = sh.axis_sizes(mesh)
    return axes, math.prod(sizes[a] for a in axes)


def _row_block(cfg: ArchConfig, batch, mesh) -> tuple[tuple, int, int]:
    """(dp axes, this rank's row group, the number of groups)."""
    axes, n = dp_split(cfg, batch, mesh)
    at = 0
    for a in axes:
        at = at * mesh.size(mesh.mesh_dim_names.index(a)) + \
            mesh.get_local_rank(a)
    return axes, at, n


def _rows(t, dim: int, at: int, n: int):
    """Row group ``at`` of ``n`` along ``dim`` of a tensor or an array (a
    view)."""
    b = t.shape[dim] // n
    return t[(slice(None),) * dim + (slice(at * b, (at + 1) * b),)]


def rows_of(tree, spec_tree, axes: tuple, at: int, n: int):
    """Row group ``at`` of ``n`` of each leaf (views): along the dim whose
    spec entry is ``axes``; a leaf that no dim of its spec cuts over them
    is kept whole."""
    def one(t, spec):
        dims = [d for d, e in enumerate(spec) if sh.spec_axes(e) == axes]
        return _rows(t, dims[0], at, n) if axes and dims else t
    return tree_map(one, tree, spec_tree)


def _dp_rows(cfg: ArchConfig, batch, mesh, microbatches: int = 1):
    """(this rank's rows of ``batch``, the dp process groups that share
    the batch): the rows ``sharding.batch_specs`` gives this rank along
    the dp axes, or the whole batch and no group where its rows do not
    divide them or one rank holds the dp axes.  With ``microbatches`` >
    1 the rank's rows of each microbatch (the batch's equal splits), in
    order: split again, they are its share of each microbatch, as a MoE
    routes over the microbatch's rows."""
    axes, at, n = _row_block(cfg, batch, mesh)
    if n == 1:
        return batch, []
    groups = [mesh.get_group(a) for a in axes]
    if microbatches == 1:
        return {k: _rows(v, 0, at, n) for k, v in batch.items()}, groups
    return ({k: torch.cat([_rows(c, 0, at, n) for c in
                           torch.as_tensor(v).chunk(microbatches)])
             for k, v in batch.items()}, groups)


def _dp_mean(groups, t):
    """The fp32 mean of ``t`` over the ranks of ``groups``."""
    t, n = t.float(), 1
    for g in groups:
        dist.all_reduce(t, group=g)
        n *= dist.get_world_size(g)
    return t / n


def _dp_reduce(mean, loss, metrics, grads):
    return (mean(loss),
            {k: mean(v) if torch.is_tensor(v) else v
             for k, v in metrics.items()},
            tree_map(lambda t: mean(t) if t is not None else None, grads))


def make_dp_train_step(cfg: ArchConfig, optimizer: Optimizer, mean,
                       microbatches: int = 1):
    """The two-pass step of one data-parallel rank: ``mean(t)`` averages
    the fp32 loss, each tensor metric and each gradient over the ranks
    that share the batch before the update (on a mesh an all-reduce a dp
    group, ``_dp_mean``; ``launch/dryrun.py`` reckons the same calls
    without a process group)."""
    return _make_two_pass_step(cfg, optimizer, microbatches,
                               functools.partial(_dp_reduce, mean))


# (strategy, family, attention) of the configs the partitioned route
# runs, two-pass and fused alike (the hybrid is never fused)
_PARTITIONED = (("tp", "dense", "full"), ("tp", "vlm", "sliding"),
                ("tp", "moe", "full"), ("tp", "moe", "mla"),
                ("tp", "ssm", "none"), ("tp", "hybrid", "full"),
                ("sp", "audio", "full"))


def partitioned(cfg: ArchConfig, optimizer: Optimizer | None = None,
                microbatches: int = 1) -> bool:
    """Whether the mesh steps run ``cfg`` on the partitioned route: the
    dense family with full attention, the vlm with its sliding window,
    the moe family with full attention or MLA, the ssm family and the
    hybrid (its shared block full attention) on the "tp" strategy, the
    audio family on the "sp" strategy, with any optimizer: a fused BP+UP
    step (``fused_update_eligible``) as well as the two-pass one.
    Everything else is gathered."""
    return (cfg.strategy, cfg.family, cfg.attn_kind) in _PARTITIONED


def make_partitioned_train_step(cfg: ArchConfig, optimizer: Optimizer,
                                part: partition.Partition,
                                microbatches: int = 1):
    """The step of one rank of a partitioned mesh, on local trees:
    train_step(params, opt_state, rows, step[, lr_scale]) with the
    rank's shards of the params (its junction views in place,
    ``sharding.with_junction_views``) and of the optimizer state, and its
    rows of the batch -> (new shards, new state shards, metrics); the
    fused BP+UP step (``_make_partitioned_fused_step``) where
    ``fused_update_eligible`` says so, else the two-pass step.  The
    two-pass loss runs under ``part`` (the model's partitioned route),
    its gradient seeded with 1 / model (partition.py's convention); each
    leaf's gradient arrives summed and averaged over the dp axes; the
    loss and metrics are averaged over the row axes; the optimizer
    updates the shards, its clip norm taken over every rank
    (``Partition.sq_sum``), and ``nonfinite`` counts the leaves whose
    gradient is not finite on some rank.  ``launch/dryrun.py`` runs it on
    ``meta`` shards with a ``ReckonedComm``."""
    if fused_update_eligible(cfg, optimizer, microbatches)[0]:
        return _make_partitioned_fused_step(cfg, optimizer, part)
    seed = None if part.m == 1 else 1.0 / part.m

    def train_step(params, opt_state, rows, step, lr_scale=None):
        with partition.use(part):
            loss, metrics, grads = _batch_grads(cfg, params, rows,
                                                microbatches, seed)
        loss = part.dp_mean(loss)
        metrics = {k: part.dp_mean(v) if torch.is_tensor(v) else v
                   for k, v in metrics.items()}
        with sharded_norm(part.sq_sum):
            new_params, new_opt = optimizer.update(grads, opt_state, params,
                                                   step)
        if lr_scale is not None:
            new_params = scale_params_delta(params, new_params, lr_scale)
        flags = [(~torch.isfinite(g)).any() for g in tree_leaves(grads)
                 if _is_trainable(g)]
        nonfinite = part.any_over_ranks(torch.stack(flags).float()).sum()
        metrics = dict(metrics, loss=loss, nonfinite=nonfinite)
        return new_params, new_opt, metrics

    return train_step


def _make_partitioned_fused_step(cfg: ArchConfig, optimizer: FusedOptimizer,
                                 part: partition.Partition):
    """``_make_fused_train_step`` on one rank of a partitioned mesh: the
    context injected from the rank's local slot shards, the loss run
    under ``part`` and seeded with 1 / model, as the two-pass step runs
    it.  Each junction's backward updates the rank's model shard of its
    weight and slots, gathered over the dp axes, over every row of the
    batch (``partition.HeldJunction``); the hyp row's gs column carries
    1 / the row groups, since each rank's loss is a mean over its own
    rows (``merge``'s ``grad_scale`` does not: the FSDP adjoint already
    averages the other leaves' gradients over the dp axes).
    A MoE's experts update the rank's experts over every row group's
    capacity slots, whisper's junctions over the rows of every rank of
    the row axes and, where the unit's rows split over it, "model".
    ``grad_clip``'s norm pre-pass is a two-pass partitioned backward
    whose norm is taken over every rank (``Partition.sq_sum``), its scale
    folded into the gs column and into merge as on one rank.  The whole
    batch runs at once, whatever the microbatches (as one rank's fused
    step runs it).  ``nonfinite`` is the one-rank count of non-finite
    update tiles (``_fused_nonfinite``)."""
    if not partitioned(cfg):
        raise ValueError(f"{cfg.name}: the partitioned route does not run "
                         f"{(cfg.strategy, cfg.family, cfg.attn_kind)} "
                         "(its mesh step is gathered)")
    seed = None if part.m == 1 else 1.0 / part.m

    def train_step(params, opt_state, rows, step, lr_scale=None):
        dev = params["embed"]["tok"].device
        hyp = optimizer.hyp(step).to(dev)
        grad_scale = None
        if optimizer.grad_clip is not None:
            with partition.use(part):
                _, _, raw = _value_and_grad(cfg, params, rows, seed=seed)
            with sharded_norm(part.sq_sum):
                grad_scale, _ = global_norm_scale(raw, optimizer.grad_clip)
            del raw
            hyp[bsm.COL_GS] *= grad_scale
        if lr_scale is not None:
            hyp[bsm.COL_LR] *= float(lr_scale)
        if part.n_rows > 1:
            hyp[bsm.COL_GS] /= part.n_rows
        aug = sl.inject_update_ctx(params, optimizer.slots(opt_state), hyp)
        with partition.use(part):
            loss, metrics, grads = _value_and_grad(cfg, aug, rows,
                                                   fused=True, seed=seed)
        new_params, new_opt = optimizer.merge(grads, opt_state, params, step,
                                              lr_scale=lr_scale,
                                              grad_scale=grad_scale)
        loss = part.dp_mean(loss)
        metrics = {k: part.dp_mean(v) if torch.is_tensor(v) else v
                   for k, v in metrics.items()}
        metrics = dict(metrics, loss=loss,
                       nonfinite=_fused_nonfinite(part, aug))
        return new_params, new_opt, metrics

    return train_step


def _fused_nonfinite(part: partition.Partition, aug) -> torch.Tensor:
    """The partitioned fused step's count of non-finite update tiles, the
    one-rank step's: the counts of a "col" junction (the rank's output
    blocks) and of experts split over "model" (the rank's experts) summed
    over "model", those of a "rep" junction and of replicated experts
    (every model rank updated the whole weight alike) taken once, as are
    whisper's on "sp", nothing summed over the dp axes (their ranks make
    the same update)."""
    found = {"col": [], "rep": []}

    def walk(t, spec):
        if isinstance(t, dict):
            if sl.UPDATE_HEALTH_LEAF in t:
                found[partition.tp_kind(spec["w"])].append(
                    t[sl.UPDATE_HEALTH_LEAF].float().sum())
            if sl.MOE_HEALTH_LEAVES[0] in t:
                split = "model" in sh.spec_axes(spec["wg"][0])
                found["col" if split else "rep"] += [
                    t[k].float().sum() for k in sl.MOE_HEALTH_LEAVES]
            for k, v in t.items():
                if isinstance(v, (dict, list, tuple)):
                    walk(v, spec[k])
        elif isinstance(t, (list, tuple)):
            for v, s in zip(t, spec):
                walk(v, s)

    walk(aug, part.specs)
    col, rep = (torch.stack(v).sum() if v else None
                for v in (found["col"], found["rep"]))
    if col is not None:
        col = part.comm.all_reduce(col, ("model",))
    got = [v for v in (col, rep) if v is not None]
    return sum(got[1:], got[0]) if got else torch.zeros(())


def mesh_partition(cfg: ArchConfig, mesh, params,
                   batch=None) -> partition.Partition:
    """The ``Partition`` of this rank of ``mesh`` for ``params`` (placed
    DTensors): the specs, ``MeshComm`` on the mesh, and the axes the
    rows of ``batch`` split over."""
    row_axes = ()
    if batch is not None:
        axes, n = dp_split(cfg, batch, mesh)
        row_axes = axes if n > 1 else ()
    return partition.Partition(cfg, partition.MeshComm(mesh),
                               sh.param_specs(cfg, params, mesh), row_axes)


def make_mesh_train_step(cfg: ArchConfig, optimizer: Optimizer, mesh,
                         microbatches: int = 1):
    """``make_train_step``'s step on params and optimizer state placed on
    ``mesh`` (DTensor trees, ``sharding.place``): each rank holds only its
    shard of every leaf at rest, and the step returns them placed as
    they came.  Where ``partitioned`` says so the step runs
    ``make_partitioned_train_step`` on the rank's shards (its junction
    views built on the first call and kept) and its rows of the batch
    (a fused step's rows of the whole batch, whatever the
    microbatches); else ``make_gathered_mesh_train_step``."""
    if not partitioned(cfg, optimizer, microbatches):
        return make_gathered_mesh_train_step(cfg, optimizer, mesh,
                                             microbatches)
    fused, _ = fused_update_eligible(cfg, optimizer, microbatches)
    views: dict = {}

    def train_step(params, opt_state, batch, step, lr_scale=None):
        part = mesh_partition(cfg, mesh, params, batch)
        local = sh.with_junction_views(partition.local_tree(params),
                                       part.specs, mesh, part.r, views)
        rows, _ = _dp_rows(cfg, batch, mesh, 1 if fused else microbatches)
        run = make_partitioned_train_step(cfg, optimizer, part, microbatches)
        new_p, new_s, metrics = run(local, partition.local_tree(opt_state),
                                    rows, step, lr_scale)
        return (sh.wrap_like(new_p, params), sh.wrap_like(new_s, opt_state),
                metrics)

    return train_step


def make_gathered_mesh_train_step(cfg: ArchConfig, optimizer: Optimizer,
                                  mesh, microbatches: int = 1):
    """The gathered route of ``make_mesh_train_step`` (any config
    ``partitioned`` refuses): a step gathers the full
    tensors, runs the update and keeps this rank's shard of the new
    params and state (placed as the inputs were).  The two-pass path
    gives each data-parallel rank its rows of the batch
    (``sharding.batch_specs``) and averages the fp32 gradients (and the
    loss) over the dp axes before the update, as microbatches are
    averaged.  The fused path updates inside the backward
    kernels, where no all-reduce can come between gradient and update,
    so every rank runs the whole batch.  With one rank on the dp axes
    nothing is split or summed."""
    fused, _ = fused_update_eligible(cfg, optimizer, microbatches)
    whole = make_train_step(cfg, optimizer, microbatches)

    def train_step(params, opt_state, batch, step, lr_scale=None):
        full_p, full_s = sh.gather(params), sh.gather(opt_state)
        rows, groups = (batch, []) if fused else _dp_rows(cfg, batch, mesh)
        run = whole if not groups else make_dp_train_step(
            cfg, optimizer, functools.partial(_dp_mean, groups),
            microbatches)
        new_p, new_s, metrics = run(full_p, full_s, rows, step, lr_scale)
        return (sh.place_like(new_p, params), sh.place_like(new_s, opt_state),
                metrics)

    return train_step


def partitioned_prefill(cfg: ArchConfig, part, params, rows):
    """``make_prefill_step`` on a rank's local shards under ``part``:
    (the rank's logits [B, 1, V / model], its cache shard, P + S)."""
    with partition.use(part):
        return make_prefill_step(cfg)(params, rows)


def partitioned_decode(cfg: ArchConfig, part, params, cache, token,
                       pos: int):
    """``make_decode_step`` on a rank's local shards and its shard of the
    cache (updated in place) under ``part``."""
    with partition.use(part):
        return make_decode_step(cfg)(params, cache, token, pos)


def make_mesh_prefill_step(cfg: ArchConfig, mesh):
    """``make_prefill_step``'s step on params placed on ``mesh``:
    prefill(params, batch) -> (logits placed by ``sharding.logits_spec``,
    the cache placed by ``sharding.cache_specs``, P + S), on this rank's
    rows of the batch (those ``batch_specs`` gives it along the dp axes,
    or the whole batch where they do not divide).  Partitioned
    (``partitioned``): the rank prefills on its shards and keeps its
    shard of the logits and cache; gathered: the params are gathered and
    the rows' logits and cache placed (``sharding.place_rows``)."""
    prefill = make_prefill_step(cfg)
    views: dict = {}

    def step(params, batch):
        axes, at, n = _row_block(cfg, batch, mesh)
        rows = {k: _rows(v, 0, at, n) for k, v in batch.items()}
        B = batch["tokens"].shape[0]
        lspec = sh.logits_spec(cfg, B, mesh)
        if partitioned(cfg):
            part = mesh_partition(cfg, mesh, params, batch)
            local = sh.with_junction_views(partition.local_tree(params),
                                           part.specs, mesh, part.r, views)
            logits, cache, npos = partitioned_prefill(cfg, part, local, rows)
            like = M.make_cache(cfg, rows["tokens"].shape[0], npos, "meta")
            return (sh.wrap_local(logits, lspec, mesh),
                    sh.wrap_local(cache, sh.cache_specs(cfg, like, mesh,
                                                        rows=n), mesh), npos)
        logits, cache, npos = prefill(sh.gather(params), rows)
        cspecs = sh.cache_specs(cfg, cache, mesh, rows=n)
        return (sh.place_rows(logits, lspec, mesh, axes),
                sh.place_rows(cache, cspecs, mesh, axes), npos)

    return step


def cache_seq_split(cspecs) -> bool:
    """Whether ``sharding.cache_specs`` split the cache's sequence over
    "model" (read at its first K or MLA latent leaf: every attention
    layer's cache has the same length)."""
    for path, spec in sh.spec_items(cspecs):
        if path.rsplit("/", 1)[-1] in ("k", "latent"):
            return "model" in sh.spec_axes(spec[2])
    return False


def make_mesh_decode_step(cfg: ArchConfig, mesh):
    """``make_decode_step``'s step on params and a cache placed on
    ``mesh`` (the cache by ``sharding.cache_specs``): decode(params,
    cache, token [B,1], pos) -> (logits placed by ``logits_spec``, the
    new cache placed as the old), on this rank's rows (its row group of
    the token and of each cache leaf along the dim its spec cuts over
    the dp axes).  Partitioned (``partitioned``): the rank decodes on its
    shards and its shard of the cache, updated in place and never
    gathered; gathered: the params and the cache are gathered, and the
    rows' results placed (``sharding.place_rows``)."""
    decode = make_decode_step(cfg)
    views: dict = {}

    def step(params, cache, token, pos):
        axes, at, n = _row_block(cfg, {"tokens": token}, mesh)
        cspecs = sh.cache_specs(cfg, cache, mesh)
        lspec = sh.logits_spec(cfg, token.shape[0], mesh)
        if partitioned(cfg):
            part = mesh_partition(cfg, mesh, params, {"tokens": token})
            part.cache_seq_split = cache_seq_split(cspecs)
            local = sh.with_junction_views(partition.local_tree(params),
                                           part.specs, mesh, part.r, views)
            logits, _ = partitioned_decode(cfg, part, local,
                                           partition.local_tree(cache),
                                           _rows(token, 0, at, n), pos)
            return sh.wrap_local(logits, lspec, mesh), cache
        rows_c = rows_of(sh.gather(cache), cspecs, axes, at, n)
        logits, new = decode(sh.gather(params), rows_c,
                             _rows(token, 0, at, n), pos)
        return (sh.place_rows(logits, lspec, mesh, axes),
                sh.place_rows(new, cspecs, mesh, axes))

    return step


def make_eval_step(cfg: ArchConfig):
    def evaluate(params, batch):
        with torch.no_grad():
            loss, metrics = M.loss_fn(cfg, params, batch)
        return dict(metrics, loss=loss)
    return evaluate


def make_prefill_step(cfg: ArchConfig):
    """prefill(params, batch) -> (logits [B,1,V] at the last position,
    the cache in ``M.make_cache``'s structure over the prefill's
    positions, their count P + S).  ``batch`` holds "tokens" [B, S] and,
    for the vlm, "patches" [B, P, d], prefilled ahead of the tokens: the
    model alone decides what comes ahead of them.  The audio family's
    "frames" [B, F, d] feed the encoder and sit ahead of nothing (P = 0):
    its positions count from the text."""
    def prefill(params, batch):
        with torch.no_grad():
            logits, cache, (_, off) = M.forward(cfg, params, batch,
                                                return_cache=True,
                                                last_only=True)
        return logits, cache, off + batch["tokens"].shape[1]
    return prefill


def make_decode_step(cfg: ArchConfig):
    """The static decode step: decode(params, cache, token [B,1], pos) ->
    (logits [B,1,V], cache), every row at the host int ``pos`` and the
    cache updated in place."""
    def decode(params, cache, token, pos):
        with torch.no_grad():
            return M.decode_step(cfg, params, cache, token, pos)
    return decode
