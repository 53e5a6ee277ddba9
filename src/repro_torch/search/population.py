"""Populations of candidate MLPs on the junction kernels' E axis.

A population is E candidate networks that share one structure (layer
widths, block size, pattern seed, fan-in per junction, activation,
optimizer kind), stacked member by member into the kernels' unit
dimension: junction weights [E, nob, kb, bs, bs], biases [E, n_out], and
one set of pattern leaves for all members.  One launch a junction then
serves every member; the fused update reads each member's own row of the
[E, HYP_K] hyp table (kernels/block_sparse_matmul.HYP_COLS), so the
members train under different hyperparameters in the same step.

Members never interact (the loss is a masked sum of per-member losses
and every trainable leaf leads with E), so training a population equals
training E single models.  A batch is shared: x [M, n_in] is broadcast
to [E, M, n_in].  A zero mask entry together with a zero hyp row freezes
a member with no change of shapes.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.core import sparse_linear as sl
from repro_torch.core.sparsity import SparsityConfig, block_fan_in
from repro_torch.device import resolve_device
from repro_torch.kernels import block_sparse_matmul as bsm

TRAINABLE = ("w", "b")


@dataclasses.dataclass(frozen=True)
class CandidateSpec:
    """One candidate network and its training hyperparameters.

    (layers, block, seed, act, opt and the fan-ins the density gives)
    are the structure that members of one population share; lr,
    momentum, b2, eps, weight_decay and init_seed vary within it.
    ``momentum`` is the hyp row's slot-0 decay: SGD momentum, or Adam's
    b1 when ``opt="adam"``.
    """
    lr: float
    momentum: float = 0.0      # slot-0 decay: SGD momentum / Adam b1
    density: float = 0.25
    layers: tuple[int, ...] = (1024, 512, 128)   # widths incl. in/out
    block: int = 128
    act: str = "sigmoid"       # every junction's activation (paper Sec. III)
    seed: int = 0              # pattern seed (structure, not init)
    init_seed: int = 0         # weight-init stream for this member
    opt: str = "sgd"           # "sgd" | "adam" (structural: slot layout)
    b2: float = 0.95           # Adam only
    eps: float = 1e-8          # Adam only
    weight_decay: float = 0.0  # Adam only

    def fan_in_blocks(self) -> tuple[int, ...]:
        """kb per junction at this density."""
        return tuple(block_fan_in(n_in // self.block, self.density)
                     for n_in, _ in zip(self.layers[:-1], self.layers[1:]))

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["layers"] = list(self.layers)
        return d


def structure_key(spec: CandidateSpec) -> tuple:
    """What shapes the stacked arrays, the shared patterns and the slot
    layout: candidates with equal keys can share a population."""
    return (spec.layers, spec.block, spec.seed, spec.act, spec.opt,
            spec.fan_in_blocks())


def _init_member(spec: CandidateSpec, seed: int, device):
    """One candidate's single-model params: a list of 4-D junction dicts
    with a bias, patterns fixed by the spec, weights from ``seed``."""
    sp = SparsityConfig(density=spec.density, block=spec.block, where="all")
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)
    layers = []
    for n_in, n_out in zip(spec.layers[:-1], spec.layers[1:]):
        p = sl.init_sparse(gen, n_in, n_out, sp, bias=True, seed=spec.seed)
        layers.append({k: v.to(device) for k, v in p.items()})
    return layers


def init_population(seed: int, specs: Sequence[CandidateSpec],
                    device=None):
    """E candidates stacked into population params: a list of junction
    dicts with E-leading ``w`` and ``b`` and shared pattern leaves, on
    ``device`` (the card unless the caller names another).
    Member e is initialized from (seed, its init_seed) as its standalone
    single model would be; ``member_slice`` gives that model back."""
    if not specs:
        raise ValueError("empty population")
    key0 = structure_key(specs[0])
    for s in specs[1:]:
        if structure_key(s) != key0:
            raise ValueError(
                f"population members must share structure: {structure_key(s)}"
                f" != {key0}; bucket with search/cohorts.py first")
    device = resolve_device(device)
    members = [_init_member(s, seed * 1_000_003 + s.init_seed, device)
               for s in specs]
    pop = []
    for li in range(len(members[0])):
        layer = {k: members[0][li][k] for k in sl.PATTERN_LEAVES}
        for k in TRAINABLE:
            layer[k] = torch.stack([m[li][k] for m in members])
        pop.append(layer)
    return pop


def member_slice(params, e: int):
    """Member e's single-model params (4-D junction dicts)."""
    return [{k: (v[e] if k in TRAINABLE else v) for k, v in layer.items()}
            for layer in params]


def population_size(params) -> int:
    p0 = params[0]
    return (p0["w"] if "w" in p0 else p0["wq"]).shape[0]


def hyp_table(specs: Sequence[CandidateSpec], device=None) -> torch.Tensor:
    """The per-member [E, HYP_K] table the update kernels read row e of,
    on ``device`` (the card unless the caller names another).
    Adam members get t = 1 as a placeholder; the caller stamps the step
    into COL_T before each step."""
    rows = []
    for s in specs:
        row = [0.0] * bsm.HYP_K
        row[bsm.COL_LR] = s.lr
        row[bsm.COL_B1] = s.momentum
        row[bsm.COL_GS] = 1.0
        if s.opt == "adam":
            row[bsm.COL_B2] = s.b2
            row[bsm.COL_EPS] = s.eps
            row[bsm.COL_WD] = s.weight_decay
            row[bsm.COL_T] = 1.0
        rows.append(row)
    return torch.tensor(rows, dtype=torch.float32,
                        device=resolve_device(device))


def _zeros_like_slots(params):
    return [{k: torch.zeros(layer[k].shape, dtype=torch.float32,
                            device=layer[k].device) for k in TRAINABLE}
            for layer in params]


def init_slots(params, specs: Sequence[CandidateSpec] | None = None):
    """The fp32 slot trees in the kernels' order: () for plain SGD,
    (mom,) with momentum, (mom, vel) for Adam.  The optimizer kind must
    be one for the whole population."""
    if specs is not None:
        kinds = {s.opt for s in specs}
        if len(kinds) > 1:
            raise ValueError(
                f"population mixes optimizer kinds {sorted(kinds)}: the slot "
                "layout is static; bucket with search/cohorts.py first")
        if kinds == {"adam"}:
            return (_zeros_like_slots(params), _zeros_like_slots(params))
        if not any(s.momentum for s in specs):
            return ()
    return (_zeros_like_slots(params),)


def init_momentum(params, specs: Sequence[CandidateSpec] | None = None):
    """The slot-0 tree of ``init_slots``, or None where it has none (the
    reference's form from before Adam; new code uses ``init_slots``)."""
    slots = init_slots(params, specs)
    return slots[0] if slots else None


# ------------------------------------------------------------------ forward
def population_forward(params, x, *, act: str):
    """y [E, M, n_out] for a shared input x [M, n_in] (or [E, M, n_in])
    through every junction of the stacked population: the junction
    kernels (the fused update when the dicts carry its context, the
    quantized kernels for quantized layers)."""
    E = population_size(params)
    if x.dim() == 2:
        x = x[None].expand(E, *x.shape)
    for layer in params:
        x = sl.apply(layer, x, act=act)
    return x


def member_losses(y, targets):
    """Per-member mean-squared error [E] against the shared one-hot
    targets [M, n_out] (the paper's output-MSE objective)."""
    t = targets[None].to(y.dtype)
    return torch.mean(torch.square(y - t), dim=(1, 2))


# --------------------------------------------------------------- train step
def _row(hyp, col, p):
    return hyp[:, col].reshape((-1,) + (1,) * (p.dim() - 1))


def _two_pass_update(params, slots, hyp):
    """Per-member optimizer step in place over the E-leading leaves from
    their ``.grad``: each column from the member's hyp row, SGD
    (+momentum) for 0 / 1 slots, Adam for 2, with the kernels' t / den
    guards, so a zeroed row freezes a member exactly here too."""
    is_adam = len(slots) == 2
    with torch.no_grad():
        for li, layer in enumerate(params):
            for k in TRAINABLE:
                p = layer[k]
                gf = _row(hyp, bsm.COL_GS, p) * p.grad.float()
                lr = _row(hyp, bsm.COL_LR, p)
                p32 = p.float()
                if is_adam:
                    m, v = slots[0][li][k], slots[1][li][k]
                    b1, b2 = _row(hyp, bsm.COL_B1, p), _row(hyp, bsm.COL_B2, p)
                    eps, wd = _row(hyp, bsm.COL_EPS, p), _row(hyp, bsm.COL_WD,
                                                              p)
                    t = _row(hyp, bsm.COL_T, p)
                    m.copy_(b1 * m + (1.0 - b1) * gf)
                    v.copy_(b2 * v + (1.0 - b2) * torch.square(gf))
                    c1 = 1.0 - torch.pow(b1, t)
                    c2 = 1.0 - torch.pow(b2, t)
                    c1 = torch.where(c1 == 0.0, 1.0, c1)
                    c2 = torch.where(c2 == 0.0, 1.0, c2)
                    den = torch.sqrt(v / c2) + eps
                    step = torch.where(den == 0.0, 0.0, (m / c1) / den) \
                        + wd * p32
                    p.copy_((p32 - lr * step).to(p.dtype))
                elif slots:
                    m = slots[0][li][k]
                    m.copy_(_row(hyp, bsm.COL_B1, p) * m + gf)
                    p.copy_((p32 - lr * m).to(p.dtype))
                else:
                    p.copy_((p32 - lr * gf).to(p.dtype))
                p.grad = None


def _member_health_fused(aug) -> torch.Tensor:
    """[E] non-finite update tile counts of each member, summed over the
    layers: the health leaves the update kernels wrote in the backward
    (the reference reads the same counts from their cotangents)."""
    return sum(layer[sl.UPDATE_HEALTH_LEAF] for layer in aug)


def _member_health_grads(params) -> torch.Tensor:
    """[E] two-pass twin: one count for each ``w`` / ``b`` gradient leaf
    of a member that holds a non-finite value."""
    return sum((~torch.isfinite(layer[k].grad.reshape(
        layer[k].shape[0], -1))).any(dim=1).float()
        for layer in params for k in TRAINABLE)


def _repack_slots(new_slots: tuple, like):
    """The slots in the caller's form: None in, None out; one tree in,
    one tree out; a tuple in, a tuple out."""
    if like is None:
        return None
    if isinstance(like, tuple):
        return new_slots
    return new_slots[0]


def make_population_step(act: str = "sigmoid", *, fused: bool = True,
                         with_health: bool = False):
    """step(params, slots, hyp, mask, x, t) -> (params, slots, losses[E]),
    or (params, slots, losses, health[E]) with ``with_health``.

    One call trains every member on the shared batch (x [M, n_in], t
    [M, n_out] one-hot) with the objective sum(mask * member_losses).
    ``fused``: each junction's backward runs ``update_dw``, which applies
    the member's update in place from its hyp row (the weight gradient
    never reaches device memory).  Otherwise the two-pass path: autograd
    gradients through the dx and dw kernels, then the same formula
    applied here.  ``slots`` follows ``init_slots`` (None or () for plain
    SGD, one tree for momentum, (mom, vel) for Adam) and comes back in
    the same form.  Params and slots are updated in place (the reference
    donates them): a caller that steps the same params twice clones them
    first.

    ``health[e] > 0``: member e's update just went non-finite.  Fused:
    the update kernels' non-finite tile counts, summed over the layers;
    two-pass: one count for each gradient leaf of the member holding a
    non-finite value.  Members are independent, so a bad member flags
    only its own slot."""
    def step(params, mom, hyp, mask, x, t):
        slots = sl.normalize_slots(mom)
        E = population_size(params)
        hyp = bsm.normalize_hyp(hyp, E).to(x.device)
        if fused:
            aug = sl.inject_update_ctx(params, slots, hyp)
            # the update runs in the junctions' backward, which runs only
            # for an input that takes part in autograd
            xin = x[None].expand(E, *x.shape).contiguous().requires_grad_()
            y = population_forward(aug, xin, act=act)
        else:
            for layer in params:
                for k in TRAINABLE:
                    layer[k].requires_grad_(True)
            y = population_forward(params, x, act=act)
        losses = member_losses(y, t)
        torch.sum(losses * mask).backward()
        health = None
        if fused:
            if with_health:
                health = _member_health_fused(aug)
        else:
            for layer in params:
                for k in TRAINABLE:
                    layer[k].requires_grad_(False)
            if with_health:
                health = _member_health_grads(params)
            _two_pass_update(params, slots, hyp)
        out = (params, _repack_slots(slots, mom), losses.detach())
        return out + (health,) if with_health else out

    return step


def make_population_eval(act: str = "sigmoid"):
    """eval(params, x, t) -> per-member losses [E] (no update)."""
    def evaluate(params, x, t):
        with torch.no_grad():
            return member_losses(population_forward(params, x, act=act), t)

    return evaluate
