"""Pre-defined-sparse linear layer: the paper's junction on tensors.

A sparse junction's params are a dict with the weight tiles
``w [nob, kb, bs, bs]`` and the static pattern leaves ``idx``,
``rev_ob``, ``rev_t``, ``rev_cnt`` (int32); a dense layer's params hold
``w [n_in, n_out]``.  Either may carry a bias ``b [n_out]``.  A MoE
expert-FFN dict (models/moe.py) is a junction pair too: per-expert
``wg``, ``wi`` [E, ...] over one pattern and ``wo`` over another, with
the pattern leaves under ``MOE_PATTERN_LEAVES`` and a dense ``router``.

Fused BP+UP context: a fused train step (train/steps.py) hands the model a
copy of the params in which every junction dict also carries
``UPDATE_HYP_LEAF`` (the optimizer's hyp row), its optimizer slots under
the ``FUSED_SLOT_NAMES`` leaf names (slot 0: SGD momentum or Adam m,
slot 1: Adam v; the tensors of the optimizer state themselves) and a
``UPDATE_HEALTH_LEAF`` of zeros (a MoE dict: one per junction,
``MOE_HEALTH_LEAVES``, of shape (E,)).  ``apply`` routes such a dict
through ``ops.junction_train_update``, whose backward updates w, b and
the slots in place and writes the non-finite tile counts into the
health leaf.  Every other leaf of a junction dict (a MoE router) takes
its gradient through autograd.

A quantized junction (core/quantize.py) carries integer codes ``wq`` (a
MoE dict ``wgq`` / ``wiq`` / ``woq``) with their scales in place of the
fp weights; ``apply`` runs it through the quantized kernels, and both
``apply`` and ``inject_update_ctx`` refuse it inside a fused train step:
the quantized datapath is inference only.

``apply_tp`` runs a linear on a rank's slice in the partitioned mesh
steps (parallel/partition.py): column-parallel (a dense weight's out
dim, or a junction's output blocks, split over "model": the kernels run
unchanged on the rank's blocks, through its own pattern rows and reverse
tables), row-parallel (a dense weight's in dim split: partial sums), or
replicated.  A fused junction there carries its holder under ``"_held"``
(``partition.HeldJunction``: the rank's shards, gathered where the
kernels read them), which ``apply`` hands to the fused update (a MoE
dict its gate's and wo's under ``"_held_in"`` / ``"_held_out"``, which
``models/moe._expert_ffn`` hands on).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.sparsity import SparsityConfig, make_block_pattern
from repro_torch.kernels import block_sparse_matmul as bsm
from repro_torch.kernels import ops

Params = dict[str, Any]
PATTERN_LEAVES = ("idx", "rev_ob", "rev_t", "rev_cnt")
MOE_PATTERN_LEAVES = ("idx_in", "idx_out",
                      "rev_in_ob", "rev_in_t", "rev_in_cnt",
                      "rev_out_ob", "rev_out_t", "rev_out_cnt")

UPDATE_HYP_LEAF = "upd_hyp"
FUSED_MOM = {"w": "mom_w", "b": "mom_b",
             "wi": "mom_wi", "wg": "mom_wg", "wo": "mom_wo"}
FUSED_VEL = {"w": "vel_w", "b": "vel_b",
             "wi": "vel_wi", "wg": "vel_wg", "wo": "vel_wo"}
FUSED_SLOT_NAMES = (FUSED_MOM, FUSED_VEL)
UPDATE_HEALTH_LEAF = "upd_health"
MOE_HEALTH_LEAVES = ("upd_health_in", "upd_health_out")
HEALTH_LEAVES = (UPDATE_HEALTH_LEAF,) + MOE_HEALTH_LEAVES
_CONTEXT_LEAVES = frozenset((UPDATE_HYP_LEAF, *HEALTH_LEAVES,
                             *FUSED_MOM.values(), *FUSED_VEL.values()))


def is_junction(p) -> bool:
    """A pattern-bearing parameter dict: a single sparse junction ("idx")
    or a MoE expert-FFN pair sharing patterns ("idx_in")."""
    return isinstance(p, dict) and ("idx" in p or "idx_in" in p)


def fused_owned(key: str) -> bool:
    """Whether leaf ``key`` of a junction dict belongs to the fused update
    in a fused step (a weight the kernels update in place, or injected
    context) rather than to autograd."""
    return key in FUSED_MOM or key in _CONTEXT_LEAVES


def normalize_slots(slots) -> tuple:
    """None -> () (plain SGD), one params-mirroring tree -> a 1-tuple
    (momentum), a tuple of trees -> itself (Adam's (m, v)).  Params trees
    are dicts or lists at top level, never tuples."""
    if slots is None:
        return ()
    if isinstance(slots, tuple):
        return slots
    return (slots,)


def _inject(p, ms, hyp):
    if isinstance(p, dict):
        out = {k: (_inject(v, tuple(m[k] for m in ms), hyp)
                   if isinstance(v, (dict, list, tuple)) else v)
               for k, v in p.items()}
        if is_junction(p):
            if is_quantized(p):
                raise ValueError(
                    "fused-update context injected into a quantized "
                    "junction: the int8/fxp datapath is inference only; "
                    "reload full-precision weights to train")
            moe = "idx_in" in p
            wl = p["wg"] if moe else p["w"]
            zeros = torch.zeros((wl.shape[0] if wl.dim() == 5 else 1,),
                                dtype=torch.float32, device=wl.device)
            out[UPDATE_HYP_LEAF] = hyp
            for hk in MOE_HEALTH_LEAVES if moe else (UPDATE_HEALTH_LEAF,):
                out[hk] = zeros.clone()
            for m, names in zip(ms, FUSED_SLOT_NAMES):
                for k, mk in names.items():
                    if k in p and not isinstance(p[k], dict):
                        out[mk] = m[k]
        return out
    if isinstance(p, (list, tuple)):
        return type(p)(_inject(v, tuple(m[i] for m in ms), hyp)
                       for i, v in enumerate(p))
    return p


def inject_update_ctx(params, slots, hyp):
    """Copy of ``params`` (the containers are new, the tensors shared)
    with the fused-update context added to every junction dict: the hyp
    row, the junction's slot tensors taken from the mirrored trees in
    ``slots`` (anything ``normalize_slots`` accepts) and float32 zeros
    health leaves, of shape (E,) for E junction units (the experts of a
    MoE dict; (1,) for a single junction).  Dense leaves ride through
    untouched."""
    slots = normalize_slots(slots)
    if len(slots) > len(FUSED_SLOT_NAMES):
        raise ValueError(f"{len(slots)} accumulator slots, but the kernel "
                         f"contract defines {len(FUSED_SLOT_NAMES)}")
    return _inject(params, slots, hyp)


def is_sparse(params: Params) -> bool:
    return "idx" in params


def is_quantized(params) -> bool:
    """A junction whose fp weight leaves were replaced by integer codes
    (core/quantize.py): inference only."""
    return isinstance(params, dict) and ("wq" in params or "wgq" in params)


def init_dense(gen: torch.Generator, n_in: int, n_out: int, *,
               bias: bool = False, dtype=torch.float32, device="cpu",
               scale: float | None = None) -> Params:
    scale = float(scale if scale is not None else 1.0 / np.sqrt(n_in))
    p: Params = {"w": torch.randn((n_in, n_out), generator=gen, dtype=dtype,
                                  device=device) * scale}
    if bias:
        p["b"] = torch.zeros((n_out,), dtype=dtype, device=device)
    return p


def init_sparse(gen: torch.Generator, n_in: int, n_out: int,
                sp: SparsityConfig, *, bias: bool = False,
                dtype=torch.float32, device="cpu", seed: int = 0) -> Params:
    """Glorot-normal init over the kept edges: variance 2/(d_in + d_out)
    over the actual degrees, not the dense widths."""
    pat = make_block_pattern(n_in, n_out, sp.density, sp.block, seed=seed)
    d_in = pat.fan_in_blocks * pat.block
    d_out = pat.fan_out_blocks * pat.block
    scale = float(np.sqrt(2.0 / (d_in + d_out)))
    shape = (pat.n_out_blocks, pat.fan_in_blocks, pat.block, pat.block)
    p: Params = {"w": torch.randn(shape, generator=gen, dtype=dtype,
                                  device=device) * scale}
    for name in PATTERN_LEAVES:
        p[name] = torch.as_tensor(getattr(pat, name), dtype=torch.int32,
                                  device=device)
    if bias:
        p["b"] = torch.zeros((n_out,), dtype=dtype, device=device)
    return p


def init_linear(gen: torch.Generator, n_in: int, n_out: int, *, family: str,
                sp: SparsityConfig | None, bias: bool = False,
                dtype=torch.float32, device="cpu", seed: int = 0) -> Params:
    """Dense unless the paper's technique applies and the dims tile."""
    if (sp is not None and sp.applies_to(family)
            and n_in % sp.block == 0 and n_out % sp.block == 0
            and n_in // sp.block >= 2):
        return init_sparse(gen, n_in, n_out, sp, bias=bias, dtype=dtype,
                           device=device, seed=seed)
    return init_dense(gen, n_in, n_out, bias=bias, dtype=dtype, device=device)


def apply_dense(params: Params, x: torch.Tensor) -> torch.Tensor:
    y = x @ params["w"].to(x.dtype)
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y


def apply(params: Params, x: torch.Tensor, *, act: str = "none"
          ) -> torch.Tensor:
    """y = act(x @ W + b): the junction kernels for a sparse layer (the
    fused BP+UP junction when the dict carries the update context, the
    quantized kernels for integer codes), a dense product with the same
    activation formula otherwise."""
    if is_sparse(params):
        pattern = [params[k] for k in PATTERN_LEAVES]
        if is_quantized(params):
            if UPDATE_HYP_LEAF in params:
                raise ValueError("quantized junction inside a fused train "
                                 "step: the int8/fxp datapath is inference "
                                 "only")
            return ops.junction_matmul(
                x, params["wq"], *pattern, bias=params.get("b"), act=act,
                w_scale=params.get("w_scale"), x_scale=params.get("x_scale"),
                qfmt=params.get("qfmt"), qlut=params.get("qlut"))
        if UPDATE_HYP_LEAF in params:
            return ops.junction_train_update(
                x, params["w"], *pattern, hyp=params[UPDATE_HYP_LEAF],
                bias=params.get("b"), act=act, mom=params.get("mom_w"),
                mom_b=params.get("mom_b"), vel=params.get("vel_w"),
                vel_b=params.get("vel_b"),
                health=params.get(UPDATE_HEALTH_LEAF),
                held=params.get("_held"))
        return ops.junction_matmul(x, params["w"], *pattern,
                                   bias=params.get("b"), act=act)
    y = apply_dense(params, x)
    return y if act == "none" else bsm.act_fwd(y, act).to(y.dtype)


def apply_tp(params: Params, x: torch.Tensor, layout: str, part, *,
             act: str = "none") -> tuple[torch.Tensor, str]:
    """``apply`` on a rank's slice, for a linear container that
    ``Partition.gather`` tagged with its kind ``"_tp"``: x in ``layout``
    ("full" or "split" features) -> (y, its layout).
    "col" and "rep" take every input feature (a split x is gathered) and
    give the rank's output features ("split") or all of them ("full"),
    the activation applied; "row" takes the rank's input features (a
    full x is cut) and gives partial sums ("partial", no bias: the caller
    adds it after the sum, ``add_row_bias``; no activation), in fp32 over
    more than one model rank (the weight rounded to x's dtype first, so
    the products are the one-rank product's; the sum rounds once
    summed)."""
    kind = params["_tp"]
    if kind == "row":
        if act != "none":
            raise ValueError("a row-parallel product's activation comes "
                             "after its sum")
        x = part.split(x, layout)
        w = params["w"].to(x.dtype)
        if part.m > 1:
            return x.float() @ w.float(), "partial"
        return x @ w, "partial"
    x = part.full(x, layout)
    q = {k: v for k, v in params.items() if k != "b"}
    if "b" in params:
        b = params["b"]
        if kind == "col" and not params["_b_split"]:
            b = part.split(b, "full")
        elif kind == "rep" and params["_b_split"]:
            b = part.full(b, "split")
        q["b"] = b
    return apply(q, x, act=act), ("split" if kind == "col" else "full")


def add_row_bias(params: Params, y: torch.Tensor) -> torch.Tensor:
    """A row-parallel product's bias, added once its partial sums are
    summed (a full bias; no-op without one)."""
    if params["_tp"] != "row" or "b" not in params:
        return y
    return y + params["b"].to(y.dtype)
