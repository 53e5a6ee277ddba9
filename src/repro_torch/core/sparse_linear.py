"""Pre-defined-sparse linear layer: the paper's junction on tensors.

A sparse junction's params are a dict with the weight tiles
``w [nob, kb, bs, bs]`` and the static pattern leaves ``idx``,
``rev_ob``, ``rev_t``, ``rev_cnt`` (int32); a dense layer's params hold
``w [n_in, n_out]``.  Either may carry a bias ``b [n_out]``.

Fused BP+UP context: a fused train step (train/steps.py) hands the model a
copy of the params in which every junction dict also carries
``UPDATE_HYP_LEAF`` (the optimizer's hyp row), its optimizer slots under
the ``FUSED_SLOT_NAMES`` leaf names (slot 0: SGD momentum or Adam m,
slot 1: Adam v; the tensors of the optimizer state themselves) and a
``UPDATE_HEALTH_LEAF`` of zeros.  ``apply`` routes such a dict through
``ops.junction_train_update``, whose backward updates w, b and the slots
in place and writes the non-finite tile counts into the health leaf.
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

UPDATE_HYP_LEAF = "upd_hyp"
FUSED_MOM = {"w": "mom_w", "b": "mom_b",
             "wi": "mom_wi", "wg": "mom_wg", "wo": "mom_wo"}
FUSED_VEL = {"w": "vel_w", "b": "vel_b",
             "wi": "vel_wi", "wg": "vel_wg", "wo": "vel_wo"}
FUSED_SLOT_NAMES = (FUSED_MOM, FUSED_VEL)
UPDATE_HEALTH_LEAF = "upd_health"
HEALTH_LEAVES = (UPDATE_HEALTH_LEAF,)


def is_junction(p) -> bool:
    """A pattern-bearing parameter dict (a sparse junction)."""
    return isinstance(p, dict) and "idx" in p


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
            out[UPDATE_HYP_LEAF] = hyp
            out[UPDATE_HEALTH_LEAF] = torch.zeros(
                (1,), dtype=torch.float32, device=p["w"].device)
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
    ``slots`` (anything ``normalize_slots`` accepts) and a float32 zeros
    health leaf of shape (1,).  Dense leaves ride through untouched."""
    slots = normalize_slots(slots)
    if len(slots) > len(FUSED_SLOT_NAMES):
        raise ValueError(f"{len(slots)} accumulator slots, but the kernel "
                         f"contract defines {len(FUSED_SLOT_NAMES)}")
    return _inject(params, slots, hyp)


def is_sparse(params: Params) -> bool:
    return "idx" in params


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
    fused BP+UP junction when the dict carries the update context), a
    dense product with the same activation formula otherwise."""
    if is_sparse(params):
        pattern = [params[k] for k in PATTERN_LEAVES]
        if UPDATE_HYP_LEAF in params:
            return ops.junction_train_update(
                x, params["w"], *pattern, hyp=params[UPDATE_HYP_LEAF],
                bias=params.get("b"), act=act, mom=params.get("mom_w"),
                mom_b=params.get("mom_b"), vel=params.get("vel_w"),
                vel_b=params.get("vel_b"),
                health=params.get(UPDATE_HEALTH_LEAF))
        return ops.junction_matmul(x, params["w"], *pattern,
                                   bias=params.get("b"), act=act)
    y = apply_dense(params, x)
    return y if act == "none" else bsm.act_fwd(y, act).to(y.dtype)
