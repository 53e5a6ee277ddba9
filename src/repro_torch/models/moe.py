"""Mixture-of-Experts with GShard-style capacity dispatch.

Tokens are processed in groups of ``group_size``; the dispatch and
combine tensors are [G, g, E, C] (groups, tokens a group, experts,
capacity a expert), so every expert sees a fixed [G*C, d] block of rows.
A token's choices take capacity in k-major order (every token's first
choice before any second choice); a choice past capacity is dropped and
the token rides the residual for it.

When the paper's pre-defined sparsity applies to the expert FFNs, one
block pattern is shared by all experts (per-expert weights
[E, nob, kb, bs, bs]) and the expert FFN runs through the junction
kernels (``_expert_ffn``): the gate silu(x @ wg) * (x @ wi) as one gated
junction, wo as a plain one, both with E = num_experts units.  Engine
"jnp" keeps the plain gather-and-einsum loop (``_expert_apply``).
Quantized experts (int8 codes ``wgq`` / ``wiq`` / ``woq``, see
core/quantize.py) run the gate through ``gated_fwd_int8`` and wo through
``fwd_int8`` (engine "jnp": ``quantize.expert_apply_int8``); they are
inference only.

Aux load-balance loss, Switch / GShard style: E * sum_e f_e * p_e times
``aux_loss_weight``.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import quantize as qz
from repro_torch.core import sparse_linear as sl
from repro_torch.core.sparsity import make_block_pattern
from repro_torch.kernels import ops
from repro_torch.kernels.block_sparse_matmul import act_fwd
from repro_torch.models.layers import mlp_apply, mlp_init

Params = dict[str, Any]


def moe_dispatch_dims(mo, T: int) -> tuple[int, int, int]:
    """(g, G, C) for T tokens: dispatch group size, group count, and the
    per-expert capacity (rounded up to a multiple of 4, at least 4)."""
    g = min(mo.group_size, T)
    G = T // g
    C = int(np.ceil(g * mo.top_k * mo.capacity_factor / mo.num_experts))
    C = max(4, -(-C // 4) * 4)
    return g, G, C


def _expert_sparse_ok(cfg: ArchConfig) -> bool:
    sp = cfg.sparsity
    return (sp is not None and sp.applies_to("ffn")
            and cfg.d_model % sp.block == 0
            and cfg.moe.d_expert % sp.block == 0
            and cfg.d_model // sp.block >= 2
            and cfg.moe.d_expert // sp.block >= 2)


def moe_init(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32,
             device="cpu", seed: int = 0) -> Params:
    """Router, expert FFNs (block-sparse over one shared pattern when the
    technique applies, dense otherwise) and the shared experts."""
    mo, d = cfg.moe, cfg.d_model
    E, F = mo.num_experts, mo.d_expert

    def randn(shape, scale):
        return torch.randn(shape, generator=gen, dtype=dtype,
                           device=device) * scale

    p: Params = {"router": randn((d, E), float(1.0 / np.sqrt(d)))}
    if _expert_sparse_ok(cfg):
        sp = cfg.sparsity
        pats = {"in": make_block_pattern(d, F, sp.density, sp.block,
                                         seed=sp.seed),
                "out": make_block_pattern(F, d, sp.density, sp.block,
                                          seed=sp.seed + 1)}
        shape, scale = {}, {}
        for name, pat in pats.items():
            shape[name] = (E, pat.n_out_blocks, pat.fan_in_blocks, sp.block,
                           sp.block)
            scale[name] = float(np.sqrt(2.0 / ((pat.fan_in_blocks
                                                + pat.fan_out_blocks)
                                               * sp.block)))
        p.update(wi=randn(shape["in"], scale["in"]),
                 wg=randn(shape["in"], scale["in"]),
                 wo=randn(shape["out"], scale["out"]))
        for name, pat in pats.items():
            p[f"idx_{name}"] = torch.as_tensor(pat.idx, device=device)
        for name, pat in pats.items():
            for leaf in ("ob", "t", "cnt"):
                p[f"rev_{name}_{leaf}"] = torch.as_tensor(
                    getattr(pat, f"rev_{leaf}"), device=device)
    else:
        p.update(wi=randn((E, d, F), float(1.0 / np.sqrt(d))),
                 wg=randn((E, d, F), float(1.0 / np.sqrt(d))),
                 wo=randn((E, F, d), float(1.0 / np.sqrt(F))))
    if mo.num_shared:
        # d_shared is the combined hidden width of the always-on experts
        p["shared"] = mlp_init(gen, cfg, dtype, device, seed=seed + 7,
                               d_ff=mo.d_shared)
    return p


def _expert_apply(w, idx, x):
    """Plain block-sparse expert product (engine "jnp"):
    x [G, E, C, din] -> [G, E, C, dout] in x's dtype, summed over the
    fan-in slots."""
    E, nob, kb, bs, _ = w.shape
    G, _, C, din = x.shape
    xb = x.reshape(G, E, C, din // bs, bs)
    wc = w.to(x.dtype)
    y = None
    for k in range(kb):
        xk = xb[:, :, :, idx[:, k].long()]                  # [G,E,C,nob,bs]
        part = torch.einsum("GECob,Eobc->GECoc", xk, wc[:, :, k])
        y = part if y is None else y + part
    return y.reshape(G, E, C, nob * bs)


def _expert_ffn(p: Params, xd, E: int):
    """The expert FFNs through the junction kernels: xd [G, E, C, d] ->
    [G, E, C, d].  When the fused-update context rides in the dict (a
    fused train step), both junctions run through
    ``ops.junction_train_update`` and their backward updates wg, wi and wo
    in place."""
    G, _, C, D = xd.shape
    xe = xd.movedim(1, 0).reshape(E, G * C, D)
    pin = [p[k] for k in sl.MOE_PATTERN_LEAVES if "_in" in k]
    pout = [p[k] for k in sl.MOE_PATTERN_LEAVES if "_out" in k]
    if "wgq" in p:      # quantized experts: inference only
        if sl.UPDATE_HYP_LEAF in p:
            raise ValueError("quantized expert FFN inside a fused train "
                             "step: the int8 datapath is inference only")
        h = ops.junction_matmul(
            xe, p["wgq"], *pin, wi=p["wiq"], w_scale=p["wg_scale"],
            wi_scale=p["wi_scale"], x_scale=p.get("x_scale_in"))
        ye = ops.junction_matmul(h, p["woq"], *pout, w_scale=p["wo_scale"],
                                 x_scale=p.get("x_scale_out"))
    elif sl.UPDATE_HYP_LEAF in p:
        hyp = p[sl.UPDATE_HYP_LEAF]
        h = ops.junction_train_update(
            xe, p["wg"], *pin, wi=p["wi"], hyp=hyp, mom=p.get("mom_wg"),
            mom_wi=p.get("mom_wi"), vel=p.get("vel_wg"),
            vel_wi=p.get("vel_wi"), health=p.get("upd_health_in"))
        ye = ops.junction_train_update(
            h, p["wo"], *pout, hyp=hyp, mom=p.get("mom_wo"),
            vel=p.get("vel_wo"), health=p.get("upd_health_out"))
    else:
        h = ops.junction_matmul(xe, p["wg"], *pin, wi=p["wi"])
        ye = ops.junction_matmul(h, p["wo"], *pout)
    return ye.reshape(E, G, C, D).movedim(0, 1)


def _top_k(probs, k: int):
    """The k largest along the last axis, ties to the lower index (the
    order of ``jax.lax.top_k``): a stable descending sort."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _one_hot(i, n: int):
    """fp32 one-hot; an index outside [0, n) gives a row of zeros."""
    return (i[..., None] == torch.arange(n, device=i.device)).float()


def moe_apply(p: Params, x, cfg: ArchConfig):
    """x [B, S, D] -> (y [B, S, D], aux loss).  The sparse experts run
    through the junction kernels unless ``cfg.engine`` is "jnp"."""
    mo = cfg.moe
    B, S, D = x.shape
    E, K = mo.num_experts, mo.top_k
    T = B * S
    g, G, C = moe_dispatch_dims(mo, T)
    if T % g:
        raise ValueError(f"tokens {T} not divisible by moe group {g}")

    xt = x.reshape(G, g, D)
    logits = torch.einsum("Ggd,de->Gge", xt, p["router"].to(x.dtype))
    probs = torch.softmax(logits.float(), dim=-1)                 # [G,g,E]
    top_p, top_e = _top_k(probs, K)                               # [G,g,K]
    top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)        # renorm

    # position in expert: cumsum over tokens, k-major (slot, then token)
    mask = _one_hot(top_e, E)                                     # [G,g,K,E]
    mask_flat = mask.transpose(1, 2).reshape(G, K * g, E)
    pos = torch.cumsum(mask_flat, dim=1) - 1.0                    # [G,Kg,E]
    keep = (pos < C) * mask_flat
    pos = pos.reshape(G, K, g, E).transpose(1, 2)                 # [G,g,K,E]
    keep = keep.reshape(G, K, g, E).transpose(1, 2)

    # aux load-balance loss (fraction routed vs mean probability)
    routed = mask[..., 0, :] if K == 1 else torch.sum(mask, dim=2)
    f_e = torch.mean(routed, dim=(0, 1)) / K
    p_e = torch.mean(probs, dim=(0, 1))
    aux = E * torch.sum(f_e * p_e) * mo.aux_loss_weight

    kept = keep[..., None] * _one_hot(pos.long(), C)              # [G,g,K,E,C]
    dispatch = torch.sum(kept, dim=2)                             # [G,g,E,C]
    combine = torch.einsum("GgK,GgKEC->GgEC", top_p, kept)

    xd = torch.einsum("GgEC,Ggd->GECd", dispatch.to(x.dtype), xt)
    if "idx_in" in p:   # pre-defined-sparse experts (the paper's technique)
        if ops.resolve_engine(cfg.engine) == "pallas":
            ye = _expert_ffn(p, xd, E)
        elif "wgq" in p:    # quantized experts, the plain int8 forms
            xs_in, xs_out = p.get("x_scale_in"), p.get("x_scale_out")
            gq = qz.expert_apply_int8(p["wgq"], p["wg_scale"], p["idx_in"],
                                      xd, xs_in)
            uq = qz.expert_apply_int8(p["wiq"], p["wi_scale"], p["idx_in"],
                                      xd, xs_in)
            h = (act_fwd(gq, "silu") * uq).to(x.dtype)
            ye = qz.expert_apply_int8(p["woq"], p["wo_scale"], p["idx_out"],
                                      h, xs_out).to(x.dtype)
        else:
            h = (act_fwd(_expert_apply(p["wg"], p["idx_in"], xd), "silu")
                 * _expert_apply(p["wi"], p["idx_in"], xd))
            ye = _expert_apply(p["wo"], p["idx_out"], h)
    else:
        h = (act_fwd(torch.einsum("GECd,Edf->GECf", xd,
                                  p["wg"].to(x.dtype)), "silu")
             * torch.einsum("GECd,Edf->GECf", xd, p["wi"].to(x.dtype)))
        ye = torch.einsum("GECf,Efd->GECd", h, p["wo"].to(x.dtype))
    y = torch.einsum("GgEC,GECd->Ggd", combine.to(x.dtype), ye)
    y = y.reshape(B, S, D)

    if "shared" in p:
        y = y + mlp_apply(p["shared"], x, cfg)
    return y, aux
