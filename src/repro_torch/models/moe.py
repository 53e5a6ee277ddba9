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

``moe_apply_tp`` is the routed experts on a rank of the partitioned mesh
steps (parallel/partition.py): the rank's experts, routing global over
the batch rows of every rank (see its docstring).
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
from repro_torch.parallel import partition

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


def _expert_ffn(p: Params, xd, E: int, window=None):
    """The expert FFNs through the junction kernels: xd [G, E, C, d] ->
    [G, E, C, d].  When the fused-update context rides in the dict (a
    fused train step), both junctions run through
    ``ops.junction_train_update`` and their backward updates wg, wi and wo
    in place; on the partitioned route through the holders
    ``Partition.gather`` put in the dict (``"_held_in"``, ``"_held_out"``),
    told the rank's ``window`` of dispatch groups where it runs on one
    (``moe_apply_tp``)."""
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
        held = [p.get(k) for k in ("_held_in", "_held_out")]
        if window is not None and held[0] is not None:
            held = [h.windowed(*window) for h in held]
        h = ops.junction_train_update(
            xe, p["wg"], *pin, wi=p["wi"], hyp=hyp, mom=p.get("mom_wg"),
            mom_wi=p.get("mom_wi"), vel=p.get("vel_wg"),
            vel_wi=p.get("vel_wi"), health=p.get("upd_health_in"),
            held=held[0])
        ye = ops.junction_train_update(
            h, p["wo"], *pout, hyp=hyp, mom=p.get("mom_wo"),
            vel=p.get("vel_wo"), health=p.get("upd_health_out"),
            held=held[1])
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


def _route(logits, K: int):
    """(probs fp32 [..., E], the renormalized top-k: top_p, top_e)."""
    probs = torch.softmax(logits.float(), dim=-1)
    top_p, top_e = _top_k(probs, K)
    return probs, top_p / torch.sum(top_p, dim=-1, keepdim=True), top_e


def _slots(mask, C: int):
    """(pos, keep) [G, g, K, E] of the one-hot choices ``mask`` [G, g, K,
    E]: each choice's position in its expert, counted over the group
    k-major (every token's first choice before any second choice), and
    whether it lies within the capacity C.  An expert's column depends on
    its own column of the mask alone."""
    G, g, K, E = mask.shape
    mask_flat = mask.transpose(1, 2).reshape(G, K * g, E)
    pos = torch.cumsum(mask_flat, dim=1) - 1.0                    # [G,Kg,E]
    keep = (pos < C) * mask_flat
    pos = pos.reshape(G, K, g, E).transpose(1, 2)                 # [G,g,K,E]
    keep = keep.reshape(G, K, g, E).transpose(1, 2)
    return pos, keep


def _load(top_e, probs, E: int, K: int):
    """The aux loss's (f_e, p_e) over these tokens (the two leading dims):
    the fraction of choices routed to each expert, and its mean
    probability.  The routed counts are integers, exact in fp32, so a
    scatter gives the one-hot sum's values."""
    routed = torch.zeros((*top_e.shape[:-1], E), dtype=torch.float32,
                         device=top_e.device)
    routed.scatter_add_(-1, top_e, torch.ones(
        top_e.shape, dtype=torch.float32, device=top_e.device))
    return torch.mean(routed, dim=(0, 1)) / K, torch.mean(probs, dim=(0, 1))


def _dispatch_combine(top_p, pos, keep, C: int):
    """The dispatch and combine tensors [G, g, E, C] of the kept choices."""
    kept = keep[..., None] * _one_hot(pos.long(), C)              # [G,g,K,E,C]
    return (torch.sum(kept, dim=2),
            torch.einsum("GgK,GgKEC->GgEC", top_p, kept))


def _experts(p: Params, xd, cfg: ArchConfig, window=None):
    """The expert FFNs on xd [G, E, C, D], E the experts ``p`` holds ->
    [G, E, C, D] in xd's dtype.  Sparse experts run through the junction
    kernels unless ``cfg.engine`` is "jnp" (``window``: ``_expert_ffn``'s)."""
    E, dtype = xd.shape[1], xd.dtype
    if "idx_in" not in p:
        h = (act_fwd(torch.einsum("GECd,Edf->GECf", xd, p["wg"].to(dtype)),
                     "silu")
             * torch.einsum("GECd,Edf->GECf", xd, p["wi"].to(dtype)))
        return torch.einsum("GECf,Efd->GECd", h, p["wo"].to(dtype))
    # pre-defined-sparse experts (the paper's technique)
    if ops.resolve_engine(cfg.engine) == "pallas":
        return _expert_ffn(p, xd, E, window)
    if "wgq" in p:      # quantized experts, the plain int8 forms
        xs_in, xs_out = p.get("x_scale_in"), p.get("x_scale_out")
        gq = qz.expert_apply_int8(p["wgq"], p["wg_scale"], p["idx_in"], xd,
                                  xs_in)
        uq = qz.expert_apply_int8(p["wiq"], p["wi_scale"], p["idx_in"], xd,
                                  xs_in)
        h = (act_fwd(gq, "silu") * uq).to(dtype)
        return qz.expert_apply_int8(p["woq"], p["wo_scale"], p["idx_out"],
                                    h, xs_out).to(dtype)
    h = (act_fwd(_expert_apply(p["wg"], p["idx_in"], xd), "silu")
         * _expert_apply(p["wi"], p["idx_in"], xd))
    return _expert_apply(p["wo"], p["idx_out"], h)


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
    probs, top_p, top_e = _route(logits, K)                       # [G,g,K]
    pos, keep = _slots(_one_hot(top_e, E), C)                     # [G,g,K,E]

    # aux load-balance loss (fraction routed vs mean probability)
    f_e, p_e = _load(top_e, probs, E, K)
    aux = E * torch.sum(f_e * p_e) * mo.aux_loss_weight

    dispatch, combine = _dispatch_combine(top_p, pos, keep, C)
    xd = torch.einsum("GgEC,Ggd->GECd", dispatch.to(x.dtype), xt)
    ye = _experts(p, xd, cfg)
    y = torch.einsum("GgEC,GECd->Ggd", combine.to(x.dtype), ye)
    y = y.reshape(B, S, D)

    if "shared" in p:
        y = y + mlp_apply(p["shared"], x, cfg)
    return y, aux


def moe_apply_tp(part, p: Params, x, cfg: ArchConfig):
    """``moe_apply``'s routed experts on a rank of a partitioned mesh
    (parallel/partition.py): x [B, S, D], the rank's rows with every
    position, alike on every model rank.  Returns (y [B, S, D], its
    layout, aux); the shared experts are the caller's (an MLP).

    Routing is global over the batch rows, as the reference's single
    program routes: the router is column-parallel (the rank's logits for
    its experts, all-gathered over "model"), so softmax and top-k see
    every expert and decide alike on every model rank; the dispatch
    groups and the capacity come from the token count of every row group
    (``Partition.n_rows``); f_e and p_e are means over every row group.
    Where a group does not cross the rank's tokens (g divides them) the
    rank routes its own groups; else it all-gathers the top-k indices
    over the row axes and takes its tokens' positions from the k-major
    count of the groups they lie in.

    The experts are the rank's (``router`` and the expert weights hold
    E / model of them where "model" divides E): ``pos``, ``keep``, the
    dispatch, the expert FFN and the combine cover them alone (a
    position depends on its expert's column of the mask only), so the
    combine is a partial sum over experts, fp32, summed over "model" in
    the residual.  Where the experts are replicated every rank computes
    them all and the combine is whole ("full").  A fused train step's
    experts update over the capacity slots of every row group (the
    holders ``Partition.gather`` put in ``p``): the rank's groups in rank
    order, or its window of groups (T tokens a row group, groups of g,
    capacity C) folded onto the global groups."""
    mo = cfg.moe
    B, S, D = x.shape
    E, K = mo.num_experts, mo.top_k
    T = B * S
    g, _, C = moe_dispatch_dims(mo, T * part.n_rows)
    if (T * part.n_rows) % g:
        raise ValueError(f"tokens {T * part.n_rows} not divisible by moe "
                         f"group {g}")
    own = T % g == 0            # the rank's tokens make whole groups
    xt = x.reshape(T // g, g, D) if own else x.reshape(1, T, D)
    router = p["router"]
    El = router.shape[1]
    e0 = part.r * El if El < E else 0
    logits = torch.einsum("Ggd,de->Gge", xt, router.to(x.dtype))
    if El < E:
        logits = part.full(logits, "split")
    probs, top_p, top_e = _route(logits, K)
    if own:
        pos, keep = _slots(_one_hot(top_e - e0, El), C)
    else:   # the groups [a, a + n) of the global tokens hold the rank's
        o = part.row_at * T
        a, n = partition.group_window(o, T, g)
        every = part.rows_gather(top_e.reshape(T, K))    # global order
        pos, keep = _slots(_one_hot(every[a:a + n].reshape(n // g, g, K)
                                    - e0, El), C)
        pos, keep = (t.reshape(n, K, El)[o - a:o - a + T][None]
                     for t in (pos, keep))

    f_e, p_e = _load(top_e, probs, E, K)
    f_e, p_e = part.row_mean(f_e), part.row_mean(p_e)
    aux = E * torch.sum(f_e * p_e) * mo.aux_loss_weight

    dispatch, combine = _dispatch_combine(top_p, pos, keep, C)
    if not own:
        dispatch, combine, xt = (_windowed(t[0], o - a, n, g)
                                 for t in (dispatch, combine, xt))
    xd = torch.einsum("GgEC,Ggd->GECd", dispatch.to(x.dtype), xt)
    ye = _experts(p, xd, cfg, None if own else (T, g, C))
    if El < E:                  # partial over the experts: fp32 sums
        y, layout = torch.einsum("GgEC,GECd->Ggd", combine.to(
            x.dtype).float(), ye.float()), "partial"
    else:
        y, layout = torch.einsum("GgEC,GECd->Ggd", combine.to(x.dtype),
                                 ye), "full"
    if not own:
        y = y.reshape(n, D)[o - a:o - a + T]
    return y.reshape(B, S, D), layout, aux


def _windowed(t, o0: int, n: int, g: int):
    """t [T, ...] (the rank's tokens) placed at [o0, o0 + T) of n zeroed
    token slots, as [n / g, g, ...]: the groups they lie in, other row
    groups' tokens zero.  The rank runs the experts on the whole [E, n /
    g * C, D] block of those groups with the other row groups' capacity
    slots zeroed (a slot's output depends on its own row alone), and
    combines its own tokens' slots only."""
    out = t.new_zeros((n, *t.shape[1:]))
    out[o0:o0 + t.shape[0]] = t
    return out.reshape(n // g, g, *t.shape[1:])
