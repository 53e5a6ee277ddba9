"""State-space blocks: Mamba-1 (falcon-mamba) and Mamba-2 / SSD (zamba2).

Training and prefill walk the sequence in chunks of ``cfg.ssm_chunk``
steps, carrying the recurrent state in fp32 from chunk to chunk; inside
a chunk the recurrence is solved in parallel: a log-step scan for
Mamba-1, the matmul form of SSD for Mamba-2.  Live memory is O(B * chunk
* d_inner * d_state) a chunk; with ``cfg.remat`` under autograd each
chunk is recomputed in the backward (``torch.utils.checkpoint``).

Decode is the O(1) recurrent step on the cache {"conv": [B, K-1, C],
"ssm": state}.  The scans are plain PyTorch, as the reference's are: its
models never call the ``selective_scan`` kernel.  The projections
``in_proj`` / ``out_proj`` (Mamba-1) and ``in_z`` / ``in_xbc`` /
``out_proj`` (Mamba-2) are the paper's sparse junctions when the
technique applies to the 'ffn' family.

``mamba1_apply_tp`` / ``mamba2_apply_tp`` run a block on one rank of a
partitioned mesh (parallel/partition.py): the mixer, its state and its
cache on the rank's channels (Mamba-1) or heads (Mamba-2), the columns
they need moved to it over "model" (``Partition.regroup``), the
projections on the rank's slices as the specs split them.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core import sparse_linear as sl
from repro_torch.kernels.block_sparse_matmul import act_fwd

Params = dict[str, Any]


def _causal_conv(x, w, b, conv_state=None):
    """Depthwise causal conv.  x [B,S,C]; w [K,C]; returns (y, new_state),
    new_state [B,K-1,C] the last K-1 inputs (for decode)."""
    K = w.shape[0]
    if conv_state is None:
        xp = torch.nn.functional.pad(x, (0, 0, K - 1, 0))
    else:
        xp = torch.cat([conv_state.to(x.dtype), x], dim=1)
    S = x.shape[1]
    y = xp[:, 0:S] * w[0]
    for i in range(1, K):
        y = y + xp[:, i:i + S] * w[i]
    y = y + b
    new_state = xp[:, -(K - 1):] if K > 1 else None
    return y.to(x.dtype), new_state


def _softplus(x):
    """log(1 + e^x) as logaddexp(x, 0), the reference's formula."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _chunk_len(cfg: ArchConfig, S: int) -> int:
    c = min(cfg.ssm_chunk, S)
    if S % c:
        raise ValueError(f"seq {S} not divisible by ssm chunk {c}")
    return c


def _chunked(step, h0, args, remat: bool):
    """Walk the chunks of ``args`` (each [B, S, ...], cut along axis 1)
    with ``step(h, *chunk) -> (h, y)``: (the last state, the ys joined
    along axis 1)."""
    h, ys = h0, []
    for chunk in zip(*args):
        if remat and torch.is_grad_enabled():
            h, y = checkpoint(step, h, *chunk, use_reentrant=False)
        else:
            h, y = step(h, *chunk)
        ys.append(y)
    return h, torch.cat(ys, dim=1)


def _new_cache(cache, decode, new_conv, new_ssm):
    if cache is None and not decode:
        return None
    dt = cache["ssm"].dtype if cache is not None else torch.float32
    return {"conv": new_conv, "ssm": new_ssm.to(dt)}


# ====================================================================
# Mamba-1 (selective scan, diagonal A per channel, d_state = N)
# ====================================================================
def mamba1_init(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32,
                device="cpu", seed: int = 0) -> Params:
    d, di, N, R = cfg.d_model, cfg.d_inner_, cfg.ssm_state, cfg.dt_rank_
    sp = cfg.sparsity
    kw = dict(dtype=dtype, device=device)
    K = cfg.conv_width
    a = torch.arange(1, N + 1, dtype=dtype, device=device)
    return {
        "in_proj": sl.init_linear(gen, d, 2 * di, family="ffn", sp=sp,
                                  seed=seed, **kw),
        "conv_w": torch.randn((K, di), generator=gen, **kw) / float(
            np.sqrt(K)),
        "conv_b": torch.zeros((di,), **kw),
        "x_proj": sl.init_dense(gen, di, R + 2 * N, **kw),
        "dt_proj": sl.init_dense(gen, R, di, bias=True, **kw),
        "A_log": torch.log(a).expand(di, N).contiguous(),
        "D": torch.ones((di,), **kw),
        "out_proj": sl.init_linear(gen, di, d, family="ffn", sp=sp,
                                   seed=seed + 1, **kw),
    }


def _ssm_chunk_scan(decay, inp, h0):
    """Solve h_t = decay_t * h_{t-1} + inp_t within a chunk, in parallel:
    a Hillis-Steele scan over axis 1 in log2(c) steps of the combine
    (da, xa), (db, xb) -> (da * db, xa * db + xb), a the earlier element.
    decay / inp [B, c, ...]; h0 the same without c.  Returns (h, h[:, -1])."""
    d, x = decay, inp
    c, off = d.shape[1], 1
    while off < c:
        x = torch.cat([x[:, :off], x[:, :-off] * d[:, off:] + x[:, off:]],
                      dim=1)
        d = torch.cat([d[:, :off], d[:, :-off] * d[:, off:]], dim=1)
        off *= 2
    h = d * h0[:, None] + x
    return h, h[:, -1]


def _mamba1_chunk(h0, dt_c, B_c, C_c, x_c, A, scan_dt):
    """One chunk: h0 [B,di,N] fp32; dt_c / x_c [B,c,di], B_c / C_c
    [B,c,N] fp32.  Returns (h_last fp32, y [B,c,di] fp32)."""
    decay = torch.exp(dt_c[..., None] * A)                    # [B,c,di,N]
    inp = (dt_c[..., None] * B_c[:, :, None, :]) * x_c[..., None]
    # the [B,c,di,N] scan elements dominate the traffic: in bf16 under
    # ssm_scan_dtype, the carry stays fp32
    h, h_last = _ssm_chunk_scan(decay.to(scan_dt), inp.to(scan_dt),
                                h0.to(scan_dt))
    y = torch.matmul(h.float(), C_c[..., None])[..., 0]
    return h_last.float(), y


def mamba1_apply(p: Params, x, cfg: ArchConfig, cache: dict | None = None,
                 decode: bool = False):
    """x [B,S,d_model] -> (y, new_cache).  Cache: conv [B,K-1,di], ssm
    [B,di,N] fp32; new_cache is None without a cache outside decode."""
    di = cfg.d_inner_
    xz = sl.apply(p["in_proj"], x)
    y, new_cache = _mamba1_mix(
        p, xz[..., :di], xz[..., di:], cfg, cache, decode,
        lambda xs: sl.apply_dense(p["x_proj"], xs),
        lambda dt: sl.apply_dense(p["dt_proj"], dt))
    return sl.apply(p["out_proj"], y), new_cache


def _mamba1_mix(p: Params, xs, z, cfg: ArchConfig, cache, decode: bool,
                x_proj, dt_proj):
    """The Mamba-1 mixer on the channels ``xs`` / ``z`` [B,S,c] hold
    (``p``'s conv, A_log and D are theirs): (y [B,S,c] in xs's dtype, the
    new cache).  ``x_proj`` maps xs to [B,S,R+2N] over every channel,
    ``dt_proj`` the low-rank dt to the channels'."""
    B, S, c = xs.shape
    N, R = cfg.ssm_state, cfg.dt_rank_
    conv_state = cache["conv"] if cache is not None else None
    xs, new_conv = _causal_conv(xs, p["conv_w"].to(xs.dtype),
                                p["conv_b"].to(xs.dtype), conv_state)
    xs = act_fwd(xs, "silu")

    dbc = x_proj(xs)
    dt, Bc, Cc = dbc[..., :R], dbc[..., R:R + N], dbc[..., R + N:]
    dt = _softplus(dt_proj(dt).float())                          # [B,S,c]
    A = -torch.exp(p["A_log"].float())                           # [c,N]
    Bc, Cc, xf = Bc.float(), Cc.float(), xs.float()

    if decode:  # S == 1 recurrent step
        h_prev = cache["ssm"]                                    # [B,c,N]
        decay = torch.exp(dt[:, 0, :, None] * A)
        inp = (dt[:, 0, :, None] * Bc[:, 0, None, :]) * xf[:, 0, :, None]
        h = decay * h_prev + inp
        y = torch.matmul(h, Cc[:, 0, :, None])[..., 0][:, None, :]
        new_ssm = h
    else:
        chunk = _chunk_len(cfg, S)
        scan_dt = getattr(torch, cfg.ssm_scan_dtype)
        h0 = (cache["ssm"].float() if cache is not None
              else xs.new_zeros((B, c, N), dtype=torch.float32))

        def step(h, dt_c, B_c, C_c, x_c):
            return _mamba1_chunk(h, dt_c, B_c, C_c, x_c, A, scan_dt)

        new_ssm, y = _chunked(step, h0, [t.split(chunk, dim=1)
                                         for t in (dt, Bc, Cc, xf)],
                              cfg.remat)

    y = y + p["D"].float() * xf
    y = y.to(xs.dtype) * act_fwd(z, "silu")
    return y, _new_cache(cache, decode, new_conv, new_ssm)


def mamba1_apply_tp(part, p: Params, x, cfg: ArchConfig,
                    cache: dict | None = None, decode: bool = False):
    """``mamba1_apply`` on a rank of a partitioned mesh (parallel/
    partition.py): x [B,S,d_model] every position, alike on every model
    rank; ``p`` the layer's leaves gathered over the dp axes, its conv,
    A_log, D and dt_proj the rank's channels where "model" splits d_inner
    (c = di / model of them), and the cache its [B,K-1,c] / [B,c,N]
    shard.  Returns (y, its layout, the new cache).

    ``in_proj``'s output columns are split over "model" as its spec
    splits them (ranks 0 .. m/2-1 hold xs, the others z), so the rank's
    columns are regrouped into its channels of xs and of z (one
    all-to-all of B*S*2c elements; a replicated in_proj is cut).
    ``x_proj`` (replicated) reads every channel: the rank's channels'
    partial products are all-reduced in fp32 over "model".  ``dt_proj``
    is column-parallel, the scan runs on the rank's channels, and
    ``out_proj`` takes them: row-parallel (dense, partial sums) or its
    output blocks (a sparse junction's split: y gathered first)."""
    di = cfg.d_inner_
    c = p["A_log"].shape[0]
    c0 = part.r * c if c < di else 0
    xz, lx = sl.apply_tp(p["in_proj"], x, "full", part)
    if c == di:
        xz = part.full(xz, lx)
        xs, z = xz[..., :di], xz[..., di:]
    elif lx == "full":
        xs, z = xz[..., c0:c0 + c], xz[..., di + c0:di + c0 + c]
    else:
        m = part.m
        xz = part.regroup(
            xz, [(q * 2 * c, (q + 1) * 2 * c) for q in range(m)],
            [[(q * c, (q + 1) * c), (di + q * c, di + (q + 1) * c)]
             for q in range(m)])
        xs, z = xz[..., :c], xz[..., c:]

    def x_proj(xs):
        if c == di:
            return sl.apply_dense(p["x_proj"], xs)
        w = p["x_proj"]["w"].to(xs.dtype)[c0:c0 + c]
        return part.full(xs.float() @ w.float(), "partial")

    def dt_proj(dt):
        y, ly = sl.apply_tp(p["dt_proj"], dt, "full", part)
        return y if ly == "split" or c == di else y[..., c0:c0 + c]

    y, new_cache = _mamba1_mix(p, xs, z, cfg, cache, decode, x_proj,
                               dt_proj)
    out, lo = sl.apply_tp(p["out_proj"], y, "split" if c < di else "full",
                          part)
    return out, lo, new_cache


# ====================================================================
# Mamba-2 / SSD (scalar decay per head, matmul-form chunk algorithm)
# ====================================================================
def mamba2_init(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32,
                device="cpu", seed: int = 0) -> Params:
    d, di, N, H = cfg.d_model, cfg.d_inner_, cfg.ssm_state, cfg.ssm_heads
    sp = cfg.sparsity
    kw = dict(dtype=dtype, device=device)
    K = cfg.conv_width
    # separate projections (z | x,B,C | dt), as the reference's
    return {
        "in_z": sl.init_linear(gen, d, di, family="ffn", sp=sp, seed=seed,
                               **kw),
        "in_xbc": sl.init_linear(gen, d, di + 2 * N, family="ffn", sp=sp,
                                 seed=seed + 2, **kw),
        "in_dt": sl.init_dense(gen, d, H, **kw),
        "conv_w": torch.randn((K, di + 2 * N), generator=gen, **kw)
                  / float(np.sqrt(K)),
        "conv_b": torch.zeros((di + 2 * N,), **kw),
        "A_log": torch.zeros((H,), **kw),
        "dt_bias": torch.zeros((H,), **kw),
        "D": torch.ones((H,), **kw),
        "out_proj": sl.init_linear(gen, di, d, family="ffn", sp=sp,
                                   seed=seed + 1, **kw),
    }


def _mamba2_chunk(h0, dt_c, B_c, C_c, x_c, A):
    """One SSD chunk: h0 [B,H,hd,N]; dt_c [B,c,H], B_c / C_c [B,c,N],
    x_c [B,c,H,hd], all fp32.  h_t = sum_{s<=t} exp(cum_t - cum_s)
    dt_s B_s x_s + exp(cum_t) h0.  Returns (h_new, y [B,c,H,hd])."""
    c = dt_c.shape[1]
    la = dt_c * A                                            # [B,c,H]
    cum = torch.cumsum(la, dim=1)
    diff = (cum[:, :, None, :] - cum[:, None, :, :]).permute(0, 3, 1, 2)
    causal = torch.ones((c, c), dtype=torch.bool, device=dt_c.device).tril()
    # masked before the exp: the same values as exp-then-mask, and the
    # masked entries (exp of a positive sum, inf past ~88) give the
    # backward zeros rather than 0 * inf
    L = torch.exp(torch.where(causal, diff, float("-inf")))  # [B,H,t,s]
    G = torch.matmul(C_c, B_c.transpose(1, 2))               # [B,t,s]
    Mdt = L * G[:, None] * dt_c.permute(0, 2, 1)[:, :, None, :]
    xh = x_c.permute(0, 2, 1, 3)                             # [B,H,s,hd]
    y_intra = torch.matmul(Mdt, xh)                          # [B,H,t,hd]
    # the incoming state's share
    y_inter = (torch.matmul(C_c[:, None], h0.transpose(-1, -2))
               * torch.exp(cum).permute(0, 2, 1)[..., None])
    # the new state: every step decayed to the chunk's end
    w = torch.exp(cum[:, -1:] - cum)                         # [B,c,H]
    wdx = (w * dt_c).permute(0, 2, 1)[..., None] * xh        # [B,H,s,hd]
    h_new = (torch.exp(cum[:, -1])[:, :, None, None] * h0
             + torch.matmul(wdx.transpose(-1, -2), B_c[:, None]))
    return h_new, (y_intra + y_inter).permute(0, 2, 1, 3)


def mamba2_apply(p: Params, x, cfg: ArchConfig, cache: dict | None = None,
                 decode: bool = False):
    """SSD.  x [B,S,d_model] -> (y, new_cache).  Cache: conv [B,K-1,
    di+2N], ssm [B,H,hd,N] fp32."""
    di, N = cfg.d_inner_, cfg.ssm_state
    z = sl.apply(p["in_z"], x)
    xbc = sl.apply(p["in_xbc"], x)
    dt = sl.apply_dense(p["in_dt"], x)
    conv_state = cache["conv"] if cache is not None else None
    xbc, new_conv = _causal_conv(xbc, p["conv_w"].to(x.dtype),
                                 p["conv_b"].to(x.dtype), conv_state)
    xbc = act_fwd(xbc, "silu")
    y, new_ssm = _mamba2_mix(p, xbc[..., :di], xbc[..., di:di + N],
                             xbc[..., di + N:], dt, z, cfg, cache, decode)
    out = sl.apply(p["out_proj"], y)
    return out, _new_cache(cache, decode, new_conv, new_ssm)


def _mamba2_mix(p: Params, xs, Bc, Cc, dt, z, cfg: ArchConfig, cache,
                decode: bool):
    """SSD on the heads ``xs`` [B,S,h*hd] / ``dt`` [B,S,h] / ``z`` hold
    (``p``'s A_log, dt_bias and D are theirs), B and C [B,S,N] read by
    every head: (y [B,S,h*hd] in z's dtype, the new ssm state)."""
    B, S, _ = xs.shape
    hd = cfg.ssm_head_dim
    H = dt.shape[-1]
    dt = _softplus(dt.float() + p["dt_bias"].float())            # [B,S,H]
    A = -torch.exp(p["A_log"].float())                           # [H]
    xh = xs.reshape(B, S, H, hd).float()
    Bf, Cf = Bc.float(), Cc.float()                              # [B,S,N]

    if decode:
        h_prev = cache["ssm"].float()                            # [B,H,hd,N]
        decay = torch.exp(dt[:, 0] * A)                          # [B,H]
        inp = ((dt[:, 0, :, None] * xh[:, 0])[..., None]
               * Bf[:, 0, None, None, :])
        h = decay[..., None, None] * h_prev + inp
        y = torch.matmul(h, Cf[:, 0, None, :, None])[..., 0]     # [B,H,hd]
        y = y + p["D"].float()[None, :, None] * xh[:, 0]
        y = y.reshape(B, 1, H * hd)
        new_ssm = h
    else:
        c = _chunk_len(cfg, S)
        h0 = (cache["ssm"].float() if cache is not None
              else xs.new_zeros((B, H, hd, cfg.ssm_state),
                                dtype=torch.float32))

        def step(h, dt_c, B_c, C_c, x_c):
            return _mamba2_chunk(h, dt_c, B_c, C_c, x_c, A)

        new_ssm, y = _chunked(step, h0, [t.split(c, dim=1)
                                         for t in (dt, Bf, Cf, xh)],
                              cfg.remat)
        y = (y + p["D"].float()[None, None, :, None] * xh).reshape(
            B, S, H * hd)
    return y.to(z.dtype) * act_fwd(z, "silu"), new_ssm


def mamba2_apply_tp(part, p: Params, x, cfg: ArchConfig,
                    cache: dict | None = None, decode: bool = False):
    """``mamba2_apply`` on a rank of a partitioned mesh: x [B,S,d_model]
    every position, alike on every model rank; ``p`` the layer's leaves
    gathered over the dp axes, A_log, dt_bias, D and in_dt the rank's
    heads where "model" splits them (h = H / model), conv_w / conv_b its
    share of the di+2N columns where "model" divides them, the cache its
    [B,K-1,(di+2N)/model] conv and [B,h,hd,N] ssm shard.  Returns (y,
    its layout, the new cache).

    ``in_z`` is column-parallel (its split is the heads'), or replicated
    and cut.  The conv is depthwise, so it runs on the rank's share of
    ``in_xbc``'s columns as the specs split conv_w and the conv cache (a
    replicated in_xbc cut to them); the columns the rank's heads read,
    their xs and all of B and C, are then regrouped to it (one
    all-to-all of B*S*(h*hd+2N) elements received).  SSD runs on the
    rank's heads; ``out_proj`` takes them as ``mamba1_apply_tp``'s
    does."""
    di, N = cfg.d_inner_, cfg.ssm_state
    H, hd = cfg.ssm_heads, cfg.ssm_head_dim
    h = p["A_log"].shape[0]
    c, c0 = h * hd, (part.r * h * hd if h < H else 0)

    def mine(t, layout, n, at):     # the rank's n columns from at
        if layout == "split" and t.shape[-1] == n:
            return t
        t = part.full(t, layout)
        return t if t.shape[-1] == n else t[..., at:at + n]

    z = mine(*sl.apply_tp(p["in_z"], x, "full", part), c, c0)
    dt = mine(*sl.apply_tp(p["in_dt"], x, "full", part), h, c0 // hd)
    C = di + 2 * N
    cc = p["conv_w"].shape[1]
    xbc = mine(*sl.apply_tp(p["in_xbc"], x, "full", part), cc,
               part.r * cc if cc < C else 0)
    conv_state = cache["conv"] if cache is not None else None
    xbc, new_conv = _causal_conv(xbc, p["conv_w"].to(x.dtype),
                                 p["conv_b"].to(x.dtype), conv_state)
    xbc = act_fwd(xbc, "silu")
    if cc < C:
        xbc = part.regroup(
            xbc, [(q * cc, (q + 1) * cc) for q in range(part.m)],
            [[(q * c, (q + 1) * c) if h < H else (0, di), (di, C)]
             for q in range(part.m)])
    elif h < H:
        xbc = torch.cat([xbc[..., c0:c0 + c], xbc[..., di:]], dim=-1)
    y, new_ssm = _mamba2_mix(p, xbc[..., :c], xbc[..., c:c + N],
                             xbc[..., c + N:], dt, z, cfg, cache, decode)
    out, lo = sl.apply_tp(p["out_proj"], y, "split" if h < H else "full",
                          part)
    return out, lo, _new_cache(cache, decode, new_conv, new_ssm)
