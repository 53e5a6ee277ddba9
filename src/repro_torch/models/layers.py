"""Common model pieces: norms, rotary and sinusoidal positions, token
embedding (with whisper's learned decoder positions), MLP.

Parameters are fp32 masters; compute runs in ``cfg.compute_dtype``
(bf16).  The rounding points follow the reference op for op.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import sparse_linear as sl


def norm_init(d: int, kind: str, dtype=torch.float32, device="cpu"):
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def norm_apply(p, x: torch.Tensor, kind: str, eps: float) -> torch.Tensor:
    """fp32 statistics, elementwise work in x's dtype: x*x is rounded to
    x's dtype before the fp32 mean, and the mean and inverse deviation are
    rounded to x's dtype before they meet x."""
    ms = torch.mean(torch.square(x), dim=-1, keepdim=True, dtype=torch.float32)
    if kind == "layernorm":
        mu = torch.mean(x, dim=-1, keepdim=True, dtype=torch.float32)
        inv = torch.rsqrt(ms - torch.square(mu) + eps)
        y = (x - mu.to(x.dtype)) * inv.to(x.dtype)
        y = y * p["scale"].to(x.dtype) + p["bias"].to(x.dtype)
    else:  # rmsnorm
        inv = torch.rsqrt(ms + eps)
        y = x * inv.to(x.dtype) * p["scale"].to(x.dtype)
    return y.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
         partial: float = 1.0) -> torch.Tensor:
    """x [..., S, H, D]; positions [..., S].  Rotates the first
    ``partial * D`` dims (stablelm-style partial rotary); cos and sin are
    rounded to x's dtype before the multiply."""
    d = x.shape[-1]
    rot = int(d * partial)
    rot -= rot % 2
    if rot == 0:
        return x
    xr, xp = x[..., :rot], x[..., rot:]
    half = rot // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(half, dtype=torch.float32,
                                     device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs        # [..., S, half]
    cos = torch.cos(ang)[..., None, :].to(x.dtype)              # [..., S, 1, half]
    sin = torch.sin(ang)[..., None, :].to(x.dtype)
    x1, x2 = xr[..., :half], xr[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out, xp], dim=-1) if rot < d else out


def sinusoidal_pos(seq: int, d: int, dtype, device="cpu") -> torch.Tensor:
    """[seq, d] fixed positions (whisper's encoder): sin of pos / 10000^(2i
    / d) in the first half, cos in the second, computed in fp32 (every
    quotient by a tensor, so that the card divides as the CPU does) and
    rounded to ``dtype`` last."""
    f32 = dict(dtype=torch.float32, device=device)
    pos = torch.arange(seq, **f32)[:, None]
    dim = torch.arange(d // 2, **f32)[None, :]
    expo = (2 * dim) / torch.tensor(float(d), **f32)
    ang = pos / torch.pow(torch.tensor(10000.0, **f32), expo)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def embed_init(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32,
               device="cpu"):
    """Token embedding (and the unembedding unless tied); the audio family
    also learns its decoder positions, ``pos`` [max_seq, d] x 0.02."""
    scale = float(1.0 / math.sqrt(cfg.d_model))
    p = {"tok": torch.randn((cfg.vocab, cfg.d_model), generator=gen,
                            dtype=dtype, device=device) * scale}
    if not cfg.tie_embeddings:
        p["out"] = torch.randn((cfg.d_model, cfg.vocab), generator=gen,
                               dtype=dtype, device=device) * scale
    if cfg.family == "audio":
        p["pos"] = torch.randn((cfg.max_seq, cfg.d_model), generator=gen,
                               dtype=dtype, device=device) * 0.02
    return p


def embed_tokens(p, tokens: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    return p["tok"][tokens.long()].to(cfg.compute_dtype)


def unembed(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    w = p["tok"].T if cfg.tie_embeddings else p["out"]
    return x @ w.to(x.dtype)


def mlp_init(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32,
             device="cpu", seed: int = 0, d_ff: int | None = None):
    """(Gated) MLP of hidden width ``d_ff`` (default ``cfg.d_ff``; a MoE's
    shared experts pass theirs); the projections are pre-defined-sparse
    when the paper's technique applies to the 'ffn' family."""
    d, f = cfg.d_model, d_ff or cfg.d_ff
    sp = cfg.sparsity
    kw = dict(family="ffn", sp=sp, dtype=dtype, device=device)
    p = {"wi": sl.init_linear(gen, d, f, seed=seed, **kw),
         "wo": sl.init_linear(gen, f, d, seed=seed + 1, **kw)}
    if cfg.act == "silu":
        p["wg"] = sl.init_linear(gen, d, f, seed=seed + 2, **kw)
    return p


def mlp_apply(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The activation rides as the producing junction's epilogue."""
    if "wg" in p:
        h = sl.apply(p["wg"], x, act="silu") * sl.apply(p["wi"], x)
    else:
        h = sl.apply(p["wi"], x, act="gelu")
    return sl.apply(p["wo"], h)


def mlp_apply_tp(part, p, x: torch.Tensor):
    """``mlp_apply`` on the rank's slice (parallel/partition.py): x with
    every feature -> (``wo``'s product, its layout).  The gate's two
    products share a layout (both gathered if they differ)."""
    if "wg" in p:
        g, lg = sl.apply_tp(p["wg"], x, "full", part, act="silu")
        u, lu = sl.apply_tp(p["wi"], x, "full", part)
        if lg != lu:
            g, u, lg = part.full(g, lg), part.full(u, lu), "full"
        h = g * u
    else:
        h, lg = sl.apply_tp(p["wi"], x, "full", part, act="gelu")
    return sl.apply_tp(p["wo"], h, lg, part)
