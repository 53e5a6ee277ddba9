"""The dense-family model over a block-paged KV cache.

``init(cfg, seed, device)``       -> params (fp32 masters, a list of layers)
``make_paged_cache(cfg, P, ps)``  -> zeroed pool {"k","v": [L, P, ps, Hkv, hd]}
``paged_decode_step(...)``        -> (logits [B,1,V], pool) one decode tick
``paged_prefill_chunk(...)``      -> (last logits [1,1,V], pool) one chunk

The layers run in a Python loop, each updating its slice ``pool[.][l]``
of the pool in place.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.layers import (embed_init, embed_tokens, mlp_apply,
                                       mlp_init, norm_apply, norm_init,
                                       unembed)

Params = dict[str, Any]


def init(cfg: ArchConfig, seed: int = 0, device=None) -> Params:
    """Random params from ``seed`` on ``device`` (the card by default)."""
    if cfg.family != "dense":
        raise ValueError(f"family {cfg.family!r}: the port builds the dense "
                         "family only")
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.param_dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params: Params = {"embed": embed_init(gen, cfg, dtype, dev),
                      "final_norm": norm_init(cfg.d_model, cfg.norm, dtype,
                                              dev)}
    params["layers"] = [
        {"norm1": norm_init(cfg.d_model, cfg.norm, dtype, dev),
         "attn": attn.attn_init(gen, cfg, dtype, dev),
         "norm2": norm_init(cfg.d_model, cfg.norm, dtype, dev),
         "mlp": mlp_init(gen, cfg, dtype, dev)}
        for _ in range(cfg.n_layers)]
    return params


def paged_supported(cfg: ArchConfig) -> tuple[bool, str]:
    """(ok, reason): whether the paged decode path can serve ``cfg``."""
    if cfg.family != "dense":
        return False, (f"family {cfg.family!r} — the port's paged path "
                       "serves the dense family")
    if cfg.attn_kind != "full":
        return False, (f"attn_kind {cfg.attn_kind!r} — paged decode covers "
                       "the full-attention GQA cache layout")
    return True, "paged"


def make_paged_cache(cfg: ArchConfig, num_pages: int, page_size: int,
                     device="cpu"):
    ok, why = paged_supported(cfg)
    if not ok:
        raise ValueError(f"paged cache unsupported: {why}")
    shape = (cfg.n_layers, num_pages, page_size, cfg.kv_heads, cfg.head_dim)
    return {key: torch.zeros(shape, dtype=cfg.compute_dtype, device=device)
            for key in ("k", "v")}


def _attn_block_paged(lp, x, cfg: ArchConfig, cache_l, positions, page_table,
                      *, decode: bool):
    h = norm_apply(lp["norm1"], x, cfg.norm, cfg.norm_eps)
    if decode:
        a, _ = attn.gqa_decode_paged(lp["attn"], h, cfg, cache_l, positions,
                                     page_table)
    else:
        a, _ = attn.gqa_prefill_paged(lp["attn"], h, cfg, cache_l, positions,
                                      page_table)
    x = x + a
    h = norm_apply(lp["norm2"], x, cfg.norm, cfg.norm_eps)
    return x + mlp_apply(lp["mlp"], h, cfg)


def _run_layers(cfg, params, pool, x, positions, page_table, decode):
    for l, lp in enumerate(params["layers"]):
        cache_l = {"k": pool["k"][l], "v": pool["v"][l]}    # views of pool
        x = _attn_block_paged(lp, x, cfg, cache_l, positions, page_table,
                              decode=decode)
    return norm_apply(params["final_norm"], x, cfg.norm, cfg.norm_eps)


def paged_decode_step(cfg: ArchConfig, params: Params, pool, token,
                      positions, page_table):
    """One decode tick: token [B,1] int, positions [B] int (each slot's
    write position), page_table [B, maxp] int32.  Returns
    (logits [B,1,V], pool) with the pool updated in place."""
    ok, why = paged_supported(cfg)
    if not ok:
        raise ValueError(f"paged decode unsupported: {why}")
    x = embed_tokens(params["embed"], token, cfg)
    x = _run_layers(cfg, params, pool, x, positions, page_table, True)
    return unembed(params["embed"], x, cfg), pool


def paged_prefill_chunk(cfg: ArchConfig, params: Params, pool, tokens,
                        base: int, page_table_row, chunk_len: int):
    """Prefill one fixed-size chunk of one slot's prompt: tokens [1, C]
    (tail-padded past ``chunk_len``), ``base`` the absolute position of
    tokens[0], page_table_row [maxp] int32.  Returns (logits [1,1,V] at
    the chunk's last valid position, pool) with the pool updated in
    place."""
    ok, why = paged_supported(cfg)
    if not ok:
        raise ValueError(f"paged prefill unsupported: {why}")
    C = tokens.shape[1]
    x = embed_tokens(params["embed"], tokens, cfg)
    positions = base + torch.arange(C, device=tokens.device)
    x = _run_layers(cfg, params, pool, x, positions, page_table_row[None, :],
                    False)
    last = x[:, chunk_len - 1:chunk_len]
    return unembed(params["embed"], last, cfg), pool
