"""The model families: training forward and loss, the static serving
cache and decode step, and serving over a block-paged KV cache.  A dense
layer is attention and an MLP; the vlm (llava) is a dense stack whose
input is ``batch["patches"]`` (patch embeddings, the frontend stubbed)
ahead of the token embeddings; a MoE layer is attention and
``models/moe.py``'s routed experts, whose load-balance losses sum into
the forward's aux, after ``first_dense_layers`` dense layers
(``params["dense_layers"]``, deepseek-v2); an ssm layer (falcon-mamba)
is a Mamba-1 block; the hybrid (zamba2) stacks super-blocks of
``hybrid_attn_every`` Mamba-2 blocks, each super-block led by one
attention-and-MLP block whose weights all super-blocks share
(``params["shared_attn"]``); the audio family (whisper) is an
encoder-decoder: ``batch["frames"]`` (frame embeddings, the conv
frontend stubbed) plus fixed sinusoidal positions feed the encoder
(``params["encoder"]``: its layers and final norm), and each decoder
layer (``params["layers"]``) runs causal self-attention, cross-attention
on the encoder's output (its K / V made at prefill, by a plain matmul
with ``cross.wk`` / ``cross.wv``) and an MLP; the tokens take learned
positions (``embed["pos"]``) and no rope.  The frames feed the encoder
only and never sit ahead of the tokens, so the text's offset is 0 and
positions count from the text.  Attention is GQA (``attn_kind`` full,
or sliding with a ring cache of ``window`` slots) or MLA (its cache the
compressed latent).

``init(cfg, seed, device)``       -> params (fp32 masters, a list of
                                     layers; the hybrid's a list of lists;
                                     whisper's encoder layers a list too)
``forward(cfg, params, batch)``   -> (logits [B,P+S,V], cache, (aux, P))
``loss_fn(cfg, params, batch)``   -> (loss, {"ce", "aux"}) next-token CE
``make_cache(cfg, B, S, device)`` -> the zeroed static cache
``cache_seq_axes(cfg)``           -> the sequence axis of each cache leaf
                                     (-1: a state leaf, copied whole)
``decode_step(cfg, params, cache, token, pos)`` -> (logits [B,1,V], cache)
``make_paged_cache(cfg, P, ps)``  -> zeroed pool {"k","v": [L, P, ps, Hkv, hd]}
``paged_decode_step(...)``        -> (logits [B,1,V], pool) one decode tick
``paged_prefill_chunk(...)``      -> (last logits [1,1,V], pool) one chunk

``forward`` calls ``parallel/hints.constrain_tokens3d`` where the
reference anchors its residual stream: after the embedding, after each
layer of ``params["layers"]`` (the ssm, the hybrid's Mamba layers and
the decoder's too, not the dense first layers or the encoder's) and
after each hybrid super-block.

Under a ``parallel/partition.Partition`` (the partitioned mesh steps,
``train/steps.py``) every family's ``forward``, ``decode_step`` and
``loss_fn`` run on the rank's shards: each layer (a MoE model's dense
first layers first; each of the hybrid's Mamba layers, and its shared
block at each use; whisper's encoder layers, then its decoder's) gathers
its leaves over the dp axes just before it runs (``Partition.gather``)
and, under grad, is recomputed in the backward (gathering again)
whatever ``cfg.remat`` says, but the dense first layers and the shared
block, whose activations are kept and whose leaves are gathered again
(``Partition.kept``), as the reference runs them outside its
checkpoint.  On the "tp" strategy the
products run on the rank's heads, output blocks, features and
experts (``moe.moe_apply_tp``: routing global over the batch rows), MLA
on the rank's heads and its shard of the latent cache, a Mamba mixer on
the rank's channels (Mamba-1) or heads (Mamba-2) and its shard of the
state (``ssm.mamba1_apply_tp`` / ``mamba2_apply_tp``); the shared
block's gradient is summed over its uses before it is reduced
(``partition.SharedUses``); the residual is stored sequence-sharded over
"model"; the embedding and unembedding are vocab-parallel, their logits
the rank's vocab columns (placed by ``sharding.logits_spec``), and the
cross entropy takes its log-sum-exp over "model"; a vlm's patches join
the embedding's partial sums ahead of the text.  Decoding runs on the
rank's sequence shard of the attention cache (a sliding window's ring:
its share of the slots) and its channels' or heads' shard of the
state.  On the "sp" strategy (whisper) every weight is whole over
"model": the decoder's residual holds the rank's positions and the
encoder's its frames (each all of them where their count does not
divide "model"), attention reads k / v of every position gathered over
"model", the loss sums the rank's positions and all-reduces the sum,
and decoding runs on the rank's sequence shard of the self-attention
cache and its frames of the cross K / V.  Without a partition they do
what the rest of this module says.

The layers run in a Python loop; with ``cfg.remat`` each training layer
is recomputed in the backward (``torch.utils.checkpoint``), whisper's
encoder layers included, but a MoE model's dense first layers and the
hybrid's shared block, which the reference runs outside its checkpoint
too.  The serving paths update each
layer's slice ``cache[.][l]`` of the static cache, or ``pool[.][l]`` of
the paged pool, in place.  The paged path serves the dense and moe
families only, as the reference's: a state leaf has no pages.
"""
from __future__ import annotations

import contextlib
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.core import sparse_linear as sl
from repro_torch.models.layers import (embed_init, embed_tokens, mlp_apply,
                                       mlp_apply_tp, mlp_init, norm_apply,
                                       norm_init, sinusoidal_pos, unembed)
from repro_torch.models.moe import moe_apply, moe_apply_tp, moe_init
from repro_torch.models.ssm import (mamba1_apply, mamba1_apply_tp,
                                    mamba1_init, mamba2_apply,
                                    mamba2_apply_tp, mamba2_init)
from repro_torch.parallel import hints, partition

Params = dict[str, Any]


FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "audio")


def _check_family(cfg: ArchConfig, what: str) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"family {cfg.family!r}: the port {what} the "
                         f"{', '.join(FAMILIES)} families only")


def init(cfg: ArchConfig, seed: int = 0, device=None) -> Params:
    """Random params from ``seed`` on ``device`` (the card by default).
    On the ``meta`` device it allocates nothing: the leaves carry their
    shapes and dtypes only (the sharding rules read them at full size)."""
    _check_family(cfg, "builds")
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.param_dtype)
    gen = torch.Generator(device="cpu" if dev.type == "meta" else dev)
    gen.manual_seed(seed)
    params: Params = {"embed": embed_init(gen, cfg, dtype, dev),
                      "final_norm": norm_init(cfg.d_model, cfg.norm, dtype,
                                              dev)}

    def block(kind):
        if kind in ("mamba1", "mamba2"):
            init_ssm = mamba1_init if kind == "mamba1" else mamba2_init
            return {"norm": norm_init(cfg.d_model, cfg.norm, dtype, dev),
                    "ssm": init_ssm(gen, cfg, dtype, dev)}
        lp = {"norm1": norm_init(cfg.d_model, cfg.norm, dtype, dev),
              "attn": attn.attn_init(gen, cfg, dtype, dev)}
        if kind == "dec":
            lp["norm_x"] = norm_init(cfg.d_model, cfg.norm, dtype, dev)
            lp["cross"] = attn.attn_init(gen, cfg, dtype, dev)
        lp["norm2"] = norm_init(cfg.d_model, cfg.norm, dtype, dev)
        if kind == "attn_moe":
            lp["moe"] = moe_init(gen, cfg, dtype, dev)
        else:
            lp["mlp"] = mlp_init(gen, cfg, dtype, dev)
        return lp

    if cfg.family == "hybrid":
        ev = cfg.hybrid_attn_every
        params["layers"] = [[block("mamba2") for _ in range(ev)]
                            for _ in range(cfg.n_layers // ev)]
        params["shared_attn"] = block("attn_mlp")
    elif cfg.family == "audio":
        params["layers"] = [block("dec") for _ in range(cfg.n_layers)]
        params["encoder"] = {
            "layers": [block("enc") for _ in range(cfg.enc_layers)],
            "norm": norm_init(cfg.d_model, cfg.norm, dtype, dev)}
    else:
        kind = {"dense": "attn_mlp", "vlm": "attn_mlp", "moe": "attn_moe",
                "ssm": "mamba1"}[cfg.family]
        nd = _n_dense(cfg)
        if nd:
            params["dense_layers"] = [block("attn_mlp") for _ in range(nd)]
        params["layers"] = [block(kind) for _ in range(cfg.n_layers - nd)]
    return params


def _n_dense(cfg: ArchConfig) -> int:
    """The dense layers ahead of a MoE stack (deepseek-v2's first)."""
    return cfg.moe.first_dense_layers if cfg.family == "moe" else 0


def _ffn(lp, h, cfg: ArchConfig):
    """The layer's FFN: (output, aux loss)."""
    if "moe" in lp:
        return moe_apply(lp["moe"], h, cfg)
    return mlp_apply(lp["mlp"], h, cfg), 0.0


def _attn_mlp_block(lp, x, cfg: ArchConfig, positions, cache=None,
                    pos=None, decode: bool = False):
    """A decoder layer: (x, cache, aux).  The whole sequence at
    ``positions`` hands back the layer's {"k", "v"} (MLA: {"latent",
    "k_rope"}); ``decode`` runs one token at ``pos`` against the layer's
    ``cache``, updated in place."""
    h = norm_apply(lp["norm1"], x, cfg.norm, cfg.norm_eps)
    mla = cfg.attn_kind == "mla"
    if decode:
        step = attn.mla_decode if mla else attn.gqa_decode
        a, new_cache = step(lp["attn"], h, cfg, cache, pos)
    else:
        fwd = attn.mla_forward if mla else attn.gqa_forward
        a, kv = fwd(lp["attn"], h, cfg, positions=positions)
        new_cache = dict(zip(("latent", "k_rope") if mla else ("k", "v"),
                             kv))
    x = x + a
    h = norm_apply(lp["norm2"], x, cfg.norm, cfg.norm_eps)
    m, aux = _ffn(lp, h, cfg)
    return x + m, new_cache, aux


def _enc_block(lp, x, cfg: ArchConfig):
    """A whisper encoder layer: bidirectional self-attention and an MLP."""
    h = norm_apply(lp["norm1"], x, cfg.norm, cfg.norm_eps)
    a, _ = attn.gqa_forward(lp["attn"], h, cfg, causal=False,
                            positions=torch.arange(x.shape[1],
                                                   device=x.device))
    x = x + a
    h = norm_apply(lp["norm2"], x, cfg.norm, cfg.norm_eps)
    return x + mlp_apply(lp["mlp"], h, cfg)


def _cross_kv(lp, enc, cfg: ArchConfig):
    """The encoder output's K / V for one decoder layer's cross-attention:
    plain products with ``cross.wk`` / ``cross.wv`` (no bias) in the
    compute dtype, [B, F, Hkv, hd] each."""
    return tuple(attn._split_heads(enc @ lp["cross"][k]["w"].to(enc.dtype),
                                   cfg.kv_heads, cfg.head_dim)
                 for k in ("wk", "wv"))


def _dec_block(lp, x, cfg: ArchConfig, positions, enc=None, cache=None,
               pos=None, decode: bool = False):
    """A whisper decoder layer: causal self-attention, cross-attention on
    the encoder output ``enc`` (or, in decode, on the cache's read-only
    "ck" / "cv"), an MLP.  Returns (x, {"k", "v", "ck", "cv"}); decode
    writes the new token's K / V into the cache in place."""
    h = norm_apply(lp["norm1"], x, cfg.norm, cfg.norm_eps)
    if decode:
        a, _ = attn.gqa_decode(lp["attn"], h, cfg,
                               {"k": cache["k"], "v": cache["v"]}, pos)
        kv = (cache["k"], cache["v"])
    else:
        a, kv = attn.gqa_forward(lp["attn"], h, cfg, positions=positions)
    x = x + a
    h = norm_apply(lp["norm_x"], x, cfg.norm, cfg.norm_eps)
    if decode:
        ckv = (cache["ck"], cache["cv"])
        c, _ = attn.gqa_decode(lp["cross"], h, cfg,
                               dict(zip(("k", "v"), ckv)), pos, cross=True)
    else:
        ckv = _cross_kv(lp, enc, cfg)
        c, _ = attn.gqa_forward(lp["cross"], h, cfg, positions=positions,
                                kv_override=ckv)
    x = x + c
    h = norm_apply(lp["norm2"], x, cfg.norm, cfg.norm_eps)
    return x + mlp_apply(lp["mlp"], h, cfg), dict(zip(("k", "v", "ck",
                                                       "cv"), kv + ckv))


def _encode_audio(cfg: ArchConfig, params, frames):
    """The encoder over ``frames`` [B, F, d] (cast to the compute dtype,
    sinusoidal positions added): its final-norm output [B, F, d]."""
    x = frames.to(cfg.compute_dtype)
    x = x + sinusoidal_pos(x.shape[1], cfg.d_model, x.dtype, x.device)[None]
    for lp in params["encoder"]["layers"]:
        x = _layer(_enc_block, lp, x, cfg, cfg=cfg)
    return norm_apply(params["encoder"]["norm"], x, cfg.norm, cfg.norm_eps)


def _ssm_block(lp, x, cfg: ArchConfig, cache=None, decode: bool = False):
    """A state-space layer (Mamba-1 in the ssm family, Mamba-2 in the
    hybrid): (x, cache, aux 0).  Given a ``cache`` (or in decode) it hands
    back the layer's {"conv", "ssm"} state."""
    h = norm_apply(lp["norm"], x, cfg.norm, cfg.norm_eps)
    apply = mamba2_apply if cfg.family == "hybrid" else mamba1_apply
    y, new_cache = apply(lp["ssm"], h, cfg, cache=cache, decode=decode)
    return x + y, new_cache, 0.0


def _ssm_zero(cfg: ArchConfig, lp, B: int, x):
    """A layer's zeroed state, for a prefill that hands its state back:
    its conv columns and its channels' (Mamba-1) or heads' (Mamba-2)
    state, read off the layer's conv_w and A_log (a rank's shard of them
    on the partitioned route)."""
    q = lp["ssm"]
    n, N = q["A_log"].shape[0], cfg.ssm_state
    ssm = (B, n, cfg.ssm_head_dim, N) if cfg.family == "hybrid" else (B, n,
                                                                       N)
    return {"conv": x.new_zeros((B, cfg.conv_width - 1,
                                 q["conv_w"].shape[1])),
            "ssm": x.new_zeros(ssm, dtype=torch.float32)}


def _layer(fn, *args, cfg: ArchConfig):
    """fn(*args), recomputed in the backward under ``cfg.remat``."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _recomputed(fn, *args):
    """fn(*args), recomputed in the backward under grad (a layer of the
    partitioned route, whatever ``cfg.remat`` says)."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _stack(caches):
    return {k: torch.stack([c[k] for c in caches]) for k in caches[0]}


def _tokens(params, batch):
    return torch.as_tensor(batch["tokens"],
                           device=params["embed"]["tok"].device)


def _embed_in(cfg: ArchConfig, params, batch):
    """The token embeddings, a vlm's ``batch["patches"]`` (cast to the
    compute dtype) ahead of them: (x [B, P+S, d], P).  The audio family
    adds its learned positions 0..S-1 and has no offset."""
    x = embed_tokens(params["embed"], _tokens(params, batch), cfg)
    if cfg.family == "audio":
        return x + params["embed"]["pos"][:x.shape[1]].to(x.dtype)[None], 0
    if cfg.family != "vlm" or "patches" not in batch:
        return x, 0
    patches = torch.as_tensor(batch["patches"], device=x.device)
    return torch.cat([patches.to(x.dtype), x], dim=1), patches.shape[1]


def _attn_stacks(params, cache=None):
    """The attention-block stacks in order, each with its part of the
    cache: a MoE model's dense first layers ("dense"), then the rest."""
    if "dense_layers" not in params:
        return [(params["layers"], cache)]
    parts = (None, None) if cache is None else (cache["dense"], cache["moe"])
    return list(zip((params["dense_layers"], params["layers"]), parts))


def forward(cfg: ArchConfig, params: Params, batch, *,
            return_cache: bool = False, last_only: bool = False,
            return_hidden: bool = False):
    """Training and prefill forward: batch {"tokens": [B, S]} and, for the
    vlm, {"patches": [B, P, d]}, for the audio family {"frames": [B, F,
    d]} (numpy or tensors).  Returns (logits
    [B,P+S,V] or the final-norm hidden state, cache, (aux, P)); aux is
    the layers' summed MoE load-balance loss (0 for the other families)
    and P the patch count, the text's offset (0 without patches).
    ``return_cache`` stacks the layers' caches in ``make_cache``'s
    structure with the prefill's P+S positions (else None); ``last_only``
    keeps the last position."""
    _check_family(cfg, "trains")
    part = _partition(cfg)
    if part is not None:
        return _forward_tp(cfg, params, batch, part, return_cache,
                           last_only, return_hidden)
    x, off = _embed_in(cfg, params, batch)
    x = hints.constrain_tokens3d(x, cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    aux = 0.0
    cache = None
    if cfg.family in ("dense", "vlm", "moe"):
        parts = []
        for layers, _ in _attn_stacks(params):
            caches = []
            first = layers is not params["layers"]
            for lp in layers:
                if first:       # dense first layers: never recomputed
                    x, c, a = _attn_mlp_block(lp, x, cfg, positions)
                else:
                    x, c, a = _layer(_attn_mlp_block, lp, x, cfg,
                                     positions, cfg=cfg)
                    x = hints.constrain_tokens3d(x, cfg)
                if return_cache:
                    caches.append(c)
                aux = aux + a
            parts.append(caches)
        if return_cache:
            cache = (_stack(parts[0]) if len(parts) == 1 else
                     {"dense": _stack(parts[0]), "moe": _stack(parts[1])})
    elif cfg.family == "audio":
        enc = _encode_audio(cfg, params, torch.as_tensor(
            batch["frames"], device=x.device))
        caches = []
        for lp in params["layers"]:
            x, c = _layer(_dec_block, lp, x, cfg, positions, enc, cfg=cfg)
            x = hints.constrain_tokens3d(x, cfg)
            if return_cache:
                caches.append(c)
        if return_cache:
            cache = _stack(caches)
    elif cfg.family == "ssm":
        caches = []
        for lp in params["layers"]:
            zero = _ssm_zero(cfg, lp, x.shape[0], x) if return_cache else None
            x, c, _ = _layer(_ssm_block, lp, x, cfg, zero, cfg=cfg)
            x = hints.constrain_tokens3d(x, cfg)
            if return_cache:
                caches.append(c)
        if return_cache:
            cache = _stack(caches)
    else:   # hybrid
        kv, states = [], []
        for lps in params["layers"]:
            # the shared block is never recomputed, as the reference's
            # super-block scan keeps it outside its checkpoint
            x, c, _ = _attn_mlp_block(params["shared_attn"], x, cfg,
                                      positions)
            inner = []
            for lp in lps:
                zero = (_ssm_zero(cfg, lp, x.shape[0], x) if return_cache
                        else None)
                x, s, _ = _layer(_ssm_block, lp, x, cfg, zero, cfg=cfg)
                x = hints.constrain_tokens3d(x, cfg)
                inner.append(s)
            x = hints.constrain_tokens3d(x, cfg)
            if return_cache:
                kv.append(c)
                states.append(inner)
        if return_cache:
            cache = {"attn": _stack(kv),
                     "ssm": _stack([_stack(inner) for inner in states])}
    x = norm_apply(params["final_norm"], x, cfg.norm, cfg.norm_eps)
    if last_only:
        x = x[:, -1:]
    if return_hidden:
        return x, cache, (aux, off)
    return unembed(params["embed"], x, cfg), cache, (aux, off)


def make_cache(cfg: ArchConfig, batch: int, seq: int, device="cpu"):
    """Zeroed static cache on ``device``, K / V and conv states in the
    compute dtype, ssm states in fp32: dense, vlm and moe {"k", "v": [L,
    B, S, Hkv, hd]}, S = min(seq, window) under a sliding window (a
    ring); MLA {"latent": [L, B, S, kv_lora], "k_rope": [L, B, S, rd]}; a
    MoE model with dense first layers {"dense": <its nd layers>, "moe":
    <the rest>}; ssm {"conv": [L, B, K-1, di], "ssm": [L, B, di, N]};
    hybrid {"attn": {"k", "v": [n_super, B, S, Hkv, hd]}, "ssm":
    {"conv": [n_super, ev, B, K-1, di+2N], "ssm": [n_super, ev, B, H,
    hd, N]}}; audio {"k", "v": [L, B, S, Hkv, hd], "ck", "cv": [L, B,
    enc_frames, Hkv, hd]} (the cross-attention's encoder K / V)."""
    _check_family(cfg, "serves")
    dt = dict(dtype=cfg.compute_dtype, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    kv = (batch, seq, cfg.kv_heads, cfg.head_dim)
    K, di, N = cfg.conv_width, cfg.d_inner_, cfg.ssm_state
    if cfg.family == "ssm":
        L = cfg.n_layers
        return {"conv": torch.zeros((L, batch, K - 1, di), **dt),
                "ssm": torch.zeros((L, batch, di, N), **f32)}
    if cfg.family == "hybrid":
        ev = cfg.hybrid_attn_every
        ns = cfg.n_layers // ev
        return {"attn": {k: torch.zeros((ns, *kv), **dt) for k in ("k", "v")},
                "ssm": {"conv": torch.zeros((ns, ev, batch, K - 1,
                                             di + 2 * N), **dt),
                        "ssm": torch.zeros((ns, ev, batch, cfg.ssm_heads,
                                            cfg.ssm_head_dim, N), **f32)}}
    if cfg.family == "audio":
        cross = (cfg.n_layers, batch, cfg.enc_frames, cfg.kv_heads,
                 cfg.head_dim)
        return {**_attn_cache(cfg, cfg.n_layers, batch, seq, dt),
                **{k: torch.zeros(cross, **dt) for k in ("ck", "cv")}}
    nd = _n_dense(cfg)
    if nd:
        return {"dense": _attn_cache(cfg, nd, batch, seq, dt),
                "moe": _attn_cache(cfg, cfg.n_layers - nd, batch, seq, dt)}
    return _attn_cache(cfg, cfg.n_layers, batch, seq, dt)


def _attn_cache(cfg: ArchConfig, n: int, batch: int, seq: int, dt: dict):
    """``n`` attention layers' zeroed cache: MLA's latent and k_rope, else
    K / V (a ring of min(seq, window) slots under a sliding window)."""
    if cfg.attn_kind == "mla":
        m = cfg.mla
        return {"latent": torch.zeros((n, batch, seq, m.kv_lora_rank), **dt),
                "k_rope": torch.zeros((n, batch, seq, m.qk_rope_head_dim),
                                      **dt)}
    S = min(seq, cfg.window) if cfg.attn_kind == "sliding" else seq
    return {k: torch.zeros((n, batch, S, cfg.kv_heads, cfg.head_dim), **dt)
            for k in ("k", "v")}


def cache_seq_axes(cfg: ArchConfig):
    """``make_cache``'s structure with each leaf's sequence axis, or -1
    for a state leaf (conv and ssm states, the encoder's cross K / V)
    whose shape does not grow with the sequence and is copied whole, for
    the static engine's cache growth."""
    _check_family(cfg, "serves")
    SEQ, STATE = 2, -1
    if cfg.family == "ssm":
        return {"conv": STATE, "ssm": STATE}
    if cfg.family == "hybrid":
        return {"attn": {"k": SEQ, "v": SEQ},
                "ssm": {"conv": STATE, "ssm": STATE}}
    if cfg.family == "audio":
        return {"k": SEQ, "v": SEQ, "ck": STATE, "cv": STATE}
    keys = ("latent", "k_rope") if cfg.attn_kind == "mla" else ("k", "v")
    axes = dict.fromkeys(keys, SEQ)
    if _n_dense(cfg):
        return {"dense": axes, "moe": dict(axes)}
    return axes


def _put(dst: dict, src: dict) -> None:
    for k in dst:
        dst[k].copy_(src[k])


def decode_step(cfg: ArchConfig, params: Params, cache, token, pos: int):
    """One static decode step: token [B,1] int, ``pos`` the position every
    row writes (a host int; the audio family's learned position ``pos``
    is added to the token).  Returns (logits [B,1,V], cache) with the
    cache updated in place."""
    _check_family(cfg, "serves")
    part = _partition(cfg)
    if part is not None:
        return _decode_tp(cfg, params, cache, token, pos, part)
    x = embed_tokens(params["embed"], token, cfg)
    if cfg.family == "audio":
        x = x + params["embed"]["pos"][pos:pos + 1].to(x.dtype)[None]
        for l, lp in enumerate(params["layers"]):
            cache_l = {k: v[l] for k, v in cache.items()}       # views
            x, _ = _dec_block(lp, x, cfg, None, cache=cache_l, pos=pos,
                              decode=True)
    elif cfg.family in ("dense", "vlm", "moe"):
        for layers, part in _attn_stacks(params, cache):
            for l, lp in enumerate(layers):
                cache_l = {k: v[l] for k, v in part.items()}    # views
                x, _, _ = _attn_mlp_block(lp, x, cfg, None, cache=cache_l,
                                          pos=pos, decode=True)
    elif cfg.family == "ssm":
        for l, lp in enumerate(params["layers"]):
            cache_l = {"conv": cache["conv"][l], "ssm": cache["ssm"][l]}
            x, new, _ = _ssm_block(lp, x, cfg, cache_l, decode=True)
            _put(cache_l, new)
    else:   # hybrid
        att, st = cache["attn"], cache["ssm"]
        for i, lps in enumerate(params["layers"]):
            cache_i = {"k": att["k"][i], "v": att["v"][i]}
            x, _, _ = _attn_mlp_block(params["shared_attn"], x, cfg, None,
                                      cache=cache_i, pos=pos, decode=True)
            for j, lp in enumerate(lps):
                cache_ij = {"conv": st["conv"][i, j], "ssm": st["ssm"][i, j]}
                x, new, _ = _ssm_block(lp, x, cfg, cache_ij, decode=True)
                _put(cache_ij, new)
    x = norm_apply(params["final_norm"], x, cfg.norm, cfg.norm_eps)
    return unembed(params["embed"], x, cfg), cache


def softmax_xent(logits, labels):
    """Per-token cross entropy in fp32: logsumexp minus the label logit."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    return lse - ll


def _chunk_ce(embed, h, labels, cfg, mask=None):
    xe = softmax_xent(unembed(embed, h, cfg), labels)
    return torch.sum(xe if mask is None else torch.where(mask, xe, 0.0))


def loss_fn(cfg: ArchConfig, params: Params, batch):
    """Mean next-token cross entropy over the text (a vlm's patch
    positions carry no label).  With ``cfg.loss_chunk`` the unembedding
    and CE run per sequence chunk (the largest divisor of the label
    length not above the chunk), each recomputed in the backward, so the
    [tokens, vocab] logits never exist at once.  On the "sp" strategy,
    where the sequence splits over "model", each rank scores its own
    positions (the last position, which has no next token, masked), in
    chunks of its own count, and the sum is all-reduced over "model"."""
    tokens = _tokens(params, batch)
    labels = tokens[:, 1:]
    B, T = labels.shape
    part = _partition(cfg)
    mask = None
    if part is not None and _sp_route(cfg) and part.seq_split(T + 1):
        labels = part.seq_shard(torch.cat([labels, tokens[:, :1]], 1), T + 1)
        mask = part.seq_shard(torch.arange(T + 1, device=tokens.device) < T,
                              T + 1, 0)
    n = labels.shape[1]
    chunk = cfg.loss_chunk
    if chunk:
        c = min(chunk, n)
        while n % c:
            c -= 1
        chunk = c if c > 1 else 0
    if not chunk and mask is None:
        logits, _, (aux, off) = forward(cfg, params, batch)
        lg = logits[:, off:off + T]
        ce = torch.mean(softmax_xent(lg, labels) if part is None
                        else _xent_tp(part, lg, labels, cfg))
        return ce + aux, {"ce": ce, "aux": aux}
    hidden, _, (aux, off) = forward(cfg, params, batch, return_hidden=True)
    if part is None:
        embed, ce_fn, args = params["embed"], _chunk_ce, (cfg,)
    elif mask is not None:   # the rank's positions, every vocab column
        embed, ce_fn, args = _unembed_unit(part, params, cfg), _chunk_ce, \
            (cfg,)
    else:   # every position on every rank; the unembedding gathered once
        hidden = part.tokens(hidden, off + T + 1)
        embed, ce_fn, args = _unembed_unit(part, params, cfg), \
            _chunk_ce_tp, (cfg, part)
    hs = hidden[:, off:off + n]
    total = hs.new_zeros((), dtype=torch.float32)
    step = chunk or n
    for c0 in range(0, n, step):
        a = (embed, hs[:, c0:c0 + step], labels[:, c0:c0 + step], *args,
             *(() if mask is None else (mask[c0:c0 + step],)))
        total = total + (checkpoint(ce_fn, *a, use_reentrant=False)
                         if chunk else ce_fn(*a))
    if mask is not None:
        total = part.sum_over_model(total)
    ce = total / (B * T)
    return ce + aux, {"ce": ce, "aux": aux}


# ------------------------------------------- the partitioned route
def _partition(cfg: ArchConfig):
    """The current ``Partition`` (the partitioned steps run every
    family)."""
    return partition.current()


def _sp_route(cfg: ArchConfig) -> bool:
    """Whether the partitioned route runs ``cfg``'s forward, decode and
    loss on the "sp" strategy (``_forward_sp``, ``_decode_sp``, the
    rank's positions in ``loss_fn``)."""
    return cfg.strategy == "sp"


def _embed_tp(part, params, tokens, cfg: ArchConfig, patches=None):
    """The token embeddings in the residual layout, vocab-parallel: each
    rank looks up the tokens of its vocab rows (zeros for the others)
    and the partial sums meet in the residual (exact: one rank holds
    each token's row); cast to the compute dtype after the sum.  A vlm's
    ``patches`` [B, P, d] (cast to the compute dtype; every model rank
    holds them) go ahead of the tokens in the same sum: rank 0 of
    "model" adds them and the others zeros, so one term a position is
    not zero and the residual holds P + S positions."""
    tok = part.gather({"tok": params["embed"]["tok"]},
                      {"tok": part.specs["embed"]["tok"]})["tok"]
    nv = tok.shape[0]
    tokens = tokens.long()
    if nv == cfg.vocab:
        e, layout = tok[tokens], "full"
    else:
        t = tokens - part.r * nv
        mine = (t >= 0) & (t < nv)
        e = torch.where(mine[..., None], tok[t.clamp(0, nv - 1)], 0.0)
        layout = "partial"
    if patches is not None:
        dt = torch.promote_types(e.dtype, cfg.compute_dtype)
        pe = patches.to(cfg.compute_dtype).to(dt)
        if layout == "partial" and part.r:
            pe = torch.zeros_like(pe)
        e = torch.cat([pe, e.to(dt)], dim=1)
    return part.residual(e, layout, e.shape[1]).to(cfg.compute_dtype)


def _unembed_unit(part, params, cfg: ArchConfig):
    """The unembedding's leaf gathered: a unit of its own."""
    key = "tok" if cfg.tie_embeddings else "out"
    return part.gather({key: params["embed"][key]},
                       {key: part.specs["embed"][key]})


def _xent_tp(part, logits, labels, cfg: ArchConfig):
    """``softmax_xent`` of the rank's vocab columns: the max and the
    exp sum all-reduced over "model" (the max carries no gradient), the
    label's logit from the rank that holds it.  Whole logits take
    ``softmax_xent`` itself."""
    nv = logits.shape[-1]
    if nv == cfg.vocab:
        return softmax_xent(logits, labels)
    lf = logits.float()
    mx = part.max_over_model(lf.amax(dim=-1, keepdim=True))
    t = labels.long() - part.r * nv
    mine = (t >= 0) & (t < nv)
    ll = torch.gather(lf, -1, t.clamp(0, nv - 1)[..., None])[..., 0]
    both = part.sum_over_model(torch.stack(
        [torch.exp(lf - mx).sum(dim=-1), torch.where(mine, ll, 0.0)]))
    return torch.log(both[0]) + mx[..., 0] - both[1]


def _chunk_ce_tp(ev, h, labels, cfg, part):
    return torch.sum(_xent_tp(part, unembed(ev, h, cfg), labels, cfg))


def _cache_shard(part, kv: dict, S: int, cfg: ArchConfig):
    """A layer's prefill cache (K / V, or MLA's latent / k_rope) of ``S``
    positions as the rank keeps it in ``make_cache``'s layout: every kv
    head (gathered over "model" where the rank computed its own), and its
    slots where their count divides the axis, as ``sharding.cache_specs``
    splits them.  Under a sliding window the cache is a ring of W =
    min(S, window) slots holding the last W positions, position p at
    slot p % W: where W < S each of the rank's slots takes the position
    that lands in it."""
    W = min(S, cfg.window) if cfg.attn_kind == "sliding" else S
    out = {}
    for name, t in kv.items():
        if name in ("k", "v") and t.shape[2] < cfg.kv_heads:
            t = part.comm.all_gather(t, ("model",), 2)
        if W < S:                   # the ring's slots: a copy
            slots = part.seq_shard(torch.arange(W, device=t.device), W, 0)
            t = t.index_select(1, S - W + (slots - (S - W)) % W)
        elif part.seq_split(S):     # a copy: the whole sequence is freed
            t = part.seq_shard(t, S).contiguous()
        out[name] = t
    return out


def _tp_stacks(part, params, cache=None):
    """``_attn_stacks`` with each stack's specs: (layers, specs, cache)."""
    keys = (("dense_layers", "layers") if "dense_layers" in params
            else ("layers",))
    return [(layers, part.specs[k], c) for k, (layers, c) in
            zip(keys, _attn_stacks(params, cache))]


def _ffn_tp(part, v, h, S: int):
    """A gathered layer's FFN on the rank's slice of ``h`` (every
    position): (its output in the residual layout, the aux loss).  The
    MLP on the rank's features; a MoE's routed experts on the rank's
    experts (``moe_apply_tp``), its shared experts an MLP, each sum
    rounded where ``moe_apply`` rounds it."""
    if "moe" not in v:
        m, lm = mlp_apply_tp(part, v["mlp"], h)
        return sl.add_row_bias(v["mlp"]["wo"], part.residual(m, lm, S)), 0.0
    y, ly, aux = moe_apply_tp(part, v["moe"], h, part.cfg)
    y = part.residual(y, ly, S)
    if "shared" in v["moe"]:
        shared = v["moe"]["shared"]
        m, lm = mlp_apply_tp(part, shared, h)
        y = y + sl.add_row_bias(shared["wo"], part.residual(m, lm, S))
    return y, aux


def _block_tp(part, lp, ls, x, positions, want_cache: bool, shared=None):
    """A dense or MoE layer (or the hybrid's shared block, ``shared`` its
    ``partition.SharedUses``) on the rank's shards: its leaves gathered
    over the dp axes, attention (GQA or MLA) on the rank's heads and the
    FFN on its features or experts, each product's result placed back in
    the residual layout.  Returns (x, the rank's cache of the layer or
    None, the aux loss)."""
    cfg = part.cfg
    S = positions.shape[0]
    v = part.gather(lp, ls, shared)
    hl = norm_apply(v["norm1"], x, cfg.norm, cfg.norm_eps)
    fwd = attn.mla_forward_tp if cfg.attn_kind == "mla" else \
        attn.gqa_forward_tp
    a, la, kv = fwd(part, v["attn"], part.tokens(hl, S), cfg,
                    positions=positions, local=hl)
    kv = dict(zip(("latent", "k_rope") if cfg.attn_kind == "mla"
                  else ("k", "v"), kv))
    x = x + sl.add_row_bias(v["attn"]["wo"], part.residual(a, la, S))
    h = part.tokens(norm_apply(v["norm2"], x, cfg.norm, cfg.norm_eps), S)
    m, aux = _ffn_tp(part, v, h, S)
    return (x + m, _cache_shard(part, kv, S, cfg) if want_cache else None,
            aux)


def _forward_tp(cfg: ArchConfig, params, batch, part, return_cache: bool,
                last_only: bool, return_hidden: bool):
    """``forward`` on the rank's shards (see the module docstring): the
    hidden state comes back in the residual layout (the rank's
    positions), logits as the rank's vocab columns of every position
    (the last one with ``last_only``).  A vlm's patches sit ahead of the
    text, which starts at position P (the returned offset)."""
    if _sp_route(cfg):
        return _forward_sp(cfg, params, batch, part, return_cache,
                           last_only, return_hidden)
    tokens = _tokens(params, batch)
    patches = None
    if cfg.family == "vlm" and "patches" in batch:
        patches = torch.as_tensor(batch["patches"], device=tokens.device)
    off = 0 if patches is None else patches.shape[1]
    S = off + tokens.shape[1]
    x = hints.constrain_tokens3d(_embed_tp(part, params, tokens, cfg,
                                           patches), cfg)
    positions = torch.arange(S, device=x.device)
    want = return_cache and not torch.is_grad_enabled()
    if cfg.family in ("ssm", "hybrid"):
        (x, cache), aux = _ssm_stack_tp(part, params, x, positions, want), 0.0
    else:
        x, cache, aux = _attn_stacks_tp(part, params, x, positions, want)
    fn = part.gather(params["final_norm"], part.specs["final_norm"])
    x = norm_apply(fn, x, cfg.norm, cfg.norm_eps)
    if last_only:
        x = part.last_position(x, S)
    if return_hidden:
        return x, cache, (aux, off)
    if not last_only:
        x = part.tokens(x, S)
    return (unembed(_unembed_unit(part, params, cfg), x, cfg), cache,
            (aux, off))


def _attn_stacks_tp(part, params, x, positions, want_cache: bool):
    """The dense, vlm and moe families' layers (a MoE model's dense
    first layers first) on the rank's shards, each recomputed in the
    backward under grad but the dense first layers, which the reference
    never recomputes: their activations are kept, their gathered leaves
    gathered again in the backward (``Partition.kept``).  Returns (x, the
    rank's cache in ``make_cache``'s structure or None, the summed aux
    loss)."""
    cfg = part.cfg
    grad = torch.is_grad_enabled()
    aux, parts = 0.0, []
    for layers, specs, _ in _tp_stacks(part, params):
        caches = []
        first = layers is not params["layers"]
        for lp, ls in zip(layers, specs):
            if grad and first:      # kept, its gathered leaves regathered
                with part.kept():
                    x, c, a = _block_tp(part, lp, ls, x, positions, False)
            elif grad:
                x, c, a = checkpoint(_block_tp, part, lp, ls, x, positions,
                                     False, use_reentrant=False)
            else:
                x, c, a = _block_tp(part, lp, ls, x, positions, want_cache)
            if not first:
                x = hints.constrain_tokens3d(x, cfg)
            caches.append(c)
            aux = aux + a
        parts.append(caches)
    cache = None
    if want_cache:
        cache = (_stack(parts[0]) if len(parts) == 1 else
                 {"dense": _stack(parts[0]), "moe": _stack(parts[1])})
    return x, cache, aux


def _ssm_block_tp(part, lp, ls, x, S: int, cache=None, decode=False):
    """A state-space layer on the rank's shards: its leaves gathered over
    the dp axes, every position gathered over "model" for the mixer
    (``mamba1_apply_tp`` / ``mamba2_apply_tp``: the rank's channels or
    heads), its output placed back in the residual layout.  Returns (x,
    the rank's shard of the layer's state: given a ``cache`` or in
    decode)."""
    cfg = part.cfg
    v = part.gather(lp, ls)
    h = part.tokens(norm_apply(v["norm"], x, cfg.norm, cfg.norm_eps), S)
    mix = mamba2_apply_tp if cfg.family == "hybrid" else mamba1_apply_tp
    y, ly, new = mix(part, v["ssm"], h, cfg, cache=cache, decode=decode)
    out = sl.add_row_bias(v["ssm"]["out_proj"], part.residual(y, ly, S))
    return x + out, new


def _ssm_stack_tp(part, params, x, positions, want_cache: bool):
    """The ssm family's layers, or the hybrid's super-blocks (the shared
    block through ``_block_tp`` at each use, its gradient summed over the
    uses before it is reduced: ``partition.SharedUses``), on the rank's
    shards, each Mamba layer recomputed in the backward under grad; the
    shared block is not, its activations kept and its gathered leaves
    gathered again (``Partition.kept``).  Returns (x, the rank's cache in
    ``make_cache``'s structure, or None)."""
    cfg, specs = part.cfg, part.specs
    S, B = positions.shape[0], x.shape[0]
    grad = torch.is_grad_enabled()

    def mamba(lp, ls, x):
        zero = _ssm_zero(cfg, lp, B, x) if want_cache else None
        x, c = _recomputed(_ssm_block_tp, part, lp, ls, x, S, zero)
        return hints.constrain_tokens3d(x, cfg), c

    if cfg.family == "ssm":
        caches = []
        for lp, ls in zip(params["layers"], specs["layers"]):
            x, c = mamba(lp, ls, x)
            caches.append(c)
        return x, _stack(caches) if want_cache else None
    shared = partition.SharedUses(len(params["layers"])) if grad else None
    kv, states = [], []
    for lps, lss in zip(params["layers"], specs["layers"]):
        with part.kept() if grad else contextlib.nullcontext():
            x, c, _ = _block_tp(part, params["shared_attn"],
                                specs["shared_attn"], x, positions,
                                want_cache, shared)
        inner = []
        for lp, ls in zip(lps, lss):
            x, st = mamba(lp, ls, x)
            inner.append(st)
        x = hints.constrain_tokens3d(x, cfg)
        kv.append(c)
        states.append(inner)
    if not want_cache:
        return x, None
    return x, {"attn": _stack(kv),
               "ssm": _stack([_stack(inner) for inner in states])}


def _decode_ssm_tp(part, lp, ls, x, cache_l):
    """A state-space layer's decode step on the rank's shards and its
    views of the layer's state (updated in place)."""
    x, new = _ssm_block_tp(part, lp, ls, x, 1, cache_l, decode=True)
    _put(cache_l, new)
    return x


def _decode_block_tp(part, lp, ls, x, cache_l, pos: int):
    """A dense or MoE layer's decode step on the rank's shards and its
    views of the layer's cache (updated in place); the gathered leaves
    die with the call."""
    cfg = part.cfg
    v = part.gather(lp, ls)
    h = norm_apply(v["norm1"], x, cfg.norm, cfg.norm_eps)
    step = attn.mla_decode_tp if cfg.attn_kind == "mla" else \
        attn.gqa_decode_tp
    a, la = step(part, v["attn"], h, cfg, cache_l, pos)
    x = x + sl.add_row_bias(v["attn"]["wo"], part.residual(a, la, 1))
    h = norm_apply(v["norm2"], x, cfg.norm, cfg.norm_eps)
    return x + _ffn_tp(part, v, h, 1)[0]


def _decode_tp(cfg: ArchConfig, params, cache, token, pos: int, part):
    """``decode_step`` on the rank's shards and its shard of the cache
    (updated in place): each layer gathered over the dp axes, the one
    token's residual replicated.  Returns (the rank's vocab columns of
    the logits, cache)."""
    if _sp_route(cfg):
        return _decode_sp(cfg, params, cache, token, pos, part)
    x = _embed_tp(part, params, token, cfg)
    specs = part.specs
    if cfg.family == "ssm":
        for l, (lp, ls) in enumerate(zip(params["layers"], specs["layers"])):
            x = _decode_ssm_tp(part, lp, ls, x,
                               {k: t[l] for k, t in cache.items()})
    elif cfg.family == "hybrid":
        att, st = cache["attn"], cache["ssm"]
        for i, (lps, lss) in enumerate(zip(params["layers"],
                                           specs["layers"])):
            x = _decode_block_tp(part, params["shared_attn"],
                                 specs["shared_attn"], x,
                                 {k: t[i] for k, t in att.items()}, pos)
            for j, (lp, ls) in enumerate(zip(lps, lss)):
                x = _decode_ssm_tp(part, lp, ls, x,
                                   {k: t[i, j] for k, t in st.items()})
    else:
        for layers, lspecs, c in _tp_stacks(part, params, cache):
            for l, (lp, ls) in enumerate(zip(layers, lspecs)):
                x = _decode_block_tp(part, lp, ls, x,
                                     {k: t[l] for k, t in c.items()}, pos)
    fn = part.gather(params["final_norm"], part.specs["final_norm"])
    x = norm_apply(fn, x, cfg.norm, cfg.norm_eps)
    return unembed(_unembed_unit(part, params, cfg), x, cfg), cache


# ------------------------------ the audio family on the "sp" strategy
def _embed_sp(part, params, tokens, pos: int = 0):
    """The rank's positions of the token embeddings with the learned
    positions from ``pos`` on added ("sp": the embedding whole on every
    rank, gathered over the dp axes as one unit)."""
    cfg = part.cfg
    e = part.gather({k: params["embed"][k] for k in ("tok", "pos")},
                    {k: part.specs["embed"][k] for k in ("tok", "pos")})
    S = tokens.shape[1]
    x = embed_tokens(e, part.seq_shard(tokens, S), cfg)
    at = part.seq_shard(e["pos"][pos:pos + S], S, 0)
    return x + at.to(x.dtype)[None]


def _enc_block_sp(part, lp, ls, x, F: int):
    """``_enc_block`` on the rank's frames of the ``F``: its leaves
    gathered over the dp axes, q on the rank's frames, k / v of every
    frame (``attention.gqa_forward_sp``), the MLP on the rank's frames
    (a fused junction's update gathers them over "model" where they are
    split over it)."""
    cfg = part.cfg
    v = part.gather(lp, ls, rows_over_model=part.seq_split(F))
    h = norm_apply(v["norm1"], x, cfg.norm, cfg.norm_eps)
    a, _ = attn.gqa_forward_sp(part, v["attn"], h, cfg, causal=False,
                               positions=torch.arange(F, device=x.device))
    x = x + a
    h = norm_apply(v["norm2"], x, cfg.norm, cfg.norm_eps)
    return x + mlp_apply_tp(part, v["mlp"], h)[0]


def _encode_sp(part, params, frames):
    """``_encode_audio`` on the rank's frames (every frame where their
    count does not divide "model"): [B, F / model, d]."""
    cfg = part.cfg
    F = frames.shape[1]
    x = part.seq_shard(frames.to(cfg.compute_dtype), F)
    x = x + part.seq_shard(sinusoidal_pos(F, cfg.d_model, x.dtype,
                                          x.device), F, 0)[None]
    enc = params["encoder"]
    for lp, ls in zip(enc["layers"], part.specs["encoder"]["layers"]):
        x = _recomputed(_enc_block_sp, part, lp, ls, x, F)
    n = part.gather(enc["norm"], part.specs["encoder"]["norm"])
    return norm_apply(n, x, cfg.norm, cfg.norm_eps)


def _dec_block_sp(part, lp, ls, x, positions, enc, F: int, want: bool):
    """``_dec_block`` on the rank's positions: its leaves gathered over
    the dp axes; self-attention's q on the rank's positions against k / v
    of every position; cross-attention's K / V projected on the rank's
    frames of the encoder output ``enc`` and gathered over "model"; the
    MLP on the rank's positions (a fused junction's update gathers them
    over "model" where they are split over it).  Returns (x, the rank's
    {"k", "v", "ck", "cv"} or None)."""
    cfg = part.cfg
    v = part.gather(lp, ls, rows_over_model=part.seq_split(
        positions.shape[0]))
    h = norm_apply(v["norm1"], x, cfg.norm, cfg.norm_eps)
    a, kv = attn.gqa_forward_sp(part, v["attn"], h, cfg, positions=positions)
    x = x + a
    h = norm_apply(v["norm_x"], x, cfg.norm, cfg.norm_eps)
    ckv = _cross_kv(v, enc, cfg)
    c, _ = attn.gqa_forward_sp(part, v["cross"], h, cfg, positions=positions,
                               kv=tuple(part.tokens(t, F) for t in ckv))
    x = x + c
    h = norm_apply(v["norm2"], x, cfg.norm, cfg.norm_eps)
    x = x + mlp_apply_tp(part, v["mlp"], h)[0]
    return x, (dict(zip(("k", "v", "ck", "cv"), kv + ckv)) if want
               else None)


def _forward_sp(cfg: ArchConfig, params, batch, part, return_cache: bool,
                last_only: bool, return_hidden: bool):
    """``forward`` of the audio family on the "sp" strategy: the decoder's
    residual on the rank's positions, the encoder's on its frames (each
    all of them where their count does not divide "model"), every layer
    recomputed in the backward under grad.  The logits are the rank's
    positions' (the last position's on every rank with ``last_only``),
    every vocab column; the cache is the rank's positions' K / V and its
    frames' cross K / V, as ``sharding.cache_specs`` splits them."""
    tokens = _tokens(params, batch)
    S = tokens.shape[1]
    positions = torch.arange(S, device=tokens.device)
    want = return_cache and not torch.is_grad_enabled()
    x = hints.constrain_tokens3d(_embed_sp(part, params, tokens), cfg)
    frames = torch.as_tensor(batch["frames"], device=x.device)
    enc = _encode_sp(part, params, frames)
    caches = []
    for lp, ls in zip(params["layers"], part.specs["layers"]):
        x, c = _recomputed(_dec_block_sp, part, lp, ls, x, positions, enc,
                           frames.shape[1], want)
        x = hints.constrain_tokens3d(x, cfg)
        caches.append(c)
    fn = part.gather(params["final_norm"], part.specs["final_norm"])
    x = norm_apply(fn, x, cfg.norm, cfg.norm_eps)
    if last_only:
        x = part.last_position(x, S)
    cache = _stack(caches) if want else None
    if return_hidden:
        return x, cache, (0.0, 0)
    return (unembed(_unembed_unit(part, params, cfg), x, cfg), cache,
            (0.0, 0))


def _dec_decode_sp(part, lp, ls, x, c, pos: int):
    """A decoder layer's decode step on the "sp" strategy and its views
    of the layer's cache ``c`` (updated in place); the gathered leaves
    die with the call."""
    cfg = part.cfg
    v = part.gather(lp, ls)
    h = norm_apply(v["norm1"], x, cfg.norm, cfg.norm_eps)
    x = x + attn.gqa_decode_tp(part, v["attn"], h, cfg,
                               {"k": c["k"], "v": c["v"]}, pos)[0]
    h = norm_apply(v["norm_x"], x, cfg.norm, cfg.norm_eps)
    x = x + attn.gqa_decode_tp(part, v["cross"], h, cfg,
                               {"k": c["ck"], "v": c["cv"]}, pos,
                               cross=True)[0]
    h = norm_apply(v["norm2"], x, cfg.norm, cfg.norm_eps)
    return x + mlp_apply_tp(part, v["mlp"], h)[0]


def _decode_sp(cfg: ArchConfig, params, cache, token, pos: int, part):
    """``decode_step`` of the audio family on the "sp" strategy: the token
    replicated over "model", so every product runs alike on each model
    rank; self-attention on the rank's sequence shard of the cache and
    cross-attention on its frames (``attention.gqa_decode_tp``).
    Returns (the logits, every vocab column, cache)."""
    x = _embed_sp(part, params, token, pos)
    for l, (lp, ls) in enumerate(zip(params["layers"],
                                     part.specs["layers"])):
        x = _dec_decode_sp(part, lp, ls, x,
                           {k: t[l] for k, t in cache.items()}, pos)
    fn = part.gather(params["final_norm"], part.specs["final_norm"])
    x = norm_apply(fn, x, cfg.norm, cfg.norm_eps)
    return unembed(_unembed_unit(part, params, cfg), x, cfg), cache


def paged_supported(cfg: ArchConfig) -> tuple[bool, str]:
    """(ok, reason): whether the paged decode path can serve ``cfg``."""
    if cfg.family not in ("dense", "moe"):
        return False, (f"family {cfg.family!r} carries non-seq cache state "
                       "(see cache_seq_axes) — static engine only")
    if cfg.attn_kind != "full":
        return False, (f"attn_kind {cfg.attn_kind!r} — paged decode covers "
                       "the full-attention GQA cache layout")
    if cfg.family == "moe" and cfg.moe.first_dense_layers:
        return False, "moe first_dense_layers splits the cache tree"
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
    return x + _ffn(lp, h, cfg)[0]


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
