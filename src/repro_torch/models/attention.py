"""Attention: grouped-query attention (full or sliding-window) and
DeepSeek-V2's multi-head latent attention (MLA).  GQA has the
full-sequence training and prefill path (``gqa_forward``), single-token
decode over a contiguous cache (``gqa_decode``, the static engine's) and,
over a block-paged KV cache, chunked prefill and single-token decode;
MLA the expanded form for training and prefill (``mla_forward``) and the
absorbed form for decode (``mla_decode``).  The audio family (whisper)
ropes nothing: its positions are added to the embeddings; its decoder's
cross-attention takes the encoder's K / V (``gqa_forward(kv_override=)``,
``gqa_decode(cross=True)``).

A contiguous cache of one layer is ``{"k": [B, S, Hkv, hd], "v": ...}``;
decode writes the new token's K / V at slot ``pos`` in place, or, under
a sliding window, in a ring of S = window slots at ``pos % S``.  MLA's
is the compressed ``{"latent": [B, S, kv_lora], "k_rope": [B, S, rd]}``.
The pool of one layer is ``{"k": [P, ps, Hkv, hd], "v": ...}``; token t
of a slot lives in page ``page_table[b, t // ps]`` at offset ``t % ps``.
Page 0 is the scratch page that free slots point at.  The pool is
updated in place.

The partitioned mesh steps (parallel/partition.py) run ``gqa_forward_tp``
on the rank's heads (the q / k / v products column-parallel where their
specs split them; a replicated k / v, as where the kv heads do not
divide the model axis, is projected on the rank's positions and gathered
over "model", and the rank takes the kv heads its q heads read) and
``gqa_decode_tp`` on the rank's sequence shard of the cache (a sliding
window's ring: its slots): q gathered over "model", every head attended
on the local slots, the shards merged by a log-sum-exp combine over
"model", and the rank's heads kept for ``wo``.  MLA likewise:
``mla_forward_tp`` on the rank's heads (the latent projected on the
rank's positions and gathered), ``mla_decode_tp`` on the rank's sequence
shard of the latent cache.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import sparse_linear as sl
from repro_torch.kernels import flash_attention as fa
from repro_torch.models.layers import norm_apply, norm_init, rope

NEG_INF = -1e30
Params = dict[str, Any]


def attn_init(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32,
              device="cpu", seed: int = 0) -> Params:
    d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.head_dim
    sp = cfg.sparsity
    if cfg.attn_kind == "mla":
        m = cfg.mla
        qk, lora = m.qk_nope_head_dim + m.qk_rope_head_dim, m.kv_lora_rank
        return {
            "wq": sl.init_linear(gen, d, H * qk, family="attn", sp=sp,
                                 dtype=dtype, device=device, seed=seed),
            "wkv_a": sl.init_dense(gen, d, lora + m.qk_rope_head_dim,
                                   dtype=dtype, device=device),
            "kv_norm": norm_init(lora, "rmsnorm", dtype, device),
            "wkv_b": sl.init_dense(gen, lora,
                                   H * (m.qk_nope_head_dim + m.v_head_dim),
                                   dtype=dtype, device=device),
            "wo": sl.init_linear(gen, H * m.v_head_dim, d, family="attn",
                                 sp=sp, dtype=dtype, device=device,
                                 seed=seed + 1),
        }
    return {
        "wq": sl.init_linear(gen, d, H * hd, family="attn", sp=sp,
                             bias=cfg.qkv_bias, dtype=dtype, device=device,
                             seed=seed),
        "wk": sl.init_dense(gen, d, Hkv * hd, bias=cfg.qkv_bias, dtype=dtype,
                            device=device),
        "wv": sl.init_dense(gen, d, Hkv * hd, bias=cfg.qkv_bias, dtype=dtype,
                            device=device),
        "wo": sl.init_linear(gen, H * hd, d, family="attn", sp=sp,
                             dtype=dtype, device=device, seed=seed + 1),
    }


def _split_heads(x, n_heads, hd):
    return x.reshape(*x.shape[:-1], n_heads, hd)


def chunked_attention(q, k, v, *, causal: bool, window: int = 0,
                      chunk: int = 1024, q_pos=None, kv_pos=None):
    """Online-softmax attention.  q [B,Sq,H,D]; k,v [B,Sk,Hkv,D].

    Walks KV chunks carrying (running max, normalizer, weighted sum) in
    fp32.  Scores are fp32 products of q and k; the probabilities are
    rounded to q's dtype before the PV product, which sums in fp32."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    scale = 1.0 / math.sqrt(D)
    chunk = min(chunk, Sk)
    dev = q.device
    if q_pos is None:
        q_pos = torch.arange(Sq, device=dev)
    if kv_pos is None:
        kv_pos = torch.arange(Sk, device=dev)
    pad = (-Sk) % chunk
    if pad:  # pad KV to a chunk multiple; the padding is masked below
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        kv_pos = torch.cat([kv_pos, torch.full((pad,), Sk + 10**9,
                                               dtype=kv_pos.dtype, device=dev)])
    q5 = q.reshape(B, Sq, Hkv, rep, D).float()
    m = torch.full((B, Hkv, rep, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Hkv, rep, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Hkv, rep, Sq, D), dtype=torch.float32, device=dev)
    for c0 in range(0, k.shape[1], chunk):
        kj = k[:, c0:c0 + chunk]
        vj = v[:, c0:c0 + chunk]
        pj = kv_pos[c0:c0 + chunk]
        s = torch.einsum("bqgrd,bkgd->bgrqk", q5, kj.float()) * scale
        mask = (pj <= Sk + 10**8)[None, None, None, None, :]
        if causal:
            mask = mask & (q_pos[None, None, None, :, None]
                           >= pj[None, None, None, None, :])
        if window:
            mask = mask & (q_pos[None, None, None, :, None]
                           - pj[None, None, None, None, :] < window)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        upd = torch.einsum("bgrqk,bkgd->bgrqd", p.to(q.dtype).float(),
                           vj.float())
        acc = acc * corr[..., None] + upd
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D)
    return out.to(q.dtype)


def decode_attention(q, k_cache, v_cache, pos):
    """q [B,1,H,D] against caches [B,S,Hkv,D] whose slots 0..pos hold
    tokens (scalar ``pos``) -> [B,1,H,D] in q's dtype.  A sliding
    window's ring of S = window slots has every slot valid once ``pos >=
    S``: the mask of slots past ``pos`` already keeps them all then, so
    the ring needs no mask of its own.  Scores are fp32 products of q
    and k, masked past ``pos`` with NEG_INF; the normalized
    probabilities are rounded to q's dtype before the fp32 PV product."""
    B, _, H, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    q5 = q.reshape(B, 1, Hkv, H // Hkv, D).float()
    s = torch.einsum("bqgrd,bkgd->bgrqk", q5, k_cache.float()) \
        * (1.0 / math.sqrt(D))
    valid = torch.arange(S, device=q.device) <= pos
    s = torch.where(valid, s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bgrqk,bkgd->bgrqd", p.to(q.dtype).float(),
                       v_cache.float())
    return out.reshape(B, 1, H, D).to(q.dtype)


def paged_kv_update(cache: dict, k_new, v_new, positions, page_table):
    """Write new KV rows into the paged pool, in place.

    k_new/v_new [B, S, Hkv, hd]; positions [B, S] absolute positions;
    page_table [B, maxp].  A position past the table's last page is sent
    to the scratch page 0, as is every row of a free slot.  Several rows
    may thus target the same (page 0, offset) cell and index_put_ leaves
    their order undefined; that is harmless only because page 0 is
    scratch that no live slot reads unmasked."""
    ps = cache["k"].shape[1]
    maxp = page_table.shape[1]
    positions = positions.long()
    slot_page = positions // ps
    pid = torch.gather(page_table.long(), 1, slot_page.clamp(max=maxp - 1))
    pid = torch.where(slot_page < maxp, pid, 0).reshape(-1)
    off = (positions % ps).reshape(-1)
    for key, new in (("k", k_new), ("v", v_new)):
        flat = new.reshape(-1, *new.shape[2:]).to(cache[key].dtype)
        cache[key].index_put_((pid, off), flat)
    return cache


def paged_decode_attention(q, k_pool, v_pool, page_table, seq_lens):
    """q [B,1,H,D] against the pool through ``flash_decode`` -> [B,1,H,D]."""
    B, _, H, D = q.shape
    rep = H // k_pool.shape[2]
    qf = q.reshape(B, k_pool.shape[2], rep, D).contiguous()
    out = fa.flash_decode(qf, k_pool, v_pool, page_table, seq_lens)
    return out.reshape(B, 1, H, D)


def _q(p: Params, x, cfg: ArchConfig):
    return _split_heads(sl.apply(p["wq"], x), cfg.n_heads, cfg.head_dim)


def _roped(cfg: ArchConfig) -> bool:
    """Whether q and k are roped: in every family but the audio one,
    whose positions are absolute and added to the embeddings."""
    return cfg.family != "audio"


def _qkv(p: Params, x, cfg: ArchConfig, positions):
    """q, k, v of ``x``, roped at ``positions`` where ``_roped``."""
    Hkv, hd = cfg.kv_heads, cfg.head_dim
    q = _q(p, x, cfg)
    k = _split_heads(sl.apply(p["wk"], x), Hkv, hd)
    v = _split_heads(sl.apply(p["wv"], x), Hkv, hd)
    if _roped(cfg):
        q = rope(q, positions, cfg.rope_theta, cfg.partial_rotary)
        k = rope(k, positions, cfg.rope_theta, cfg.partial_rotary)
    return q, k, v


def gqa_forward(p: Params, x, cfg: ArchConfig, *, positions,
                causal: bool = True, kv_override=None):
    """Self-attention over the whole sequence: x [B,S,d], positions [S].
    ``kv_override`` = (k, v) [B,Sk,Hkv,hd] (whisper's encoder K / V) makes
    it cross-attention: q alone comes from x, every key is visible and
    ``causal`` is ignored.  Returns (out [B,S,d], (k, v))."""
    B, S, _ = x.shape
    kv_pos = None
    if kv_override is None:
        q, k, v = _qkv(p, x, cfg, positions)
        kv_pos = positions
    else:
        q, (k, v), causal = _q(p, x, cfg), kv_override, False
    window = cfg.window if cfg.attn_kind == "sliding" else 0
    out = chunked_attention(q, k, v, causal=causal, window=window,
                            chunk=cfg.attn_chunk, q_pos=positions,
                            kv_pos=kv_pos)
    out = sl.apply(p["wo"], out.reshape(B, S, cfg.n_heads * cfg.head_dim))
    return out, (k, v)


def gqa_decode(p: Params, x, cfg: ArchConfig, cache: dict, pos: int,
               cross: bool = False):
    """Single-token decode of every row at position ``pos``: x [B,1,d],
    cache {"k", "v": [B,S,Hkv,hd]} holding positions 0..pos-1 (under a
    sliding window the last S of them, position t at slot t % S).  The
    new K / V (rope at ``pos``) go into slot ``pos`` (``pos % S``) in
    place; returns (out [B,1,d], cache).  With ``cross`` the cache is
    the encoder's K / V: read-only, every slot valid."""
    B = x.shape[0]
    if cross:
        S = cache["k"].shape[1]
        out = decode_attention(_q(p, x, cfg), cache["k"], cache["v"], S - 1)
        out = sl.apply(p["wo"], out.reshape(B, 1, cfg.n_heads * cfg.head_dim))
        return out, cache
    q, k_new, v_new = _qkv(p, x, cfg, torch.full((1,), pos,
                                                  device=x.device))
    S = cache["k"].shape[1]
    slot = pos % S if cfg.attn_kind == "sliding" else pos
    cache["k"][:, slot] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v_new[:, 0].to(cache["v"].dtype)
    out = decode_attention(q, cache["k"], cache["v"], pos)
    out = sl.apply(p["wo"], out.reshape(B, 1, cfg.n_heads * cfg.head_dim))
    return out, cache


def gqa_decode_paged(p: Params, x, cfg: ArchConfig, cache: dict, positions,
                     page_table):
    """Single-token decode for every slot.  x [B,1,d]; positions [B] —
    the slot's write position (the cache holds ``positions[b]`` tokens
    before the call); page_table [B, maxp].  The slot then attends over
    ``positions + 1`` tokens, so a free slot (position 0, all pages 0)
    reads one token of the scratch page; the engine discards that row."""
    B = x.shape[0]
    pos2d = positions[:, None]                                   # [B, 1]
    q, k_new, v_new = _qkv(p, x, cfg, pos2d)
    cache = paged_kv_update(cache, k_new, v_new, pos2d, page_table)
    out = paged_decode_attention(q, cache["k"], cache["v"], page_table,
                                 (positions + 1).to(torch.int32))
    out = sl.apply(p["wo"], out.reshape(B, 1, cfg.n_heads * cfg.head_dim))
    return out, cache


def gqa_prefill_paged(p: Params, x, cfg: ArchConfig, cache: dict, positions,
                      page_table):
    """Chunked prefill of one slot: x [1,C,d] (a fixed-size prompt chunk,
    maybe tail-padded), positions [C] absolute, page_table [1, maxp].
    Writes the chunk's KV, then attends causally over the slot's gathered
    pages (earlier chunks included); padded tail tokens land past the
    prompt and are overwritten by decode before they are ever unmasked."""
    B, C, _ = x.shape
    Hkv, hd = cfg.kv_heads, cfg.head_dim
    q, k_new, v_new = _qkv(p, x, cfg, positions)
    cache = paged_kv_update(cache, k_new, v_new, positions[None, :],
                            page_table)
    ps = cache["k"].shape[1]
    maxp = page_table.shape[1]
    rows = page_table[0].long()
    kg = cache["k"][rows].reshape(1, maxp * ps, Hkv, hd)
    vg = cache["v"][rows].reshape(1, maxp * ps, Hkv, hd)
    out = chunked_attention(q, kg, vg, causal=True, chunk=cfg.attn_chunk,
                            q_pos=positions,
                            kv_pos=torch.arange(maxp * ps, device=x.device))
    out = sl.apply(p["wo"], out.reshape(B, C, cfg.n_heads * hd))
    return out, cache


def _mla_dims(cfg: ArchConfig):
    m = cfg.mla
    return (m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim,
            m.kv_lora_rank)


def _mla_q(p: Params, x, cfg: ArchConfig, positions):
    """(q_nope, q_rope roped at ``positions``), each [B,S,H,.]."""
    nope, rd, _, _ = _mla_dims(cfg)
    q = _split_heads(sl.apply(p["wq"], x), cfg.n_heads, nope + rd)
    return q[..., :nope], rope(q[..., nope:], positions, cfg.rope_theta)


def _mla_latent(p: Params, x, cfg: ArchConfig, positions):
    """(latent [B,S,lora] rms-normed, k_rope [B,S,1,rd] roped)."""
    lora = cfg.mla.kv_lora_rank
    a = sl.apply_dense(p["wkv_a"], x)                       # [B,S,lora+rd]
    latent = norm_apply(p["kv_norm"], a[..., :lora], "rmsnorm", cfg.norm_eps)
    return latent, rope(a[..., lora:][:, :, None, :], positions,
                        cfg.rope_theta)


def mla_forward(p: Params, x, cfg: ArchConfig, *, positions):
    """Multi-head latent attention, expanded form (training and prefill):
    x [B,S,d], positions [S].  K and V come out of the latent through
    ``wkv_b``; v is zero-padded to the qk width for ``chunked_attention``
    and sliced after.  Returns (out [B,S,d], (latent [B,S,lora], k_rope
    [B,S,rd])) for the compressed cache."""
    B, S, _ = x.shape
    H = cfg.n_heads
    nope, rd, vd, _ = _mla_dims(cfg)
    q_nope, q_rope = _mla_q(p, x, cfg, positions)
    latent, k_rope = _mla_latent(p, x, cfg, positions)
    kvb = sl.apply_dense(p["wkv_b"], latent).reshape(B, S, H, nope + vd)
    k = torch.cat([kvb[..., :nope], k_rope.expand(B, S, H, rd)], -1)
    v = torch.nn.functional.pad(kvb[..., nope:], (0, nope + rd - vd))
    out = chunked_attention(torch.cat([q_nope, q_rope], -1), k, v,
                            causal=True, chunk=cfg.attn_chunk,
                            q_pos=positions, kv_pos=positions)[..., :vd]
    out = sl.apply(p["wo"], out.reshape(B, S, H * vd))
    return out, (latent, k_rope[:, :, 0, :])


def _rounded(t, dtype):
    """t rounded to ``dtype``: one of the absorbed decode's four rounding
    points, where the reference's einsums round their results."""
    return t.to(dtype)


def _einsum_as(eq, a, b, dtype):
    """An einsum summed in fp32 and rounded to ``dtype``."""
    return _rounded(torch.einsum(eq, a.float(), b.float()), dtype)


def mla_decode(p: Params, x, cfg: ArchConfig, cache: dict, pos: int):
    """Absorbed-form MLA decode of every row at position ``pos``: x
    [B,1,d], cache {"latent": [B,S,lora], "k_rope": [B,S,rd]} holding
    positions 0..pos-1.  The new latent and k_rope go into slot ``pos``
    in place; ``wkv_b``'s K half is absorbed into q and its V half
    applied after the latent-space PV product, so attention is scored
    against the latent directly.  Scores are fp32; q_abs, the
    probabilities, o_lat and the output are rounded to x's dtype, as the
    reference's einsums round them.  Returns (out [B,1,d], cache)."""
    B = x.shape[0]
    H = cfg.n_heads
    nope, rd, vd, lora = _mla_dims(cfg)
    at = torch.full((1,), pos, device=x.device)
    q_nope, q_rope = _mla_q(p, x, cfg, at)
    lat_new, kr_new = _mla_latent(p, x, cfg, at)
    lat, kr = cache["latent"], cache["k_rope"]
    lat[:, pos] = lat_new[:, 0].to(lat.dtype)
    kr[:, pos] = kr_new[:, 0, 0].to(kr.dtype)
    wkv_b = p["wkv_b"]["w"].reshape(lora, H, nope + vd).to(x.dtype)
    w_uk, w_uv = wkv_b[..., :nope], wkv_b[..., nope:]
    q_abs = _einsum_as("bqhn,lhn->bqhl", q_nope, w_uk, x.dtype)
    s = (torch.einsum("bqhl,bsl->bhqs", q_abs.float(), lat.float())
         + torch.einsum("bqhr,bsr->bhqs", q_rope.float(), kr.float()))
    s = s / math.sqrt(nope + rd)
    valid = torch.arange(lat.shape[1], device=x.device) <= pos
    s = torch.where(valid, s, NEG_INF)
    pr = _rounded(torch.softmax(s, dim=-1), x.dtype)
    o_lat = _einsum_as("bhqs,bsl->bqhl", pr, lat, x.dtype)
    out = _einsum_as("bqhl,lhv->bqhv", o_lat, w_uv, x.dtype)
    out = sl.apply(p["wo"], out.reshape(B, 1, H * vd))
    return out, cache


def _local_heads(part, t, layout: str, n_heads: int, hd: int):
    """(t as [..., heads, hd], the first head, the head count) for a q /
    k / v product in ``layout``: the rank's heads where the product is
    split on head boundaries, else every head (gathered if split)."""
    if layout == "split" and n_heads % part.m == 0:
        hl = n_heads // part.m
        return _split_heads(t, hl, hd), part.r * hl, hl
    t = part.full(t, layout)
    return _split_heads(t, n_heads, hd), 0, n_heads


def _kv_for(k, k0: int, hk: int, q0: int, hq: int, rep: int):
    """The kv heads that q heads [q0, q0 + hq) read (head h reads kv head
    h // rep), from k holding kv heads [k0, k0 + hk): a contiguous run
    where the q heads group evenly, else one kv head a q head."""
    if hq % rep == 0 or rep % hq == 0:
        a, b = q0 // rep, (q0 + hq - 1) // rep + 1
        return k[..., a - k0:b - k0, :]
    pick = torch.arange(q0, q0 + hq, device=k.device) // rep - k0
    return k[..., pick, :]


def _rep_seq(part, p: Params, local, positions, n_heads: int, hd: int,
             theta=None, partial: float = 1.0):
    """A replicated projection's product on the rank's positions
    (``local``, the residual layout), split into ``n_heads`` heads and
    roped at its positions where ``theta`` is given, then gathered over
    "model" (``Partition.tokens``): [B, S, n_heads, hd] on every rank."""
    S = positions.shape[0]
    t = _split_heads(sl.apply_tp(p, local, "full", part)[0], n_heads, hd)
    if theta is not None:
        t = rope(t, part.seq_shard(positions, S, 0), theta, partial)
    return part.tokens(t, S)


def gqa_forward_tp(part, p: Params, x, cfg: ArchConfig, *, positions,
                   local):
    """``gqa_forward`` on the rank's heads: x [B,S,d] with every position
    (``Partition.tokens`` of ``local``, the rank's positions in the
    residual layout), under the sliding window where ``cfg`` has one.  A
    replicated ``wk`` / ``wv`` (the kv heads do not divide "model")
    projects ``local``, and its products are gathered over "model", k
    roped at its positions first.  Returns (out, its layout, (k, v, k0)):
    out is ``wo``'s product (partial sums where ``wo`` is row-parallel),
    k / v [B,S,hk,hd] roped, with the kv heads the rank computed and the
    first one's index (for the prefill's cache)."""
    B, S, _ = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    q, lq = sl.apply_tp(p["wq"], x, "full", part)
    q, q0, hq = _local_heads(part, q, lq, H, hd)
    q = rope(q, positions, cfg.rope_theta, cfg.partial_rotary)
    if p["wk"]["_tp"] == "rep":   # every kv head, from the rank's positions
        k = _rep_seq(part, p["wk"], local, positions, Hkv, hd,
                     cfg.rope_theta, cfg.partial_rotary)
        v = _rep_seq(part, p["wv"], local, positions, Hkv, hd)
        k0, hk = 0, Hkv
    else:
        k, lk = sl.apply_tp(p["wk"], x, "full", part)
        v, lv = sl.apply_tp(p["wv"], x, "full", part)
        if hq < H:        # the rank's q heads; its kv heads, or every one
            k, k0, hk = _local_heads(part, k, lk, Hkv, hd)
            v, _, _ = _local_heads(part, v, lv, Hkv, hd)
        else:             # every q head here: every kv head too
            k, k0, hk = _split_heads(part.full(k, lk), Hkv, hd), 0, Hkv
            v = _split_heads(part.full(v, lv), Hkv, hd)
        k = rope(k, positions, cfg.rope_theta, cfg.partial_rotary)
    rep = H // Hkv
    window = cfg.window if cfg.attn_kind == "sliding" else 0
    out = chunked_attention(q, _kv_for(k, k0, hk, q0, hq, rep),
                            _kv_for(v, k0, hk, q0, hq, rep), causal=True,
                            window=window, chunk=cfg.attn_chunk,
                            q_pos=positions, kv_pos=positions)
    lo = "split" if hq < H else "full"
    y, ly = sl.apply_tp(p["wo"], out.reshape(B, S, hq * hd), lo, part)
    return y, ly, (k, v, k0)


def gqa_forward_sp(part, p: Params, x, cfg: ArchConfig, *, positions,
                   causal: bool = True, kv=None):
    """``gqa_forward`` on the "sp" strategy (every weight whole on every
    rank; whisper, which ropes nothing): x [B,n,d] the rank's share of
    the S = len(positions) positions (every one where S does not divide
    "model").  q on them; k / v projected on them and gathered over
    "model" (``Partition.tokens``), masked at their global positions;
    or ``kv`` = (k, v) of every key (cross-attention: ``causal``
    ignored).  Returns (out [B,n,d], (k, v) of the rank's positions, or
    ``kv``)."""
    B, n, _ = x.shape
    S = positions.shape[0]
    H, Hkv, hd = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    q = _split_heads(sl.apply_tp(p["wq"], x, "full", part)[0], H, hd)
    kv_pos = None
    if kv is None:
        kv = tuple(_split_heads(sl.apply_tp(p[w], x, "full", part)[0], Hkv,
                                hd) for w in ("wk", "wv"))
        k, v = (part.tokens(t, S) for t in kv)
        kv_pos = positions
    else:
        (k, v), causal = kv, False
    out = chunked_attention(q, k, v, causal=causal, chunk=cfg.attn_chunk,
                            q_pos=part.seq_shard(positions, S, 0),
                            kv_pos=kv_pos)
    y, _ = sl.apply_tp(p["wo"], out.reshape(B, n, H * hd), "full", part)
    return y, kv


def decode_attention_tp(part, q, k_cache, v_cache, pos, base: int):
    """``decode_attention`` over the rank's slots [base, base + S) of the
    cache, merged over "model": the global max (all-reduced), the local
    exp sums all-reduced, the probabilities normalized by the global sum
    and rounded to q's dtype before the fp32 PV product, whose partial
    sums are all-reduced.  q [B,1,H,D] holds every head."""
    B, _, H, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    q5 = q.reshape(B, 1, Hkv, H // Hkv, D).float()
    s = torch.einsum("bqgrd,bkgd->bgrqk", q5, k_cache.float()) \
        * (1.0 / math.sqrt(D))
    valid = base + torch.arange(S, device=q.device) <= pos
    s = torch.where(valid, s, NEG_INF)
    mx = part.max_over_model(s.amax(dim=-1, keepdim=True))
    p = torch.where(valid, torch.exp(s - mx), 0.0)
    p = p / part.sum_over_model(p.sum(dim=-1, keepdim=True))
    out = torch.einsum("bgrqk,bkgd->bgrqd", p.to(q.dtype).float(),
                       v_cache.float())
    out = part.sum_over_model(out)
    return out.reshape(B, 1, H, D).to(q.dtype)


def gqa_decode_tp(part, p: Params, x, cfg: ArchConfig, cache: dict,
                  pos: int, cross: bool = False):
    """``gqa_decode`` of every row at ``pos`` on the rank's cache: x
    [B,1,d] (replicated), cache {"k", "v": [B,S,Hkv,hd]}, the rank's
    sequence shard where ``part.cache_seq_split`` (slots [r S, (r+1) S))
    else every slot.  q, k, v are gathered over "model" (every head);
    only the rank that holds slot ``pos`` (under a sliding window ``pos
    % W`` of the ring's W slots, as ``gqa_decode`` writes it) writes the
    new K / V.  With ``cross`` the cache is whisper's encoder K / V,
    read-only and every slot valid: the rank's frames where it holds
    fewer than ``enc_frames`` (``sharding.cache_specs`` split them).
    Returns (out, its layout): ``wo``'s product on the rank's heads."""
    B = x.shape[0]
    H, Hkv, hd = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    at = torch.full((1,), pos, device=x.device)
    q, lq = sl.apply_tp(p["wq"], x, "full", part)
    q = _split_heads(part.full(q, lq), H, hd)
    S = cache["k"].shape[1]
    if cross:
        if S < cfg.enc_frames:
            out = decode_attention_tp(part, q, cache["k"], cache["v"],
                                      S * part.m - 1, part.r * S)
        else:
            out = decode_attention(q, cache["k"], cache["v"], S - 1)
        return sl.apply_tp(p["wo"], out.reshape(B, 1, H * hd), "full", part)
    k, lk = sl.apply_tp(p["wk"], x, "full", part)
    v, lv = sl.apply_tp(p["wv"], x, "full", part)
    k = _split_heads(part.full(k, lk), Hkv, hd)
    v = _split_heads(part.full(v, lv), Hkv, hd)
    if _roped(cfg):
        q = rope(q, at, cfg.rope_theta, cfg.partial_rotary)
        k = rope(k, at, cfg.rope_theta, cfg.partial_rotary)
    split = part.cache_seq_split and part.m > 1
    base = part.r * S if split else 0
    slot = pos % (S * part.m if split else S) \
        if cfg.attn_kind == "sliding" else pos
    if base <= slot < base + S:
        cache["k"][:, slot - base] = k[:, 0].to(cache["k"].dtype)
        cache["v"][:, slot - base] = v[:, 0].to(cache["v"].dtype)
    if split:
        out = decode_attention_tp(part, q, cache["k"], cache["v"], pos, base)
    else:
        out = decode_attention(q, cache["k"], cache["v"], pos)
    return sl.apply_tp(p["wo"], out.reshape(B, 1, H * hd), "full", part)


def _mla_heads(part, q, lq, kv, lkv, H: int, qd: int, kd: int):
    """q ([..., H * qd] products) and kv ([..., H * kd]) as [..., h, .]
    over the same heads [h0, h0 + h): the rank's where either product
    is split on head boundaries (the other, whole, cut to them), else
    every head.  Returns (q, kv, h0, h)."""
    q, q0, hq = _local_heads(part, q, lq, H, qd)
    kv, k0, hk = _local_heads(part, kv, lkv, H, kd)
    if hq == hk:
        return q, kv, q0, hq
    if hq < hk:
        return q, kv[..., q0:q0 + hq, :], q0, hq
    return q[..., k0:k0 + hk, :], kv, k0, hk


def mla_forward_tp(part, p: Params, x, cfg: ArchConfig, *, positions,
                   local):
    """``mla_forward`` on the rank's heads: x [B,S,d] with every position
    (``Partition.tokens`` of ``local``, the rank's positions in the
    residual layout).  ``wq`` and ``wkv_b`` are column-parallel on the
    rank's heads where the heads divide "model"; ``wkv_a`` and
    ``kv_norm`` are replicated, so each rank runs them on its positions
    and gathers the latent and the roped k_rope over "model".  Returns
    (out, its layout, (latent [B,S,lora], k_rope [B,S,rd])): out is
    ``wo``'s product (partial sums where ``wo`` is row-parallel)."""
    B, S, _ = x.shape
    H = cfg.n_heads
    nope, rd, vd, lora = _mla_dims(cfg)
    q, lq = sl.apply_tp(p["wq"], x, "full", part)
    a, _ = sl.apply_tp(p["wkv_a"], local, "full", part)
    latent = part.tokens(norm_apply(p["kv_norm"], a[..., :lora], "rmsnorm",
                                    cfg.norm_eps), S)
    k_rope = part.tokens(rope(a[..., lora:][:, :, None, :],
                              part.seq_shard(positions, S, 0),
                              cfg.rope_theta), S)
    kvb, lkv = sl.apply_tp(p["wkv_b"], latent, "full", part)
    q, kvb, _, hl = _mla_heads(part, q, lq, kvb, lkv, H, nope + rd,
                               nope + vd)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], positions,
                                       cfg.rope_theta)], -1)
    k = torch.cat([kvb[..., :nope], k_rope.expand(B, S, hl, rd)], -1)
    v = torch.nn.functional.pad(kvb[..., nope:], (0, nope + rd - vd))
    out = chunked_attention(q, k, v, causal=True, chunk=cfg.attn_chunk,
                            q_pos=positions, kv_pos=positions)[..., :vd]
    y, ly = sl.apply_tp(p["wo"], out.reshape(B, S, hl * vd),
                        "split" if hl < H else "full", part)
    return y, ly, (latent, k_rope[:, :, 0, :])


def mla_decode_tp(part, p: Params, x, cfg: ArchConfig, cache: dict,
                  pos: int):
    """``mla_decode`` of every row at ``pos`` on the rank's cache: x
    [B,1,d] (replicated), cache {"latent": [B,S,lora], "k_rope": [B,S,
    rd]}, the rank's sequence shard where ``part.cache_seq_split`` (slots
    [r S, (r+1) S)) else every slot; only the rank that holds slot
    ``pos`` writes the new latent.  q_abs and q_rope of the rank's heads
    are all-gathered over "model" ([B,1,H,lora+rd]), every head is
    scored on the rank's slots, and the shards merge by a log-sum-exp
    combine over "model" (the max all-reduced, the exp sums and the
    fp32 o_lat partial sums all-reduced; the probabilities and o_lat
    rounded where ``mla_decode`` rounds them); the rank's heads are kept
    for ``w_uv`` and ``wo``.  Returns (out, its layout)."""
    B = x.shape[0]
    H = cfg.n_heads
    nope, rd, vd, lora = _mla_dims(cfg)
    at = torch.full((1,), pos, device=x.device)
    q, lq = sl.apply_tp(p["wq"], x, "full", part)
    a, _ = sl.apply_tp(p["wkv_a"], x, "full", part)
    w = p["wkv_b"]["w"].to(x.dtype)             # [lora, the rank's heads]
    lw = "split" if w.shape[1] < H * (nope + vd) else "full"
    q, wkv, h0, hl = _mla_heads(part, q, lq, w, lw, H, nope + rd, nope + vd)
    lat, kr = cache["latent"], cache["k_rope"]
    S = lat.shape[1]
    split = part.cache_seq_split and part.m > 1
    base = part.r * S if split else 0
    if base <= pos < base + S:
        lat[:, pos - base] = norm_apply(p["kv_norm"], a[..., :lora],
                                        "rmsnorm", cfg.norm_eps)[:, 0].to(
                                            lat.dtype)
        kr[:, pos - base] = rope(a[..., lora:][:, :, None, :], at,
                                 cfg.rope_theta)[:, 0, 0].to(kr.dtype)
    w_uk, w_uv = wkv[..., :nope], wkv[..., nope:]
    q_abs = _einsum_as("bqhn,lhn->bqhl", q[..., :nope], w_uk, x.dtype)
    qa = torch.cat([q_abs, rope(q[..., nope:], at, cfg.rope_theta)], -1)
    if hl < H:                  # every head's [B,1,H,lora+rd]
        qa = part.comm.all_gather(qa, ("model",), 2)
    s = (torch.einsum("bqhl,bsl->bhqs", qa[..., :lora].float(), lat.float())
         + torch.einsum("bqhr,bsr->bhqs", qa[..., lora:].float(),
                        kr.float()))
    s = s / math.sqrt(nope + rd)
    valid = base + torch.arange(S, device=x.device) <= pos
    s = torch.where(valid, s, NEG_INF)
    if split:
        mx = part.max_over_model(s.amax(dim=-1, keepdim=True))
        e = torch.where(valid, torch.exp(s - mx), 0.0)
        pr = _rounded(e / part.sum_over_model(e.sum(dim=-1, keepdim=True)),
                      x.dtype)
        o_lat = _rounded(part.sum_over_model(torch.einsum(
            "bhqs,bsl->bqhl", pr.float(), lat.float())), x.dtype)
    else:
        pr = _rounded(torch.softmax(s, dim=-1), x.dtype)
        o_lat = _einsum_as("bhqs,bsl->bqhl", pr, lat, x.dtype)
    out = _einsum_as("bqhl,lhv->bqhv", o_lat[:, :, h0:h0 + hl], w_uv,
                     x.dtype)
    return sl.apply_tp(p["wo"], out.reshape(B, 1, hl * vd),
                       "split" if hl < H else "full", part)
