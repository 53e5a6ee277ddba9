"""Attention kernels: the plain PyTorch versions and the wrappers of the
CUDA kernels ``csrc/flash_attention.cu`` and ``csrc/flash_decode.cu``.

``flash_attention`` (``attention_ref``): q [BH, Sq, D], k / v
[BHkv, Sk, D] (BH a multiple of BHkv; query row bh reads kv row
bh // (BH / BHkv)) -> [BH, Sq, D] in q's dtype.  Scores, probabilities
and the weighted sum in fp32, scale 1/sqrt(D); a key is valid when
kpos < Sk, with ``causal`` when qpos >= kpos and with ``window`` when
qpos - kpos < window (positions from 0 on both sides, so Sq != Sk aligns
the causal mask top-left).  A masked score is NEG_INF = -1e30, a finite
value: a query row with no valid key (only when Sq > Sk) averages V
uniformly over the Sk keys, as a softmax over its scores does.  ``mha``
takes [B, S, H, D] layouts.

``flash_decode`` (``paged_decode_ref``): q [B, Hkv, rep, D] (one query
token per slot, grouped by kv head), k_pool / v_pool [P, ps, Hkv, D]
(one layer's page pool), page_table [B, maxp] int32 (pool page ids in
token order), seq_lens [B] int32 (valid tokens per slot) ->
[B, Hkv, rep, D] in q's dtype.  Softmax in fp32; a slot with seq_len 0
gives exact zeros.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.device import plain_route as _route
from repro_torch.kernels import build

NEG_INF = -1e30
MAX_HEAD_DIM = 128        # the attention kernel's limit
# the plain attention walks query rows in chunks of at most this many
# fp32 scores, so that S = 8192 stays well inside the card's memory
_REF_SCORES = 1 << 28


def _check(q, k_pool, v_pool, page_table, seq_lens):
    if q.dim() != 4 or k_pool.dim() != 4:
        raise ValueError("expected q [B,Hkv,rep,D] and pools [P,ps,Hkv,D]")
    B, Hkv, rep, D = q.shape
    if (k_pool.shape != v_pool.shape or k_pool.shape[2:] != (Hkv, D)
            or page_table.dim() != 2 or page_table.shape[0] != B
            or tuple(seq_lens.shape) != (B,)):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, pools "
                         f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}, "
                         f"page_table {tuple(page_table.shape)}, "
                         f"seq_lens {tuple(seq_lens.shape)}")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise ValueError("pools must be in q's dtype")
    if page_table.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise ValueError("page_table and seq_lens must be int32")


def paged_decode_ref(q, k_pool, v_pool, page_table, seq_lens):
    """Plain PyTorch version: gather the slot's pages, masked softmax in
    fp32 over all of them at once."""
    _check(q, k_pool, v_pool, page_table, seq_lens)
    B, Hkv, rep, D = q.shape
    ps = k_pool.shape[1]
    maxp = page_table.shape[1]
    pt = page_table.long()
    kg = k_pool[pt].reshape(B, maxp * ps, Hkv, D).float()
    vg = v_pool[pt].reshape(B, maxp * ps, Hkv, D).float()
    scale = 1.0 / (D ** 0.5)
    s = torch.einsum("bgrd,bkgd->bgrk", q.float(), kg) * scale
    valid = (torch.arange(maxp * ps, device=q.device)[None, :]
             < seq_lens[:, None])                                    # [B, K]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bgrk,bkgd->bgrd", p / l.clamp_min(1e-30), vg)
    out = torch.where((seq_lens > 0)[:, None, None, None], out, 0.0)
    return out.to(q.dtype)


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _kernel():
    fn = build.load("flash_decode").flash_decode
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


# a split covers at most this many cached tokens, and the splits of all
# (slot, kv head) blocks aim at this many blocks an SM; the kernel's
# combine takes at most _MAX_SPLITS
_SPLIT_TOKENS = 128
_BLOCKS_PER_SM = 2
_MAX_SPLITS = 256


def decode_splits(B: int, Hkv: int, rep: int, ps: int, maxp: int,
                  n_sms: int) -> tuple[int, int]:
    """(nsplit, pages a split) of the ``flash_decode`` kernel, from shapes
    alone (never from seq_lens, which would sync the card): enough splits
    that a split holds at most ``_SPLIT_TOKENS`` tokens and that the grid
    has ``_BLOCKS_PER_SM`` blocks an SM, at least one page and at most
    ``_MAX_SPLITS`` splits."""
    blocks = B * Hkv * -(-rep // 8)          # (slot, kv head, 8 q heads)
    want = max(-(-maxp * ps // _SPLIT_TOKENS),
               -(-_BLOCKS_PER_SM * n_sms // blocks))
    pps = -(-maxp // min(maxp, _MAX_SPLITS, max(1, want)))
    return -(-maxp // pps), pps


@functools.lru_cache(maxsize=None)
def _n_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def flash_decode(q, k_pool, v_pool, page_table, seq_lens):
    """A CPU or meta tensor runs ``paged_decode_ref``.  A CUDA tensor launches
    the ``flash_decode`` kernel on the current stream
    (``flash_decode.launches`` counts those launches) or raises; any
    other device raises.  Page ids must lie in [0, P): the kernel reads
    them on the card without a check.  The split count comes from the
    shapes (``decode_splits``); the partials' scratch is a
    ``torch.empty`` of the call, the combine's tickets are the device's
    own (one stream at a time)."""
    if _route(q, "flash_decode"):
        return paged_decode_ref(q, k_pool, v_pool, page_table, seq_lens)
    _check(q, k_pool, v_pool, page_table, seq_lens)
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"flash_decode takes float32 or bfloat16, not {q.dtype}")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("page_table", page_table), ("seq_lens", seq_lens)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    B, Hkv, rep, D = q.shape
    ps = k_pool.shape[1]
    maxp = page_table.shape[1]
    if ps == 0:
        raise ValueError("flash_decode needs pages of at least one token")
    if B == 0 or maxp == 0:               # nothing cached: exact zeros
        return torch.zeros_like(q)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        nsplit, pps = decode_splits(B, Hkv, rep, ps, maxp,
                                    _n_sms(q.device.index))
        rows = B * Hkv * rep
        part = (torch.empty(rows * nsplit * (D + 2), dtype=torch.float32,
                            device=q.device) if nsplit > 1 else out)
        tickets = build.tickets(q.device, rows) if nsplit > 1 else out
        err = _kernel()(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                        page_table.data_ptr(), seq_lens.data_ptr(),
                        out.data_ptr(), part.data_ptr(), tickets.data_ptr(),
                        B, Hkv, rep, D, ps, maxp, nsplit, pps,
                        1.0 / (D ** 0.5), _DTYPE_CODE[q.dtype],
                        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_decode launch failed: cudaError {err}")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0


# ------------------------------------------------------------ flash_attention
def _check_attn(q, k, v, window):
    if q.dim() != 3 or k.dim() != 3:
        raise ValueError("expected q [BH,Sq,D] and k, v [BHkv,Sk,D]")
    BH, Sq, D = q.shape
    BHkv, Sk, _ = k.shape
    if (tuple(v.shape) != tuple(k.shape) or k.shape[2] != D or BHkv == 0
            or BH % BHkv):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if Sk == 0:
        raise ValueError("attention needs at least one key")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("k and v must be in q's dtype")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"attention takes float32 or bfloat16, not "
                         f"{q.dtype}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """Plain version: masked scores and a softmax in fp32 over all keys at
    once, query rows in chunks (each row's softmax is its own)."""
    _check_attn(q, k, v, window)
    BH, Sq, D = q.shape
    BHkv, Sk, _ = k.shape
    rep = BH // BHkv
    kf = k.float().repeat_interleave(rep, 0)
    vf = v.float().repeat_interleave(rep, 0)
    kpos = torch.arange(Sk, device=q.device)
    rows = max(1, _REF_SCORES // (BH * Sk))
    out = []
    for q0 in range(0, Sq, rows):
        qc = q[:, q0:q0 + rows].float()
        s = torch.einsum("hqd,hkd->hqk", qc, kf) * (1.0 / (D ** 0.5))
        qpos = torch.arange(q0, q0 + qc.shape[1], device=q.device)[:, None]
        mask = torch.ones((qc.shape[1], Sk), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= qpos >= kpos
        if window:
            mask &= qpos - kpos < window
        s = torch.where(mask, s, NEG_INF)
        out.append(torch.einsum("hqk,hkd->hqd", torch.softmax(s, -1), vf)
                   .to(q.dtype))
    return torch.cat(out, 1) if out else q.new_empty(q.shape)


def _attn_kernel():
    fn = build.load("flash_attention").flash_attention
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 \
        + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """A CPU or meta tensor runs ``attention_ref``.  A CUDA tensor launches the
    ``flash_attention`` kernel on the current stream
    (``flash_attention.launches`` counts those launches) or raises; any
    other device raises.  The kernel takes head_dim up to 128."""
    if _route(q, "flash_attention"):
        return attention_ref(q, k, v, causal=causal, window=window)
    _check_attn(q, k, v, window)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    BH, Sq, D = q.shape
    BHkv, Sk, _ = k.shape
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"the kernel takes head_dim 1..{MAX_HEAD_DIM}, "
                         f"not {D}")
    out = torch.empty_like(q)
    if BH == 0 or Sq == 0:
        return out
    with torch.cuda.device(q.device):
        err = _attn_kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             out.data_ptr(), BH, BH // BHkv, Sq, Sk, D,
                             int(causal), int(window),
                             _DTYPE_CODE[q.dtype], 1.0 / (D ** 0.5),
                             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def mha(q, k, v, *, causal: bool = True, window: int = 0):
    """q [B,Sq,H,D], k / v [B,Sk,Hkv,D] -> [B,Sq,H,D] through
    ``flash_attention`` (heads moved ahead of the sequence and back)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("expected q [B,Sq,H,D] and k, v [B,Sk,Hkv,D]")
    B, Sq, H, D = q.shape
    _, Sk, Hkv, _ = k.shape
    if k.shape[0] != B or k.shape[3] != D or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    qf = q.transpose(1, 2).reshape(B * H, Sq, D).contiguous()
    kf = k.transpose(1, 2).reshape(B * Hkv, Sk, D).contiguous()
    vf = v.transpose(1, 2).reshape(B * Hkv, Sk, D).contiguous()
    o = flash_attention(qf, kf, vf, causal=causal, window=window)
    return o.reshape(B, H, Sq, D).transpose(1, 2)
