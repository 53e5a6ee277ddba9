"""Paged single-query decode attention: the plain PyTorch version
``paged_decode_ref`` and the wrapper ``flash_decode`` of the CUDA kernel
``csrc/flash_decode.cu``.

q [B, Hkv, rep, D] (one query token per slot, grouped by kv head),
k_pool / v_pool [P, ps, Hkv, D] (one layer's page pool), page_table
[B, maxp] int32 (pool page ids in token order), seq_lens [B] int32
(valid tokens per slot) -> [B, Hkv, rep, D] in q's dtype.  Softmax in
fp32; a slot with seq_len 0 gives exact zeros.
"""
from __future__ import annotations

import ctypes

import torch

NEG_INF = -1e30


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
    from repro_torch.kernels import build
    fn = build.load("flash_decode").flash_decode
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_decode(q, k_pool, v_pool, page_table, seq_lens):
    """A CPU tensor runs ``paged_decode_ref``.  A CUDA tensor launches
    the ``flash_decode`` kernel on the current stream
    (``flash_decode.launches`` counts those launches) or raises; any
    other device raises.  Page ids must lie in [0, P): the kernel reads
    them on the card without a check."""
    if q.device.type == "cpu":
        return paged_decode_ref(q, k_pool, v_pool, page_table, seq_lens)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode runs on cpu or cuda, not {q.device}")
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
    out = torch.empty_like(q)
    if B == 0:
        return out
    with torch.cuda.device(q.device):
        err = _kernel()(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                        page_table.data_ptr(), seq_lens.data_ptr(),
                        out.data_ptr(), B, Hkv, rep, D, ps, maxp,
                        1.0 / (D ** 0.5), _DTYPE_CODE[q.dtype],
                        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_decode launch failed: cudaError {err}")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
