"""Table lookup of fixed-point codes (the paper's BRAM sigmoid tables):
the plain PyTorch version ``lut_lookup_ref`` and the wrapper
``lut_lookup`` of the CUDA kernel ``csrc/sigmoid_lut.cu``.

codes [M, N] int32, table [T] fp32 -> table[codes] [M, N] fp32, with
the reference's fill rule (``jnp.take``'s default mode): a code in
[0, T) indexes the table, a code in [-T, 0) counts from its end, and any
other code gives NaN.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.device import plain_route as _route


def _check(codes, table):
    if codes.dim() != 2 or table.dim() != 1:
        raise ValueError(f"expected codes [M, N] and table [T], got "
                         f"{tuple(codes.shape)} and {tuple(table.shape)}")
    if codes.dtype != torch.int32:
        raise ValueError(f"codes must be int32, not {codes.dtype}")
    if table.dtype != torch.float32:
        raise ValueError(f"table must be float32, not {table.dtype}")
    if not 1 <= table.shape[0] < 2 ** 31:
        raise ValueError(f"table length {table.shape[0]} out of range")


def lut_lookup_ref(codes, table):
    """Plain version: the fill rule written out (no indexing that could
    raise on an out-of-range code)."""
    _check(codes, table)
    T = table.shape[0]
    c = codes.long()
    j = torch.where(c < 0, c + T, c)
    ok = (j >= 0) & (j < T)
    got = table[torch.where(ok, j, 0)]
    return torch.where(ok, got, torch.full_like(got, float("nan")))


def _kernel():
    from repro_torch.kernels import build
    fn = build.load("sigmoid_lut").lut_lookup
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def lut_lookup(codes, table):
    """A CPU or meta tensor runs ``lut_lookup_ref``.  A CUDA tensor launches the
    ``lut_lookup`` kernel on the current stream (``lut_lookup.launches``
    counts those launches) or raises; any other device raises."""
    if _route(codes, "lut_lookup"):
        return lut_lookup_ref(codes, table)
    _check(codes, table)
    if table.device != codes.device:
        raise ValueError(f"table is on {table.device}, codes on "
                         f"{codes.device}")
    if not (codes.is_contiguous() and table.is_contiguous()):
        raise ValueError("lut_lookup takes contiguous codes and table")
    out = torch.empty(codes.shape, dtype=torch.float32, device=codes.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(codes.device):
        err = _kernel()(codes.data_ptr(), table.data_ptr(), out.data_ptr(),
                        codes.numel(), table.shape[0],
                        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"lut_lookup launch failed: cudaError {err}")
    lut_lookup.launches += 1
    return out


lut_lookup.launches = 0
