"""Fixed-point matmul of integer codes: the plain PyTorch version
``qmatmul_ref`` and the wrapper ``qmatmul`` of the CUDA kernel
``csrc/fxp_qmatmul.cu``.

a [M, K] int32 codes, w [K, N] int32 codes -> [M, N] int32 codes:

    acc = sum_k a[m, k] * w[k, n]        (int32, wrapping as an int32 dot)
    out = clip((acc + 2^(bf-1)) >> bf,   (wrapping add, arithmetic shift)
               -2^(bn+bf), 2^(bn+bf) - 1)

the paper's one bit triplet (b_w, b_n, b_f) kept end to end: products
summed exactly, one round-half-up shift by b_f, saturation to the
triplet's range.  Any M, K, N (ragged shapes need no padding).
"""
from __future__ import annotations

import ctypes

import torch

# the plain version's float64 sums are exact while K * 2^32 < 2^53
MAX_K = 1 << 20


def _check(a_code, w_code, bf: int, bn: int):
    if a_code.dim() != 2 or w_code.dim() != 2:
        raise ValueError("expected a [M, K] and w [K, N]")
    if a_code.shape[1] != w_code.shape[0]:
        raise ValueError(f"shape mismatch: a {tuple(a_code.shape)}, w "
                         f"{tuple(w_code.shape)}")
    if a_code.dtype != torch.int32 or w_code.dtype != torch.int32:
        raise ValueError(f"codes must be int32, not {a_code.dtype} / "
                         f"{w_code.dtype}")
    if not (bf >= 1 and bn >= 0 and bn + bf <= 31):
        raise ValueError(f"need 1 <= bf and 0 <= bn with bn + bf <= 31, "
                         f"got bf={bf} bn={bn}")
    if a_code.shape[1] > MAX_K:
        raise ValueError(f"K = {a_code.shape[1]} > {MAX_K}")


def _wrap_i32(v):
    """int64 values wrapped into int32's range, as an int32 sum wraps."""
    return torch.remainder(v + 2 ** 31, 2 ** 32) - 2 ** 31


def qmatmul_ref(a_code, w_code, *, bf: int, bn: int):
    """Plain version, bit for bit the reference: the int32 dot taken
    modulo 2^32 from 16-bit halves (a = ah * 2^16 + al, al in
    [0, 2^16)): al.wl and ah.wl + al.wh summed exactly in float64 (the
    ah.wh term is a multiple of 2^32), then the wrapped round-half-up
    shift and the clip."""
    _check(a_code, w_code, bf, bn)
    a, w = a_code.long(), w_code.long()
    al, ah = (a & 0xFFFF).double(), (a >> 16).double()
    wl, wh = (w & 0xFFFF).double(), (w >> 16).double()
    lo_sum = (al @ wl).long()
    mid_sum = (ah @ wl + al @ wh).long()
    acc = _wrap_i32(lo_sum + (torch.remainder(mid_sum, 1 << 16) << 16))
    rounded = _wrap_i32(acc + (1 << (bf - 1))) >> bf
    lim = 1 << (bn + bf)
    return torch.clamp(rounded, -lim, lim - 1).to(torch.int32)


def _kernel():
    from repro_torch.kernels import build
    fn = build.load("fxp_qmatmul").fxp_qmatmul
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def qmatmul(a_code, w_code, *, bf: int, bn: int):
    """A CPU tensor runs ``qmatmul_ref``.  A CUDA tensor launches the
    ``fxp_qmatmul`` kernel on the current stream (``qmatmul.launches``
    counts those launches) or raises; any other device raises."""
    if a_code.device.type == "cpu":
        return qmatmul_ref(a_code, w_code, bf=bf, bn=bn)
    if a_code.device.type != "cuda":
        raise ValueError(f"qmatmul runs on cpu or cuda, not {a_code.device}")
    _check(a_code, w_code, bf, bn)
    if w_code.device != a_code.device:
        raise ValueError(f"w_code is on {w_code.device}, a_code on "
                         f"{a_code.device}")
    if not (a_code.is_contiguous() and w_code.is_contiguous()):
        raise ValueError("qmatmul takes contiguous codes")
    M, K = a_code.shape
    N = w_code.shape[1]
    out = torch.empty((M, N), dtype=torch.int32, device=a_code.device)
    if M == 0 or N == 0:
        return out
    with torch.cuda.device(a_code.device):
        err = _kernel()(a_code.data_ptr(), w_code.data_ptr(), out.data_ptr(),
                        M, K, N, bf, bn,
                        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fxp_qmatmul launch failed: cudaError {err}")
    qmatmul.launches += 1
    return out


qmatmul.launches = 0
