"""Block-sparse junction forward: the activation table, the plain
PyTorch version ``fwd_ref`` and the wrapper ``fwd`` of the CUDA kernel
``csrc/junction_fwd.cu``.

``fwd`` computes, for E junction units sharing one block pattern,

    y[e] = act(sum_k x[e][:, blk(idx[o, k])] @ w[e, o, k] + bias[e])

with fp32 accumulation, the bias widened from x's dtype, the activation
in fp32 and the result stored in x's dtype.  On a CPU tensor it runs
``fwd_ref``; on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

ACTIVATIONS = ("none", "relu", "sigmoid", "silu", "gelu")

_GELU_C = 0.7978845608028654  # sqrt(2/pi)
_GELU_A = 0.044715


def act_fwd(s: torch.Tensor, act: str) -> torch.Tensor:
    """Epilogue activation; gelu is the tanh approximation."""
    if act == "none":
        return s
    if act == "relu":
        return torch.clamp_min(s, 0.0)
    if act == "sigmoid":
        return torch.sigmoid(s)
    if act == "silu":
        return s * torch.sigmoid(s)
    if act == "gelu":
        u = _GELU_C * (s + _GELU_A * s * s * s)
        return 0.5 * s * (1.0 + torch.tanh(u))
    raise ValueError(f"unknown activation {act!r}")


def _check(x, w, idx, bias, act):
    if act not in ACTIVATIONS:
        raise ValueError(f"unknown activation {act!r}")
    if x.dim() != 3 or w.dim() != 5 or idx.dim() != 2 or bias.dim() != 2:
        raise ValueError("expected x [E,M,n_in], w [E,nob,kb,bs,bs], "
                         "idx [nob,kb], bias [E,n_out]")
    E, M, n_in = x.shape
    _, nob, kb, bs, bs2 = w.shape
    if (w.shape[0] != E or bs != bs2 or n_in % bs
            or tuple(idx.shape) != (nob, kb)
            or tuple(bias.shape) != (E, nob * bs)):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}, idx {tuple(idx.shape)}, "
                         f"bias {tuple(bias.shape)}")
    if w.dtype != x.dtype or bias.dtype != x.dtype:
        raise ValueError("w and bias must already be in x's dtype")
    if idx.dtype != torch.int32:
        raise ValueError("idx must be int32")


def fwd_ref(x, w, idx, bias, act: str = "none"):
    """Plain PyTorch version of the kernel: same operands, same
    rounding points (fp32 sum over the kb slots, bias widened from x's
    dtype, activation in fp32, one cast to x's dtype)."""
    _check(x, w, idx, bias, act)
    E, M, n_in = x.shape
    _, nob, kb, bs, _ = w.shape
    xb = x.reshape(E, M, n_in // bs, bs)
    acc = torch.zeros((E, M, nob, bs), dtype=torch.float32, device=x.device)
    for k in range(kb):
        xk = xb[:, :, idx[:, k].long(), :].float()          # [E, M, nob, bs]
        acc += torch.einsum("emob,eobc->emoc", xk, w[:, :, k].float())
    s = acc.reshape(E, M, nob * bs) + bias.float()[:, None, :]
    return act_fwd(s, act).to(x.dtype)


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_BLOCKS = (32, 64, 128)


def _kernel():
    from repro_torch.kernels import build
    lib = build.load("junction_fwd")
    fn = lib.junction_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fwd(x, w, idx, bias, act: str = "none"):
    """x [E, M, nib*bs], w [E, nob, kb, bs, bs], idx [nob, kb] int32,
    bias [E, nob*bs] -> y [E, M, nob*bs] in x's dtype.

    A CPU tensor runs ``fwd_ref``.  A CUDA tensor launches
    ``junction_fwd`` on the current stream (``fwd.launches`` counts
    those launches) or raises; any other device raises."""
    if x.device.type == "cpu":
        return fwd_ref(x, w, idx, bias, act)
    if x.device.type != "cuda":
        raise ValueError(f"junction fwd runs on cpu or cuda, not {x.device}")
    _check(x, w, idx, bias, act)
    E, M, n_in = x.shape
    _, nob, kb, bs, _ = w.shape
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"junction_fwd takes float32 or bfloat16, not {x.dtype}")
    if bs not in _BLOCKS:
        raise ValueError(f"junction_fwd takes block sizes {_BLOCKS}, not {bs}")
    for name, t in (("x", x), ("w", w), ("idx", idx), ("bias", bias)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    y = torch.empty((E, M, nob * bs), dtype=x.dtype, device=x.device)
    if M == 0:
        return y
    with torch.cuda.device(x.device):
        err = _kernel()(x.data_ptr(), w.data_ptr(), idx.data_ptr(),
                        bias.data_ptr(), y.data_ptr(), E, M, n_in // bs, nob,
                        kb, bs, ACTIVATIONS.index(act), _DTYPE_CODE[x.dtype],
                        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"junction_fwd launch failed: cudaError {err}")
    fwd.launches += 1
    return y


fwd.launches = 0
