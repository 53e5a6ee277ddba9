"""Fused Mamba-1 selective scan: the plain PyTorch version
``selective_scan_ref``, the wrapper ``selective_scan`` of the CUDA
kernel ``csrc/selective_scan.cu``, and its traffic model ``hbm_bytes``.

dt, x [B, S, di]; bc, cc [B, S, N]; a [di, N]; h0 [B, di, N]:

    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) outer B_t
    y_t = h_t . C_t

computed in fp32 whatever the inputs' types; returns (y [B, S, di] in
dt's dtype, h_last [B, di, N] fp32).  Any S and di; N up to 32.  The
kernel takes dt, x, bc and cc in one dtype (fp32 or bf16) and a, h0 in
fp32; the plain version any mix of the two.
"""
from __future__ import annotations

import ctypes

import torch

MAX_N = 32
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check(dt, x, bc, cc, a, h0):
    if dt.dim() != 3 or bc.dim() != 3 or a.dim() != 2 or h0.dim() != 3:
        raise ValueError("expected dt, x [B,S,di], bc, cc [B,S,N], a [di,N], "
                         "h0 [B,di,N]")
    B, S, di = dt.shape
    N = bc.shape[-1]
    if (tuple(x.shape) != (B, S, di) or tuple(bc.shape) != (B, S, N)
            or tuple(cc.shape) != (B, S, N) or tuple(a.shape) != (di, N)
            or tuple(h0.shape) != (B, di, N)):
        raise ValueError(
            f"shape mismatch: dt {tuple(dt.shape)}, x {tuple(x.shape)}, bc "
            f"{tuple(bc.shape)}, cc {tuple(cc.shape)}, a {tuple(a.shape)}, "
            f"h0 {tuple(h0.shape)}")
    if not 1 <= N <= MAX_N:
        raise ValueError(f"state size N = {N} outside [1, {MAX_N}]")
    for name, t in (("dt", dt), ("x", x), ("bc", bc), ("cc", cc), ("a", a),
                    ("h0", h0)):
        if t.dtype not in _DTYPE_CODE:
            raise ValueError(f"{name} must be float32 or bfloat16, not "
                             f"{t.dtype}")


def selective_scan_ref(dt, x, bc, cc, a, h0):
    """Plain version: the sequential recurrence of the reference's oracle
    (``kernels/ref.selective_scan``), one step a time, in fp32."""
    _check(dt, x, bc, cc, a, h0)
    dtf, xf, bf, cf = (t.float() for t in (dt, x, bc, cc))
    af = a.float()
    h = h0.float()
    ys = []
    for t in range(dt.shape[1]):
        decay = torch.exp(dtf[:, t, :, None] * af[None])          # [B,di,N]
        inp = (dtf[:, t] * xf[:, t])[..., None] * bf[:, t, None, :]
        h = decay * h + inp
        ys.append((h * cf[:, t, None, :]).sum(-1))
    y = torch.stack(ys, 1) if ys else dtf.new_zeros(dt.shape)
    return y.to(dt.dtype), h


def _kernel():
    from repro_torch.kernels import build
    fn = build.load("selective_scan").selective_scan
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def selective_scan(dt, x, bc, cc, a, h0):
    """A CPU tensor runs ``selective_scan_ref``.  A CUDA tensor launches
    the ``selective_scan`` kernel on the current stream
    (``selective_scan.launches`` counts those launches) or raises; any
    other device raises."""
    if dt.device.type == "cpu":
        return selective_scan_ref(dt, x, bc, cc, a, h0)
    if dt.device.type != "cuda":
        raise ValueError(f"selective_scan runs on cpu or cuda, not "
                         f"{dt.device}")
    _check(dt, x, bc, cc, a, h0)
    for name, t in (("x", x), ("bc", bc), ("cc", cc), ("a", a), ("h0", h0)):
        if t.device != dt.device:
            raise ValueError(f"{name} is on {t.device}, dt on {dt.device}")
    for name, t in (("dt", dt), ("x", x), ("bc", bc), ("cc", cc), ("a", a),
                    ("h0", h0)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not (x.dtype == bc.dtype == cc.dtype == dt.dtype
            and a.dtype == h0.dtype == torch.float32):
        raise ValueError("the kernel takes dt, x, bc and cc in one dtype "
                         "and a, h0 in float32")
    B, S, di = dt.shape
    N = bc.shape[-1]
    y = torch.empty((B, S, di), dtype=dt.dtype, device=dt.device)
    h_last = torch.empty((B, di, N), dtype=torch.float32, device=dt.device)
    if B * di == 0:
        return y, h_last
    with torch.cuda.device(dt.device):
        err = _kernel()(dt.data_ptr(), x.data_ptr(), bc.data_ptr(),
                        cc.data_ptr(), a.data_ptr(), h0.data_ptr(),
                        y.data_ptr(), h_last.data_ptr(), B, S, di, N,
                        _DTYPE_CODE[dt.dtype],
                        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"selective_scan launch failed: cudaError {err}")
    selective_scan.launches += 1
    return y, h_last


selective_scan.launches = 0


def hbm_bytes(B: int, S: int, di: int, N: int, elt: int = 4) -> int:
    """Device-memory traffic of the fused scan, each operand read or
    written once: dt, x and y [B,S,di], B and C [B,S,N], h0 and h_last
    [B,di,N], all of ``elt`` bytes."""
    return elt * (2 * B * S * di          # dt, x reads
                  + 2 * B * S * N         # B, C reads
                  + B * S * di            # y write
                  + 2 * B * di * N)       # h0 read + h_last write
