"""Fused Mamba-1 selective scan: the plain PyTorch version
``selective_scan_ref``, the wrapper ``selective_scan`` of the CUDA
kernel ``csrc/selective_scan.cu``, its plan ``scan_plan`` and its
traffic model ``hbm_bytes``.

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

from repro_torch.device import plain_route as _route

MAX_N = 32
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# the kernel's shape (csrc/selective_scan.cu): threads a block, steps a
# ring stage, ring stages, states a lane at most
SCAN_THREADS, SCAN_STEPS, SCAN_STAGES, SCAN_MAX_NS = 128, 16, 3, 16
# the card's SMs, and the blocks of the scan one SM holds at once (its
# fp32 ring of 59.5 KB fits three times in the 227 KB of shared memory)
SCAN_SMS, SCAN_BLOCKS_PER_SM = 132, 3
# the shortest chunk of a split sequence, in steps
SCAN_MIN_CHUNK = 256


def scan_ns(N: int, nt: int) -> int:
    """States a lane holds when a channel's N states lie on nt lanes: N /
    nt rounded up to a power of two (lanes past N hold zeros)."""
    ns = 1
    while ns * nt < N:
        ns *= 2
    return ns


def scan_plan(B: int, S: int, di: int, N: int) -> tuple[int, int, int, int,
                                                        int]:
    """(nt, ns, ch, L, chunk) of one ``selective_scan`` call: nt lanes a
    channel holding ns states each (the fewest lanes that keep ns within
    SCAN_MAX_NS: a lane's states cost no shuffle), ch = SCAN_THREADS / nt
    channels a block, and the sequence in L chunks of ``chunk`` steps
    ((L - 1) * chunk < S <= L * chunk).  The sequence is split only where
    the unsplit grid has fewer blocks than the card has SMs, into as many
    chunks as one wave of resident blocks holds (SCAN_BLOCKS_PER_SM an
    SM), each at least SCAN_MIN_CHUNK steps: a split reruns the exps of
    all but its last chunk."""
    nt = 1
    while scan_ns(N, nt) > SCAN_MAX_NS:
        nt *= 2
    ch = SCAN_THREADS // nt
    blocks = B * -(-di // ch)
    L = 1
    if blocks < SCAN_SMS:
        L = min(SCAN_SMS * SCAN_BLOCKS_PER_SM // blocks, S // SCAN_MIN_CHUNK)
    return nt, scan_ns(N, nt), ch, *scan_chunks(S, L)


def scan_chunks(S: int, L: int) -> tuple[int, int]:
    """(L, chunk): S steps in at most L chunks of a whole number of ring
    stages, all full but the last ((L - 1) * chunk < S <= L * chunk; one
    chunk of one stage when S is 0)."""
    chunk = SCAN_STEPS * max(1, -(-S // (max(1, L) * SCAN_STEPS)))
    return max(1, -(-S // chunk)), chunk


def scratch_floats(B: int, di: int, N: int, L: int) -> int:
    """fp32 scratch of a split call: the L - 1 chunks' end states, then
    their exp products, [L - 1, B, di, N] each (none unsplit)."""
    return 2 * (L - 1) * B * di * N


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
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def selective_scan(dt, x, bc, cc, a, h0):
    """A CPU or meta tensor runs ``selective_scan_ref``.  A CUDA tensor launches
    the ``selective_scan`` kernel on the current stream at
    ``scan_plan``'s plan (three CUDA kernels when it splits the sequence,
    with their scratch a ``torch.empty`` of the call; one otherwise;
    ``selective_scan.launches`` counts one a call) or raises; any other
    device raises."""
    if _route(dt, "selective_scan"):
        return selective_scan_ref(dt, x, bc, cc, a, h0)
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
    nt, _, _, L, chunk = scan_plan(B, S, di, N)
    scratch = None
    if L > 1:
        scratch = torch.empty(scratch_floats(B, di, N, L),
                              dtype=torch.float32, device=dt.device)
    with torch.cuda.device(dt.device):
        err = _kernel()(dt.data_ptr(), x.data_ptr(), bc.data_ptr(),
                        cc.data_ptr(), a.data_ptr(), h0.data_ptr(),
                        y.data_ptr(), h_last.data_ptr(),
                        None if scratch is None else scratch.data_ptr(), B,
                        S, di, N, nt, L, chunk, _DTYPE_CODE[dt.dtype],
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
