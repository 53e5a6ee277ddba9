"""Block-sparse junction kernels: the activation table, the hyp-column
registry, the plain PyTorch versions and the wrappers of the CUDA kernels
``csrc/junction_fwd.cu``, ``csrc/junction_dx.cu`` and
``csrc/junction_dw.cu``, each in a plain and a gated form, of their
tensor-core forms in ``csrc/junction_tc.cu`` (bf16; ``junction_variant``
routes), and of the quantized forwards of ``csrc/junction_quant.cu``.

For E junction units sharing one block pattern (idx [nob, kb] and its
reverse rev_ob / rev_t / rev_cnt [nib, fb]):

* ``fwd``       y[e] = act(sum_k x[e][:, blk(idx[o, k])] @ w[e, o, k] + bias[e])
                and, with ``save_pre``, the pre-activation s in x's dtype;
* ``dx``        dx[e][:, blk(i)] = sum_{f < rev_cnt[i]}
                    dz[:, blk(rev_ob[i, f])] @ w[e, rev_ob[i, f], rev_t[i, f]]^T;
* ``dw``        dw[e, o, k] = sum_m x[e][m, blk(idx[o, k])]^T dz[e][m, blk(o)]
                in fp32, plus db[e, o] = sum_m dz_f32 when biased;
* ``update_dw`` the dw reduction followed by one optimizer step
                (``_epilogue_step``) applied in place to w, b and the fp32
                slots, with an optional [E] count of non-finite (e, o) tiles.

The gated junction (the SwiGLU expert FFN) has two weight streams wg, wi
over one pattern and no bias or activation argument:

* ``gated_fwd``       h = silu(g) * u with g = x @ Wg, u = x @ Wi, both fp32
                      sums; with ``save_res`` g and u in x's dtype;
* ``gated_dx``        dx through both reverse weight streams from
                      dz_g = dh * u * silu'(g) and dz_u = dh * silu(g);
* ``gated_dw``        (dwg, dwi) in fp32;
* ``update_gated_dw`` the gated_dw reduction and one optimizer step on
                      both streams in place, a tile counted once when
                      either branch goes non-finite.

The quantized forwards (inference only; core/quantize.py makes the codes)
take integer weight codes and an fp32 bias:

* ``fwd_int8``       int8 codes with per-[nob, kb] scales against int8
                     activation codes made per slot (per row absmax / 127,
                     or a static per-unit x_scale), an exact integer dot
                     per slot, dequantized into an fp32 sum in slot order,
                     then bias and activation;
* ``gated_fwd_int8`` both gate branches from the same activation codes,
                     h = silu(g) * u;
* ``fwd_fxp``        the paper's fixed point: int32 triplet codes, an int32
                     sum (wrapping), a round-half-up shift by bf,
                     saturation, the bias code, then a lookup table that
                     holds the activation.

dz_g and dz_u are recomputed in fp32 from the saved g and u (rounded to
x's dtype) and rounded to dh's dtype before the products.

dz = (dy * act'(res)).astype(dy.dtype) is recomputed from the saved
residual (y for relu/sigmoid, the pre-activation for silu/gelu): it is
rounded to dy's dtype before the products, while db sums the fp32 value.
A padded reverse slot (f >= rev_cnt[i]) adds exactly nothing, whatever dy
holds.  On a CPU or meta tensor each wrapper runs its plain version; on a
CUDA tensor it launches its kernel (counting the launch) or raises.

Hyp columns: the per-unit ``[E, HYP_K]`` fp32 table the update reads row
e of — ``lr, b1, b2, eps, wd, t, gs``: learning rate; momentum (SGD) or
first-moment decay (Adam); second-moment decay; Adam's epsilon; decoupled
weight decay; Adam's 1-based step for bias correction; gradient pre-scale
(the global-norm clip folds in here).  The optimizer is chosen by which
fp32 slots ride along: none (SGD), mom (SGD+momentum), mom and vel
(Adam).  An all-zero row leaves w and b bit for bit unchanged.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.device import plain_route as _route
from repro_torch.kernels import fxp_qmatmul as fxk

ACTIVATIONS = ("none", "relu", "sigmoid", "silu", "gelu")
# activations whose gradient needs the pre-activation s (saved as a second
# forward output); relu and sigmoid rebuild their gradient from y itself
ACT_NEEDS_PRE = ("silu", "gelu")

HYP_COLS = ("lr", "b1", "b2", "eps", "wd", "t", "gs")
HYP_K = len(HYP_COLS)
COL_LR, COL_B1, COL_B2, COL_EPS, COL_WD, COL_T, COL_GS = range(HYP_K)

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


def act_bwd(res: torch.Tensor, act: str) -> torch.Tensor | None:
    """d act / d s from the residual: y for relu/sigmoid, s for silu/gelu;
    None for "none" (the caller skips the multiply)."""
    if act == "none":
        return None
    if act == "relu":
        return (res > 0.0).to(res.dtype)
    if act == "sigmoid":
        return res * (1.0 - res)
    if act == "silu":
        sg = torch.sigmoid(res)
        return sg * (1.0 + res * (1.0 - sg))
    if act == "gelu":
        s = res
        u = _GELU_C * (s + _GELU_A * s * s * s)
        t = torch.tanh(u)
        du = _GELU_C * (1.0 + 3.0 * _GELU_A * s * s)
        return 0.5 * (1.0 + t) + 0.5 * s * (1.0 - t * t) * du
    raise ValueError(f"unknown activation {act!r}")


def _acc(t: torch.Tensor) -> torch.dtype:
    """Accumulation dtype of the plain versions: fp32, or fp64 for fp64
    operands (gradient checks)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _dz(dy, res, act):
    """(dz in dy's dtype, dz before that rounding in the accumulation
    dtype)."""
    if act == "none":
        return dy, dy.to(_acc(dy))
    dzf = dy.to(_acc(dy)) * act_bwd(res.to(_acc(dy)), act)
    return dzf.to(dy.dtype), dzf


# ------------------------------------------------------------ validation
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check_fwd(x, w, idx, bias, act):
    """``bias`` None: the gated forward, which takes none."""
    if act not in ACTIVATIONS:
        raise ValueError(f"unknown activation {act!r}")
    if x.dim() != 3 or w.dim() != 5 or idx.dim() != 2 or (
            bias is not None and bias.dim() != 2):
        raise ValueError("expected x [E,M,n_in], w [E,nob,kb,bs,bs], "
                         "idx [nob,kb], bias [E,n_out]")
    E, M, n_in = x.shape
    _, nob, kb, bs, bs2 = w.shape
    if (w.shape[0] != E or bs != bs2 or n_in % bs
            or tuple(idx.shape) != (nob, kb)
            or (bias is not None and tuple(bias.shape) != (E, nob * bs))):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}, idx {tuple(idx.shape)}, "
                         f"bias {None if bias is None else tuple(bias.shape)}")
    if w.dtype != x.dtype or (bias is not None and bias.dtype != x.dtype):
        raise ValueError("w and bias must already be in x's dtype")
    if idx.dtype != torch.int32:
        raise ValueError("idx must be int32")


def _check_res(res, dy, act):
    if act == "none":
        return
    if res is None or tuple(res.shape) != tuple(dy.shape) \
            or res.dtype != dy.dtype:
        raise ValueError(f"act {act!r} needs a residual shaped and typed "
                         "like dy")


def _check_dx(dy, w, rev_ob, rev_t, rev_cnt, res, act):
    if act not in ACTIVATIONS:
        raise ValueError(f"unknown activation {act!r}")
    if dy.dim() != 3 or w.dim() != 5 or rev_ob.dim() != 2:
        raise ValueError("expected dy [E,M,nob*bs], w [E,nob,kb,bs,bs], "
                         "rev_ob [nib,fb]")
    E, _, n_out = dy.shape
    _, nob, _, bs, bs2 = w.shape
    nib, fb = rev_ob.shape
    if (w.shape[0] != E or bs != bs2 or n_out != nob * bs
            or tuple(rev_t.shape) != (nib, fb)
            or tuple(rev_cnt.shape) != (nib,)):
        raise ValueError(f"shape mismatch: dy {tuple(dy.shape)}, w "
                         f"{tuple(w.shape)}, rev_ob {tuple(rev_ob.shape)}")
    if w.dtype != dy.dtype:
        raise ValueError("w must already be in dy's dtype")
    for name, t in (("rev_ob", rev_ob), ("rev_t", rev_t),
                    ("rev_cnt", rev_cnt)):
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32")
    _check_res(res, dy, act)


def _check_dw(x, dy, idx, res, act):
    if act not in ACTIVATIONS:
        raise ValueError(f"unknown activation {act!r}")
    if x.dim() != 3 or dy.dim() != 3 or idx.dim() != 2:
        raise ValueError("expected x [E,M,n_in], dy [E,M,nob*bs], "
                         "idx [nob,kb]")
    E, M, n_in = x.shape
    nob = idx.shape[0]
    if (dy.shape[0] != E or dy.shape[1] != M or dy.shape[2] % nob
            or n_in % (dy.shape[2] // nob)):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, dy "
                         f"{tuple(dy.shape)}, idx {tuple(idx.shape)}")
    if x.dtype != dy.dtype:
        raise ValueError("x and dy must share a dtype")
    if idx.dtype != torch.int32:
        raise ValueError("idx must be int32")
    _check_res(res, dy, act)


def _check_pair(wg, wi):
    """The gate's second weight stream matches the first."""
    if wi.shape != wg.shape or wi.dtype != wg.dtype:
        raise ValueError(f"wi must be shaped and typed like wg: wg "
                         f"{tuple(wg.shape)} {wg.dtype}, wi "
                         f"{tuple(wi.shape)} {wi.dtype}")


def _check_u(u, g):
    if u is None or u.shape != g.shape or u.dtype != g.dtype:
        raise ValueError("the gated backward needs u shaped and typed like "
                         "g and dh")


def _check_cuda(lead, bs, blocks, name, **tensors):
    """Device, dtype, block size and contiguity checks before a launch;
    ``lead`` sets the device and the operand dtype."""
    dev = lead.device
    if lead.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name} takes float32 or bfloat16, not "
                         f"{lead.dtype}")
    if bs not in blocks:
        raise ValueError(f"{name} takes block sizes {blocks}, not {bs}")
    for tname, t in tensors.items():
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"{tname} is on {t.device}, not {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{tname} must be contiguous")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _kernel(lib: str, name: str, n_ptr: int, n_int: int):
    """The C entry ``name`` of kernel library ``lib`` (built at first
    use): ``n_ptr`` pointers, ``n_int`` ints, then the stream."""
    from repro_torch.kernels import build
    fn = getattr(build.load(lib), name)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


# ------------------------------------------------------------------- fwd
def fwd_ref(x, w, idx, bias, act: str = "none", save_pre: bool = False):
    """Plain PyTorch version of the forward kernel: same operands, same
    rounding points (fp32 sum over the kb slots, bias widened from x's
    dtype, activation in fp32, one cast to x's dtype).  Returns y, or
    (y, pre) with ``save_pre``."""
    _check_fwd(x, w, idx, bias, act)
    E, M, n_in = x.shape
    _, nob, kb, bs, _ = w.shape
    xb = x.reshape(E, M, n_in // bs, bs)
    at = _acc(x)
    acc = torch.zeros((E, M, nob, bs), dtype=at, device=x.device)
    for k in range(kb):
        xk = xb[:, :, idx[:, k].long(), :].to(at)            # [E, M, nob, bs]
        acc += torch.einsum("emob,eobc->emoc", xk, w[:, :, k].to(at))
    s = acc.reshape(E, M, nob * bs) + bias.to(at)[:, None, :]
    y = act_fwd(s, act).to(x.dtype)
    return (y, s.to(x.dtype)) if save_pre else y


_FWD_BLOCKS = (32, 64, 128)
# The tensor-core entry points (csrc/junction_tc.cu: bf16 wgmma, 128-row
# tiles) take bf16 junctions of at least TC_MIN_M rows; fp32 always goes
# to the SIMT kernels (no TF32).  On an H100 the tensor-core fwd beat the
# SIMT one at every shape timed from the 4 rows of a decode tick (one
# 128-row tile, mostly zeros) to 2048; at 1 row the SIMT kernel won at
# the 2560 -> 6912 junction (chip_smoke.route_phase; PERF.md §6).  The
# tensor-core gated_fwd won from 1 row on at qwen3-moe's gate junction,
# and dw, update_dw, update_gated_dw, gated_dx and gated_dw at the
# training rows; no path runs the backward kernels below 4 rows (an
# expert's capacity is at least 4), so one threshold serves all eight.
TC_MIN_M = 4
_TC_BLOCKS = (32, 64, 128)


def junction_variant(dtype: torch.dtype, M: int, bs: int) -> str:
    """The entry point the junction wrappers (``fwd``, ``dx``, ``dw``,
    ``update_dw`` and their gated forms) launch on a CUDA tensor: "tc"
    (``junction_*_tc``, bf16 on tensor cores) or "simt" (their
    ``junction_*`` entry points), from the operand dtype, the rows M and
    the block size alone (no host sync)."""
    if dtype == torch.bfloat16 and M >= TC_MIN_M and bs in _TC_BLOCKS:
        return "tc"
    return "simt"


def fwd(x, w, idx, bias, act: str = "none", save_pre: bool = False):
    """x [E, M, nib*bs], w [E, nob, kb, bs, bs], idx [nob, kb] int32,
    bias [E, nob*bs] -> y [E, M, nob*bs] in x's dtype, or (y, pre) with
    ``save_pre`` (pre = the pre-activation, in x's dtype).

    A CPU or meta tensor runs ``fwd_ref``.  A CUDA tensor launches, on the
    current stream, ``junction_fwd_tc`` or ``junction_fwd`` as
    ``junction_variant`` says, or raises; ``fwd.launches`` counts both,
    ``fwd.tc_launches`` the first.  Any other device raises."""
    if _route(x, "junction fwd"):
        return fwd_ref(x, w, idx, bias, act, save_pre)
    _check_fwd(x, w, idx, bias, act)
    E, M, n_in = x.shape
    _, nob, kb, bs, _ = w.shape
    _check_cuda(x, bs, _FWD_BLOCKS, "junction_fwd", x=x, w=w, idx=idx,
                bias=bias)
    y = torch.empty((E, M, nob * bs), dtype=x.dtype, device=x.device)
    pre = torch.empty_like(y) if save_pre else None
    if M:
        tc = junction_variant(x.dtype, M, bs) == "tc"
        name = "junction_fwd_tc" if tc else "junction_fwd"
        ptrs = (x.data_ptr(), w.data_ptr(), idx.data_ptr(), bias.data_ptr(),
                y.data_ptr(), _ptr(pre), E, M, n_in // bs, nob, kb, bs,
                ACTIVATIONS.index(act))
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            if tc:
                err = _kernel("junction_tc", name, 6, 7)(*ptrs, stream)
            else:
                err = _kernel("junction_fwd", name, 6, 8)(
                    *ptrs, _DTYPE_CODE[x.dtype], stream)
        _raise_on(err, name)
        fwd.launches += 1
        fwd.tc_launches += tc
    return (y, pre) if save_pre else y


fwd.launches = 0
fwd.tc_launches = 0


# ------------------------------------------------------------- gated fwd
def gated_fwd_ref(x, wg, wi, idx, save_res: bool = False):
    """Plain version of the gated forward kernel: the two fp32 sums over
    the kb slots side by side, h = silu(g) * u from the fp32 sums, one
    cast to x's dtype.  Returns h, or (h, g, u) with ``save_res`` (g and
    u rounded to x's dtype)."""
    _check_fwd(x, wg, idx, None, "silu")
    _check_pair(wg, wi)
    E, M, n_in = x.shape
    _, nob, kb, bs, _ = wg.shape
    xb = x.reshape(E, M, n_in // bs, bs)
    at = _acc(x)
    ag = torch.zeros((E, M, nob, bs), dtype=at, device=x.device)
    au = torch.zeros_like(ag)
    for k in range(kb):
        xk = xb[:, :, idx[:, k].long(), :].to(at)            # [E, M, nob, bs]
        ag += torch.einsum("emob,eobc->emoc", xk, wg[:, :, k].to(at))
        au += torch.einsum("emob,eobc->emoc", xk, wi[:, :, k].to(at))
    g = ag.reshape(E, M, nob * bs)
    u = au.reshape(E, M, nob * bs)
    h = (act_fwd(g, "silu") * u).to(x.dtype)
    return (h, g.to(x.dtype), u.to(x.dtype)) if save_res else h


def gated_fwd(x, wg, wi, idx, save_res: bool = False):
    """x [E, M, nib*bs], wg and wi [E, nob, kb, bs, bs] (x's dtype), idx
    [nob, kb] int32 -> h = silu(x @ Wg) * (x @ Wi) [E, M, nob*bs] in x's
    dtype, or (h, g, u) with ``save_res``.  x is read once for both
    branches.  CPU: ``gated_fwd_ref``; CUDA: ``junction_gated_fwd_tc`` or
    ``junction_gated_fwd`` as ``junction_variant`` says
    (``gated_fwd.launches`` counts both, ``gated_fwd.tc_launches`` the
    first)."""
    if _route(x, "junction gated_fwd"):
        return gated_fwd_ref(x, wg, wi, idx, save_res)
    _check_fwd(x, wg, idx, None, "silu")
    _check_pair(wg, wi)
    E, M, n_in = x.shape
    _, nob, kb, bs, _ = wg.shape
    _check_cuda(x, bs, _FWD_BLOCKS, "junction_gated_fwd", x=x, wg=wg, wi=wi,
                idx=idx)
    h = torch.empty((E, M, nob * bs), dtype=x.dtype, device=x.device)
    g = torch.empty_like(h) if save_res else None
    u = torch.empty_like(h) if save_res else None
    if M:
        tc = junction_variant(x.dtype, M, bs) == "tc"
        name = "junction_gated_fwd_tc" if tc else "junction_gated_fwd"
        ptrs = (x.data_ptr(), wg.data_ptr(), wi.data_ptr(), idx.data_ptr(),
                h.data_ptr(), _ptr(g), _ptr(u), E, M, n_in // bs, nob, kb,
                bs)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            if tc:
                err = _kernel("junction_tc", name, 7, 6)(*ptrs, stream)
            else:
                err = _kernel("junction_fwd", name, 7, 7)(
                    *ptrs, _DTYPE_CODE[x.dtype], stream)
        _raise_on(err, name)
        gated_fwd.launches += 1
        gated_fwd.tc_launches += tc
    return (h, g, u) if save_res else h


gated_fwd.launches = 0
gated_fwd.tc_launches = 0


# ------------------------------------------------------- quantized forward
# The int8 and fixed-point forwards of core/quantize.py's codes: forward
# only (inference), bias in fp32, output in x's dtype.
_QUANT_BLOCKS = (32, 64, 128)


def _check_quant(x, wq, idx, bias, code_dtype, name):
    if x.dim() != 3 or wq.dim() != 5 or idx.dim() != 2:
        raise ValueError(f"{name}: expected x [E,M,n_in], wq "
                         "[E,nob,kb,bs,bs], idx [nob,kb]")
    E, M, n_in = x.shape
    _, nob, kb, bs, bs2 = wq.shape
    if (wq.shape[0] != E or bs != bs2 or n_in % bs
            or tuple(idx.shape) != (nob, kb)):
        raise ValueError(f"{name}: shape mismatch: x {tuple(x.shape)}, wq "
                         f"{tuple(wq.shape)}, idx {tuple(idx.shape)}")
    if not x.is_floating_point():
        raise ValueError(f"{name}: x must be floating point, not {x.dtype}")
    if wq.dtype != code_dtype:
        raise ValueError(f"{name} takes {code_dtype} weight codes, not "
                         f"{wq.dtype}")
    if idx.dtype != torch.int32:
        raise ValueError("idx must be int32")
    if bias is not None and (bias.dtype != torch.float32
                             or tuple(bias.shape) != (E, nob * bs)):
        raise ValueError(f"{name}: bias must be fp32 [E, n_out] = "
                         f"{(E, nob * bs)}, got {bias.dtype} "
                         f"{tuple(bias.shape)}")


def _check_f32(t, shape, name):
    if t is not None and (t.dtype != torch.float32
                          or tuple(t.shape) != tuple(shape)):
        raise ValueError(f"{name} must be fp32 of shape {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")


def _check_int8(x, ws, idx, scales, bias, x_scale, name):
    for w in ws:
        _check_quant(x, w, idx, bias, torch.int8, name)
    if len(ws) == 2:
        _check_pair(*ws)
    E, nob, kb = ws[0].shape[:3]
    for s in scales:
        _check_f32(s, (E, nob, kb), f"{name}: w_scale")
    _check_f32(x_scale, (E,), f"{name}: x_scale")


# The int8 kernels' plan, from the shapes alone (no host read): which
# path, how many rows of x a block takes, how many consecutive fan-in
# slots, and so into how many blocks an output block's kb slots split.
# mma.sync takes block 128 from INT8_MMA_MIN_M rows, the crossover
# measured on the H100 (PERF.md; at stablelm-3b's FFN layer dp4a
# leads up to 16 rows, mma at 32; at qwen3-moe's 128 experts mma leads
# from 16); the dp4a path takes all other calls.  A block takes at most
# 8 rows on the dp4a path and 16 on the mma path (one row tile, its K
# split over the warps).  Slots split until the grid has _INT8_BLOCKS
# blocks (two a streaming multiprocessor of the H100), never finer than
# one slot a block; a block's activation codes stay within
# _INT8_XQ_BYTES of shared memory.
INT8_MMA_MIN_M = 32
_INT8_BLOCKS = 264
_INT8_XQ_BYTES = 64 << 10


def int8_variant(M: int, bs: int) -> str:
    """"mma" (block 128 from INT8_MMA_MIN_M rows) or "dp4a"."""
    return "mma" if bs == 128 and M >= INT8_MMA_MIN_M else "dp4a"


def int8_rows_pad(variant: str, rows: int) -> int:
    """The rows a block's tile holds for ``rows`` rows of x: 16 on the
    mma path, 4 or 8 on the dp4a path."""
    return 16 if variant == "mma" else (4 if rows <= 4 else 8)


def int8_plan(E: int, M: int, nob: int, kb: int, bs: int):
    """(variant, rows a block, slots a block, blocks an output block) of
    the int8 kernels for E units, M >= 1 rows, nob output blocks of kb
    slots at block bs; block s of an output block takes slots s * run ..
    min(kb, (s + 1) * run) - 1."""
    variant = int8_variant(M, bs)
    rows = min(M, 16 if variant == "mma" else 8)
    chunks = -(-M // rows)
    nsplit = max(1, min(kb, -(-_INT8_BLOCKS // (E * nob * chunks))))
    run = min(-(-kb // nsplit), max(1, _INT8_XQ_BYTES // (
        int8_rows_pad(variant, rows) * (bs + 16))))
    return variant, rows, run, -(-kb // run)


def _int8_launch_args(x, nbr, E, M, nob, kb, bs):
    """The plan's ints (mma, rows, run, nsplit) and the split's scratch
    and tickets (None unsplit) of one int8 launch."""
    variant, rows, run, nsplit = int8_plan(E, M, nob, kb, bs)
    part = tickets = None
    if nsplit > 1:
        chunks = -(-M // rows)
        part = torch.empty(nbr * E * chunks * nob * kb
                           * int8_rows_pad(variant, rows) * 128,
                           dtype=torch.float32, device=x.device)
        from repro_torch.kernels import build
        tickets = build.tickets(x.device, E * chunks * nob)
    return (int(variant == "mma"), rows, run, nsplit), part, tickets


def _check_codes_aligned(name, *codes):
    for w in codes:
        if w.data_ptr() % 16:
            raise ValueError(f"{name}: weight codes must be 16-byte aligned")


def _slot_scale(xk, x_scale):
    """The activation scale of one gathered fan-in slot: per row
    absmax / 127 (1 where the row is all zeros), or the static per-unit
    x_scale [E]."""
    if x_scale is None:
        ax = xk.abs().amax(dim=-1, keepdim=True)
        return torch.where(ax == 0.0, 1.0, true_div(ax, 127.0))
    return x_scale.float().reshape(-1, 1, 1, 1)


def unit_x_scale(x_scale, E: int):
    """A calibrated activation scale as the int8 kernels and their plain
    versions take it: None, or fp32 [E], one scale per unit (a scalar
    serves a single unit only; the reference refuses it for experts)."""
    if x_scale is None:
        return None
    xs = x_scale.float().reshape(-1).contiguous()
    if xs.numel() != E:
        raise ValueError(f"x_scale holds {xs.numel()} scale(s) for {E} "
                         f"units: calibrate one per unit")
    return xs


def true_div(t, v: float):
    """t / v rounded as IEEE division.  On the card PyTorch divides by a
    Python number as a multiply by its reciprocal, which may round the
    other way; divided by a tensor, it divides."""
    return t / torch.full_like(t, v)


def int8_sums(x, ws, idx, scales, x_scale):
    """The fp32 sums of one int8 junction per (codes, scales) pair over
    the kb slots, in slot order: per slot the activation codes, their dot
    with the weight codes (integers: exact in fp32 below 2^24) and the
    dequant by (sx * w_scale)."""
    E, M, n_in = x.shape
    _, nob, kb, bs, _ = ws[0].shape
    if 127 * 127 * bs >= 2 ** 24:
        raise ValueError(f"int8 block {bs}: its dots are not exact in fp32 "
                         f"(|dot| <= 127^2 * bs < 2^24 needs bs <= 1040)")
    xb = x.float().reshape(E, M, n_in // bs, bs)
    accs = [None] * len(ws)
    for k in range(kb):
        xk = xb[:, :, idx[:, k].long(), :]                   # [E, M, nob, bs]
        sx = _slot_scale(xk, x_scale)
        xq = torch.clamp(torch.round(xk / sx), -127, 127)
        for j, (w, sc) in enumerate(zip(ws, scales)):
            dot = torch.einsum("emob,eobc->emoc", xq, w[:, :, k].float())
            part = dot * (sx * sc[:, None, :, k, None])
            accs[j] = part if accs[j] is None else accs[j] + part
    return [a.reshape(E, M, nob * bs) for a in accs]


def fwd_int8_ref(x, wq, idx, w_scale, bias, act: str = "none",
                 x_scale=None):
    """Plain PyTorch version of the int8 forward kernel, op for op the
    reference's arithmetic (core/quantize._int8_apply): the fp32 sums of
    ``int8_sums``, the fp32 bias, the activation in fp32, one cast to
    x's dtype."""
    if act not in ACTIVATIONS:
        raise ValueError(f"unknown activation {act!r}")
    _check_int8(x, (wq,), idx, (w_scale,), bias, x_scale, "fwd_int8")
    (s,) = int8_sums(x, (wq,), idx, (w_scale,), x_scale)
    return act_fwd(s + bias[:, None, :], act).to(x.dtype)


def fwd_int8(x, wq, idx, w_scale, bias, act: str = "none", x_scale=None):
    """x [E, M, nib*bs] (fp32 / bf16), wq [E, nob, kb, bs, bs] int8, idx
    [nob, kb] int32, w_scale [E, nob, kb] fp32, bias [E, nob*bs] fp32,
    x_scale None (dynamic per-row activation scales) or [E] fp32 ->
    act(dequant(xq @ wq) + bias) [E, M, nob*bs] in x's dtype.
    CPU: ``fwd_int8_ref``; CUDA: ``junction_fwd_int8``
    (``fwd_int8.launches``)."""
    if _route(x, "junction fwd_int8"):
        return fwd_int8_ref(x, wq, idx, w_scale, bias, act, x_scale)
    if act not in ACTIVATIONS:
        raise ValueError(f"unknown activation {act!r}")
    _check_int8(x, (wq,), idx, (w_scale,), bias, x_scale, "fwd_int8")
    E, M, n_in = x.shape
    _, nob, kb, bs, _ = wq.shape
    _check_cuda(x, bs, _QUANT_BLOCKS, "junction_fwd_int8", x=x, wq=wq,
                idx=idx, w_scale=w_scale, bias=bias, x_scale=x_scale)
    _check_codes_aligned("junction_fwd_int8", wq)
    y = torch.empty((E, M, nob * bs), dtype=x.dtype, device=x.device)
    if M:
        with torch.cuda.device(x.device):
            plan, part, tickets = _int8_launch_args(x, 1, E, M, nob, kb, bs)
            err = _kernel("junction_quant", "junction_fwd_int8", 9, 12)(
                x.data_ptr(), wq.data_ptr(), idx.data_ptr(),
                w_scale.data_ptr(), bias.data_ptr(), _ptr(x_scale),
                y.data_ptr(), _ptr(part), _ptr(tickets), E, M, n_in // bs,
                nob, kb, bs, ACTIVATIONS.index(act), _DTYPE_CODE[x.dtype],
                *plan, torch.cuda.current_stream().cuda_stream)
        _raise_on(err, "junction_fwd_int8")
        fwd_int8.launches += 1
    return y


fwd_int8.launches = 0


def gated_fwd_int8_ref(x, wgq, wiq, idx, wg_scale, wi_scale, x_scale=None):
    """Plain version of the gated int8 kernel: one set of activation codes
    a slot for both branches, the two fp32 sums side by side, h =
    silu(g) * u from them, one cast to x's dtype."""
    _check_int8(x, (wgq, wiq), idx, (wg_scale, wi_scale), None, x_scale,
                "gated_fwd_int8")
    g, u = int8_sums(x, (wgq, wiq), idx, (wg_scale, wi_scale), x_scale)
    return (act_fwd(g, "silu") * u).to(x.dtype)


def gated_fwd_int8(x, wgq, wiq, idx, wg_scale, wi_scale, x_scale=None):
    """x [E, M, nib*bs], wgq and wiq [E, nob, kb, bs, bs] int8 with their
    [E, nob, kb] fp32 scales, idx [nob, kb] int32, x_scale None or [E]
    -> h = silu(x @ Wg) * (x @ Wi) [E, M, nob*bs] in x's dtype, both from
    the same activation codes.  CPU: ``gated_fwd_int8_ref``; CUDA:
    ``junction_gated_fwd_int8`` (``gated_fwd_int8.launches``)."""
    if _route(x, "junction gated_fwd_int8"):
        return gated_fwd_int8_ref(x, wgq, wiq, idx, wg_scale, wi_scale,
                                  x_scale)
    _check_int8(x, (wgq, wiq), idx, (wg_scale, wi_scale), None, x_scale,
                "gated_fwd_int8")
    E, M, n_in = x.shape
    _, nob, kb, bs, _ = wgq.shape
    _check_cuda(x, bs, _QUANT_BLOCKS, "junction_gated_fwd_int8", x=x,
                wgq=wgq, wiq=wiq, idx=idx, wg_scale=wg_scale,
                wi_scale=wi_scale, x_scale=x_scale)
    _check_codes_aligned("junction_gated_fwd_int8", wgq, wiq)
    h = torch.empty((E, M, nob * bs), dtype=x.dtype, device=x.device)
    if M:
        with torch.cuda.device(x.device):
            plan, part, tickets = _int8_launch_args(x, 2, E, M, nob, kb, bs)
            err = _kernel("junction_quant", "junction_gated_fwd_int8", 10,
                          11)(
                x.data_ptr(), wgq.data_ptr(), wiq.data_ptr(), idx.data_ptr(),
                wg_scale.data_ptr(), wi_scale.data_ptr(), _ptr(x_scale),
                h.data_ptr(), _ptr(part), _ptr(tickets), E, M, n_in // bs,
                nob, kb, bs, _DTYPE_CODE[x.dtype], *plan,
                torch.cuda.current_stream().cuda_stream)
        _raise_on(err, "junction_gated_fwd_int8")
        gated_fwd_int8.launches += 1
    return h


gated_fwd_int8.launches = 0


def _check_fxp(x, wq, idx, qfmt, lut, bias):
    _check_quant(x, wq, idx, bias, torch.int32, "fwd_fxp")
    if qfmt.dtype != torch.int32 or tuple(qfmt.shape) != (2,):
        raise ValueError("qfmt must be int32 [bf, bn]")
    T = lut.shape[0] if lut.dim() == 1 else 0
    if lut.dtype != torch.float32 or T < 2 or T & (T - 1):
        raise ValueError("lut must be fp32 with a power-of-two length "
                         f"(2^bw), got {lut.dtype} {tuple(lut.shape)}")


def fxp_plan(E: int, M: int, nob: int, kb: int, bs: int):
    """(output tiles, run, nsplit) of one ``junction_fwd_fxp`` launch:
    E * nob * ceil(M / 64) tiles of 64 rows and one output block, whose
    kb * bs / 32 K tiles (the slots' code rows in order) split over
    nsplit blocks of run K tiles (``fxp_qmatmul.split_plan``), from the
    shapes alone."""
    tiles = E * nob * -(-M // fxk.TILE_M)
    return (tiles, *fxk.split_plan(tiles, kb * bs // fxk.TILE_K))


def fwd_fxp_ref(x, wq, idx, qfmt, lut, bias):
    """Plain version of the fixed-point kernel, bit for bit the
    reference's integer pipeline (core/quantize._fxp_apply): the codes'
    products summed mod 2^32 as the int32 dot sums them (each slot's
    ``fxp_qmatmul.wrapped_dot``, exact for any int32 codes; the slots'
    sums added in int64 and wrapped), the round-half-up shift of the
    wrapped (acc + 2^(bf-1)), saturation, the bias code added and
    saturated again, the LUT.  Reads bf on the host."""
    _check_fxp(x, wq, idx, qfmt, lut, bias)
    E, M, n_in = x.shape
    _, nob, kb, bs, _ = wq.shape
    T = lut.shape[0]
    lim = T // 2
    bf = int(qfmt[0])
    scale = float(2 ** bf)
    xb = x.float().reshape(E, M, n_in // bs, bs)
    acc = torch.zeros((E, M, nob, bs), dtype=torch.int64, device=x.device)
    for k in range(kb):
        xk = xb[:, :, idx[:, k].long(), :]
        xq = torch.clamp(torch.round(xk * scale), -lim, lim - 1)
        acc = fxk.wrap_i32(acc + fxk.wrapped_dot(
            "emob,eobc->emoc", xq.long(), wq[:, :, k].long()))
    acc = acc.reshape(E, M, nob * bs)
    s = fxk.wrap_i32(acc + (1 << (bf - 1))) >> bf
    s = torch.clamp(s, -lim, lim - 1)
    bcode = torch.clamp(torch.round(bias * scale), -lim, lim - 1)
    s = torch.clamp(s + bcode.to(torch.int64)[:, None, :], -lim, lim - 1)
    return lut[torch.bitwise_and(s, T - 1)].to(x.dtype)


def fwd_fxp(x, wq, idx, qfmt, lut, bias):
    """x [E, M, nib*bs], wq [E, nob, kb, bs, bs] int32 triplet codes, idx
    [nob, kb] int32, qfmt [bf, bn] int32, lut [2^bw] fp32 (the activation
    baked in), bias [E, nob*bs] fp32 on the grid -> lut[...] [E, M,
    nob*bs] in x's dtype.  CPU: ``fwd_fxp_ref``; CUDA:
    ``junction_fwd_fxp`` at ``fxp_plan`` (``fwd_fxp.launches``), which
    reads bf from qfmt on the card."""
    if _route(x, "junction fwd_fxp"):
        return fwd_fxp_ref(x, wq, idx, qfmt, lut, bias)
    _check_fxp(x, wq, idx, qfmt, lut, bias)
    E, M, n_in = x.shape
    _, nob, kb, bs, _ = wq.shape
    _check_cuda(x, bs, _QUANT_BLOCKS, "junction_fwd_fxp", x=x, wq=wq,
                idx=idx, qfmt=qfmt, lut=lut, bias=bias)
    _check_codes_aligned("junction_fwd_fxp", wq)
    if x.data_ptr() % 16:         # the kernel copies x in 16-byte pieces
        x = x.clone()
    y = torch.empty((E, M, nob * bs), dtype=x.dtype, device=x.device)
    if M:
        with torch.cuda.device(x.device):
            tiles, run, nsplit = fxp_plan(E, M, nob, kb, bs)
            part = tickets = None
            if nsplit > 1:
                from repro_torch.kernels import build
                part = torch.empty(nsplit * tiles * fxk.TILE_M * bs,
                                   dtype=torch.int32, device=x.device)
                tickets = build.tickets(x.device, tiles)
            err = _kernel("junction_quant", "junction_fwd_fxp", 9, 10)(
                x.data_ptr(), wq.data_ptr(), idx.data_ptr(), qfmt.data_ptr(),
                lut.data_ptr(), bias.data_ptr(), y.data_ptr(), _ptr(part),
                _ptr(tickets), E, M, n_in // bs, nob, kb, bs, lut.shape[0],
                _DTYPE_CODE[x.dtype], run, nsplit,
                torch.cuda.current_stream().cuda_stream)
        _raise_on(err, "junction_fwd_fxp")
        fwd_fxp.launches += 1
    return y


fwd_fxp.launches = 0


# -------------------------------------------------------------------- dx
def dx_ref(dy, w, rev_ob, rev_t, rev_cnt, res=None, act: str = "none"):
    """Plain version of the dx kernel: dz rounded to dy's dtype, fp32 sum
    over the reverse slots, padded slots masked to exact zeros, one cast
    to dy's dtype."""
    _check_dx(dy, w, rev_ob, rev_t, rev_cnt, res, act)
    E, M, _ = dy.shape
    _, nob, _, bs, _ = w.shape
    nib, fb = rev_ob.shape
    dz, _ = _dz(dy, res, act)
    dzb = dz.reshape(E, M, nob, bs)
    at = _acc(dy)
    acc = torch.zeros((E, M, nib, bs), dtype=at, device=dy.device)
    for f in range(fb):
        ob = rev_ob[:, f].long()
        part = torch.einsum("emic,eiac->emia", dzb[:, :, ob, :].to(at),
                            w[:, ob, rev_t[:, f].long()].to(at))
        valid = (rev_cnt > f)[None, None, :, None]
        acc += torch.where(valid, part, 0.0)
    return acc.reshape(E, M, nib * bs).to(dy.dtype)


_BWD_BLOCKS = (32, 64, 128)


def dx(dy, w, rev_ob, rev_t, rev_cnt, res=None, act: str = "none"):
    """dy [E, M, nob*bs] -> dx [E, M, nib*bs] in dy's dtype, through the
    reverse pattern against the forward-layout w [E, nob, kb, bs, bs]
    (already in dy's dtype); res is the forward's residual (y for
    relu / sigmoid, the pre-activation for silu / gelu, unused for none).
    CPU: ``dx_ref``; CUDA: ``junction_dx_tc`` or ``junction_dx`` as
    ``junction_variant`` says (``dx.launches`` counts both,
    ``dx.tc_launches`` the first)."""
    if _route(dy, "junction dx"):
        return dx_ref(dy, w, rev_ob, rev_t, rev_cnt, res, act)
    _check_dx(dy, w, rev_ob, rev_t, rev_cnt, res, act)
    E, M, _ = dy.shape
    _, nob, kb, bs, _ = w.shape
    nib, fb = rev_ob.shape
    _check_cuda(dy, bs, _BWD_BLOCKS, "junction_dx", dy=dy, w=w,
                rev_ob=rev_ob, rev_t=rev_t, rev_cnt=rev_cnt, res=res)
    out = torch.empty((E, M, nib * bs), dtype=dy.dtype, device=dy.device)
    if M:
        tc = junction_variant(dy.dtype, M, bs) == "tc"
        name = "junction_dx_tc" if tc else "junction_dx"
        ptrs = (dy.data_ptr(), _ptr(res if act != "none" else None),
                w.data_ptr(), rev_ob.data_ptr(), rev_t.data_ptr(),
                rev_cnt.data_ptr(), out.data_ptr(), E, M, nob, kb, nib, fb,
                bs, ACTIVATIONS.index(act))
        with torch.cuda.device(dy.device):
            stream = torch.cuda.current_stream().cuda_stream
            if tc:
                err = _kernel("junction_tc", name, 7, 8)(*ptrs, stream)
            else:
                err = _kernel("junction_dx", name, 7, 9)(
                    *ptrs, _DTYPE_CODE[dy.dtype], stream)
        _raise_on(err, name)
        dx.launches += 1
        dx.tc_launches += tc
    return out


dx.launches = 0
dx.tc_launches = 0


# -------------------------------------------------------------- gated dx
def _gated_dz(dh, g, u):
    """(dz_g, dz_u) in dh's dtype: dh * u * silu'(g) and dh * silu(g),
    computed in the accumulation dtype from the rounded g and u."""
    at = _acc(dh)
    dhf, gf, uf = dh.to(at), g.to(at), u.to(at)
    return ((dhf * uf * act_bwd(gf, "silu")).to(dh.dtype),
            (dhf * act_fwd(gf, "silu")).to(dh.dtype))


def _check_gated_dx(dh, wg, wi, rev_ob, rev_t, rev_cnt, g, u):
    _check_dx(dh, wg, rev_ob, rev_t, rev_cnt, g, "silu")
    _check_pair(wg, wi)
    _check_u(u, g)


def gated_dx_ref(dh, wg, wi, rev_ob, rev_t, rev_cnt, g, u):
    """Plain version of the gated dx kernel: both branch gradients rounded
    to dh's dtype, both reverse weight streams summed per slot in fp32,
    padded slots masked to exact zeros, one cast to dh's dtype."""
    _check_gated_dx(dh, wg, wi, rev_ob, rev_t, rev_cnt, g, u)
    E, M, _ = dh.shape
    _, nob, _, bs, _ = wg.shape
    nib, fb = rev_ob.shape
    at = _acc(dh)
    dzg, dzu = (z.reshape(E, M, nob, bs) for z in _gated_dz(dh, g, u))
    acc = torch.zeros((E, M, nib, bs), dtype=at, device=dh.device)
    for f in range(fb):
        ob, t = rev_ob[:, f].long(), rev_t[:, f].long()
        part = (torch.einsum("emic,eiac->emia", dzg[:, :, ob, :].to(at),
                             wg[:, ob, t].to(at))
                + torch.einsum("emic,eiac->emia", dzu[:, :, ob, :].to(at),
                               wi[:, ob, t].to(at)))
        valid = (rev_cnt > f)[None, None, :, None]
        acc += torch.where(valid, part, 0.0)
    return acc.reshape(E, M, nib * bs).to(dh.dtype)


def gated_dx(dh, wg, wi, rev_ob, rev_t, rev_cnt, g, u):
    """dh [E, M, nob*bs] with the forward's residuals g, u (same shape and
    dtype) -> dx [E, M, nib*bs] in dh's dtype, through the reverse
    pattern against the forward-layout wg and wi (already in dh's dtype).
    CPU: ``gated_dx_ref``; CUDA: ``junction_gated_dx_tc`` or
    ``junction_gated_dx`` as ``junction_variant`` says
    (``gated_dx.launches`` counts both, ``gated_dx.tc_launches`` the
    first)."""
    if _route(dh, "junction gated_dx"):
        return gated_dx_ref(dh, wg, wi, rev_ob, rev_t, rev_cnt, g, u)
    _check_gated_dx(dh, wg, wi, rev_ob, rev_t, rev_cnt, g, u)
    E, M, _ = dh.shape
    _, nob, kb, bs, _ = wg.shape
    nib, fb = rev_ob.shape
    _check_cuda(dh, bs, _BWD_BLOCKS, "junction_gated_dx", dh=dh, wg=wg,
                wi=wi, rev_ob=rev_ob, rev_t=rev_t, rev_cnt=rev_cnt, g=g, u=u)
    out = torch.empty((E, M, nib * bs), dtype=dh.dtype, device=dh.device)
    if M:
        tc = junction_variant(dh.dtype, M, bs) == "tc"
        name = "junction_gated_dx_tc" if tc else "junction_gated_dx"
        ptrs = (dh.data_ptr(), g.data_ptr(), u.data_ptr(), wg.data_ptr(),
                wi.data_ptr(), rev_ob.data_ptr(), rev_t.data_ptr(),
                rev_cnt.data_ptr(), out.data_ptr(), E, M, nob, kb, nib, fb,
                bs)
        with torch.cuda.device(dh.device):
            stream = torch.cuda.current_stream().cuda_stream
            if tc:
                err = _kernel("junction_tc", name, 9, 7)(*ptrs, stream)
            else:
                err = _kernel("junction_dx", name, 9, 8)(
                    *ptrs, _DTYPE_CODE[dh.dtype], stream)
        _raise_on(err, name)
        gated_dx.launches += 1
        gated_dx.tc_launches += tc
    return out


gated_dx.launches = 0
gated_dx.tc_launches = 0


# -------------------------------------------------------------------- dw
def dw_ref(x, dy, idx, res=None, act: str = "none", with_bias: bool = True):
    """Plain version of the dw kernel: (dw [E, nob, kb, bs, bs] fp32,
    db [E, nob*bs] fp32 or None).  dw sums dz rounded to dy's dtype; db
    sums the unrounded fp32 dz."""
    _check_dw(x, dy, idx, res, act)
    E, M, n_in = x.shape
    nob, kb = idx.shape
    bs = dy.shape[2] // nob
    dz, dzf = _dz(dy, res, act)
    at = _acc(x)
    dzb = dz.reshape(E, M, nob, bs).to(at)
    xb = x.reshape(E, M, n_in // bs, bs)
    dwv = torch.empty((E, nob, kb, bs, bs), dtype=at, device=x.device)
    for k in range(kb):
        xk = xb[:, :, idx[:, k].long(), :].to(at)            # [E, M, nob, bs]
        dwv[:, :, k] = torch.einsum("emoa,emoc->eoac", xk, dzb)
    db = dzf.sum(dim=1) if with_bias else None
    return dwv, db


def dw(x, dy, idx, res=None, act: str = "none", with_bias: bool = True):
    """x [E, M, nib*bs], dy [E, M, nob*bs] -> (dw [E, nob, kb, bs, bs]
    fp32, db [E, nob*bs] fp32 or None).  CPU: ``dw_ref``; CUDA:
    ``junction_dw_tc`` or ``junction_dw`` as ``junction_variant`` says
    (``dw.launches`` counts both, ``dw.tc_launches`` the first).  The
    tensor-core dw sums in the order of ``junction_update_dw_tc``: the
    gradient a fused update steps, bit for bit."""
    if _route(x, "junction dw"):
        return dw_ref(x, dy, idx, res, act, with_bias)
    _check_dw(x, dy, idx, res, act)
    E, M, n_in = x.shape
    nob, kb = idx.shape
    bs = dy.shape[2] // nob
    _check_cuda(x, bs, _BWD_BLOCKS, "junction_dw", x=x, dy=dy, idx=idx,
                res=res)
    dwv = torch.empty((E, nob, kb, bs, bs), dtype=torch.float32,
                      device=x.device)
    db = (torch.empty((E, nob * bs), dtype=torch.float32, device=x.device)
          if with_bias else None)
    tc = junction_variant(x.dtype, M, bs) == "tc"
    name = "junction_dw_tc" if tc else "junction_dw"
    ptrs = (x.data_ptr(), dy.data_ptr(), _ptr(res if act != "none" else None),
            idx.data_ptr(), dwv.data_ptr(), _ptr(db), E, M, n_in // bs, nob,
            kb, bs, ACTIVATIONS.index(act))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if tc:
            err = _kernel("junction_tc", name, 6, 7)(*ptrs, stream)
        else:
            err = _kernel("junction_dw", name, 6, 8)(
                *ptrs, _DTYPE_CODE[x.dtype], stream)
    _raise_on(err, name)
    dw.launches += 1
    dw.tc_launches += tc
    return dwv, db


dw.launches = 0
dw.tc_launches = 0


# -------------------------------------------------------------- gated dw
def _check_gated_dw(x, dh, idx, g, u):
    _check_dw(x, dh, idx, g, "silu")
    _check_u(u, g)


def gated_dw_ref(x, dh, idx, g, u):
    """Plain version of the gated dw kernel: (dwg, dwi) [E, nob, kb, bs,
    bs] fp32, each an fp32 sum over M of x against its branch gradient
    rounded to dh's dtype."""
    _check_gated_dw(x, dh, idx, g, u)
    E, M, n_in = x.shape
    nob, kb = idx.shape
    bs = dh.shape[2] // nob
    at = _acc(x)
    dzg, dzu = (z.reshape(E, M, nob, bs).to(at) for z in _gated_dz(dh, g, u))
    xb = x.reshape(E, M, n_in // bs, bs)
    dwg = torch.empty((E, nob, kb, bs, bs), dtype=at, device=x.device)
    dwi = torch.empty_like(dwg)
    for k in range(kb):
        xk = xb[:, :, idx[:, k].long(), :].to(at)            # [E, M, nob, bs]
        dwg[:, :, k] = torch.einsum("emoa,emoc->eoac", xk, dzg)
        dwi[:, :, k] = torch.einsum("emoa,emoc->eoac", xk, dzu)
    return dwg, dwi


def gated_dw(x, dh, idx, g, u):
    """x [E, M, nib*bs], dh, g, u [E, M, nob*bs] -> (dwg, dwi)
    [E, nob, kb, bs, bs] fp32.  CPU: ``gated_dw_ref``; CUDA:
    ``junction_gated_dw_tc`` or ``junction_gated_dw`` as
    ``junction_variant`` says (``gated_dw.launches`` counts both,
    ``gated_dw.tc_launches`` the first).  The tensor-core gated_dw sums
    in the order of ``junction_update_gated_dw_tc``: the gradients a
    fused gated update steps, bit for bit."""
    if _route(x, "junction gated_dw"):
        return gated_dw_ref(x, dh, idx, g, u)
    _check_gated_dw(x, dh, idx, g, u)
    E, M, n_in = x.shape
    nob, kb = idx.shape
    bs = dh.shape[2] // nob
    _check_cuda(x, bs, _BWD_BLOCKS, "junction_gated_dw", x=x, dh=dh, idx=idx,
                g=g, u=u)
    dwg = torch.empty((E, nob, kb, bs, bs), dtype=torch.float32,
                      device=x.device)
    dwi = torch.empty_like(dwg)
    tc = junction_variant(x.dtype, M, bs) == "tc"
    name = "junction_gated_dw_tc" if tc else "junction_gated_dw"
    ptrs = (x.data_ptr(), dh.data_ptr(), g.data_ptr(), u.data_ptr(),
            idx.data_ptr(), dwg.data_ptr(), dwi.data_ptr(), E, M, n_in // bs,
            nob, kb, bs)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if tc:
            err = _kernel("junction_tc", name, 7, 6)(*ptrs, stream)
        else:
            err = _kernel("junction_dw", name, 7, 7)(
                *ptrs, _DTYPE_CODE[x.dtype], stream)
    _raise_on(err, name)
    gated_dw.launches += 1
    gated_dw.tc_launches += tc
    return dwg, dwi


gated_dw.launches = 0
gated_dw.tc_launches = 0


# ------------------------------------------------------- fused update_dw
def normalize_hyp(hyp, E: int, *, name: str = "hyp") -> torch.Tensor:
    """Every accepted hyp shape -> the canonical ``[E, HYP_K]`` fp32
    table: a ``(HYP_K,)`` row broadcasts to all units, and a legacy
    ``(2,)`` / ``[E, 2]`` [lr, momentum] pair pads to
    ``[lr, momentum, 0, 0, 0, 0, 1]``."""
    hyp = torch.as_tensor(hyp, dtype=torch.float32)
    if tuple(hyp.shape) in ((2,), (HYP_K,)):
        hyp = hyp.expand((E,) + tuple(hyp.shape))
    if tuple(hyp.shape) == (E, 2):
        hyp = torch.cat([hyp, hyp.new_zeros((E, HYP_K - 3)),
                         hyp.new_ones((E, 1))], dim=1)
    if tuple(hyp.shape) != (E, HYP_K):
        raise ValueError(
            f"{name} must be a (2,) [lr, momentum] pair, a ({HYP_K},) "
            f"[{', '.join(HYP_COLS)}] row, or a per-unit [E={E}, 2] / "
            f"[E={E}, {HYP_K}] table, got {tuple(hyp.shape)}")
    return hyp.contiguous()


def _epilogue_step(h, acc, w32, mom, vel):
    """One optimizer step from the fp32 gradient ``acc``: SGD(+momentum)
    when ``vel`` is None, Adam when it rides along.  ``h(col)`` gives the
    hyp column broadcastable against ``acc``.  Returns (new_w32, new_mom,
    new_vel, finite) where ``finite`` holds the tensors whose finiteness
    is the health verdict (mv for SGD, m' and v' for Adam).

    Adam's guards make an all-zero hyp row an exact freeze: pow(0, 0) is
    1, so both bias corrections hit ``c == 0 -> 1``, and eps 0 makes the
    denominator 0, which resolves to a zero update."""
    g = h(COL_GS) * acc
    if vel is None:
        mv = g if mom is None else h(COL_B1) * mom + g
        return w32 - h(COL_LR) * mv, (mv if mom is not None else None), \
            None, (mv,)
    b1, b2 = h(COL_B1), h(COL_B2)
    m1 = b1 * mom + (1.0 - b1) * g
    v2 = b2 * vel + (1.0 - b2) * torch.square(g)
    t = h(COL_T)
    c1 = 1.0 - torch.pow(b1, t)
    c2 = 1.0 - torch.pow(b2, t)
    c1 = torch.where(c1 == 0.0, 1.0, c1)
    c2 = torch.where(c2 == 0.0, 1.0, c2)
    den = torch.sqrt(v2 / c2) + h(COL_EPS)
    upd = torch.where(den == 0.0, 0.0, (m1 / c1) / den)
    upd = upd + h(COL_WD) * w32
    return w32 - h(COL_LR) * upd, m1, v2, (m1, v2)


def _check_update(x, dy, idx, res, w, b, mom, mom_b, vel, vel_b, act,
                  with_bias):
    _check_dw(x, dy, idx, res, act)
    E = x.shape[0]
    nob, kb = idx.shape
    bs = dy.shape[2] // nob
    if tuple(w.shape) != (E, nob, kb, bs, bs) or w.dtype != x.dtype:
        raise ValueError(f"w must be [E, nob, kb, bs, bs] in x's dtype, got "
                         f"{tuple(w.shape)} {w.dtype}")
    if vel is not None and mom is None:
        raise ValueError("the Adam vel slot requires the mom slot too")
    for name, s in (("mom", mom), ("vel", vel)):
        if s is not None and (s.dtype != torch.float32
                              or s.shape != w.shape):
            raise ValueError(f"{name} must be fp32 shaped like w")
    if with_bias:
        if b is None or tuple(b.shape) != (E, nob * bs) \
                or b.dtype != x.dtype:
            raise ValueError("with_bias needs b [E, nob*bs] in x's dtype")
        for name, s, need in (("mom_b", mom_b, mom is not None),
                              ("vel_b", vel_b, vel is not None)):
            if need and (s is None or s.dtype != torch.float32
                         or s.shape != b.shape):
                raise ValueError(f"{name} must be fp32 shaped like b")


def _hyp_cols(hyp, E: int, ndim: int):
    """h(col) of ``_epilogue_step``: hyp column ``col`` shaped to broadcast
    against an [E, ...] tensor of ``ndim`` dims."""
    return lambda c: hyp[:, c].reshape((E,) + (1,) * (ndim - 1))


def _step_in_place(hyp, acc, w, mom, vel, nob: int) -> torch.Tensor:
    """``_epilogue_step`` of one stream (w [E, ...] with its fp32 slots)
    from its fp32 gradient ``acc``, written back in place; returns the
    [E, nob] verdict: True where tile (e, o) stayed finite."""
    E = w.shape[0]
    nw, nm, nv, fin = _epilogue_step(_hyp_cols(hyp, E, w.dim()), acc,
                                     w.float(), mom, vel)
    ok = torch.ones((E, nob), dtype=torch.bool, device=w.device)
    for t in fin:
        ok &= torch.isfinite(t).reshape(E, nob, -1).all(dim=2)
    with torch.no_grad():
        w.copy_(nw)
        if mom is not None:
            mom.copy_(nm)
        if vel is not None:
            vel.copy_(nv)
    return ok


def _health(ok, with_health: bool):
    """The [E] int32 count of non-finite (e, o) tiles, or None."""
    return (~ok).sum(dim=1).to(torch.int32) if with_health else None


def update_dw_ref(x, dy, idx, res, w, b, mom, mom_b, hyp, *, vel=None,
                  vel_b=None, act: str = "none", with_bias: bool = True,
                  with_health: bool = False):
    """Plain version of the fused update: ``dw_ref``'s gradient, then
    ``_epilogue_step`` with unit e's hyp row, written in place into w, b
    and the slots.  Returns the [E] int32 count of (e, o) tiles whose
    update went non-finite (None unless ``with_health``)."""
    _check_update(x, dy, idx, res, w, b, mom, mom_b, vel, vel_b, act,
                  with_bias)
    nob = idx.shape[0]
    hyp = normalize_hyp(hyp, x.shape[0]).to(x.device)
    acc, accb = dw_ref(x, dy, idx, res, act, with_bias)
    ok = _step_in_place(hyp, acc, w, mom, vel, nob)
    if with_bias:
        ok &= _step_in_place(hyp, accb, b, mom_b, vel_b, nob)
    return _health(ok, with_health)


def update_dw(x, dy, idx, res, w, b, mom, mom_b, hyp, *, vel=None,
              vel_b=None, act: str = "none", with_bias: bool = True,
              with_health: bool = False):
    """The fused BP+UP stage: the ``dw`` reduction, then one optimizer
    step applied in place to w [E, nob, kb, bs, bs] (x's dtype), b
    [E, nob*bs] and the fp32 slots (mom / mom_b alone: SGD+momentum, plus
    vel / vel_b: Adam), from ``hyp`` (any shape ``normalize_hyp``
    accepts).  The gradient never leaves the kernel.  Returns the [E]
    int32 non-finite tile counts, or None unless ``with_health``.  CPU:
    ``update_dw_ref``; CUDA: ``junction_update_dw_tc`` or
    ``junction_update_dw`` as ``junction_variant`` says
    (``update_dw.launches`` counts both, ``update_dw.tc_launches`` the
    first)."""
    if _route(x, "junction update_dw"):
        return update_dw_ref(x, dy, idx, res, w, b, mom, mom_b, hyp, vel=vel,
                             vel_b=vel_b, act=act, with_bias=with_bias,
                             with_health=with_health)
    _check_update(x, dy, idx, res, w, b, mom, mom_b, vel, vel_b, act,
                  with_bias)
    E, M, n_in = x.shape
    nob, kb = idx.shape
    bs = dy.shape[2] // nob
    hyp = normalize_hyp(hyp, E).to(x.device)
    if not with_bias:
        b = mom_b = vel_b = None
    if mom is None:
        mom_b = None
    if vel is None:
        vel_b = None
    _check_cuda(x, bs, _BWD_BLOCKS, "junction_update_dw", x=x, dy=dy,
                idx=idx, res=res, w=w, b=b, mom=mom, mom_b=mom_b, vel=vel,
                vel_b=vel_b, hyp=hyp)
    bad = torch.zeros((E, nob), dtype=torch.int32, device=x.device)
    health = torch.empty((E,), dtype=torch.int32, device=x.device)
    tc = junction_variant(x.dtype, M, bs) == "tc"
    name = "junction_update_dw_tc" if tc else "junction_update_dw"
    ptrs = (x.data_ptr(), dy.data_ptr(), _ptr(res if act != "none" else None),
            idx.data_ptr(), hyp.data_ptr(), w.data_ptr(), _ptr(b), _ptr(mom),
            _ptr(mom_b), _ptr(vel), _ptr(vel_b), bad.data_ptr(),
            health.data_ptr(), E, M, n_in // bs, nob, kb, bs,
            ACTIVATIONS.index(act))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if tc:
            err = _kernel("junction_tc", name, 13, 7)(*ptrs, stream)
        else:
            err = _kernel("junction_dw", name, 13, 8)(
                *ptrs, _DTYPE_CODE[x.dtype], stream)
    _raise_on(err, name)
    update_dw.launches += 1
    update_dw.tc_launches += tc
    return health if with_health else None


update_dw.launches = 0
update_dw.tc_launches = 0


# ------------------------------------------------ fused update_gated_dw
def _check_gated_update(x, dh, idx, g, u, wg, wi, mg, mi, vg, vi):
    _check_gated_dw(x, dh, idx, g, u)
    _check_pair(wg, wi)
    E = x.shape[0]
    nob, kb = idx.shape
    bs = dh.shape[2] // nob
    if tuple(wg.shape) != (E, nob, kb, bs, bs) or wg.dtype != x.dtype:
        raise ValueError(f"wg must be [E, nob, kb, bs, bs] in x's dtype, got "
                         f"{tuple(wg.shape)} {wg.dtype}")
    if (mg is None) != (mi is None) or (vg is None) != (vi is None):
        raise ValueError("a gated update takes each slot for both branches")
    if vg is not None and mg is None:
        raise ValueError("the Adam v slots require the m slots too")
    for name, s in (("mg", mg), ("mi", mi), ("vg", vg), ("vi", vi)):
        if s is not None and (s.dtype != torch.float32
                              or s.shape != wg.shape):
            raise ValueError(f"{name} must be fp32 shaped like wg")


def update_gated_dw_ref(x, dh, idx, g, u, wg, wi, mg, mi, hyp, *, vg=None,
                        vi=None, with_health: bool = False):
    """Plain version of the fused gated update: ``gated_dw_ref``'s two
    gradients, then ``_epilogue_step`` with unit e's hyp row on each
    branch, written in place into wg, wi and their fp32 slots.  Returns
    the [E] int32 count of (e, o) tiles where either branch went
    non-finite, each tile counted once (None unless ``with_health``)."""
    _check_gated_update(x, dh, idx, g, u, wg, wi, mg, mi, vg, vi)
    nob = idx.shape[0]
    hyp = normalize_hyp(hyp, x.shape[0]).to(x.device)
    accg, acci = gated_dw_ref(x, dh, idx, g, u)
    ok = _step_in_place(hyp, accg, wg, mg, vg, nob)
    ok &= _step_in_place(hyp, acci, wi, mi, vi, nob)
    return _health(ok, with_health)


def update_gated_dw(x, dh, idx, g, u, wg, wi, mg, mi, hyp, *, vg=None,
                    vi=None, with_health: bool = False):
    """The fused BP+UP stage of the gated junction: the ``gated_dw``
    reductions, then one optimizer step applied in place to wg and wi
    [E, nob, kb, bs, bs] (x's dtype) and their fp32 slots (mg / mi alone:
    SGD+momentum, plus vg / vi: Adam) from ``hyp`` (any shape
    ``normalize_hyp`` accepts).  Returns the [E] int32 non-finite tile
    counts, or None unless ``with_health``.  CPU:
    ``update_gated_dw_ref``; CUDA: ``junction_update_gated_dw_tc`` or
    ``junction_update_gated_dw`` as ``junction_variant`` says
    (``update_gated_dw.launches`` counts both,
    ``update_gated_dw.tc_launches`` the first)."""
    if _route(x, "junction update_gated_dw"):
        return update_gated_dw_ref(x, dh, idx, g, u, wg, wi, mg, mi, hyp,
                                   vg=vg, vi=vi, with_health=with_health)
    _check_gated_update(x, dh, idx, g, u, wg, wi, mg, mi, vg, vi)
    E, M, n_in = x.shape
    nob, kb = idx.shape
    bs = dh.shape[2] // nob
    hyp = normalize_hyp(hyp, E).to(x.device)
    _check_cuda(x, bs, _BWD_BLOCKS, "junction_update_gated_dw", x=x, dh=dh,
                idx=idx, g=g, u=u, wg=wg, wi=wi, mg=mg, mi=mi, vg=vg, vi=vi,
                hyp=hyp)
    bad = torch.zeros((E, nob), dtype=torch.int32, device=x.device)
    health = torch.empty((E,), dtype=torch.int32, device=x.device)
    tc = junction_variant(x.dtype, M, bs) == "tc"
    name = "junction_update_gated_dw_tc" if tc else "junction_update_gated_dw"
    ptrs = (x.data_ptr(), dh.data_ptr(), g.data_ptr(), u.data_ptr(),
            idx.data_ptr(), hyp.data_ptr(), wg.data_ptr(), wi.data_ptr(),
            _ptr(mg), _ptr(mi), _ptr(vg), _ptr(vi), bad.data_ptr(),
            health.data_ptr(), E, M, n_in // bs, nob, kb, bs)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if tc:
            err = _kernel("junction_tc", name, 14, 6)(*ptrs, stream)
        else:
            err = _kernel("junction_dw", name, 14, 7)(
                *ptrs, _DTYPE_CODE[x.dtype], stream)
    _raise_on(err, name)
    update_gated_dw.launches += 1
    update_gated_dw.tc_launches += tc
    return health if with_health else None


update_gated_dw.launches = 0
update_gated_dw.tc_launches = 0
