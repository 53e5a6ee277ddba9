"""Block-sparse junction kernels: the activation table, the hyp-column
registry, the plain PyTorch versions and the wrappers of the CUDA kernels
``csrc/junction_fwd.cu``, ``csrc/junction_dx.cu`` and
``csrc/junction_dw.cu``.

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

dz = (dy * act'(res)).astype(dy.dtype) is recomputed from the saved
residual (y for relu/sigmoid, the pre-activation for silu/gelu): it is
rounded to dy's dtype before the products, while db sums the fp32 value.
A padded reverse slot (f >= rev_cnt[i]) adds exactly nothing, whatever dy
holds.  On a CPU tensor each wrapper runs its plain version; on a CUDA
tensor it launches its kernel (counting the launch) or raises.

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


def _route(t: torch.Tensor, name: str) -> bool:
    """True for a CPU tensor (plain version), False for CUDA (kernel)."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {t.device}")
    return False


def _ptr(t):
    return None if t is None else t.data_ptr()


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


def _fwd_kernel():
    from repro_torch.kernels import build
    fn = build.load("junction_fwd").junction_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fwd(x, w, idx, bias, act: str = "none", save_pre: bool = False):
    """x [E, M, nib*bs], w [E, nob, kb, bs, bs], idx [nob, kb] int32,
    bias [E, nob*bs] -> y [E, M, nob*bs] in x's dtype, or (y, pre) with
    ``save_pre`` (pre = the pre-activation, in x's dtype).

    A CPU tensor runs ``fwd_ref``.  A CUDA tensor launches
    ``junction_fwd`` on the current stream (``fwd.launches`` counts
    those launches) or raises; any other device raises."""
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
        with torch.cuda.device(x.device):
            err = _fwd_kernel()(
                x.data_ptr(), w.data_ptr(), idx.data_ptr(), bias.data_ptr(),
                y.data_ptr(), _ptr(pre), E, M, n_in // bs, nob, kb, bs,
                ACTIVATIONS.index(act), _DTYPE_CODE[x.dtype],
                torch.cuda.current_stream().cuda_stream)
        _raise_on(err, "junction_fwd")
        fwd.launches += 1
    return (y, pre) if save_pre else y


fwd.launches = 0


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


def _dx_kernel():
    from repro_torch.kernels import build
    fn = build.load("junction_dx").junction_dx
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def dx(dy, w, rev_ob, rev_t, rev_cnt, res=None, act: str = "none"):
    """dy [E, M, nob*bs] -> dx [E, M, nib*bs] in dy's dtype, through the
    reverse pattern against the forward-layout w [E, nob, kb, bs, bs]
    (already in dy's dtype); res is the forward's residual (y for
    relu / sigmoid, the pre-activation for silu / gelu, unused for none).
    CPU: ``dx_ref``; CUDA: ``junction_dx`` (``dx.launches``)."""
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
        with torch.cuda.device(dy.device):
            err = _dx_kernel()(
                dy.data_ptr(), _ptr(res if act != "none" else None),
                w.data_ptr(), rev_ob.data_ptr(), rev_t.data_ptr(),
                rev_cnt.data_ptr(), out.data_ptr(), E, M, nob, kb, nib, fb,
                bs, ACTIVATIONS.index(act), _DTYPE_CODE[dy.dtype],
                torch.cuda.current_stream().cuda_stream)
        _raise_on(err, "junction_dx")
        dx.launches += 1
    return out


dx.launches = 0


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


def _dw_kernel(name):
    from repro_torch.kernels import build
    fn = getattr(build.load("junction_dw"), name)
    if name == "junction_dw":
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 \
            + [ctypes.c_void_p]
    else:
        fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 8 \
            + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def dw(x, dy, idx, res=None, act: str = "none", with_bias: bool = True):
    """x [E, M, nib*bs], dy [E, M, nob*bs] -> (dw [E, nob, kb, bs, bs]
    fp32, db [E, nob*bs] fp32 or None).  CPU: ``dw_ref``; CUDA:
    ``junction_dw`` (``dw.launches``)."""
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
    with torch.cuda.device(x.device):
        err = _dw_kernel("junction_dw")(
            x.data_ptr(), dy.data_ptr(), _ptr(res if act != "none" else None),
            idx.data_ptr(), dwv.data_ptr(), _ptr(db), E, M, n_in // bs, nob,
            kb, bs, ACTIVATIONS.index(act), _DTYPE_CODE[x.dtype],
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "junction_dw")
    dw.launches += 1
    return dwv, db


dw.launches = 0


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


def update_dw_ref(x, dy, idx, res, w, b, mom, mom_b, hyp, *, vel=None,
                  vel_b=None, act: str = "none", with_bias: bool = True,
                  with_health: bool = False):
    """Plain version of the fused update: ``dw_ref``'s gradient, then
    ``_epilogue_step`` with unit e's hyp row, written in place into w, b
    and the slots.  Returns the [E] int32 count of (e, o) tiles whose
    update went non-finite (None unless ``with_health``)."""
    _check_update(x, dy, idx, res, w, b, mom, mom_b, vel, vel_b, act,
                  with_bias)
    E = x.shape[0]
    nob = idx.shape[0]
    hyp = normalize_hyp(hyp, E).to(x.device)
    acc, accb = dw_ref(x, dy, idx, res, act, with_bias)

    def hcol(ndim):
        return lambda c: hyp[:, c].reshape((E,) + (1,) * (ndim - 1))

    nw, nm, nv, fin = _epilogue_step(hcol(5), acc, w.float(), mom, vel)
    ok = torch.ones((E, nob), dtype=torch.bool, device=x.device)
    for t in fin:
        ok &= torch.isfinite(t).flatten(2).all(dim=2)
    if with_bias:
        nb, nmb, nvb, finb = _epilogue_step(hcol(2), accb, b.float(), mom_b,
                                            vel_b)
        for t in finb:
            ok &= torch.isfinite(t).reshape(E, nob, -1).all(dim=2)
    with torch.no_grad():
        w.copy_(nw)
        if mom is not None:
            mom.copy_(nm)
        if vel is not None:
            vel.copy_(nv)
        if with_bias:
            b.copy_(nb)
            if mom is not None:
                mom_b.copy_(nmb)
            if vel is not None:
                vel_b.copy_(nvb)
    if not with_health:
        return None
    return (~ok).sum(dim=1).to(torch.int32)


def update_dw(x, dy, idx, res, w, b, mom, mom_b, hyp, *, vel=None,
              vel_b=None, act: str = "none", with_bias: bool = True,
              with_health: bool = False):
    """The fused BP+UP stage: the ``dw`` reduction, then one optimizer
    step applied in place to w [E, nob, kb, bs, bs] (x's dtype), b
    [E, nob*bs] and the fp32 slots (mom / mom_b alone: SGD+momentum, plus
    vel / vel_b: Adam), from ``hyp`` (any shape ``normalize_hyp``
    accepts).  The gradient never leaves the kernel.  Returns the [E]
    int32 non-finite tile counts, or None unless ``with_health``.  CPU:
    ``update_dw_ref``; CUDA: ``junction_update_dw``
    (``update_dw.launches``)."""
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
    with torch.cuda.device(x.device):
        err = _dw_kernel("junction_update_dw")(
            x.data_ptr(), dy.data_ptr(), _ptr(res if act != "none" else None),
            idx.data_ptr(), hyp.data_ptr(), w.data_ptr(), _ptr(b), _ptr(mom),
            _ptr(mom_b), _ptr(vel), _ptr(vel_b), bad.data_ptr(),
            health.data_ptr(), E, M, n_in // bs, nob, kb, bs,
            ACTIVATIONS.index(act), _DTYPE_CODE[x.dtype],
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "junction_update_dw")
    update_dw.launches += 1
    return health if with_health else None


update_dw.launches = 0
