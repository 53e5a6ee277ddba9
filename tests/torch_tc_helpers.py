"""What the tests of the port's redesigned junction kernels share
(test_torch_update_gated_tc.py, test_torch_dw_gated_update_tc.py,
test_torch_gated_bwd_tc.py and test_torch_quant_redesign.py): the chip
script's tolerances, small copies of the path's junction shapes, bf16
round trips, optimizer hyp rows, the emulations of the two tensor-core
update kernels and of the gated dz they and the gated backward kernels
round, and a recorder of the C entry points the wrappers launch, with
their arguments."""
import contextlib
import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch

from repro_torch.kernels import block_sparse_matmul as tbsm

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
OUT_TOL = chip_smoke.REL_TOL["bf16_out"]
SUM_TOL = chip_smoke.REL_TOL["bf16_sum"]
# SGD / momentum weights, as chip_smoke._update_case holds them: one bf16
# rounding, plus 1e-6 where w - lr * g cancels almost exactly and the
# gradient's summation-order difference is all that is left
W_TOL = dict(atol=1e-6, rtol=OUT_TOL)

KM, KM_GATED = 64, 32        # rows of M a K step: update_dw, update_gated_dw
BF16 = torch.bfloat16
# (n_in, n_out, block, pattern seed): block-32 copies of qwen3-moe's
# expert gate (2048 -> 768, kb 4) and down (768 -> 2048, kb 2) junctions
# and of stablelm-3b's 2560 -> 6912 (kb 5) and 6912 -> 2560 (kb 14), a
# block-64 and a block-128 junction (two K steps a slot in gated_fwd)
GATE, MDOWN = (512, 192, 32, 0), (192, 512, 32, 1)
UP, DOWN = (640, 1728, 32, 2), (1728, 640, 32, 1)
B64, WIDE = (512, 768, 64, 0), (512, 1024, 128, 0)


def rel_err(got, want) -> float:
    return chip_smoke.rel_err(torch.as_tensor(np.asarray(got, np.float32)),
                              torch.as_tensor(np.asarray(want, np.float32)))


def _bf(a):
    """a rounded to bf16 (as float32 numpy): the same values both sides."""
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a)).to(BF16)


def _pad_rows(a, m):
    """a [E, M, n] with zero rows up to m: the reference takes whole row
    tiles only (its ops.py pads); a zero row adds exactly nothing."""
    return np.pad(a, ((0, 0), (0, m - a.shape[1]), (0, 0)))


# ------------------------------------------------------------- emulation
def _k_steps(M, km):
    return [slice(m0, min(m0 + km, M)) for m0 in range(0, M, km)]


def emulate_update_dw_tc(x, dy, idx, res, w, b, mom, mom_b, hyp, vel=None,
                         vel_b=None, act="none", with_bias=True, km=KM):
    """``junction_update_dw_tc``'s arithmetic on copies of the operands:
    returns (w, b, mom, mom_b, vel, vel_b, health) after the step, the
    slots None where absent, b None without bias."""
    E, M, n_in = x.shape
    nob, kb = idx.shape
    bs = dy.shape[2] // nob
    acc = torch.zeros((E, nob, kb, bs, bs))          # [e, o, k, a, c]
    db = torch.zeros((E, nob * bs))
    xb = x.reshape(E, M, n_in // bs, bs)
    for m0 in range(0, M, km):                       # K steps, in order
        rows = slice(m0, min(m0 + km, M))            # past M: zeros, add 0
        dzf = dy[:, rows].float()
        dz = dzf
        if act != "none":                            # rounded to bf16
            dzf = dzf * tbsm.act_bwd(res[:, rows].float(), act)
            dz = dzf.to(dy.dtype).float()
        db += dzf.sum(dim=1)                         # the fp32 dz
        dzb = dz.reshape(E, -1, nob, bs)
        for k in range(kb):
            xk = xb[:, rows][:, :, idx[:, k].long(), :].float()
            acc[:, :, k] += torch.einsum("emoa,emoc->eoac", xk, dzb)
    hyp = tbsm.normalize_hyp(hyp, E)
    out = [t if t is None else t.clone()
           for t in (w, b, mom, mom_b, vel, vel_b)]
    nw, nm, nv, fin = tbsm._epilogue_step(tbsm._hyp_cols(hyp, E, 5), acc,
                                          w.float(), mom, vel)
    ok = torch.ones((E, nob), dtype=torch.bool)
    for t in fin:
        ok &= torch.isfinite(t).reshape(E, nob, -1).all(dim=2)
    out[0], out[2], out[4] = nw.to(w.dtype), nm, nv
    if with_bias:
        nb, nmb, nvb, finb = tbsm._epilogue_step(
            tbsm._hyp_cols(hyp, E, 2), db, b.float(), mom_b, vel_b)
        for t in finb:
            ok &= torch.isfinite(t).reshape(E, nob, -1).all(dim=2)
        out[1], out[3], out[5] = nb.to(b.dtype), nmb, nvb
    else:
        out[1] = out[3] = out[5] = None
    return (*out, (~ok).sum(dim=1).to(torch.int32))


def gated_dz_tc(dh, g, u):
    """The kernel's (dz_g, dz_u) in bf16 from bf16 dh, g, u: fp32 products
    with silu's sigmoid 1 / (1 + exp(-g)) taken once for both branches.
    Each torch op rounds, so 1 + g (1 - s) is rounded twice, as the
    kernels' ``silu_grad`` rounds it (no FMA) and as ``bsm._gated_dz``
    does."""
    d, gv, uv = dh.float(), g.float(), u.float()
    s = 1.0 / (1.0 + torch.exp(-gv))
    return ((d * uv * (s * (1.0 + gv * (1.0 - s)))).to(dh.dtype),
            (d * (gv * s)).to(dh.dtype))


def emulate_update_gated_dw_tc(x, dh, idx, g, u, wg, wi, mg, mi, hyp,
                               vg=None, vi=None, km=KM_GATED):
    """``junction_update_gated_dw_tc``'s arithmetic on copies of the
    operands: (wg, wi, mg, mi, vg, vi, health) after the step, the slots
    None where absent."""
    E, M, n_in = x.shape
    nob, kb = idx.shape
    bs = dh.shape[2] // nob
    accg = torch.zeros((E, nob, kb, bs, bs))
    accu = torch.zeros_like(accg)
    xb = x.reshape(E, M, n_in // bs, bs)
    for rows in _k_steps(M, km):
        dzg, dzu = (z.float().reshape(E, -1, nob, bs) for z in
                    gated_dz_tc(dh[:, rows], g[:, rows], u[:, rows]))
        for k in range(kb):
            xk = xb[:, rows][:, :, idx[:, k].long(), :].float()
            accg[:, :, k] += torch.einsum("emoa,emoc->eoac", xk, dzg)
            accu[:, :, k] += torch.einsum("emoa,emoc->eoac", xk, dzu)
    hyp = tbsm.normalize_hyp(hyp, E)
    ok = torch.ones((E, nob), dtype=torch.bool)
    out = []
    for acc, w, m, v in ((accg, wg, mg, vg), (accu, wi, mi, vi)):
        nw, nm, nv, fin = tbsm._epilogue_step(tbsm._hyp_cols(hyp, E, 5), acc,
                                              w.float(), m, v)
        for t in fin:
            ok &= torch.isfinite(t).reshape(E, nob, -1).all(dim=2)
        out.append((nw.to(w.dtype), nm, nv))
    (nwg, nmg, nvg), (nwi, nmi, nvi) = out
    return nwg, nwi, nmg, nmi, nvg, nvi, (~ok).sum(dim=1).to(torch.int32)


# ---------------------------------------------------------------- inputs
def _res(rng, shape, act):
    """A residual as the forward leaves it: y for relu/sigmoid, the
    pre-activation for silu/gelu."""
    s = rng.standard_normal(shape).astype(np.float32)
    if act == "relu":
        return np.maximum(s, 0.0)
    if act == "sigmoid":
        return 1.0 / (1.0 + np.exp(-s))
    return s


def _hyp(opt, E):
    """Per-unit hyp rows in the registry's order: SGD and momentum with
    each unit's own lr; Adam at the card's ``chip_smoke.ADAM_HYP`` (lr,
    decays, eps and step, which ``_adam_w_ok``'s noise-floor slack
    assumes) with each unit's own weight decay and gradient scale."""
    rows = []
    for e in range(E):
        lr = 1e-2 * (1 + e)
        adam = list(chip_smoke.ADAM_HYP)
        adam[tbsm.COL_WD] *= 1 + e
        adam[tbsm.COL_GS] /= 1 + e
        rows.append({"sgd": [lr, 0, 0, 0, 0, 0, 1],
                     "momentum": [lr, 0.9, 0, 0, 0, 0, 1],
                     "adam": adam}[opt])
    return np.asarray(rows, np.float32)


# ---------------------------------------------------------------- route
def _c_prototype(name):
    """(pointer count, int count) of an extern "C" entry point of csrc/,
    the stream not counted."""
    for src in (ROOT / "src" / "repro_torch" / "csrc").glob("*.cu"):
        m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)",
                      src.read_text())
        if m:
            params = [p.strip() for p in m.group(1).split(",")]
            ptrs = sum(p.startswith(("const void*", "void*")) for p in params)
            ints = sum(p.startswith("int ") for p in params)
            return ptrs - 1, ints                    # the last void* is the stream
    raise AssertionError(f"no entry point {name}")


class _Calls(list):
    """The recorded launches, and in ``args`` each launch's arguments."""

    def __init__(self):
        super().__init__()
        self.args = []


@contextlib.contextmanager
def _launch_recorder(monkeypatch):
    """The wrappers' CUDA branch on CPU tensors: every launch is recorded
    as (library, entry point, pointer count, int count, argument count),
    its arguments in ``calls.args``, and returns success; nothing runs."""
    calls = _Calls()

    def kernel(lib, name, n_ptr, n_int):
        def fn(*args):
            calls.append((lib, name, n_ptr, n_int, len(args)))
            calls.args.append(args)
            return 0
        return fn
    monkeypatch.setattr(tbsm, "_route", lambda *_: False)
    monkeypatch.setattr(tbsm, "_kernel", kernel)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda *_: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *_: type("S", (), {"cuda_stream": 0})())
    yield calls
