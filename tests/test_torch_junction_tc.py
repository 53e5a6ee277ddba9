"""The arithmetic of the port's tensor-core junction kernels
(``csrc/junction_tc.cu``: ``junction_fwd_tc`` and ``junction_dx_tc``),
emulated in plain torch on the CPU and held against the plain versions
(``fwd_ref``, ``dx_ref``) and the reference's Pallas kernels in
interpret mode; and the route (``junction_variant``) that sends a
junction to them.  The CUDA kernels run only on the card, where
``chip_smoke.py`` holds them to their plain versions; these tests pin
the design they follow.

Both kernels take bf16 operands.  A block owns a tile of BM = 128 rows
(64 in the small cases here, so that a ragged M spans more than one
tile) and one output block (fwd) or input block (dx), sums fp32 products
(a product of two bf16 values is exact in fp32) in K steps of 64 columns
(the block size when it is 32), and stages rows past M as zeros:

* fwd walks the kb slots of idx[o] in order; the epilogue widens the
  bias, stores the pre-activation in bf16, applies the activation in
  fp32 and stores y in bf16;
* dx walks only the rev_cnt[i] valid slots of the reverse pattern in
  order, computes dz = dy * act'(res) in fp32 and rounds it to bf16
  before the product (dz = dy for "none"), against the weight tile in
  the forward layout; an input block that feeds no output gets exact
  zeros whatever dy holds.

Tolerance: ``chip_smoke.REL_TOL["bf16_out"]`` = 2^-7 of max |want|, the
bound the kernels are held to on the card: both sides round fp32 sums
that differ only in order, so an output may move by one bf16 ulp.
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sparsity import make_block_pattern
from repro.kernels import block_sparse_matmul as jbsm

from repro_torch.core.interleaver import reverse_block_pattern
from repro_torch.kernels import block_sparse_matmul as tbsm

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
TOL = chip_smoke.REL_TOL["bf16_out"]

BM, KS = 128, 64                  # the kernels' row tile and K step
BF16 = torch.bfloat16
# (n_in, n_out, block, pattern seed): block-32 copies of stablelm-3b's
# 2560 -> 6912 (kb 5) and 6912 -> 2560 (kb 14) junctions, and a block-128
# junction, whose slots take two K steps each
UP, DOWN, WIDE = (640, 1728, 32, 2), (1728, 640, 32, 1), (512, 1024, 128, 0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiles(M, bm):
    """(first row, rows) of each row tile; the last one may be ragged."""
    return [(m0, min(bm, M - m0)) for m0 in range(0, M, bm)]


def _staged(t, m0, rows, bm):
    """Rows [m0, m0 + bm) of t in fp32 as the kernel stages them: rows
    past M are zeros."""
    out = torch.zeros((t.shape[0], bm, t.shape[2]), dtype=t.dtype)
    out[:, :rows] = t[:, m0:m0 + rows]
    return out


def emulate_fwd_tc(x, w, idx, bias, act, bm=BM):
    """``junction_fwd_tc``'s arithmetic: x [E, M, nib*bs], w [E, nob, kb,
    bs, bs], idx [nob, kb], bias [E, nob*bs], all bf16 -> (y, pre) bf16."""
    E, M, _ = x.shape
    _, nob, kb, bs, _ = w.shape
    ks = min(KS, bs)
    y = torch.empty((E, M, nob * bs), dtype=x.dtype)
    pre = torch.empty_like(y)
    for m0, rows in _tiles(M, bm):
        xt = _staged(x, m0, rows, bm).float()
        acc = torch.zeros((E, bm, nob, bs))
        for k in range(kb):                            # slots in order
            for j0 in range(0, bs, ks):                # K steps of a slot
                cols = idx[:, k].long()[:, None] * bs + j0 + torch.arange(ks)
                acc += torch.einsum("emoi,eoic->emoc", xt[:, :, cols],
                                    w[:, :, k, j0:j0 + ks, :].float())
        s = acc.reshape(E, bm, nob * bs)[:, :rows] + bias.float()[:, None, :]
        pre[:, m0:m0 + rows] = s.to(x.dtype)
        y[:, m0:m0 + rows] = tbsm.act_fwd(s, act).to(x.dtype)
    return y, pre


def emulate_dx_tc(dy, w, rev_ob, rev_t, rev_cnt, res, act, bm=BM):
    """``junction_dx_tc``'s arithmetic: dy (and res) [E, M, nob*bs], w
    [E, nob, kb, bs, bs] in the forward layout, the reverse pattern
    [nib, fb] / [nib], all bf16 -> dx [E, M, nib*bs] bf16."""
    E, M, _ = dy.shape
    _, _, _, bs, _ = w.shape
    nib = rev_ob.shape[0]
    ks = min(KS, bs)
    dx = torch.empty((E, M, nib * bs), dtype=dy.dtype)
    for m0, rows in _tiles(M, bm):
        d = _staged(dy, m0, rows, bm)
        r = None if act == "none" else _staged(res, m0, rows, bm)
        for i in range(nib):
            acc = torch.zeros((E, bm, bs))
            for f in range(int(rev_cnt[i])):           # valid slots only
                ob, t = int(rev_ob[i, f]), int(rev_t[i, f])
                for j0 in range(0, bs, ks):
                    c = slice(ob * bs + j0, ob * bs + j0 + ks)
                    dz = d[:, :, c].float()
                    if act != "none":                  # rounded to bf16
                        dz = (dz * tbsm.act_bwd(r[:, :, c].float(), act)
                              ).to(dy.dtype).float()
                    acc += torch.einsum("emc,eac->ema", dz,
                                        w[:, ob, t, :, j0:j0 + ks].float())
            dx[:, m0:m0 + rows, i * bs:(i + 1) * bs] = acc[:, :rows].to(
                dy.dtype)
    return dx


def rel_err(got, want) -> float:
    return chip_smoke.rel_err(torch.as_tensor(np.asarray(got, np.float32)),
                              torch.as_tensor(np.asarray(want, np.float32)))


def _res(rng, shape, act):
    """A residual as the forward leaves it: y for relu/sigmoid, the
    pre-activation for silu/gelu."""
    s = rng.standard_normal(shape).astype(np.float32)
    if act == "relu":
        return np.maximum(s, 0.0)
    if act == "sigmoid":
        return 1.0 / (1.0 + np.exp(-s))
    return s


def _inputs(shape, E, M, act, seed=0):
    n_in, n_out, bs, pseed = shape
    pat = make_block_pattern(n_in, n_out, 0.25, bs, seed=pseed)
    nob, kb = pat.idx.shape
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    bf = lambda a: np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
    return pat, {k: bf(v) for k, v in dict(
        x=f32(E, M, n_in), dy=f32(E, M, n_out),
        w=f32(E, nob, kb, bs, bs) / np.sqrt(kb * bs),
        res=_res(rng, (E, M, n_out), act), b=f32(E, n_out)).items()}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a)).to(BF16)


def _pad_rows(a, m):
    """a [E, M, n] with zero rows up to m: the reference takes whole row
    tiles only (its ops.py pads)."""
    return np.pad(a, ((0, 0), (0, m - a.shape[1]), (0, 0)))


# ------------------------------------------------------------------ route
@pytest.mark.parametrize("bs", [32, 64, 128])
@pytest.mark.parametrize("M", sorted({0, 1, 4, 32, tbsm.TC_MIN_M - 1,
                                      tbsm.TC_MIN_M, 160, 2000, 2048}))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_route_sends_bf16_from_the_threshold_to_tensor_cores(dtype, M, bs):
    want = "tc" if dtype == BF16 and M >= tbsm.TC_MIN_M else "simt"
    assert tbsm.junction_variant(dtype, M, bs) == want


def test_route_takes_every_bf16_path_shape_to_tensor_cores():
    """The rows of every path chip_smoke.py drives in bf16 (decode ticks,
    prefill chunks, dense and MoE training) are at or above the measured
    threshold; fp32 never leaves SIMT, at any M."""
    for M in (chip_smoke.MOE_M["decode"], 32, chip_smoke.MOE_M["train"],
              chip_smoke.TRAIN_M):
        assert tbsm.junction_variant(BF16, M, chip_smoke.BS) == "tc"
    assert tbsm.junction_variant(torch.float32, 1 << 20, 128) == "simt"


# -------------------------------------------------------------------- fwd
FWD_CASES = [
    *[(UP, 2, 70, act, True, 64) for act in tbsm.ACTIVATIONS],
    (UP, 1, 70, "silu", False, 128),
    (DOWN, 2, 200, "none", True, 128),
    (WIDE, 1, 70, "gelu", True, 64),
    (WIDE, 2, 130, "relu", True, 128),
]


@pytest.mark.parametrize("shape,E,M,act,bias,bm", FWD_CASES)
def test_emulated_fwd_holds_tol_against_plain_version(shape, E, M, act, bias,
                                                      bm):
    pat, a = _inputs(shape, E, M, act)
    b = a["b"] if bias else np.zeros_like(a["b"])
    idx = torch.from_numpy(pat.idx)
    y, pre = emulate_fwd_tc(_t(a["x"]), _t(a["w"]), idx, _t(b), act, bm)
    wy, wpre = tbsm.fwd(_t(a["x"]), _t(a["w"]), idx, _t(b), act,
                        save_pre=True)
    assert y.dtype == pre.dtype == BF16
    assert rel_err(y.float(), wy.float()) <= TOL
    assert rel_err(pre.float(), wpre.float()) <= TOL


@pytest.mark.parametrize("shape,E,M,act,bias,bm",
                         [FWD_CASES[3], FWD_CASES[6], FWD_CASES[8]])
def test_emulated_fwd_holds_tol_against_reference_kernel(shape, E, M, act,
                                                         bias, bm):
    pat, a = _inputs(shape, E, M, act)
    b = a["b"] if bias else np.zeros_like(a["b"])
    y, pre = emulate_fwd_tc(_t(a["x"]), _t(a["w"]),
                            torch.from_numpy(pat.idx), _t(b), act, bm)
    mp = -(-M // 16) * 16
    jy, jpre = jbsm.fwd(jnp.asarray(_pad_rows(a["x"], mp), jnp.bfloat16),
                        jnp.asarray(a["w"], jnp.bfloat16), pat.idx,
                        jnp.asarray(b, jnp.bfloat16), act=act, bm=mp,
                        save_pre=True, interpret=True)
    assert rel_err(y.float(), np.asarray(jy.astype(jnp.float32))[:, :M]) \
        <= TOL
    assert rel_err(pre.float(),
                   np.asarray(jpre.astype(jnp.float32))[:, :M]) <= TOL


def test_emulated_fwd_rows_are_independent_of_the_tile_cut():
    """A ragged last tile (rows past M staged as zeros) changes no row:
    the same rows cut into 64-row and 128-row tiles agree bit for bit."""
    pat, a = _inputs(UP, 1, 70, "silu")
    args = (_t(a["x"]), _t(a["w"]), torch.from_numpy(pat.idx), _t(a["b"]),
            "silu")
    for got, want in zip(emulate_fwd_tc(*args, bm=64),
                         emulate_fwd_tc(*args, bm=128)):
        assert torch.equal(got, want)


# --------------------------------------------------------------------- dx
DX_CASES = [
    *[(UP, 2, 70, act, 64) for act in tbsm.ACTIVATIONS],
    (DOWN, 1, 70, "silu", 128),
    (DOWN, 2, 200, "none", 128),
    (WIDE, 1, 70, "gelu", 64),
    (WIDE, 2, 130, "relu", 128),
]


def _dx_args(pat, a, act):
    res = _t(a["res"]) if act != "none" else None
    return (_t(a["dy"]), _t(a["w"]),
            *(torch.from_numpy(v) for v in (pat.rev_ob, pat.rev_t,
                                             pat.rev_cnt)), res, act)


@pytest.mark.parametrize("shape,E,M,act,bm", DX_CASES)
def test_emulated_dx_holds_tol_against_plain_version(shape, E, M, act, bm):
    pat, a = _inputs(shape, E, M, act)
    args = _dx_args(pat, a, act)
    got = emulate_dx_tc(*args, bm=bm)
    assert got.dtype == BF16
    assert rel_err(got.float(), tbsm.dx(*args).float()) <= TOL


@pytest.mark.parametrize("shape,E,M,act,bm",
                         [DX_CASES[3], DX_CASES[5], DX_CASES[8]])
def test_emulated_dx_holds_tol_against_reference_kernel(shape, E, M, act,
                                                        bm):
    pat, a = _inputs(shape, E, M, act)
    got = emulate_dx_tc(*_dx_args(pat, a, act), bm=bm)
    res = jnp.asarray(a["res"], jnp.bfloat16) if act != "none" else None
    want = jbsm.dx(jnp.asarray(a["dy"], jnp.bfloat16),
                   jnp.asarray(a["w"], jnp.bfloat16), pat.rev_ob, pat.rev_t,
                   pat.rev_cnt, res, act=act, interpret=True)
    assert rel_err(got.float(), np.asarray(want.astype(jnp.float32))) <= TOL


def test_emulated_dx_padded_reverse_slots_are_exact_zeros():
    """Input blocks 1 and 2 feed no output block: their reverse slots are
    all padding, and dy is inf everywhere.  Their dx is exact zeros (no
    slot is read), block 0's is inf, on every side."""
    idx = np.zeros((2, 1), np.int32)               # both outputs read block 0
    rev_ob, rev_t, rev_cnt = reverse_block_pattern(idx, 3)
    assert list(rev_cnt) == [2, 0, 0]
    rng = np.random.default_rng(1)
    dy = np.full((1, 70, 64), np.inf, np.float32)
    w = rng.standard_normal((1, 2, 1, 32, 32)).astype(np.float32)
    res = rng.standard_normal((1, 70, 64)).astype(np.float32)
    pt = [torch.from_numpy(v) for v in (rev_ob, rev_t, rev_cnt)]
    got = emulate_dx_tc(_t(dy), _t(w), *pt, _t(res), "silu", bm=64).float()
    plain = tbsm.dx(_t(dy), _t(w), *pt, _t(res), "silu").float()
    want = np.asarray(jbsm.dx(jnp.asarray(dy, jnp.bfloat16),
                              jnp.asarray(w, jnp.bfloat16), rev_ob, rev_t,
                              rev_cnt, jnp.asarray(res, jnp.bfloat16),
                              act="silu", interpret=True
                              ).astype(jnp.float32))
    for side in (got.numpy(), plain.numpy(), want):
        assert not np.isfinite(side[..., :32]).any()
        assert (side[..., 32:] == 0).all() and not np.signbit(
            side[..., 32:]).any()


def test_tensor_core_counts_sit_beside_the_sixteen_kernel_counts():
    """``ops.launch_counts`` keeps one key a kernel; the tensor-core
    entry points are counted apart, reset with the rest, and a CPU tensor
    (the plain version) counts nowhere."""
    from repro_torch.kernels import ops as tops
    assert len(tops.launch_counts()) == 16
    tops.reset_launch_counts()
    assert tops.tc_launch_counts() == {
        "junction_fwd": 0, "junction_dx": 0, "junction_dw": 0,
        "junction_update_dw": 0, "junction_gated_fwd": 0,
        "junction_gated_dx": 0, "junction_gated_dw": 0,
        "junction_update_gated_dw": 0}
    pat, a = _inputs(UP, 1, 8, "none")
    tbsm.fwd(_t(a["x"]), _t(a["w"]), torch.from_numpy(pat.idx), _t(a["b"]))
    tbsm.dx(*_dx_args(pat, a, "none"))
    assert set(tops.launch_counts().values()) == {0}
    assert set(tops.tc_launch_counts().values()) == {0}
