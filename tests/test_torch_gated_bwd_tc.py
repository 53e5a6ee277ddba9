"""The arithmetic of the port's tensor-core gated backward kernels
(``csrc/junction_tc.cu``: ``junction_gated_dx_tc`` and
``junction_gated_dw_tc``), emulated in plain torch on the CPU and held
against the plain versions (``gated_dx_ref``, ``gated_dw_ref``) and the
reference's Pallas kernels in interpret mode; the route and the wrappers
that send a junction to them.  The CUDA kernels run only on the card,
where ``chip_smoke.py`` holds them to their plain versions; these tests
pin the design they follow.

Both kernels take bf16 dh, g and u and compute dz_g = dh * u * silu'(g)
and dz_u = dh * silu(g) in fp32 from the stored values, silu's sigmoid
taken once for both, each rounded to bf16 once (the routine the fused
gated update uses); they sum fp32 products (a product of two bf16 values
is exact in fp32):

* gated_dx: a block owns a 128-row tile of one input block i and walks
  only the rev_cnt[i] valid reverse slots, in order, in K steps of
  ``KS_DX`` of an output block's columns; both streams' products of a
  step go into one fp32 sum (dz_g against wg, dz_u against wi, each the
  forward-layout tile); one bf16 store.  An input block that feeds no
  output block gets exact zeros, whatever dh holds;
* gated_dw: the fused gated update's reduction at its own layout (K steps
  of 32 rows of M at block 128, 64 at blocks 32 and 64, in order), both
  gradients in fp32, stored as summed; so the gradients it stores are
  the ones the update steps, bit for bit.

Tolerances, ``chip_smoke.REL_TOL``, relative to max |want|: dx
``bf16_out`` = 2^-7, one bf16 ulp, since both sides round fp32 sums that
differ only in order and in the dz elements whose fp32 value differs in
its last bit and rounds to the other bf16 neighbour (here the sigmoid as
1 / (1 + exp(-g)) against torch.sigmoid; on the card the kernels' one
FMA of 1 + g (1 - s) against two roundings); dwg and dwi ``bf16_sum`` = 1e-3,
fp32 sums of the same bf16 products in another order with the same dz
neighbours.  The zeros of a block that feeds nothing and the identity
with the update's gradients are exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sparsity import make_block_pattern
from repro.kernels import block_sparse_matmul as jbsm

from repro_torch.core.interleaver import reverse_block_pattern
from repro_torch.kernels import block_sparse_matmul as tbsm
from repro_torch.kernels import ops as tops

import torch_tc_helpers as ug
from torch_tc_helpers import (B64, BF16, GATE, MDOWN, OUT_TOL, SUM_TOL, WIDE,
                              _bf, _k_steps, _pad_rows, _t, chip_smoke,
                              emulate_update_gated_dw_tc, gated_dz_tc,
                              rel_err)

KS_DX = 32                   # columns of an output block a gated_dx K step


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- emulation
def emulate_gated_dx_tc(dh, wg, wi, rev_ob, rev_t, rev_cnt, g, u, ks=KS_DX):
    """``junction_gated_dx_tc``'s arithmetic: dh, g, u [E, M, nob*bs], wg
    and wi [E, nob, kb, bs, bs], the reverse pattern, all bf16 -> dx
    [E, M, nib*bs] bf16.  Rows are independent: a row past M (the kernel
    stages zeros) changes no other row."""
    E, M, _ = dh.shape
    _, nob, kb, bs, _ = wg.shape
    nib = rev_ob.shape[0]
    ks = min(ks, bs)
    dzg, dzu = (z.float() for z in gated_dz_tc(dh, g, u))
    acc = torch.zeros((E, M, nib, bs))
    for i in range(nib):
        for f in range(int(rev_cnt[i])):             # valid slots, in order
            ob, t = int(rev_ob[i, f]), int(rev_t[i, f])
            for j0 in range(0, bs, ks):              # K steps of the slot
                cols = slice(ob * bs + j0, ob * bs + j0 + ks)
                for dz, w in ((dzg, wg), (dzu, wi)):  # one fp32 sum
                    acc[:, :, i] += torch.einsum(
                        "emc,eac->ema", dz[:, :, cols],
                        w[:, ob, t, :, j0:j0 + ks].float())
    return acc.reshape(E, M, nib * bs).to(dh.dtype)


def gated_dw_km(bs):
    """Rows of M a K step of ``junction_gated_dw_tc`` (and of the fused
    gated update it shares its layout with) at block ``bs``."""
    return 32 if bs == 128 else 64


def emulate_gated_dw_tc(x, dh, idx, g, u, km=None):
    """``junction_gated_dw_tc``'s arithmetic: the fp32 sums of
    ``emulate_update_gated_dw_tc`` over K steps of ``km`` rows, in order
    -> (dwg, dwi) [E, nob, kb, bs, bs] fp32."""
    E, M, n_in = x.shape
    nob, kb = idx.shape
    bs = dh.shape[2] // nob
    km = gated_dw_km(bs) if km is None else km
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
    return accg, accu


# ---------------------------------------------------------------- inputs
def _inputs(shape, E, M, seed=9):
    """bf16 x, dh, g, u and the two weight streams (numpy, rounded to
    bf16), and the pattern."""
    n_in, n_out, bs, pseed = shape
    pat = make_block_pattern(n_in, n_out, 0.25, bs, seed=pseed)
    nob, kb = pat.idx.shape
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    return pat, {k: _bf(v) for k, v in dict(
        x=f32(E, M, n_in), dh=f32(E, M, n_out), g=f32(E, M, n_out),
        u=f32(E, M, n_out), wg=f32(E, nob, kb, bs, bs) / np.sqrt(kb * bs),
        wi=f32(E, nob, kb, bs, bs) / np.sqrt(kb * bs)).items()}


def _rev(pat):
    return tuple(torch.from_numpy(v)
                 for v in (pat.rev_ob, pat.rev_t, pat.rev_cnt))


def _dx_args(pat, a, dtype=BF16):
    c = lambda k: _t(a[k]).to(dtype)
    return (c("dh"), c("wg"), c("wi"), *_rev(pat), c("g"), c("u"))


def _dw_args(pat, a, dtype=BF16):
    c = lambda k: _t(a[k]).to(dtype)
    return (c("x"), c("dh"), torch.from_numpy(pat.idx), c("g"), c("u"))


def _jnp(a, k, mp):
    return jnp.asarray(_pad_rows(a[k], mp), jnp.bfloat16)


# ---------------------------------------------------------------- route
def _call_wrapper(kernel, M, dtype):
    """One call of the wrapper at M rows in ``dtype`` (nothing runs under
    ``ug._launch_recorder``)."""
    pat, a = _inputs(GATE, 2, M)
    if kernel == "gated_dx":
        tbsm.gated_dx(*_dx_args(pat, a, dtype))
    else:
        tbsm.gated_dw(*_dw_args(pat, a, dtype))


@pytest.mark.parametrize("variant", ["tc", "simt"])
@pytest.mark.parametrize("kernel", ["gated_dx", "gated_dw"])
def test_wrapper_launches_the_routed_entry_point_and_counts_it(
        monkeypatch, kernel, variant):
    """The wrapper calls the entry point its route names, with the C
    prototype's arguments, and counts the launch in ``launches`` and, on
    the tensor cores, in ``tc_launches`` (``ops.tc_launch_counts``)."""
    tops.reset_launch_counts()
    monkeypatch.setattr(tbsm, "junction_variant", lambda *_: variant)
    with ug._launch_recorder(monkeypatch) as calls:
        _call_wrapper(kernel, 8, BF16)
    name = f"junction_{kernel}" + ("_tc" if variant == "tc" else "")
    lib = ("junction_tc" if variant == "tc" else
           {"gated_dx": "junction_dx", "gated_dw": "junction_dw"}[kernel])
    assert [c[:2] for c in calls] == [(lib, name)]
    _, _, n_ptr, n_int, n_args = calls[0]
    assert (n_ptr, n_int) == ug._c_prototype(name)
    assert n_args == n_ptr + n_int + 1                 # and the stream
    counts, tc = tops.launch_counts(), tops.tc_launch_counts()
    assert counts[f"junction_{kernel}"] == 1
    assert sum(counts.values()) == 1
    assert tc[f"junction_{kernel}"] == (variant == "tc")
    assert sum(tc.values()) == (variant == "tc")
    tops.reset_launch_counts()


@pytest.mark.parametrize("kernel,M", [
    ("gated_dx", chip_smoke.MOE_M["train"]),             # an expert's rows
    ("gated_dw", chip_smoke.MOE_M["train"]),
    ("gated_dx", chip_smoke.MOE_M["decode"]),            # TC_MIN_M rows
    ("gated_dw", chip_smoke.MOE_M["decode"]),
    ("gated_dx", 157),                                   # a ragged tile
    ("gated_dx", 1), ("gated_dw", 3)])                   # below TC_MIN_M
def test_wrapper_route_at_every_path_shape(monkeypatch, kernel, M):
    """At the rows of every train path, bf16 launches the tensor-core
    entry point; below ``TC_MIN_M`` rows, and in fp32 at any rows, the
    SIMT one."""
    with ug._launch_recorder(monkeypatch) as calls:
        _call_wrapper(kernel, M, BF16)
        _call_wrapper(kernel, M, torch.float32)
    name = f"junction_{kernel}"
    bf16_tc = M >= tbsm.TC_MIN_M
    assert [c[1] for c in calls] == [name + ("_tc" if bf16_tc else ""), name]
    tops.reset_launch_counts()


def test_tensor_core_counts_cover_gated_dx_and_gated_dw():
    """Both new entry points are counted apart from their kernels' totals
    and reset with them; a CPU tensor (the plain version) counts
    nowhere."""
    tops.reset_launch_counts()
    assert {"junction_gated_dx", "junction_gated_dw"} <= set(
        tops.tc_launch_counts())
    _call_wrapper("gated_dx", 8, BF16)
    _call_wrapper("gated_dw", 8, BF16)
    assert set(tops.launch_counts().values()) == {0}
    assert set(tops.tc_launch_counts().values()) == {0}


# -------------------------------------------------------------- gated_dx
DX_CASES = [
    (GATE, 2, 160),                    # an expert's training rows
    (GATE, 2, 157),                    # ragged: a 29-row second tile
    (GATE, 4, 4),                      # a tick's capacity
    (MDOWN, 1, 70),                    # reverse fan-in 4
    (B64, 2, 157),
    (WIDE, 2, 157),                    # four K steps a slot
]


@pytest.mark.parametrize("shape,E,M", DX_CASES)
def test_emulated_gated_dx_holds_tol_against_plain_version(shape, E, M):
    pat, a = _inputs(shape, E, M)
    args = _dx_args(pat, a)
    got = emulate_gated_dx_tc(*args)
    assert got.dtype == BF16
    assert rel_err(got.float(), tbsm.gated_dx(*args).float()) <= OUT_TOL


@pytest.mark.parametrize("shape,E,M", [DX_CASES[1], DX_CASES[4],
                                       DX_CASES[5]])
def test_emulated_gated_dx_holds_tol_against_reference_kernel(shape, E, M):
    pat, a = _inputs(shape, E, M)
    got = emulate_gated_dx_tc(*_dx_args(pat, a))
    mp = -(-M // 16) * 16
    want = jbsm.gated_dx(_jnp(a, "dh", mp), jnp.asarray(a["wg"], jnp.bfloat16),
                         jnp.asarray(a["wi"], jnp.bfloat16), pat.rev_ob,
                         pat.rev_t, pat.rev_cnt, _jnp(a, "g", mp),
                         _jnp(a, "u", mp), bm=mp, interpret=True)
    want = np.asarray(want.astype(jnp.float32))[:, :M]
    assert rel_err(got.float(), want) <= OUT_TOL


def test_emulated_gated_dx_padded_reverse_slots_are_exact_zeros():
    """Input blocks 1 and 2 feed no output block: their reverse slots are
    all padding, and dh is inf everywhere.  Their dx is exact zeros (no
    slot is read), block 0's is not finite, on every side."""
    idx = np.zeros((2, 1), np.int32)               # both outputs read block 0
    rev_ob, rev_t, rev_cnt = reverse_block_pattern(idx, 3)
    assert list(rev_cnt) == [2, 0, 0]
    rng = np.random.default_rng(2)
    f32 = lambda *s: _bf(rng.standard_normal(s).astype(np.float32))
    dh = np.full((2, 157, 64), np.inf, np.float32)
    wg, wi = f32(2, 2, 1, 32, 32), f32(2, 2, 1, 32, 32)
    g, u = f32(2, 157, 64), f32(2, 157, 64)
    pt = [torch.from_numpy(v) for v in (rev_ob, rev_t, rev_cnt)]
    args = (_t(dh), _t(wg), _t(wi), *pt, _t(g), _t(u))
    got = emulate_gated_dx_tc(*args).float()
    plain = tbsm.gated_dx(*args).float()
    b = lambda v: jnp.asarray(_pad_rows(v, 160), jnp.bfloat16)
    want = np.asarray(jbsm.gated_dx(
        b(dh), jnp.asarray(wg, jnp.bfloat16), jnp.asarray(wi, jnp.bfloat16),
        rev_ob, rev_t, rev_cnt, b(g), b(u), bm=160,
        interpret=True).astype(jnp.float32))[:, :157]
    for side in (got.numpy(), plain.numpy(), want):
        assert not np.isfinite(side[..., :32]).any()
        assert (side[..., 32:] == 0).all() and not np.signbit(
            side[..., 32:]).any()


def test_emulated_gated_dx_does_not_depend_on_the_k_step():
    """K steps of 32 against 64 columns (both timed on the card): the
    same dx within one bf16 ulp (the kernel's order is one of many)."""
    pat, a = _inputs(WIDE, 2, 157)
    args = _dx_args(pat, a)
    assert rel_err(emulate_gated_dx_tc(*args).float(),
                   emulate_gated_dx_tc(*args, ks=64).float()) <= OUT_TOL


def test_emulated_gated_dx_rows_past_m_change_nothing():
    """Zero rows up to the next 128-row tile (what the kernel stages past
    M) change no bit of the rows that are there."""
    pat, a = _inputs(GATE, 2, 157)
    pad = {k: (_pad_rows(v, 256) if v.ndim == 3 else v) for k, v in a.items()}
    assert torch.equal(emulate_gated_dx_tc(*_dx_args(pat, a)),
                       emulate_gated_dx_tc(*_dx_args(pat, pad))[:, :157])


# -------------------------------------------------------------- gated_dw
DW_CASES = [
    (GATE, 2, 160),                    # an expert's training rows
    (GATE, 2, 157),                    # ragged: a half-filled last K step
    (GATE, 4, 4),                      # a tick's capacity
    (MDOWN, 1, 70),
    (B64, 2, 157),
    (WIDE, 2, 157),                    # block 128: 32-row K steps
]


@pytest.mark.parametrize("shape,E,M", DW_CASES)
def test_emulated_gated_dw_holds_tol_against_plain_version(shape, E, M):
    pat, a = _inputs(shape, E, M)
    args = _dw_args(pat, a)
    got, want = emulate_gated_dw_tc(*args), tbsm.gated_dw(*args)
    for gw, ww in zip(got, want):
        assert gw.dtype == torch.float32
        assert rel_err(gw, ww) <= SUM_TOL


@pytest.mark.parametrize("shape,E,M", [DW_CASES[1], DW_CASES[4],
                                       DW_CASES[5]])
def test_emulated_gated_dw_holds_tol_against_reference_kernel(shape, E, M):
    pat, a = _inputs(shape, E, M)
    got = emulate_gated_dw_tc(*_dw_args(pat, a))
    mp = -(-M // 16) * 16
    want = jbsm.gated_dw(_jnp(a, "x", mp), _jnp(a, "dh", mp), pat.idx,
                         _jnp(a, "g", mp), _jnp(a, "u", mp), interpret=True)
    for gw, ww in zip(got, want):
        assert rel_err(gw, np.asarray(ww)) <= SUM_TOL


@pytest.mark.parametrize("shape,E,M", [DW_CASES[0], DW_CASES[4],
                                       DW_CASES[5]])
def test_emulated_gated_dw_is_the_gradient_update_gated_dw_tc_steps_bitwise(
        shape, E, M):
    """SGD + momentum at lr 0, b1 0, gs 1, wd 0 from zero slots leaves mg =
    b1 * 0 + gs * acc, the update's own fp32 gradients, and wg and wi as
    they were: the emulated dwg and dwi equal them bit for bit at the
    update's K step (the card's check of ``junction_gated_dw_tc``
    against ``junction_update_gated_dw_tc``)."""
    pat, a = _inputs(shape, E, M)
    x, dh, idx, g, u = _dw_args(pat, a)
    wg, wi = _t(a["wg"]), _t(a["wi"])
    mg, mi = torch.zeros(wg.shape), torch.zeros(wi.shape)
    hyp = np.array([0, 0, 0, 0, 0, 0, 1], np.float32)
    km = gated_dw_km(shape[2])
    out = emulate_update_gated_dw_tc(x, dh, idx, g, u, wg, wi, mg, mi,
                                         hyp, km=km)
    dwg, dwi = emulate_gated_dw_tc(x, dh, idx, g, u, km=km)
    assert torch.equal(out[2], dwg) and torch.equal(out[3], dwi)
    assert torch.equal(out[0], wg) and torch.equal(out[1], wi)
    assert out[6].tolist() == [0] * E


def test_emulated_gated_dw_rows_past_m_add_nothing():
    """Zero rows up to the next K step (what the kernel stages past M)
    change no bit of dwg or dwi."""
    pat, a = _inputs(WIDE, 2, 157)
    pad = {k: (_pad_rows(v, 160) if v.ndim == 3 else v) for k, v in a.items()}
    for got, want in zip(emulate_gated_dw_tc(*_dw_args(pat, a)),
                         emulate_gated_dw_tc(*_dw_args(pat, pad))):
        assert torch.equal(got, want)
