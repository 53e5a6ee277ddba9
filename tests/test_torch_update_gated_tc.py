"""The arithmetic of the port's tensor-core ``gated_fwd`` and fused
``update_dw`` (``csrc/junction_tc.cu``: ``junction_gated_fwd_tc`` and
``junction_update_dw_tc``), emulated in plain torch on the CPU and held
against the plain versions (``gated_fwd_ref``, ``update_dw_ref``) and the
reference's Pallas kernels in interpret mode; the route and the wrappers
that send a junction to them.  The CUDA kernels run only on the card,
where ``chip_smoke.py`` holds them to their plain versions; these tests
pin the design they follow.

Both kernels take bf16 operands and sum fp32 products (a product of two
bf16 values is exact in fp32):

* gated_fwd: a block owns a tile of BM = 128 rows (64 in some small cases
  here, so that a ragged M spans more than one tile), stages rows past M
  as zeros, and walks the kb slots of idx[o] in K steps of 64 columns
  (the block size when it is 32), one fp32 sum a weight stream over the
  same x tile; the epilogue forms h = silu(g) * u from the fp32 sums and
  stores h (and g, u with ``save_res``) in bf16;
* update_dw: a block owns one slot's weight tile and sums over all M rows
  in K steps of 64 rows, in order: dz = dy * act'(res) in fp32, rounded to
  bf16 before the product (dz = dy for "none"), the bias gradient summed
  from the fp32 dz; then one optimizer step (``_epilogue_step``: SGD,
  SGD + momentum or Adam by the slots given) on every element, and a
  per-(e, o) flag when a tile's update goes non-finite.

Tolerances, ``chip_smoke.REL_TOL``, relative to max |want|: the bf16
outputs (h, g, u, the weights) ``bf16_out`` = 2^-7, one bf16 ulp, since
both sides round fp32 sums that differ only in order (SGD weights also
1e-6 absolute, where w - lr * g cancels); the fp32 slots
``bf16_sum`` = 1e-3, fp32 sums of the same bf16 products in another
order, where a dz element whose fp32 value differs in its last bit
between two activation gradients can also round to the other bf16
neighbour.  Adam weights near the noise floor are held as on the card
(``chip_smoke._adam_w_ok``).  The zero-hyp freeze and the health counts
are exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sparsity import make_block_pattern
from repro.kernels import block_sparse_matmul as jbsm

from repro_torch.kernels import block_sparse_matmul as tbsm
from repro_torch.kernels import ops as tops

from torch_tc_helpers import (B64, BF16, DOWN, GATE, KM, MDOWN, OUT_TOL,
                              SUM_TOL, UP, W_TOL, WIDE, _bf, _c_prototype,
                              _hyp, _launch_recorder, _pad_rows, _res, _t,
                              chip_smoke, emulate_update_dw_tc, rel_err)

BM, KS = 128, 64             # row tile and K step of gated_fwd


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- emulation
def _tiles(M, bm):
    """(first row, rows) of each row tile; the last one may be ragged."""
    return [(m0, min(bm, M - m0)) for m0 in range(0, M, bm)]


def emulate_gated_fwd_tc(x, wg, wi, idx, save_res=False, bm=BM):
    """``junction_gated_fwd_tc``'s arithmetic: x [E, M, nib*bs], wg and wi
    [E, nob, kb, bs, bs], idx [nob, kb], all bf16 -> h (and g, u) bf16."""
    E, M, _ = x.shape
    _, nob, kb, bs, _ = wg.shape
    ks = min(KS, bs)
    h = torch.empty((E, M, nob * bs), dtype=x.dtype)
    g, u = torch.empty_like(h), torch.empty_like(h)
    for m0, rows in _tiles(M, bm):
        xt = torch.zeros((E, bm, x.shape[2]))        # rows past M: zeros
        xt[:, :rows] = x[:, m0:m0 + rows].float()
        ag = torch.zeros((E, bm, nob, bs))
        au = torch.zeros_like(ag)
        for k in range(kb):                          # slots in order
            for j0 in range(0, bs, ks):              # K steps of a slot
                cols = idx[:, k].long()[:, None] * bs + j0 + torch.arange(ks)
                xk = xt[:, :, cols]                  # [E, bm, nob, ks]
                ag += torch.einsum("emoi,eoic->emoc", xk,
                                   wg[:, :, k, j0:j0 + ks, :].float())
                au += torch.einsum("emoi,eoic->emoc", xk,
                                   wi[:, :, k, j0:j0 + ks, :].float())
        gs = ag.reshape(E, bm, nob * bs)[:, :rows]
        us = au.reshape(E, bm, nob * bs)[:, :rows]
        h[:, m0:m0 + rows] = (tbsm.act_fwd(gs, "silu") * us).to(x.dtype)
        g[:, m0:m0 + rows] = gs.to(x.dtype)
        u[:, m0:m0 + rows] = us.to(x.dtype)
    return (h, g, u) if save_res else h


# ---------------------------------------------------------------- inputs
def _gated_inputs(shape, E, M, seed=0):
    n_in, n_out, bs, pseed = shape
    pat = make_block_pattern(n_in, n_out, 0.25, bs, seed=pseed)
    nob, kb = pat.idx.shape
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    return pat, {k: _bf(v) for k, v in dict(
        x=f32(E, M, n_in), wg=f32(E, nob, kb, bs, bs) / np.sqrt(kb * bs),
        wi=f32(E, nob, kb, bs, bs) / np.sqrt(kb * bs)).items()}


def _update_inputs(shape, E, M, act, opt, seed=3):
    """Operands of an update: bf16 x, dy, res, w, b; fp32 slots (the
    optimizer's: m for momentum and Adam, v for Adam, v kept away from 0
    as on the card)."""
    n_in, n_out, bs, pseed = shape
    pat = make_block_pattern(n_in, n_out, 0.25, bs, seed=pseed)
    nob, kb = pat.idx.shape
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    a = {k: _bf(v) for k, v in dict(
        x=f32(E, M, n_in), dy=f32(E, M, n_out),
        w=f32(E, nob, kb, bs, bs) / np.sqrt(kb * bs),
        res=_res(rng, (E, M, n_out), act), b=f32(E, n_out)).items()}
    for k in ("w", "b"):
        a[f"mom_{k}"] = f32(*a[k].shape) * 0.01
        a[f"vel_{k}"] = 1.0 + np.abs(f32(*a[k].shape))
    use = {"sgd": (False, False), "momentum": (True, False),
           "adam": (True, True)}[opt]
    return pat, a, use


def _torch_update_args(pat, a, use, act, bias, hyp):
    slot = lambda k, on: torch.from_numpy(a[k].copy()) if on else None
    return ((_t(a["x"]), _t(a["dy"]), torch.from_numpy(pat.idx),
             _t(a["res"]) if act != "none" else None, _t(a["w"]),
             _t(a["b"]) if bias else None, slot("mom_w", use[0]),
             slot("mom_b", use[0] and bias), torch.from_numpy(hyp)),
            dict(vel=slot("vel_w", use[1]), vel_b=slot("vel_b", use[1] and bias),
                 act=act, with_bias=bias))


def _plain_update(args, kw):
    """update_dw_ref on copies: (w, b, mom, mom_b, vel, vel_b, health)."""
    x, dy, idx, res, w, b, mom, mom_b, hyp = args
    cp = lambda t: None if t is None else t.clone()
    st = [cp(t) for t in (w, b, mom, mom_b, kw["vel"], kw["vel_b"])]
    health = tbsm.update_dw_ref(x, dy, idx, res, st[0], st[1], st[2], st[3],
                                hyp, vel=st[4], vel_b=st[5], act=kw["act"],
                                with_bias=kw["with_bias"], with_health=True)
    return (*st, health)


def _assert_update_close(got, want, w0, use):
    """Slots within SUM_TOL, weights within one bf16 rounding (Adam: as
    ``chip_smoke._adam_w_ok`` holds them), equal health."""
    gw, gb, gm, gmb, gv, gvb, gh = got
    ww, wb, wm, wmb, wv, wvb, wh = want
    for g, w in ((gm, wm), (gmb, wmb), (gv, wv), (gvb, wvb)):
        if w is not None:
            assert rel_err(g, w) <= SUM_TOL
    if use[1]:
        assert chip_smoke._adam_w_ok(gw, ww, w0, gm, wm, gv, wv)
    else:
        assert torch.allclose(gw.float(), ww.float(), **W_TOL)
    if wb is not None:
        assert rel_err(gb.float(), wb.float()) <= OUT_TOL
    assert gh.tolist() == wh.tolist()


# ---------------------------------------------------------------- route
@pytest.mark.parametrize("variant", ["tc", "simt"])
@pytest.mark.parametrize("kernel", ["gated_fwd", "update_dw"])
def test_wrapper_launches_the_routed_entry_point_and_counts_it(
        monkeypatch, kernel, variant):
    """The wrapper calls the entry point its route names, with the C
    prototype's arguments, and counts the launch in ``launches`` and, on
    the tensor cores, in ``tc_launches`` (``ops.tc_launch_counts``)."""
    tops.reset_launch_counts()
    monkeypatch.setattr(tbsm, "junction_variant", lambda *_: variant)
    with _launch_recorder(monkeypatch) as calls:
        if kernel == "gated_fwd":
            pat, a = _gated_inputs(GATE, 2, 8)
            tbsm.gated_fwd(_t(a["x"]), _t(a["wg"]), _t(a["wi"]),
                           torch.from_numpy(pat.idx), save_res=True)
        else:
            pat, a, use = _update_inputs(UP, 2, 8, "silu", "adam")
            args, kw = _torch_update_args(pat, a, use, "silu", True,
                                          _hyp("adam", 2))
            tbsm.update_dw(*args, **kw, with_health=True)
    name = f"junction_{kernel}" + ("_tc" if variant == "tc" else "")
    lib = ("junction_tc" if variant == "tc" else
           {"gated_fwd": "junction_fwd", "update_dw": "junction_dw"}[kernel])
    assert [c[:2] for c in calls] == [(lib, name)]
    _, _, n_ptr, n_int, n_args = calls[0]
    assert (n_ptr, n_int) == _c_prototype(name)
    assert n_args == n_ptr + n_int + 1                 # and the stream
    counts, tc = tops.launch_counts(), tops.tc_launch_counts()
    assert counts[f"junction_{kernel}"] == 1
    assert sum(counts.values()) == 1
    assert tc[f"junction_{kernel}"] == (variant == "tc")
    assert sum(tc.values()) == (variant == "tc")
    tops.reset_launch_counts()


def _call_wrapper(kernel, M, dtype):
    """One call of the wrapper at M rows in ``dtype`` (nothing runs under
    ``_launch_recorder``)."""
    if kernel == "gated_fwd":
        pat, a = _gated_inputs(GATE, 2, M)
        tbsm.gated_fwd(*(_t(a[k]).to(dtype) for k in ("x", "wg", "wi")),
                       torch.from_numpy(pat.idx), save_res=True)
        return
    pat, a, use = _update_inputs(UP, 1, M, "silu", "adam")
    args, kw = _torch_update_args(pat, a, use, "silu", True, _hyp("adam", 1))
    args = tuple(t.to(dtype) if t is not None and t.dtype == BF16 else t
                 for t in args)
    tbsm.update_dw(*args, **kw, with_health=True)


@pytest.mark.parametrize("kernel,M", [
    ("gated_fwd", chip_smoke.SERVE_MIN_ROWS),            # a decode tick
    ("gated_fwd", 32),                                   # a prefill chunk
    ("gated_fwd", chip_smoke.MOE_M["train"]),            # an expert's rows
    ("update_dw", chip_smoke.TRAIN_M),                   # a dense junction
    ("update_dw", chip_smoke.MOE_M["train"]),            # MoE down
    ("gated_fwd", 1), ("update_dw", 3)])                 # below TC_MIN_M
def test_wrapper_route_at_every_path_shape(monkeypatch, kernel, M):
    """At the rows of every serve and train path, bf16 launches the
    tensor-core entry point; below ``TC_MIN_M`` rows, and in fp32 at any
    rows, the SIMT one."""
    with _launch_recorder(monkeypatch) as calls:
        _call_wrapper(kernel, M, BF16)
        _call_wrapper(kernel, M, torch.float32)
    name = f"junction_{kernel}"
    bf16_tc = M >= tbsm.TC_MIN_M
    assert [c[1] for c in calls] == [name + ("_tc" if bf16_tc else ""), name]
    tops.reset_launch_counts()


def test_tensor_core_counts_name_each_tensor_core_entry_point():
    assert len(tops.launch_counts()) == 16
    tops.reset_launch_counts()
    assert tops.tc_launch_counts() == {
        "junction_fwd": 0, "junction_dx": 0, "junction_dw": 0,
        "junction_update_dw": 0, "junction_gated_fwd": 0,
        "junction_gated_dx": 0, "junction_gated_dw": 0,
        "junction_update_gated_dw": 0}
    assert set(tops.tc_launch_counts()) <= set(tops.launch_counts())


# ------------------------------------------------------------ gated fwd
GATED_CASES = [
    (GATE, 4, 4, False, 64),          # a decode tick's capacity
    (GATE, 4, 32, True, 64),          # a prefill chunk's
    (GATE, 2, 160, True, 128),        # an expert's training rows
    (GATE, 2, 157, False, 128),       # ragged: a 29-row second tile
    (MDOWN, 1, 70, True, 64),
    (B64, 2, 70, True, 64),
    (WIDE, 2, 130, True, 128),        # two K steps a slot
    (WIDE, 1, 4, False, 128),
]


@pytest.mark.parametrize("shape,E,M,save,bm", GATED_CASES)
def test_emulated_gated_fwd_holds_tol_against_plain_version(shape, E, M,
                                                            save, bm):
    pat, a = _gated_inputs(shape, E, M)
    args = (_t(a["x"]), _t(a["wg"]), _t(a["wi"]), torch.from_numpy(pat.idx))
    got = emulate_gated_fwd_tc(*args, save_res=save, bm=bm)
    want = tbsm.gated_fwd(*args, save_res=save)
    got, want = (got, want) if save else ((got,), (want,))
    for g, w in zip(got, want):
        assert g.dtype == BF16
        assert rel_err(g.float(), w.float()) <= OUT_TOL


@pytest.mark.parametrize("shape,E,M,save,bm",
                         [GATED_CASES[2], GATED_CASES[3], GATED_CASES[6]])
def test_emulated_gated_fwd_holds_tol_against_reference_kernel(shape, E, M,
                                                               save, bm):
    pat, a = _gated_inputs(shape, E, M)
    got = emulate_gated_fwd_tc(_t(a["x"]), _t(a["wg"]), _t(a["wi"]),
                               torch.from_numpy(pat.idx), save_res=True,
                               bm=bm)
    mp = -(-M // 16) * 16
    want = jbsm.gated_fwd(jnp.asarray(_pad_rows(a["x"], mp), jnp.bfloat16),
                          jnp.asarray(a["wg"], jnp.bfloat16),
                          jnp.asarray(a["wi"], jnp.bfloat16), pat.idx,
                          bm=mp, save_res=True, interpret=True)
    for g, w in zip(got, want):
        assert rel_err(g.float(), np.asarray(w.astype(jnp.float32))[:, :M]) \
            <= OUT_TOL


def test_emulated_gated_fwd_rows_are_independent_of_the_tile_cut():
    """Rows past M staged as zeros change no row: 64-row and 128-row
    tiles give the same h, g and u bit for bit."""
    pat, a = _gated_inputs(GATE, 2, 157)
    args = (_t(a["x"]), _t(a["wg"]), _t(a["wi"]), torch.from_numpy(pat.idx))
    for got, want in zip(emulate_gated_fwd_tc(*args, save_res=True, bm=64),
                         emulate_gated_fwd_tc(*args, save_res=True, bm=128)):
        assert torch.equal(got, want)


# ------------------------------------------------------------ update_dw
UPDATE_CASES = [
    (UP, 2, 200, "silu", True, "sgd"),          # ragged last K step
    (DOWN, 2, 70, "none", True, "momentum"),
    (UP, 2, 200, "silu", True, "adam"),         # E 2, per-unit hyp, bias
    (UP, 1, 64, "gelu", False, "adam"),
    (MDOWN, 4, 20, "none", False, "adam"),      # experts at small capacity
    (WIDE, 2, 130, "relu", True, "adam"),
    (B64, 2, 70, "sigmoid", True, "momentum"),
    (WIDE, 1, 130, "none", False, "sgd"),
]


def _update_pair(shape, E, M, act, bias, opt, hyp=None, km=KM):
    pat, a, use = _update_inputs(shape, E, M, act, opt)
    hyp = _hyp(opt, E) if hyp is None else hyp
    args, kw = _torch_update_args(pat, a, use, act, bias, hyp)
    return (pat, a, use, args, kw,
            emulate_update_dw_tc(*args, **kw, km=km), _plain_update(args, kw))


@pytest.mark.parametrize("shape,E,M,act,bias,opt", UPDATE_CASES)
def test_emulated_update_dw_holds_tol_against_plain_version(shape, E, M, act,
                                                            bias, opt):
    _, _, use, args, _, got, want = _update_pair(shape, E, M, act, bias, opt)
    assert got[0].dtype == BF16 and (got[2] is None or
                                     got[2].dtype == torch.float32)
    _assert_update_close(got, want, args[4], use)


@pytest.mark.parametrize("shape,E,M,act,bias,opt",
                         [UPDATE_CASES[0], UPDATE_CASES[1], UPDATE_CASES[2]])
def test_emulated_update_dw_holds_tol_against_reference_kernel(shape, E, M,
                                                               act, bias,
                                                               opt):
    pat, a, use, args, kw, got, _ = _update_pair(shape, E, M, act, bias, opt)
    mp = -(-M // 16) * 16
    j = lambda k: jnp.asarray(_pad_rows(a[k], mp), jnp.bfloat16)
    slot = lambda k, on: jnp.asarray(a[k]) if on else None
    jout = jbsm.update_dw(
        j("x"), j("dy"), pat.idx, j("res") if act != "none" else None,
        jnp.asarray(a["w"], jnp.bfloat16),
        jnp.asarray(a["b"], jnp.bfloat16) if bias else None,
        slot("mom_w", use[0]), slot("mom_b", use[0] and bias),
        jnp.asarray(_hyp(opt, E)), vel=slot("vel_w", use[1]),
        vel_b=slot("vel_b", use[1] and bias), act=act, with_bias=bias,
        with_health=True, interpret=True)
    want = [None if v is None else torch.from_numpy(
        np.asarray(v.astype(jnp.float32) if v.dtype == jnp.bfloat16 else v))
        for v in jout[:6]]
    want[0] = want[0].to(BF16)
    if bias:
        want[1] = want[1].to(BF16)
    want.append(torch.from_numpy(np.asarray(jout[6]).reshape(-1)))
    _assert_update_close(got, want, args[4], use)


@pytest.mark.parametrize("opt", ["sgd", "momentum", "adam"])
def test_emulated_update_dw_zero_hyp_row_freezes_unit_bitwise(opt):
    """Unit 1's hyp row is zero: its w and b stay as they were, bit for
    bit, on the emulation and on the plain version; unit 0 moves."""
    hyp = _hyp(opt, 2)
    hyp[1] = 0.0
    _, _, _, args, _, got, want = _update_pair(UP, 2, 200, "silu", True, opt,
                                               hyp=hyp)
    for i in (0, 1):                                # w, b
        for side in (got, want):
            assert torch.equal(side[i][1], args[4 + i][1])
            assert not torch.equal(side[i][0], args[4 + i][0])
    assert got[6].tolist() == want[6].tolist() == [0, 0]


@pytest.mark.parametrize("opt", ["momentum", "adam"])
def test_emulated_update_dw_counts_poisoned_tiles_as_plain_version(opt):
    """inf in dy of unit 1 at output blocks 3 and 7 (two tiles, one of
    them hit twice): both sides count [0, 2]."""
    pat, a, use = _update_inputs(UP, 2, 70, "none", opt)
    a["dy"][1, 0, 3 * 32] = np.inf
    a["dy"][1, 5, 7 * 32 + 3] = np.inf
    a["dy"][1, 69, 7 * 32] = np.inf
    args, kw = _torch_update_args(pat, a, use, "none", True, _hyp(opt, 2))
    got = emulate_update_dw_tc(*args, **kw)
    want = _plain_update(args, kw)
    assert got[6].tolist() == want[6].tolist() == [0, 2]
    assert torch.equal(torch.isfinite(got[2]), torch.isfinite(want[2]))


def test_emulated_update_dw_does_not_depend_on_the_k_step():
    """The M sum in 64-row steps against 16-row steps: the same gradient
    to fp32 round-off, so the same update within tolerance (the kernel's
    fixed order is one of many; none is the plain version's)."""
    _, _, use, args, kw, got, _ = _update_pair(UP, 2, 200, "silu", True,
                                               "momentum")
    other = emulate_update_dw_tc(*args, **kw, km=16)
    _assert_update_close(got, other, args[4], use)
