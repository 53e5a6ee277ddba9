"""The arithmetic of the port's tensor-core ``dw`` and fused
``update_gated_dw`` (``csrc/junction_tc.cu``: ``junction_dw_tc`` and
``junction_update_gated_dw_tc``), emulated in plain torch on the CPU and
held against the plain versions (``dw_ref``, ``update_gated_dw_ref``)
and the reference's Pallas kernels in interpret mode; the route and the
wrappers that send a junction to them.  The CUDA kernels run only on the
card, where ``chip_smoke.py`` holds them to their plain versions; these
tests pin the design they follow.

Both kernels take bf16 operands and sum fp32 products (a product of two
bf16 values is exact in fp32).  A block owns one slot's weight tile (the
gated update at block 128: 64 of its columns) and sums over all M rows in
K steps, in order: 64 rows for dw, 32 for the gated update (rows past M
are zeros and add nothing):

* dw: dz = dy * act'(res) in fp32, rounded to bf16 before the product (dz
  = dy for "none"), the bias gradient summed from the fp32 dz; the same
  routine, order and layout as the tensor-core ``update_dw``, so the
  gradient it stores is the one the fused update steps, bit for bit;
* update_gated_dw: dz_g = dh * u * silu'(g) and dz_u = dh * silu(g) in
  fp32 from the stored bf16 g and u, silu's sigmoid taken once for both
  branches, each rounded to bf16 once; two fp32 sums over the same x
  rows; then one optimizer step (``_epilogue_step``: SGD, SGD + momentum
  or Adam by the slots given) on both streams, and a per-(e, o) flag
  when either branch's update goes non-finite.

Tolerances, ``chip_smoke.REL_TOL``, relative to max |want|: dw, db and
the fp32 slots ``bf16_sum`` = 1e-3, fp32 sums of the same bf16 products
in another order, where a dz element whose fp32 value differs in its
last bit can also round to the other bf16 neighbour (here the sigmoid as
1 / (1 + exp(-g)) against torch.sigmoid; on the card the kernels' one
FMA of 1 + g (1 - s) against two roundings); the bf16 weights ``bf16_out`` =
2^-7, one bf16 ulp, since both sides round fp32 values that differ only
in that order (SGD and momentum weights also 1e-6 absolute, where w - lr
* g cancels); Adam weights near the noise floor are held as on the card
(``chip_smoke._adam_w_ok``).  The bit-for-bit identity with the update's
gradient, the zero-hyp freeze and the health counts are exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sparsity import make_block_pattern
from repro.kernels import block_sparse_matmul as jbsm

from repro_torch.kernels import block_sparse_matmul as tbsm
from repro_torch.kernels import ops as tops

import torch_tc_helpers as ug
from torch_tc_helpers import (B64, BF16, DOWN, GATE, KM, KM_GATED, MDOWN,
                              SUM_TOL, UP, W_TOL, WIDE, _bf, _k_steps,
                              _pad_rows, _t, chip_smoke,
                              emulate_update_gated_dw_tc, gated_dz_tc,
                              rel_err)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- emulation
def emulate_dw_tc(x, dy, idx, res=None, act="none", with_bias=True, km=KM):
    """``junction_dw_tc``'s arithmetic: x [E, M, nib*bs], dy (and res)
    [E, M, nob*bs], bf16 -> (dw [E, nob, kb, bs, bs] fp32, db [E, nob*bs]
    fp32 or None)."""
    E, M, n_in = x.shape
    nob, kb = idx.shape
    bs = dy.shape[2] // nob
    acc = torch.zeros((E, nob, kb, bs, bs))          # [e, o, k, a, c]
    db = torch.zeros((E, nob * bs))
    xb = x.reshape(E, M, n_in // bs, bs)
    for rows in _k_steps(M, km):                     # K steps, in order
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
    return acc, (db if with_bias else None)


# ---------------------------------------------------------------- inputs
def _dw_inputs(shape, E, M, act, seed=5):
    """bf16 x, dy and the residual of ``act`` (numpy, rounded to bf16)."""
    n_in, n_out, bs, pseed = shape
    pat = make_block_pattern(n_in, n_out, 0.25, bs, seed=pseed)
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    return pat, {k: _bf(v) for k, v in dict(
        x=f32(E, M, n_in), dy=f32(E, M, n_out),
        res=ug._res(rng, (E, M, n_out), act)).items()}


def _dw_args(pat, a, act, bias):
    return (_t(a["x"]), _t(a["dy"]), torch.from_numpy(pat.idx),
            _t(a["res"]) if act != "none" else None, act, bias)


def _gated_update_inputs(shape, E, M, opt, seed=7):
    """bf16 x, dh, g, u, wg, wi; fp32 slots (m for momentum and Adam, v
    for Adam, kept away from 0 as on the card)."""
    n_in, n_out, bs, pseed = shape
    pat = make_block_pattern(n_in, n_out, 0.25, bs, seed=pseed)
    nob, kb = pat.idx.shape
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    a = {k: _bf(v) for k, v in dict(
        x=f32(E, M, n_in), dh=f32(E, M, n_out), g=f32(E, M, n_out),
        u=f32(E, M, n_out), wg=f32(E, nob, kb, bs, bs) / np.sqrt(kb * bs),
        wi=f32(E, nob, kb, bs, bs) / np.sqrt(kb * bs)).items()}
    for k in ("mg", "mi"):
        a[k] = f32(E, nob, kb, bs, bs) * 0.01
    for k in ("vg", "vi"):
        a[k] = 1.0 + np.abs(f32(E, nob, kb, bs, bs))
    use = {"sgd": (False, False), "momentum": (True, False),
           "adam": (True, True)}[opt]
    return pat, a, use


def _gated_args(pat, a, use, hyp):
    slot = lambda k, on: torch.from_numpy(a[k].copy()) if on else None
    return ((_t(a["x"]), _t(a["dh"]), torch.from_numpy(pat.idx), _t(a["g"]),
             _t(a["u"]), _t(a["wg"]), _t(a["wi"]), slot("mg", use[0]),
             slot("mi", use[0]), torch.from_numpy(hyp)),
            dict(vg=slot("vg", use[1]), vi=slot("vi", use[1])))


def _plain_gated_update(args, kw):
    """update_gated_dw_ref on copies: (wg, wi, mg, mi, vg, vi, health)."""
    x, dh, idx, g, u, wg, wi, mg, mi, hyp = args
    cp = lambda t: None if t is None else t.clone()
    st = [cp(t) for t in (wg, wi, mg, mi, kw["vg"], kw["vi"])]
    health = tbsm.update_gated_dw_ref(x, dh, idx, g, u, st[0], st[1], st[2],
                                      st[3], hyp, vg=st[4], vi=st[5],
                                      with_health=True)
    return (*st, health)


def _assert_gated_close(got, want, w0, use):
    """Slots within SUM_TOL, weights within one bf16 rounding (Adam: as
    ``chip_smoke._adam_w_ok`` holds them), equal health."""
    for gs, ws in zip(got[2:6], want[2:6]):
        if ws is not None:
            assert rel_err(gs, ws) <= SUM_TOL
    for i in (0, 1):
        if use[1]:
            assert chip_smoke._adam_w_ok(got[i], want[i], w0[i], got[2 + i],
                                         want[2 + i], got[4 + i],
                                         want[4 + i])
        else:
            assert torch.allclose(got[i].float(), want[i].float(), **W_TOL)
    assert got[6].tolist() == want[6].tolist()


# ---------------------------------------------------------------- route
@pytest.mark.parametrize("variant", ["tc", "simt"])
@pytest.mark.parametrize("kernel", ["dw", "update_gated_dw"])
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
    lib = "junction_tc" if variant == "tc" else "junction_dw"
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


def _call_wrapper(kernel, M, dtype):
    """One call of the wrapper at M rows in ``dtype`` (nothing runs under
    ``_launch_recorder``)."""
    cast = lambda t: t.to(dtype) if t is not None and t.dtype == BF16 else t
    if kernel == "dw":
        pat, a = _dw_inputs(UP, 1, M, "silu")
        args = _dw_args(pat, a, "silu", True)
        tbsm.dw(*(cast(t) if torch.is_tensor(t) else t for t in args))
        return
    pat, a, use = _gated_update_inputs(GATE, 2, M, "adam")
    args, kw = _gated_args(pat, a, use, ug._hyp("adam", 2))
    tbsm.update_gated_dw(*(cast(t) for t in args), **kw, with_health=True)


@pytest.mark.parametrize("kernel,M", [
    ("dw", chip_smoke.TRAIN_M),                          # a dense junction
    ("dw", chip_smoke.MOE_M["train"]),                   # MoE down
    ("update_gated_dw", chip_smoke.MOE_M["train"]),      # an expert's rows
    ("update_gated_dw", chip_smoke.MOE_M["decode"]),     # a tick's capacity
    ("dw", 3), ("update_gated_dw", 1)])                  # below TC_MIN_M
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


def test_tensor_core_counts_cover_dw_and_update_gated_dw():
    """Both new entry points are counted apart from their kernels' totals
    and reset with them; a CPU tensor (the plain version) counts
    nowhere."""
    tops.reset_launch_counts()
    assert {"junction_dw", "junction_update_gated_dw"} <= set(
        tops.tc_launch_counts())
    _call_wrapper("dw", 8, BF16)
    _call_wrapper("update_gated_dw", 8, BF16)
    assert set(tops.launch_counts().values()) == {0}
    assert set(tops.tc_launch_counts().values()) == {0}


# -------------------------------------------------------------------- dw
DW_CASES = [
    (UP, 2, 200, "silu", True),        # ragged last K step, bias, E 2
    (DOWN, 2, 70, "none", True),
    (MDOWN, 4, 160, "none", False),    # MoE down at an expert's rows
    (MDOWN, 4, 20, "none", False),     # experts at small capacity
    (UP, 1, 64, "gelu", False),
    (B64, 2, 70, "sigmoid", True),
    (WIDE, 2, 130, "relu", True),
]


@pytest.mark.parametrize("shape,E,M,act,bias", DW_CASES)
def test_emulated_dw_holds_tol_against_plain_version(shape, E, M, act, bias):
    pat, a = _dw_inputs(shape, E, M, act)
    args = _dw_args(pat, a, act, bias)
    got, want = emulate_dw_tc(*args), tbsm.dw(*args)
    assert got[0].dtype == torch.float32
    assert rel_err(got[0], want[0]) <= SUM_TOL
    if bias:
        assert rel_err(got[1], want[1]) <= SUM_TOL
    else:
        assert got[1] is None and want[1] is None


@pytest.mark.parametrize("shape,E,M,act,bias",
                         [DW_CASES[0], DW_CASES[1], DW_CASES[5]])
def test_emulated_dw_holds_tol_against_reference_kernel(shape, E, M, act,
                                                        bias):
    pat, a = _dw_inputs(shape, E, M, act)
    got = emulate_dw_tc(*_dw_args(pat, a, act, bias))
    mp = -(-M // 16) * 16
    j = lambda k: jnp.asarray(_pad_rows(a[k], mp), jnp.bfloat16)
    jdw, jdb = jbsm.dw(j("x"), j("dy"), pat.idx,
                       j("res") if act != "none" else None, act=act,
                       with_bias=bias, interpret=True)
    assert rel_err(got[0], np.asarray(jdw)) <= SUM_TOL
    if bias:
        assert rel_err(got[1], np.asarray(jdb)) <= SUM_TOL


@pytest.mark.parametrize("shape,E,M,act",
                         [(UP, 2, 200, "silu"), (MDOWN, 4, 160, "none"),
                          (B64, 2, 70, "gelu")])
def test_emulated_dw_is_the_gradient_update_dw_tc_steps_bitwise(shape, E, M,
                                                                act):
    """SGD + momentum at lr 0, b1 0, gs 1, wd 0 from zero slots leaves mom
    = b1 * 0 + gs * acc, the update's own fp32 gradient, and w and b as
    they were: the emulated dw and db equal it bit for bit (the card's
    check of ``junction_dw_tc`` against ``junction_update_dw_tc``)."""
    pat, a = _dw_inputs(shape, E, M, act)
    x, dy, idx, res, _, _ = _dw_args(pat, a, act, True)
    nob, kb = idx.shape
    bs = dy.shape[2] // nob
    w = torch.zeros((E, nob, kb, bs, bs), dtype=BF16)
    b = torch.zeros((E, nob * bs), dtype=BF16)
    mom, mom_b = torch.zeros(w.shape), torch.zeros(b.shape)
    hyp = np.array([0, 0, 0, 0, 0, 0, 1], np.float32)
    out = ug.emulate_update_dw_tc(x, dy, idx, res, w, b, mom, mom_b, hyp,
                                  act=act, with_bias=True)
    dwv, db = emulate_dw_tc(x, dy, idx, res, act, True)
    assert torch.equal(out[2], dwv) and torch.equal(out[3], db)
    assert torch.equal(out[0], w) and torch.equal(out[1], b)
    assert out[6].tolist() == [0] * E


def test_emulated_dw_does_not_depend_on_the_k_step():
    """The M sum in 64-row steps against 16-row steps: the same gradient
    to fp32 round-off (the kernel's fixed order is one of many; none is
    the plain version's)."""
    pat, a = _dw_inputs(UP, 2, 200, "silu")
    args = _dw_args(pat, a, "silu", True)
    for got, want in zip(emulate_dw_tc(*args), emulate_dw_tc(*args, km=16)):
        assert rel_err(got, want) <= SUM_TOL


def test_emulated_dw_rows_past_m_add_nothing():
    """Zero rows up to the next K step (what the kernel stages past M)
    change no bit of dw or db."""
    pat, a = _dw_inputs(UP, 2, 200, "silu")
    pad = {k: _pad_rows(v, 256) for k, v in a.items()}
    for got, want in zip(emulate_dw_tc(*_dw_args(pat, a, "silu", True)),
                         emulate_dw_tc(*_dw_args(pat, pad, "silu", True))):
        assert torch.equal(got, want)


# ------------------------------------------------------- update_gated_dw
GATED_CASES = [
    (GATE, 2, 160, "adam"),            # an expert's training rows
    (GATE, 2, 157, "sgd"),             # ragged: a half-filled last K step
    (GATE, 4, 4, "momentum"),          # a tick's capacity
    (MDOWN, 1, 70, "adam"),
    (B64, 2, 70, "adam"),
    (WIDE, 2, 130, "momentum"),
    (WIDE, 1, 40, "sgd"),
]


def _gated_pair(shape, E, M, opt, hyp=None, km=KM_GATED):
    pat, a, use = _gated_update_inputs(shape, E, M, opt)
    hyp = ug._hyp(opt, E) if hyp is None else hyp
    args, kw = _gated_args(pat, a, use, hyp)
    return (pat, a, use, args, kw,
            emulate_update_gated_dw_tc(*args, **kw, km=km),
            _plain_gated_update(args, kw))


@pytest.mark.parametrize("shape,E,M,opt", GATED_CASES)
def test_emulated_update_gated_dw_holds_tol_against_plain_version(shape, E, M,
                                                                  opt):
    _, _, use, args, _, got, want = _gated_pair(shape, E, M, opt)
    assert got[0].dtype == BF16 and got[1].dtype == BF16
    _assert_gated_close(got, want, args[5:7], use)


@pytest.mark.parametrize("shape,E,M,opt",
                         [GATED_CASES[0], GATED_CASES[1], GATED_CASES[2]])
def test_emulated_update_gated_dw_holds_tol_against_reference_kernel(
        shape, E, M, opt):
    pat, a, use, args, _, got, _ = _gated_pair(shape, E, M, opt)
    mp = -(-M // 16) * 16
    j = lambda k: jnp.asarray(_pad_rows(a[k], mp), jnp.bfloat16)
    slot = lambda k, on: jnp.asarray(a[k]) if on else None
    jout = jbsm.update_gated_dw(
        j("x"), j("dh"), pat.idx, j("g"), j("u"),
        jnp.asarray(a["wg"], jnp.bfloat16), jnp.asarray(a["wi"], jnp.bfloat16),
        slot("mg", use[0]), slot("mi", use[0]), jnp.asarray(ug._hyp(opt, E)),
        vg=slot("vg", use[1]), vi=slot("vi", use[1]), with_health=True,
        interpret=True)
    want = [None if v is None else torch.from_numpy(
        np.asarray(v.astype(jnp.float32) if v.dtype == jnp.bfloat16 else v))
        for v in jout[:6]]
    want[0], want[1] = want[0].to(BF16), want[1].to(BF16)
    want.append(torch.from_numpy(np.asarray(jout[6]).reshape(-1)))
    _assert_gated_close(got, want, args[5:7], use)


@pytest.mark.parametrize("opt", ["sgd", "momentum", "adam"])
def test_emulated_update_gated_dw_zero_hyp_row_freezes_unit_bitwise(opt):
    """Unit 1's hyp row is zero: its wg and wi stay as they were, bit for
    bit, on the emulation and on the plain version; unit 0 moves."""
    hyp = ug._hyp(opt, 2)
    hyp[1] = 0.0
    _, _, _, args, _, got, want = _gated_pair(GATE, 2, 157, opt, hyp=hyp)
    for i in (0, 1):                                # wg, wi
        for side in (got, want):
            assert torch.equal(side[i][1], args[5 + i][1])
            assert not torch.equal(side[i][0], args[5 + i][0])
    assert got[6].tolist() == want[6].tolist() == [0, 0]


@pytest.mark.parametrize("opt", ["sgd", "momentum", "adam"])
def test_emulated_update_gated_dw_counts_poisoned_tiles_once(opt):
    """Unit 1 gets a non-finite gradient in the wg branch only (u = inf)
    of output block 1, in the wi branch only (silu(g) * dh overflows) of
    block 3 and in both of block 5: three tiles, each counted once, on
    both sides."""
    pat, a, use = _gated_update_inputs(GATE, 2, 70, opt)
    bs = GATE[2]
    for o, wg_br, wi_br in ((1, True, False), (3, False, True),
                            (5, True, True)):
        col = o * bs + 7
        a["dh"][1, 2, col] = 4.0
        if wg_br:
            a["u"][1, 2, col] = np.inf
        if wi_br:
            a["g"][1, 2, col] = _bf(np.float32(3e38))
    args, kw = _gated_args(pat, a, use, ug._hyp(opt, 2))
    got = emulate_update_gated_dw_tc(*args, **kw)
    want = _plain_gated_update(args, kw)
    assert got[6].tolist() == want[6].tolist() == [0, 3]
    assert torch.equal(torch.isfinite(got[0].float()),
                       torch.isfinite(want[0].float()))


def test_gated_dz_takes_one_sigmoid_within_one_bf16_ulp_of_plain():
    """Both branch gradients from one sigmoid of the same rounded g: equal
    to the plain version's (torch.sigmoid twice) but for elements whose
    fp32 value differs in its last bit and rounds to the neighbouring
    bf16 value; no element further."""
    rng = np.random.default_rng(11)
    dh, g, u = (_t(rng.standard_normal((4, 64, 256)).astype(np.float32) * 3)
                for _ in range(3))
    for got, want in zip(gated_dz_tc(dh, g, u), tbsm._gated_dz(dh, g, u)):
        diff = (got.float() - want.float()).abs()
        ulp = want.float().abs() * 2.0 ** -7
        assert bool((diff <= ulp).all())
        assert float((diff > 0).float().mean()) < 1e-2


def test_emulated_update_gated_dw_does_not_depend_on_the_k_step():
    """The M sum in 32-row steps against 64-row steps (both timed on the
    card): the same update within tolerance."""
    _, _, use, args, kw, got, _ = _gated_pair(GATE, 2, 160, "momentum")
    other = emulate_update_gated_dw_tc(*args, **kw, km=64)
    _assert_gated_close(got, other, args[5:7], use)
