"""The plain versions of the port's backward kernels (dx, dw and the fused
update_dw) against the JAX reference's Pallas kernels in interpret mode,
on the CPU.  The CUDA kernels run only on the card (``chip_smoke.py``
holds each against its plain version there); here the wrappers take
their plain versions because the tensors lie on the CPU.

Shapes are block-32 copies of the full-width stablelm-3b FFN junctions:
640->1728 (idx [54, 5], the wg / wi shape) and 1728->640 (idx [20, 14],
the wo shape) have the patterns of 2560->6912 and 6912->2560 at block
128.  Inputs come from numpy seeds and go to both sides.

Tolerances: fp32 results differ in summation order only (atol/rtol
1e-5 on outputs of order one).  bf16 dx is a bf16 rounding of fp32 sums
that differ in order, so one bf16 ulp (rtol 2**-7).  dw is an fp32 sum
of bf16 products (exact in fp32), but in bf16 a dz element whose fp32
value differs in its last bit between the two activation gradients
(other tanh / exp) can round to the neighbouring bf16 value, moving dw
by |x| * ulp(dz): atol 1e-3 for bf16 dw.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sparsity import make_block_pattern
from repro.kernels import block_sparse_matmul as jbsm

from repro_torch.core.interleaver import reverse_block_pattern
from repro_torch.kernels import block_sparse_matmul as tbsm
from repro_torch.kernels import ops as tops

FP32 = dict(atol=1e-5, rtol=1e-5)
BF16 = dict(atol=1e-5, rtol=2.0 ** -7)
DW_BF16 = dict(atol=1e-3, rtol=1e-5)
UP, DOWN = (640, 1728, 2), (1728, 640, 1)       # (n_in, n_out, pattern seed)
M = 16
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: the test workers share the
    cores, and oversubscribed BLAS / OpenMP thread teams spin (an fp64
    gradcheck here ran a hundred times slower beside five busy workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _res(rng, shape, act):
    """A residual as the forward leaves it: y for relu/sigmoid, the
    pre-activation for silu/gelu, unused for none."""
    s = rng.standard_normal(shape).astype(np.float32)
    if act == "relu":
        return np.maximum(s, 0.0)
    if act == "sigmoid":
        return 1.0 / (1.0 + np.exp(-s))
    return s


def _inputs(shape, E, act, seed=0):
    n_in, n_out, pseed = shape
    pat = make_block_pattern(n_in, n_out, 0.25, 32, seed=pseed)
    nob, kb = pat.idx.shape
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    return pat, dict(
        x=f32(E, M, n_in), dy=f32(E, M, n_out),
        w=f32(E, nob, kb, 32, 32) / np.sqrt(kb * 32),
        res=_res(rng, (E, M, n_out), act), b=f32(E, n_out))


def _j(a, dtype):
    return jnp.asarray(a, dtype)


def _t(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a)).to(TDT[dtype])


def _pat(pat):
    return [torch.from_numpy(a) for a in (pat.rev_ob, pat.rev_t, pat.rev_cnt)]


def _np(t):
    return t.float().numpy()


# -------------------------------------------------------------------- dx
@pytest.mark.parametrize("shape,dtype,E,act", [
    *[(UP, "float32", 2, a) for a in tbsm.ACTIVATIONS],
    (UP, "bfloat16", 1, "silu"), (DOWN, "float32", 1, "none"),
    (DOWN, "bfloat16", 2, "relu")])
def test_dx_ref_matches_reference(shape, dtype, E, act):
    pat, a = _inputs(shape, E, act)
    res = a["res"] if act != "none" else None
    want = jbsm.dx(_j(a["dy"], dtype), _j(a["w"], dtype), pat.rev_ob,
                   pat.rev_t, pat.rev_cnt,
                   None if res is None else _j(res, dtype), act=act,
                   interpret=True)
    got = tbsm.dx(_t(a["dy"], dtype), _t(a["w"], dtype), *_pat(pat),
                  None if res is None else _t(res, dtype), act)
    assert got.dtype == TDT[dtype]
    np.testing.assert_allclose(_np(got), np.asarray(want.astype(jnp.float32)),
                               **(FP32 if dtype == "float32" else BF16))


def test_dx_padded_reverse_slots_are_exact_zeros():
    """Input blocks 1 and 2 feed no output block: their reverse slots are
    all padding with the (0, 0) sentinel, and dy of output block 0 is inf.
    Their dx must be exact zeros on both sides, not inf * w or NaN."""
    idx = np.zeros((2, 1), np.int32)                 # both outputs read block 0
    rev_ob, rev_t, rev_cnt = reverse_block_pattern(idx, 3)
    assert list(rev_cnt) == [2, 0, 0]
    rng = np.random.default_rng(1)
    dy = np.full((1, 4, 64), np.inf, np.float32)
    w = rng.standard_normal((1, 2, 1, 32, 32)).astype(np.float32)
    res = rng.standard_normal((1, 4, 64)).astype(np.float32)
    want = np.asarray(jbsm.dx(jnp.asarray(dy), jnp.asarray(w), rev_ob, rev_t,
                              rev_cnt, jnp.asarray(res), act="silu",
                              interpret=True))
    got = tbsm.dx(torch.from_numpy(dy), torch.from_numpy(w),
                  *(torch.from_numpy(a) for a in (rev_ob, rev_t, rev_cnt)),
                  torch.from_numpy(res), "silu").numpy()
    assert not np.isfinite(got[..., :32]).any()      # block 0 does see inf
    assert (got[..., 32:] == 0).all() and (want[..., 32:] == 0).all()
    assert not np.signbit(got[..., 32:]).any()


# -------------------------------------------------------------------- dw
@pytest.mark.parametrize("shape,dtype,E,act,bias", [
    *[(UP, "float32", 2, a, True) for a in tbsm.ACTIVATIONS],
    (UP, "bfloat16", 1, "silu", False), (DOWN, "float32", 1, "none", False),
    (DOWN, "bfloat16", 2, "gelu", True)])
def test_dw_ref_matches_reference(shape, dtype, E, act, bias):
    pat, a = _inputs(shape, E, act)
    res = a["res"] if act != "none" else None
    jdw, jdb = jbsm.dw(_j(a["x"], dtype), _j(a["dy"], dtype), pat.idx,
                       None if res is None else _j(res, dtype), act=act,
                       with_bias=bias, interpret=True)
    tdw, tdb = tbsm.dw(_t(a["x"], dtype), _t(a["dy"], dtype),
                       torch.from_numpy(pat.idx),
                       None if res is None else _t(res, dtype), act, bias)
    assert tdw.dtype == torch.float32
    tol = FP32 if dtype == "float32" else DW_BF16
    np.testing.assert_allclose(tdw.numpy(), np.asarray(jdw), **tol)
    if bias:
        np.testing.assert_allclose(tdb.numpy(), np.asarray(jdb), **FP32)
    else:
        assert tdb is None and jdb is None


# ------------------------------------------------------------- update_dw
def _hyp(opt, E):
    """Per-unit hyp rows (unit 1 trains at another lr) in the registry's
    column order."""
    rows = []
    for e in range(E):
        lr = 1e-2 * (1 + e)
        if opt == "sgd":
            rows.append([lr, 0, 0, 0, 0, 0, 1])
        elif opt == "momentum":
            rows.append([lr, 0.9, 0, 0, 0, 0, 1])
        else:
            rows.append([lr, 0.9, 0.95, 1e-8, 0.01, 3, 0.5])
    return np.asarray(rows, np.float32)


def _update_case(shape, dtype, E, act, bias, opt, hyp=None, poison=()):
    """Run the reference's update_dw and the port's update_dw_ref on the
    same operands; return (reference outputs, port tensors, port health)."""
    pat, a = _inputs(shape, E, act, seed=3)
    for e, o in poison:                              # inf into dy tiles
        a["dy"][e, 0, o * 32] = np.inf
    rng = np.random.default_rng(4)
    mom = rng.standard_normal(a["w"].shape).astype(np.float32) * 0.1
    mom_b = rng.standard_normal(a["b"].shape).astype(np.float32) * 0.1
    vel = np.abs(mom) * 0.1
    vel_b = np.abs(mom_b) * 0.1
    hyp = _hyp(opt, E) if hyp is None else hyp
    res = a["res"] if act != "none" else None
    use_m, use_v = opt != "sgd", opt == "adam"
    # the port updates its operands in place, and in fp32 they share
    # their host buffers with the reference's: the reference finishes
    # reading them before the port starts
    jout = jax.block_until_ready(jbsm.update_dw(
        _j(a["x"], dtype), _j(a["dy"], dtype), pat.idx,
        None if res is None else _j(res, dtype), _j(a["w"], dtype),
        _j(a["b"], dtype) if bias else None,
        jnp.asarray(mom) if use_m else None,
        jnp.asarray(mom_b) if use_m and bias else None, jnp.asarray(hyp),
        vel=jnp.asarray(vel) if use_v else None,
        vel_b=jnp.asarray(vel_b) if use_v and bias else None, act=act,
        with_bias=bias, with_health=True, interpret=True))
    t = dict(w=_t(a["w"], dtype), b=_t(a["b"], dtype),
             mom=torch.from_numpy(mom) if use_m else None,
             mom_b=torch.from_numpy(mom_b) if use_m and bias else None,
             vel=torch.from_numpy(vel) if use_v else None,
             vel_b=torch.from_numpy(vel_b) if use_v and bias else None)
    before = {k: (None if v is None else v.clone()) for k, v in t.items()}
    health = tbsm.update_dw(
        _t(a["x"], dtype), _t(a["dy"], dtype), torch.from_numpy(pat.idx),
        None if res is None else _t(res, dtype), t["w"],
        t["b"] if bias else None, t["mom"], t["mom_b"],
        torch.from_numpy(hyp), vel=t["vel"], vel_b=t["vel_b"], act=act,
        with_bias=bias, with_health=True)
    names = ("w", "b", "mom", "mom_b", "vel", "vel_b")
    want = dict(zip(names, jout[:6]))
    return want, t, before, health, np.asarray(jout[6]).reshape(-1)


@pytest.mark.parametrize("opt,bias,dtype,act", [
    ("sgd", False, "float32", "silu"), ("sgd", True, "float32", "relu"),
    ("momentum", False, "float32", "none"),
    ("momentum", True, "float32", "sigmoid"),
    ("adam", False, "float32", "gelu"), ("adam", True, "float32", "silu"),
    ("adam", False, "bfloat16", "silu")])
def test_update_dw_ref_matches_reference(opt, bias, dtype, act):
    shape = UP if opt != "momentum" else DOWN
    want, got, _, health, jhealth = _update_case(shape, dtype, 2, act, bias,
                                                 opt)
    tol = dict(atol=2e-5, rtol=1e-5) if dtype == "float32" else BF16
    for k, v in got.items():
        if v is None or (k.endswith("b") and not bias):
            continue
        assert v.dtype == (TDT[dtype] if k in ("w", "b") else torch.float32)
        np.testing.assert_allclose(_np(v), np.asarray(want[k], np.float32),
                                   err_msg=k, **tol)
    assert health.tolist() == jhealth.tolist() == [0, 0]


@pytest.mark.parametrize("opt", ["momentum", "adam"])
def test_update_dw_health_counts_poisoned_tiles(opt):
    """inf in dy reaches the dw tiles of (e=1, o=3) and (e=1, o=7) and,
    through the bias, the same tiles: unit 1 counts 2, unit 0 counts 0."""
    want, got, _, health, jhealth = _update_case(
        UP, "float32", 2, "none", True, opt, poison=[(1, 3), (1, 7)])
    assert jhealth.tolist() == [0, 2]
    assert health.tolist() == [0, 2]
    np.testing.assert_allclose(got["w"][0].numpy(), np.asarray(want["w"][0]),
                               atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("opt", ["sgd", "momentum", "adam"])
def test_zero_hyp_row_freezes_weights_bitwise(opt):
    """An all-zero hyp row leaves w and b bit for bit as they were; the
    slots take the reference's values (the zero decay rates reset them)."""
    hyp = _hyp(opt, 2)
    hyp[1] = 0.0
    want, got, before, _, _ = _update_case(UP, "float32", 2, "silu", True,
                                           opt, hyp=hyp)
    for k in ("w", "b"):
        assert torch.equal(got[k][1], before[k][1]), k
        assert not torch.equal(got[k][0], before[k][0]), k
        np.testing.assert_array_equal(np.asarray(want[k][1]),
                                      before[k][1].numpy())
    for k in ("mom", "mom_b", "vel", "vel_b"):
        if got[k] is not None:
            np.testing.assert_array_equal(got[k][1].numpy(),
                                          np.asarray(want[k][1]))


def test_normalize_hyp_legacy_pair_and_broadcast():
    pair = tbsm.normalize_hyp(torch.tensor([0.1, 0.9]), 3)
    assert pair.shape == (3, tbsm.HYP_K)
    assert pair[0].tolist() == pytest.approx([0.1, 0.9, 0, 0, 0, 0, 1])
    np.testing.assert_array_equal(
        pair.numpy(), np.asarray(jbsm.normalize_hyp(jnp.asarray([0.1, 0.9]),
                                                    3)))
    assert tbsm.HYP_COLS == jbsm.HYP_COLS
    with pytest.raises(ValueError, match="hyp must be"):
        tbsm.normalize_hyp(torch.zeros(5), 2)


# ---------------------------------------------------------- autograd
@pytest.mark.parametrize("act,E,bias", [("silu", 1, True), ("gelu", 2, False),
                                        ("sigmoid", 2, True),
                                        ("none", 1, False)])
def test_junction_function_gradcheck_fp64(act, E, bias):
    """The junction's autograd.Function through the plain versions, in
    float64: its dx / dw / db backward against finite differences."""
    pat = make_block_pattern(96, 64, 0.5, 32, seed=0)
    rng = np.random.default_rng(5)
    x = torch.tensor(rng.standard_normal((E, 3, 96)), requires_grad=True)
    w = torch.tensor(rng.standard_normal((E,) + pat.idx.shape + (32, 32))
                     * 0.2, requires_grad=True)
    b = (torch.tensor(rng.standard_normal((E, 64)), requires_grad=True)
         if bias else None)
    args = (x, w) + ((b,) if bias else ())
    if E == 1:                                   # the 4-D (single) form
        args = tuple(t[0].detach().requires_grad_() for t in args)
    fn = lambda x_, w_, *b_: tops.junction_matmul(
        x_, w_, *_all(pat), bias=b_[0] if b_ else None, act=act)
    assert torch.autograd.gradcheck(fn, args, eps=1e-6, atol=1e-6)


def _all(pat):
    return [torch.from_numpy(a)
            for a in (pat.idx, pat.rev_ob, pat.rev_t, pat.rev_cnt)]


def test_fused_function_runs_dx_on_old_weights_and_updates_in_place():
    """junction_train_update: dx equals the two-pass dx (computed with the
    weights before the step), w moves by exactly -lr * dw under plain SGD,
    and the health tensor receives the kernel's counts."""
    pat = make_block_pattern(96, 64, 0.5, 32, seed=0)
    rng = np.random.default_rng(6)
    x0 = torch.tensor(rng.standard_normal((5, 96)), dtype=torch.float32)
    w0 = torch.tensor(rng.standard_normal(pat.idx.shape + (32, 32)) * 0.2,
                      dtype=torch.float32)
    g = torch.tensor(rng.standard_normal((5, 64)), dtype=torch.float32)
    x_ref = x0.clone().requires_grad_()
    w_ref = w0.clone().requires_grad_()
    (tops.junction_matmul(x_ref, w_ref, *_all(pat), act="silu") * g).sum() \
        .backward()
    x = x0.clone().requires_grad_()
    w = w0.clone()
    health = torch.full((1,), 7.0)
    (tops.junction_train_update(x, w, *_all(pat), hyp=torch.tensor([0.5, 0.0]),
                                act="silu", health=health) * g).sum() \
        .backward()
    torch.testing.assert_close(x.grad, x_ref.grad, rtol=0, atol=0)
    torch.testing.assert_close(w, w0 - 0.5 * w_ref.grad, rtol=1e-6,
                               atol=1e-6)
    assert health.tolist() == [0.0]
    with pytest.raises(ValueError, match="param dtype == activation dtype"):
        tops.junction_train_update(x.bfloat16(), w, *_all(pat),
                                   hyp=torch.zeros(2))
    with pytest.raises(ValueError, match="take part in autograd"):
        tops.junction_train_update(x0, w, *_all(pat), hyp=torch.zeros(2))
    with pytest.raises(ValueError, match="fp32 accumulator"):
        tops.junction_train_update(x, w, *_all(pat), hyp=torch.zeros(2),
                                   mom=torch.zeros_like(w).double())
