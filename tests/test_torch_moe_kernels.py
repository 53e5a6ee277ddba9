"""The plain versions of the port's gated kernels (gated_fwd, gated_dx,
gated_dw and the fused update_gated_dw) against the JAX reference's
Pallas kernels in interpret mode, on the CPU.  The CUDA kernels run only
on the card (``chip_smoke.py`` holds each against its plain version
there); here the wrappers take their plain versions because the tensors
lie on the CPU.

Shapes are block-32 copies of qwen3-moe-30b-a3b's expert junctions at
density 0.25: 512->192 (idx [6, 4], reverse fan-in 1-2: the gate shape of
2048->768 at block 128) and 192->512 (idx [16, 2], reverse fan-in 5-6).
Inputs come from numpy seeds and go to both sides.

Tolerances: fp32 results differ in summation order only (atol/rtol 1e-5
on outputs of order one).  bf16 outputs (h, g, u, dx) are bf16 roundings
of fp32 sums that differ in order: one bf16 ulp (rtol 2**-7).  The fp32
gradients of bf16 operands are sums of exact products, but a branch
gradient whose fp32 value differs in its last bit between the two
silu formulas can round to the neighbouring bf16 value, moving a sum by
|x| * ulp(dz): atol 1e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sparsity import make_block_pattern
from repro.kernels import block_sparse_matmul as jbsm
from repro.kernels import ops as jops

from repro_torch.core.interleaver import reverse_block_pattern
from repro_torch.kernels import block_sparse_matmul as tbsm
from repro_torch.kernels import ops as tops

FP32 = dict(atol=1e-5, rtol=1e-5)
BF16 = dict(atol=1e-5, rtol=2.0 ** -7)
SUM_BF16 = dict(atol=1e-3, rtol=1e-5)
GATE, DOWN = (512, 192, 0), (192, 512, 1)       # (n_in, n_out, pattern seed)
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


def _inputs(shape, E, seed=0):
    n_in, n_out, pseed = shape
    pat = make_block_pattern(n_in, n_out, 0.25, 32, seed=pseed)
    nob, kb = pat.idx.shape
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    return pat, dict(x=f32(E, M, n_in), dh=f32(E, M, n_out),
                     wg=f32(E, nob, kb, 32, 32) / np.sqrt(kb * 32),
                     wi=f32(E, nob, kb, 32, 32) / np.sqrt(kb * 32),
                     g=f32(E, M, n_out), u=f32(E, M, n_out))


def _j(a, dtype):
    return jnp.asarray(a, dtype)


def _t(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a)).to(TDT[dtype])


def _rev(pat):
    return [torch.from_numpy(a) for a in (pat.rev_ob, pat.rev_t, pat.rev_cnt)]


def _all(pat):
    return [torch.from_numpy(a)
            for a in (pat.idx, pat.rev_ob, pat.rev_t, pat.rev_cnt)]


def _np(t):
    return np.asarray(t, np.float32) if not torch.is_tensor(t) \
        else t.float().numpy()


def test_patterns_have_fan_in_two_and_ragged_reverse_counts():
    gate = make_block_pattern(*GATE[:2], 0.25, 32, seed=GATE[2])
    down = make_block_pattern(*DOWN[:2], 0.25, 32, seed=DOWN[2])
    assert gate.idx.shape == (6, 4) and down.idx.shape == (16, 2)
    assert set(gate.rev_cnt.tolist()) == {1, 2}
    assert set(down.rev_cnt.tolist()) == {5, 6}


# ------------------------------------------------------------- gated fwd
@pytest.mark.parametrize("shape,dtype,E", [
    (GATE, "float32", 2), (GATE, "bfloat16", 2), (DOWN, "float32", 1)])
def test_gated_fwd_ref_matches_reference(shape, dtype, E):
    """h and the save_res residuals g, u."""
    pat, a = _inputs(shape, E)
    want = jbsm.gated_fwd(_j(a["x"], dtype), _j(a["wg"], dtype),
                          _j(a["wi"], dtype), pat.idx, save_res=True,
                          interpret=True)
    args = (_t(a["x"], dtype), _t(a["wg"], dtype), _t(a["wi"], dtype),
            torch.from_numpy(pat.idx))
    got = tbsm.gated_fwd(*args, save_res=True)
    tol = FP32 if dtype == "float32" else BF16
    for name, g, w in zip(("h", "g", "u"), got, want):
        assert g.dtype == TDT[dtype], name
        np.testing.assert_allclose(_np(g), _np(w.astype(jnp.float32)),
                                   err_msg=name, **tol)
    assert torch.equal(tbsm.gated_fwd(*args), got[0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gated_junction_ragged_rows(dtype):
    """13 rows through junction_matmul(wi=): the reference pads M to its
    row tile, the port's kernels mask the ragged edge."""
    pat, a = _inputs(GATE, 2)
    x = a["x"][:, :13]
    want = jops.junction_matmul(_j(x, dtype), _j(a["wg"], dtype),
                                pat.idx, pat.rev_ob, pat.rev_t, pat.rev_cnt,
                                wi=_j(a["wi"], dtype), interpret=True)
    got = tops.junction_matmul(_t(x, dtype), _t(a["wg"], dtype), *_all(pat),
                               wi=_t(a["wi"], dtype))
    assert tuple(got.shape) == (2, 13, 192)
    np.testing.assert_allclose(_np(got), _np(want.astype(jnp.float32)),
                               **(FP32 if dtype == "float32" else BF16))


# -------------------------------------------------------------- gated dx
@pytest.mark.parametrize("shape,dtype,E", [
    (GATE, "float32", 2), (GATE, "bfloat16", 1), (DOWN, "float32", 1),
    (DOWN, "bfloat16", 2)])
def test_gated_dx_ref_matches_reference(shape, dtype, E):
    pat, a = _inputs(shape, E, seed=1)
    want = jbsm.gated_dx(*(_j(a[k], dtype) for k in ("dh", "wg", "wi")),
                         pat.rev_ob, pat.rev_t, pat.rev_cnt,
                         _j(a["g"], dtype), _j(a["u"], dtype), interpret=True)
    got = tbsm.gated_dx(*(_t(a[k], dtype) for k in ("dh", "wg", "wi")),
                        *_rev(pat), _t(a["g"], dtype), _t(a["u"], dtype))
    assert got.dtype == TDT[dtype]
    np.testing.assert_allclose(_np(got), _np(want.astype(jnp.float32)),
                               **(FP32 if dtype == "float32" else BF16))


def test_gated_dx_padded_reverse_slots_are_exact_zeros():
    """Input blocks 1 and 2 feed no output block (their reverse slots are
    all padding) and dh of output block 0 is inf: their dx must be exact
    zeros on both sides, not inf * w or NaN."""
    idx = np.zeros((2, 1), np.int32)                 # both outputs read block 0
    rev_ob, rev_t, rev_cnt = reverse_block_pattern(idx, 3)
    assert list(rev_cnt) == [2, 0, 0]
    rng = np.random.default_rng(2)
    dh = np.full((1, 16, 64), np.inf, np.float32)
    wg, wi = (rng.standard_normal((1, 2, 1, 32, 32)).astype(np.float32)
              for _ in range(2))
    g, u = (rng.standard_normal((1, 16, 64)).astype(np.float32)
            for _ in range(2))
    want = np.asarray(jbsm.gated_dx(*(jnp.asarray(t) for t in (dh, wg, wi)),
                                    rev_ob, rev_t, rev_cnt, jnp.asarray(g),
                                    jnp.asarray(u), interpret=True))
    got = tbsm.gated_dx(*(torch.from_numpy(t) for t in (dh, wg, wi)),
                        *(torch.from_numpy(t) for t in (rev_ob, rev_t,
                                                        rev_cnt)),
                        torch.from_numpy(g), torch.from_numpy(u)).numpy()
    assert not np.isfinite(got[..., :32]).any()      # block 0 does see inf
    assert (got[..., 32:] == 0).all() and (want[..., 32:] == 0).all()
    assert not np.signbit(got[..., 32:]).any()


# -------------------------------------------------------------- gated dw
@pytest.mark.parametrize("shape,dtype,E", [
    (GATE, "float32", 2), (GATE, "bfloat16", 2), (DOWN, "float32", 1)])
def test_gated_dw_ref_matches_reference(shape, dtype, E):
    pat, a = _inputs(shape, E, seed=3)
    args = ("x", "dh")
    want = jbsm.gated_dw(*(_j(a[k], dtype) for k in args), pat.idx,
                         _j(a["g"], dtype), _j(a["u"], dtype), interpret=True)
    got = tbsm.gated_dw(*(_t(a[k], dtype) for k in args),
                        torch.from_numpy(pat.idx), _t(a["g"], dtype),
                        _t(a["u"], dtype))
    for name, g, w in zip(("dwg", "dwi"), got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **(FP32 if dtype == "float32"
                                      else SUM_BF16))


# ------------------------------------------------------ update_gated_dw
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


def _poison(a):
    """Unit 1: a non-finite gradient in the wg branch only (u = inf) of
    output block 1, in the wi branch only (dh * silu(g) overflows) of
    block 3, and in both branches of block 5."""
    for o, wg_branch, wi_branch in ((1, True, False), (3, False, True),
                                    (5, True, True)):
        col = o * 32 + 7
        a["dh"][1, 2, col] = 4.0
        if wg_branch:
            a["u"][1, 2, col] = np.inf
        if wi_branch:
            a["g"][1, 2, col] = 3e38


def _update_case(dtype, opt, hyp=None, poison=False):
    """The reference's update_gated_dw and the port's on the same
    operands: (reference outputs, port tensors, their values before,
    port health, reference health)."""
    pat, a = _inputs(GATE, 2, seed=4)
    if poison:
        _poison(a)
    rng = np.random.default_rng(5)
    mg, mi = (rng.standard_normal(a["wg"].shape).astype(np.float32) * 0.1
              for _ in range(2))
    vg, vi = np.abs(mg) * 0.1, np.abs(mi) * 0.1
    hyp = _hyp(opt, 2) if hyp is None else hyp
    use_m, use_v = opt != "sgd", opt == "adam"
    # the port updates its operands in place, and in fp32 they share
    # their host buffers with the reference's: the reference finishes
    # reading them before the port starts
    jout = jax.block_until_ready(jbsm.update_gated_dw(
        *(_j(a[k], dtype) for k in ("x", "dh")), pat.idx,
        *(_j(a[k], dtype) for k in ("g", "u", "wg", "wi")),
        jnp.asarray(mg) if use_m else None, jnp.asarray(mi) if use_m else None,
        jnp.asarray(hyp), vg=jnp.asarray(vg) if use_v else None,
        vi=jnp.asarray(vi) if use_v else None, with_health=True,
        interpret=True))
    t = dict(wg=_t(a["wg"], dtype), wi=_t(a["wi"], dtype),
             mg=torch.from_numpy(mg) if use_m else None,
             mi=torch.from_numpy(mi) if use_m else None,
             vg=torch.from_numpy(vg) if use_v else None,
             vi=torch.from_numpy(vi) if use_v else None)
    before = {k: (None if v is None else v.clone()) for k, v in t.items()}
    health = tbsm.update_gated_dw(
        *(_t(a[k], dtype) for k in ("x", "dh")), torch.from_numpy(pat.idx),
        _t(a["g"], dtype), _t(a["u"], dtype), t["wg"], t["wi"], t["mg"],
        t["mi"], torch.from_numpy(hyp), vg=t["vg"], vi=t["vi"],
        with_health=True)
    want = dict(zip(("wg", "wi", "mg", "mi", "vg", "vi"), jout[:6]))
    return want, t, before, health, np.asarray(jout[6]).reshape(-1)


def _update_failure(k, got, want, before, dtype, tol):
    """What leaf k of ``_update_case`` holds at its worst element (the
    element furthest past the tolerance): both results, the branch
    gradient there from each side (the reference's gated_dw in interpret
    mode, the port's plain one) and the weight and slots before the
    step, so that a failure shows which side moved."""
    g, w = _np(got), _np(want)
    i = np.unravel_index(np.argmax(np.abs(g - w) - tol["atol"]
                                   - tol["rtol"] * np.abs(w)), g.shape)
    pat, a = _inputs(GATE, 2, seed=4)
    args = [a[n] for n in ("x", "dh")]
    res = [a[n] for n in ("g", "u")]
    jg = jbsm.gated_dw(*(_j(v, dtype) for v in args), pat.idx,
                       *(_j(v, dtype) for v in res), interpret=True)
    tg = tbsm.gated_dw_ref(*(_t(v, dtype) for v in args),
                           torch.from_numpy(pat.idx),
                           *(_t(v, dtype) for v in res))
    br = 0 if k.endswith("g") else 1                 # wg / mg / vg: dz_g
    was = {n: None if before[n] is None else _np(before[n])[i]
           for n in (c + "gi"[br] for c in "wmv")}
    return (f"leaf {k}, element {tuple(int(j) for j in i)}: port "
            f"{g[i]!r}, reference {w[i]!r}; gradient: port "
            f"{_np(tg[br])[i]!r}, reference {_np(jg[br])[i]!r}; before the "
            f"step: {was}")


@pytest.mark.parametrize("opt,dtype", [
    ("sgd", "float32"), ("momentum", "float32"), ("adam", "float32"),
    ("adam", "bfloat16")])
def test_update_gated_dw_ref_matches_reference(opt, dtype):
    want, got, before, health, jhealth = _update_case(dtype, opt)
    tol = dict(atol=2e-5, rtol=1e-5) if dtype == "float32" else BF16
    for k, v in got.items():
        if v is None:
            assert want[k] is None, k
            continue
        assert v.dtype == (TDT[dtype] if k in ("wg", "wi")
                           else torch.float32)
        try:
            np.testing.assert_allclose(_np(v), _np(want[k]), err_msg=k,
                                       **tol)
        except AssertionError as e:
            raise AssertionError(f"{e}\n" + _update_failure(
                k, v, want[k], before, dtype, tol)) from None
    assert health.tolist() == jhealth.tolist() == [0, 0]


@pytest.mark.parametrize("opt", ["sgd", "momentum", "adam"])
def test_update_gated_dw_counts_each_poisoned_tile_once(opt):
    """Three tiles of unit 1 go non-finite (wg branch only, wi branch
    only, both): each counts once, on both sides; unit 0 is unaffected."""
    want, got, _, health, jhealth = _update_case("float32", opt, poison=True)
    assert jhealth.tolist() == [0, 3]
    assert health.tolist() == [0, 3]
    for k in ("wg", "wi"):
        np.testing.assert_allclose(got[k][0].numpy(), np.asarray(want[k][0]),
                                   atol=2e-5, rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("opt", ["sgd", "momentum", "adam"])
def test_gated_zero_hyp_row_freezes_both_branches_bitwise(opt):
    hyp = _hyp(opt, 2)
    hyp[1] = 0.0
    want, got, before, _, _ = _update_case("float32", opt, hyp=hyp)
    for k in ("wg", "wi"):
        assert torch.equal(got[k][1], before[k][1]), k
        assert not torch.equal(got[k][0], before[k][0]), k
        np.testing.assert_array_equal(np.asarray(want[k][1]),
                                      before[k][1].numpy())


# ---------------------------------------------------------- autograd
def test_gated_junction_grads_match_reference_grad():
    """x, wg and wi gradients of the gated junction (the plain versions
    behind the autograd Function) against jax.grad of the reference's
    gated junction_matmul in interpret mode, fp32."""
    pat, a = _inputs(GATE, 2, seed=6)
    rng = np.random.default_rng(7)
    cot = rng.standard_normal((2, M, 192)).astype(np.float32)

    def jloss(x, wg, wi):
        y = jops.junction_matmul(x, wg, pat.idx, pat.rev_ob, pat.rev_t,
                                 pat.rev_cnt, wi=wi, interpret=True)
        return jnp.sum(y * cot)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(a[k]) for k in ("x", "wg", "wi")))
    ts = [torch.from_numpy(a[k]).requires_grad_() for k in ("x", "wg", "wi")]
    y = tops.junction_matmul(ts[0], ts[1], *_all(pat), wi=ts[2])
    (y * torch.from_numpy(cot)).sum().backward()
    for name, t, w in zip(("x", "wg", "wi"), ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   err_msg=name, **FP32)


def test_gated_junction_gradcheck_fp64():
    """The gated Function's gated_dx / gated_dw backward against finite
    differences in float64, in the 4-D (single junction) form."""
    pat = make_block_pattern(96, 64, 0.5, 32, seed=0)
    rng = np.random.default_rng(8)
    x = torch.tensor(rng.standard_normal((3, 96)), requires_grad=True)
    wg, wi = (torch.tensor(rng.standard_normal(pat.idx.shape + (32, 32))
                           * 0.2, requires_grad=True) for _ in range(2))
    fn = lambda x_, g_, i_: tops.junction_matmul(x_, g_, *_all(pat), wi=i_)
    assert torch.autograd.gradcheck(fn, (x, wg, wi), eps=1e-6, atol=1e-6)


def test_gated_train_update_runs_dx_on_old_weights_and_updates_in_place():
    """junction_train_update(wi=): dx equals the two-pass dx (weights
    before the step), both streams move by exactly -lr * grad under plain
    SGD, and the health tensor receives the kernel's counts."""
    pat = make_block_pattern(96, 64, 0.5, 32, seed=0)
    rng = np.random.default_rng(9)
    x0 = torch.tensor(rng.standard_normal((2, 5, 96)), dtype=torch.float32)
    w0 = [torch.tensor(rng.standard_normal((2,) + pat.idx.shape + (32, 32))
                       * 0.2, dtype=torch.float32) for _ in range(2)]
    cot = torch.tensor(rng.standard_normal((2, 5, 64)), dtype=torch.float32)
    x_ref = x0.clone().requires_grad_()
    w_ref = [w.clone().requires_grad_() for w in w0]
    (tops.junction_matmul(x_ref, w_ref[0], *_all(pat), wi=w_ref[1])
     * cot).sum().backward()
    x = x0.clone().requires_grad_()
    wg, wi = (w.clone() for w in w0)
    health = torch.full((2,), 7.0)
    (tops.junction_train_update(x, wg, *_all(pat), wi=wi,
                                hyp=torch.tensor([0.5, 0.0]), health=health)
     * cot).sum().backward()
    torch.testing.assert_close(x.grad, x_ref.grad, rtol=0, atol=0)
    for w, w_start, r in ((wg, w0[0], w_ref[0]), (wi, w0[1], w_ref[1])):
        torch.testing.assert_close(w, w_start - 0.5 * r.grad, rtol=1e-6,
                                   atol=1e-6)
    assert health.tolist() == [0.0, 0.0]


def test_gated_junction_refusals():
    pat = make_block_pattern(96, 64, 0.5, 32, seed=0)
    x = torch.randn(2, 3, 96, requires_grad=True)
    wg = torch.randn((2,) + pat.idx.shape + (32, 32))
    wi = wg.clone()
    hyp = torch.zeros(2)
    with pytest.raises(ValueError, match="takes no bias"):
        tops.junction_matmul(x, wg, *_all(pat), wi=wi, act="relu")
    with pytest.raises(ValueError, match="takes no bias"):
        tops.junction_train_update(x, wg, *_all(pat), wi=wi, hyp=hyp,
                                   bias=torch.zeros(2, 64))
    with pytest.raises(ValueError, match="param dtype == activation dtype"):
        tops.junction_train_update(x, wg, *_all(pat), wi=wi.bfloat16(),
                                   hyp=hyp)
    with pytest.raises(ValueError, match="momentum for both branches"):
        tops.junction_train_update(x, wg, *_all(pat), wi=wi, hyp=hyp,
                                   mom=torch.zeros_like(wg))
    with pytest.raises(ValueError, match="fp32 accumulator"):
        tops.junction_train_update(x, wg, *_all(pat), wi=wi, hyp=hyp,
                                   mom=torch.zeros_like(wg),
                                   mom_wi=torch.zeros_like(wg).double())
    with pytest.raises(ValueError, match="wi must be shaped"):
        tbsm.gated_fwd(x.detach(), wg, wi[:, :1].contiguous(),
                       torch.from_numpy(pat.idx))


# ------------------------------------------------------- device routing
_GATED = ("gated_fwd", "gated_dx", "gated_dw", "update_gated_dw")


@pytest.mark.parametrize("name", _GATED)
def test_gated_wrapper_on_a_card_tensor_launches_or_raises(name, monkeypatch):
    """A card tensor never reaches the plain version: the wrapper goes to
    its kernel, which here (no card, no nvcc) raises.  A meta tensor, which
    carries shapes only, takes the plain version and launches nothing."""
    pat, a = _inputs(GATE, 1)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    idx, rev = torch.from_numpy(pat.idx), _rev(pat)
    args = {"gated_fwd": (t["x"], t["wg"], t["wi"], idx),
            "gated_dx": (t["dh"], t["wg"], t["wi"], *rev, t["g"], t["u"]),
            "gated_dw": (t["x"], t["dh"], idx, t["g"], t["u"]),
            "update_gated_dw": (t["x"], t["dh"], idx, t["g"], t["u"],
                                t["wg"], t["wi"], None, None,
                                torch.zeros(7))}[name]

    def plain(*a, **k):
        raise AssertionError("the plain version ran for a card tensor")

    monkeypatch.setattr(tbsm, f"{name}_ref", plain)
    monkeypatch.setattr(tbsm, "_route", lambda t, what: False)
    before = getattr(tbsm, name).launches
    with pytest.raises((RuntimeError, ValueError)):   # no card, no nvcc
        getattr(tbsm, name)(*args)
    assert getattr(tbsm, name).launches == before
    monkeypatch.undo()
    seen = []
    monkeypatch.setattr(tbsm, f"{name}_ref",
                        lambda *a, **k: seen.append(a[0].device.type))
    getattr(tbsm, name)(*(x.to("meta") if torch.is_tensor(x) else x
                          for x in args))
    assert seen == ["meta"] and getattr(tbsm, name).launches == before


def test_gated_kernels_are_counted():
    assert {f"junction_{n}" for n in _GATED} <= set(tops.launch_counts())
    tops.reset_launch_counts()
    assert set(tops.launch_counts().values()) == {0}
