"""The plain versions of the port's two CUDA kernels against the JAX
reference on the CPU.  The CUDA kernels themselves run only on the card
(``chip_smoke.py`` holds each against its plain version there); here the
wrappers take their plain versions because the tensors lie on the CPU.

Junction shapes are a block-32 copy of the full-width stablelm-3b FFN
junctions: 640->1728 and 1728->640 give the same idx ([54, 5] and
[20, 14]) as 2560->6912 and 6912->2560 at block 128.  The reference runs
``ops.junction_matmul(..., interpret=True)``, which pads the rows that
``bsm.fwd`` alone would refuse (M = 33)."""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sparsity import make_block_pattern
from repro.kernels import block_sparse_matmul as jbsm
from repro.kernels import flash_attention as jfa
from repro.kernels import ops as jops

from repro_torch.kernels import block_sparse_matmul as tbsm
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops

# fp32: the two sides sum the same products in another order.
FP32 = dict(atol=1e-5, rtol=0)
# bf16: both sides round an fp32 result that differs only in summation
# order, so an output may differ by one bf16 ulp (2**-7 relative).
BF16 = dict(atol=1e-5, rtol=2.0 ** -7)
UP, DOWN = (640, 1728, 0), (1728, 640, 1)       # (n_in, n_out, pattern seed)


def _junction_inputs(shape, M, dtype, with_bias, seed=0):
    n_in, n_out, pseed = shape
    pat = make_block_pattern(n_in, n_out, 0.25, 32, seed=pseed)
    rng = np.random.default_rng(seed)
    kb = pat.fan_in_blocks
    w = (rng.standard_normal((pat.n_out_blocks, kb, 32, 32))
         / np.sqrt(kb * 32)).astype(np.float32)
    x = rng.standard_normal((M, n_in)).astype(np.float32)
    b = (rng.standard_normal(n_out).astype(np.float32) if with_bias
         else None)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(x).to(tdt)
    return pat, w, b, jx, tx


def _pattern_tensors(pat):
    return [torch.from_numpy(a)
            for a in (pat.idx, pat.rev_ob, pat.rev_t, pat.rev_cnt)]


def _check_junction(shape, M, dtype, act, with_bias):
    pat, w, b, jx, tx = _junction_inputs(shape, M, dtype, with_bias)
    want = jops.junction_matmul(
        jx, jnp.asarray(w), pat.idx, pat.rev_ob, pat.rev_t, pat.rev_cnt,
        bias=None if b is None else jnp.asarray(b), act=act, interpret=True)
    got = tops.junction_matmul(
        tx, torch.from_numpy(w), *_pattern_tensors(pat),
        bias=None if b is None else torch.from_numpy(b), act=act)
    assert got.dtype == tx.dtype and tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **(FP32 if dtype == "float32" else BF16))


@pytest.mark.parametrize("act", tbsm.ACTIVATIONS)
def test_junction_every_activation_fp32_with_bias(act):
    _check_junction(UP, 33, "float32", act, True)


@pytest.mark.parametrize("act", tbsm.ACTIVATIONS)
def test_junction_every_activation_bf16_no_bias(act):
    _check_junction(UP, 4, "bfloat16", act, False)


@pytest.mark.parametrize("dtype,M", [("float32", 33), ("bfloat16", 4)])
def test_junction_down_projection(dtype, M):
    """The wo shape: kb 14 slots gathered from 54 input blocks (the other
    dtype/M pairs are covered at the up-projection shape)."""
    _check_junction(DOWN, M, dtype, "none", False)


def test_junction_gate_shape_silu_bf16_prefill():
    _check_junction(UP, 33, "bfloat16", "silu", False)


def test_junction_expert_batched_and_leading_dims():
    """5-D weights (E units sharing one pattern) against the reference,
    and the E=1 squeeze keeping the caller's leading dims."""
    pat = make_block_pattern(128, 256, 0.5, 32, seed=0)
    rng = np.random.default_rng(3)
    E, M = 3, 5
    w = rng.standard_normal((E, 8, 2, 32, 32)).astype(np.float32) / 8
    x = rng.standard_normal((E, M, 128)).astype(np.float32)
    b = rng.standard_normal((E, 256)).astype(np.float32)
    want = jops.junction_matmul(jnp.asarray(x), jnp.asarray(w), pat.idx,
                                pat.rev_ob, pat.rev_t, pat.rev_cnt,
                                bias=jnp.asarray(b), act="relu",
                                interpret=True)
    got = tops.junction_matmul(torch.from_numpy(x), torch.from_numpy(w),
                               *_pattern_tensors(pat),
                               bias=torch.from_numpy(b), act="relu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)
    x4 = torch.from_numpy(x[0]).reshape(1, M, 128)
    y4 = tops.junction_matmul(x4, torch.from_numpy(w[0]),
                              *_pattern_tensors(pat))
    assert tuple(y4.shape) == (1, M, 256)
    ref = tbsm.fwd_ref(torch.from_numpy(x[:1]), torch.from_numpy(w[:1]),
                       torch.from_numpy(pat.idx), torch.zeros(1, 256))
    assert torch.equal(y4, ref)


@pytest.mark.parametrize("act", tbsm.ACTIVATIONS)
def test_act_fwd_matches_reference(act):
    s = np.linspace(-12, 12, 2001).astype(np.float32)
    want = np.asarray(jbsm.act_fwd(jnp.asarray(s), act))
    got = tbsm.act_fwd(torch.from_numpy(s), act).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def test_wrappers_use_plain_versions_only_on_cpu():
    pat = make_block_pattern(128, 256, 0.5, 32, seed=0)
    x = torch.randn(1, 4, 128)
    w = torch.randn(1, 8, 2, 32, 32)
    idx = torch.from_numpy(pat.idx)
    b = torch.zeros(1, 256)
    tops.reset_launch_counts()
    assert torch.equal(tbsm.fwd(x, w, idx, b, "silu"),
                       tbsm.fwd_ref(x, w, idx, b, "silu"))
    # a meta tensor carries shapes only: it takes the plain version too
    got = tbsm.fwd(x.to("meta"), w.to("meta"), idx.to("meta"), b.to("meta"))
    assert got.device.type == "meta" and got.shape == (1, 4, 256)
    with pytest.raises(ValueError, match="cpu, meta or cuda"):
        tbsm.fwd(types.SimpleNamespace(device=torch.device("xpu")), w, idx,
                 b)
    q = torch.randn(2, 2, 1, 16)
    pool = torch.randn(3, 4, 2, 16)
    pt = torch.tensor([[1], [2]], dtype=torch.int32)
    lens = torch.tensor([3, 0], dtype=torch.int32)
    got = tfa.flash_decode(q.to("meta"), pool.to("meta"), pool.to("meta"),
                           pt.to("meta"), lens.to("meta"))
    assert got.device.type == "meta" and got.shape == q.shape
    assert torch.equal(tfa.flash_decode(q, pool, pool, pt, lens),
                       tfa.paged_decode_ref(q, pool, pool, pt, lens))
    assert set(tops.launch_counts().values()) == {0}


def test_fwd_refuses_bad_operands():
    pat = make_block_pattern(128, 256, 0.5, 32, seed=0)
    x = torch.randn(1, 4, 128, dtype=torch.bfloat16)
    w = torch.randn(1, 8, 2, 32, 32)
    idx = torch.from_numpy(pat.idx)
    b = torch.zeros(1, 256, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="x's dtype"):
        tbsm.fwd(x, w, idx, b)                        # w not cast
    with pytest.raises(ValueError, match="activation"):
        tbsm.fwd(x, w.bfloat16(), idx, b, "tanh")
    with pytest.raises(ValueError, match="int32"):
        tbsm.fwd(x, w.bfloat16(), idx.long(), b)
    with pytest.raises(ValueError, match="shape"):
        tbsm.fwd(x, w.bfloat16(), idx[:, :1], b)


# ------------------------------------------------------------ flash_decode
def _decode_inputs(lens, rep, seed):
    B, Hkv, D, ps, maxp = len(lens), 2, 32, 8, 3
    P = 1 + B * maxp
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hkv, rep, D)).astype(np.float32)
    k = rng.standard_normal((P, ps, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((P, ps, Hkv, D)).astype(np.float32)
    pt = np.zeros((B, maxp), np.int32)
    nxt = 1
    for b, n in enumerate(lens):
        for j in range(-(-max(n, 1) // ps)):
            pt[b, j] = nxt
            nxt += 1
    pt = pt[:, ::-1].copy() if seed % 2 else pt     # page order is arbitrary
    sl = np.asarray(lens, np.int32)
    return q, k, v, pt, sl


@pytest.mark.parametrize("rep", [1, 4])
def test_flash_decode_matches_reference_kernel(rep):
    """Ragged lengths including 0 and full pages, against the reference's
    Pallas flash_decode (interpret mode) and its paged_decode_ref."""
    lens = [0, 1, 7, 8, 23, 24]
    q, k, v, pt, sl = _decode_inputs(lens, rep, seed=0)
    args = [jnp.asarray(a) for a in (q, k, v, pt, sl)]
    want_kernel = np.asarray(jfa.flash_decode(*args, interpret=True))
    want_ref = np.asarray(jfa.paged_decode_ref(*args))
    got = tfa.flash_decode(*(torch.from_numpy(a) for a in (q, k, v, pt, sl)))
    np.testing.assert_allclose(got.numpy(), want_kernel, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got.numpy(), want_ref, atol=2e-5, rtol=2e-5)
    assert not np.any(got.numpy()[sl == 0])                 # exact zeros


@pytest.mark.parametrize("rep", [1, 4])
def test_paged_decode_ref_bf16_matches_reference(rep):
    lens = [5, 0, 24, 13]
    q, k, v, pt, sl = _decode_inputs(lens, rep, seed=1)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    want = np.asarray(jfa.paged_decode_ref(*jb, jnp.asarray(pt),
                                           jnp.asarray(sl)).astype(jnp.float32))
    tb = [torch.from_numpy(a).bfloat16() for a in (q, k, v)]
    got = tfa.paged_decode_ref(*tb, torch.from_numpy(pt),
                               torch.from_numpy(sl))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, **BF16)
    assert not np.any(got.float().numpy()[sl == 0])
