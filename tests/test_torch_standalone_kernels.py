"""The port's four standalone kernels against the JAX reference on the
CPU: the fixed-point matmul (``ops.fxp_qmatmul``), the table lookup
(``ops.sigmoid_lut``), the Mamba-1 selective scan and flash attention
(``mha``).  The CUDA kernels run only on the card (``chip_smoke.py``
holds each against its plain version there); here the wrappers take
their plain versions because the tensors lie on the CPU.

The reference runs its Pallas kernels in interpret mode and its oracles
(``kernels/ref.py``, the softmax oracle of ``tests/test_kernels.py``).
Inputs are made with numpy from a seed.

Tolerances:
- the matmul and the lookup: exact (integer arithmetic; a table read),
  NaNs of out-of-range codes in the same places;
- the scan in fp32: 1e-5 of max |y| and of max |h| (both sides sum in
  fp32 with their own exp; the decay is at most 1, so an error does not
  grow along the sequence); with bf16 inputs, one bf16 ulp of y;
- attention in fp32: 2e-5 (one fp32 softmax against another, sums of at
  most 256 terms in another order); bf16: one bf16 ulp.
"""
import ast
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fixed_point as jfp
from repro.kernels import flash_attention as jfa
from repro.kernels import fxp_qmatmul as jfxpk
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import selective_scan as jss
from repro.kernels import sigmoid_lut as jslut

from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import fxp_qmatmul as tfxpk
from repro_torch.kernels import ops as tops
from repro_torch.kernels import selective_scan as tss
from repro_torch.kernels import sigmoid_lut as tslut
from repro_torch.models.attention import chunked_attention

ROOT = Path(__file__).resolve().parents[1]
TRIPLETS = [(f.bw, f.bn, f.bf) for f in jfp.PAPER_TRIPLETS]
ATTN_F32 = dict(atol=2e-5, rtol=2e-5)
BF16_ULP = 2.0 ** -7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------ fxp qmatmul
@pytest.mark.parametrize("fmt", TRIPLETS, ids=[f"{t}" for t in TRIPLETS])
@pytest.mark.parametrize("M,K,N", [(128, 128, 128), (100, 200, 96),
                                   (257, 130, 50), (75, 33, 50)])
def test_qmatmul_bit_exact_vs_reference(M, K, N, fmt):
    bw, bn, bf = fmt
    lim = 1 << (bn + bf)
    rng = np.random.default_rng(M * K + N + bw)
    a = rng.integers(-lim, lim, (M, K), dtype=np.int32)
    w = rng.integers(-lim, lim, (K, N), dtype=np.int32)
    got = tops.fxp_qmatmul(_t(a), _t(w), bf=bf, bn=bn)
    assert got.dtype == torch.int32 and got.shape == (M, N)
    want = np.asarray(jfxpk.qmatmul(jnp.asarray(a), jnp.asarray(w), bf=bf,
                                    bn=bn, interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jref.fxp_qmatmul(jnp.asarray(a),
                                                 jnp.asarray(w), bf, bn)))


def test_qmatmul_int32_sum_wraps_as_the_reference():
    """1024 products of (2^15 - 1)^2 overflow int32: the reference's dot
    wraps, and so does the port (-32767 at (16, 4, 11))."""
    bw, bn, bf = TRIPLETS[-1]
    a = np.full((4, 1024), 2 ** 15 - 1, np.int32)
    w = np.full((1024, 3), 2 ** 15 - 1, np.int32)
    w[:, 1] = -(2 ** 15)
    got = tfxpk.qmatmul(_t(a), _t(w), bf=bf, bn=bn).numpy()
    want = np.asarray(jfxpk.qmatmul(jnp.asarray(a), jnp.asarray(w), bf=bf,
                                    bn=bn, interpret=True))
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] == -32767
    assert int(a[0].astype(np.int64) @ w[:, 0].astype(np.int64)) > 2 ** 31


def test_qmatmul_plain_sum_exact_for_any_int32_codes():
    """The 16-bit halves keep the plain sum exact modulo 2^32 for codes
    beyond 16 bits too: against an int64 numpy dot wrapped to int32."""
    rng = np.random.default_rng(3)
    a = rng.integers(-2 ** 31, 2 ** 31, (9, 300), dtype=np.int64)
    w = rng.integers(-2 ** 31, 2 ** 31, (300, 7), dtype=np.int64)
    acc = np.zeros((9, 7), np.uint64)
    for k in range(300):   # uint64 products and sums wrap mod 2^64
        acc += np.outer(a[:, k].astype(np.uint64), w[k].astype(np.uint64))
    acc32 = (acc & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    bf, bn = 11, 4
    rounded = (acc32.astype(np.int64) + (1 << (bf - 1)) + 2 ** 31) \
        % 2 ** 32 - 2 ** 31
    want = np.clip(rounded >> bf, -(1 << (bn + bf)), (1 << (bn + bf)) - 1)
    got = tfxpk.qmatmul(_t(a.astype(np.int32)), _t(w.astype(np.int32)),
                        bf=bf, bn=bn)
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------ sigmoid LUT
@pytest.mark.parametrize("fmt", [jfp.PAPER_FMT, jfp.PAPER_TRIPLETS[-1]],
                         ids=["paper_fmt", "16_4_11"])
def test_sigmoid_lut_bit_exact_with_out_of_range_codes(fmt):
    table, _ = jfp.sigmoid_tables(fmt)
    T = table.shape[0]
    assert T == 2 ** fmt.bw
    rng = np.random.default_rng(T)
    codes = rng.integers(0, T, (2, 3, 77), dtype=np.int32)
    codes[0, 0, :8] = [T, T + 5, -1, -T, -T - 1, 2 ** 31 - 1, -2 ** 31, 0]
    codes[1, 2, ::3] = rng.integers(-2 * T, 2 * T, 26, dtype=np.int32)
    got = tops.sigmoid_lut(_t(codes), _t(table)).numpy()
    assert got.shape == codes.shape and got.dtype == np.float32
    want = np.asarray(jops.sigmoid_lut(jnp.asarray(codes), jnp.asarray(table),
                                       interpret=True))
    take = np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(codes), axis=0))
    for ref in (want, take):
        np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
        np.testing.assert_array_equal(got, ref)    # NaNs compare equal here
    valid = (codes >= -T) & (codes < T)
    assert np.isnan(got).sum() == (~valid).sum() > 0
    np.testing.assert_array_equal(got[0, 0, 2], table[T - 1])


def test_lut_lookup_ragged_rows_vs_reference_kernel():
    table, _ = jfp.sigmoid_tables(jfp.PAPER_FMT)
    codes = np.random.default_rng(0).integers(0, 4096, (37, 77),
                                              dtype=np.int32)
    got = tslut.lut_lookup(_t(codes), _t(table)).numpy()
    want = np.asarray(jslut.lut_lookup(jnp.asarray(codes), jnp.asarray(table),
                                       interpret=True))
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ selective scan
def _scan_inputs(B, S, di, N, seed):
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, di)))) * 0.1
    x = rng.standard_normal((B, S, di))
    bc = rng.standard_normal((B, S, N))
    cc = rng.standard_normal((B, S, N))
    a = -np.exp(rng.standard_normal((di, N)) * 0.3)
    h0 = rng.standard_normal((B, di, N)) * 0.1
    return [v.astype(np.float32) for v in (dt, x, bc, cc, a, h0)]


def _rel_err(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("B,S,di,N,chunk,bd", [
    (2, 128, 512, 16, 64, 256), (1, 256, 256, 8, 128, 256),
    (3, 64, 1024, 32, 32, 512),
])
def test_selective_scan_vs_reference_kernel(B, S, di, N, chunk, bd):
    ins = _scan_inputs(B, S, di, N, B * S + di)
    y, h = tss.selective_scan(*map(_t, ins))
    assert y.dtype == torch.float32 and h.dtype == torch.float32
    y1, h1 = jss.selective_scan(*map(jnp.asarray, ins), chunk=chunk, bd=bd,
                                interpret=True)
    y2, h2 = jref.selective_scan(*map(jnp.asarray, ins))
    for got, want in ((y, y1), (h, h1), (y, y2), (h, h2)):
        assert _rel_err(got.numpy(), np.asarray(want)) <= 1e-5


def test_selective_scan_bf16_inputs_vs_reference_kernel():
    """bf16 dt, x, B, C (fp32 A and h0): both sides compute in fp32 and
    round y to bf16 once; h_last stays fp32."""
    ins = _scan_inputs(2, 64, 256, 16, 11)
    bf = [jnp.asarray(v).astype(jnp.bfloat16) for v in ins[:4]] \
        + [jnp.asarray(v) for v in ins[4:]]
    y1, h1 = jss.selective_scan(*bf, chunk=32, bd=128, interpret=True)
    tin = [_t(np.asarray(v.astype(jnp.float32))).to(torch.bfloat16)
           for v in bf[:4]] + [_t(v) for v in ins[4:]]
    y, h = tss.selective_scan(*tin)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    want = np.asarray(y1.astype(jnp.float32))
    np.testing.assert_allclose(y.float().numpy(), want, rtol=BF16_ULP,
                               atol=1e-5)
    assert _rel_err(h.numpy(), np.asarray(h1)) <= 1e-5


def test_selective_scan_any_length_and_width():
    """No tile limits: S and di need not divide a chunk or a channel
    tile (the reference kernel asserts both); against its oracle."""
    ins = _scan_inputs(1, 37, 100, 5, 2)
    y, h = tss.selective_scan(*map(_t, ins))
    y2, h2 = jref.selective_scan(*map(jnp.asarray, ins))
    assert _rel_err(y.numpy(), np.asarray(y2)) <= 1e-5
    assert _rel_err(h.numpy(), np.asarray(h2)) <= 1e-5


def test_hbm_bytes_matches_reference_model():
    for args in ((16, 4096, 512, 16), (1, 4096, 8192, 16, 2)):
        assert tss.hbm_bytes(*args) == jss.hbm_bytes(*args)


# ------------------------------------------------------------ flash attention
def _attn_oracle(q, k, v, causal, window):
    """The softmax oracle of the reference's tests, in jnp."""
    rep = q.shape[2] // k.shape[2]
    kf = jnp.repeat(k, rep, axis=2)
    vf = jnp.repeat(v, rep, axis=2)
    s = jnp.einsum("bqhd,bkhd->bhqk", q, kf) / np.sqrt(q.shape[-1])
    qp = jnp.arange(q.shape[1])[:, None]
    kp = jnp.arange(k.shape[1])[None, :]
    mask = jnp.ones_like(qp >= kp) if not causal else (qp >= kp)
    if window:
        mask = mask & (qp - kp < window)
    s = jnp.where(mask[None, None], s, -1e30)
    return jnp.einsum("bhqk,bkhd->bqhd", jax.nn.softmax(s, -1), vf)


def _qkv(B, Sq, Sk, H, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, D)).astype(np.float32),
            rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32),
            rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32))


@pytest.mark.parametrize("H,Hkv,Sq,window", [
    (4, 4, 128, 0), (8, 2, 128, 0), (4, 2, 256, 96), (2, 1, 64, 0),
])
def test_mha_vs_reference_kernel(H, Hkv, Sq, window):
    q, k, v = _qkv(2, Sq, Sq, H, Hkv, 32, H * Sq)
    got = tfa.mha(*map(_t, (q, k, v)), causal=True, window=window)
    assert got.shape == q.shape
    want = jfa.mha(*map(jnp.asarray, (q, k, v)), causal=True, window=window,
                   interpret=True, bq=64, bk=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_F32)


@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (37, 37, True, 0), (37, 53, False, 0), (100, 100, True, 48),
    (1, 64, False, 0),
])
def test_mha_ragged_vs_reference_kernel_and_oracle(Sq, Sk, causal, window):
    q, k, v = _qkv(2, Sq, Sk, 4, 4, 32, Sq * Sk)
    got = tfa.mha(*map(_t, (q, k, v)), causal=causal, window=window).numpy()
    want = jfa.mha(*map(jnp.asarray, (q, k, v)), causal=causal,
                   window=window, interpret=True, bq=64, bk=64)
    np.testing.assert_allclose(got, np.asarray(want), **ATTN_F32)
    oracle = _attn_oracle(*map(jnp.asarray, (q, k, v)), causal, window)
    np.testing.assert_allclose(got, np.asarray(oracle), **ATTN_F32)


def test_mha_head_dim_80_gqa_vs_reference_kernel():
    """stablelm-3b's head_dim (not a power of two), GQA rep 4."""
    q, k, v = _qkv(1, 96, 96, 8, 2, 80, 80)
    got = tfa.mha(*map(_t, (q, k, v)), causal=True)
    want = jfa.mha(*map(jnp.asarray, (q, k, v)), causal=True, interpret=True,
                   bq=32, bk=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_F32)


def test_mha_bf16_within_one_ulp_of_reference_kernel():
    q, k, v = _qkv(2, 64, 64, 4, 2, 32, 5)
    jb = [jnp.asarray(t).astype(jnp.bfloat16) for t in (q, k, v)]
    want = jfa.mha(*jb, causal=True, window=24, interpret=True, bq=32, bk=32)
    tb = [_t(np.asarray(t.astype(jnp.float32))).to(torch.bfloat16)
          for t in jb]
    got = tfa.mha(*tb, causal=True, window=24)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=BF16_ULP, atol=1e-5)


def test_mha_row_without_valid_key_follows_the_oracle():
    """Sq 100 over Sk 10 with window 5: rows 14.. see no key, and their
    softmax over Sk scores of -1e30 averages V uniformly."""
    q, k, v = _qkv(1, 100, 10, 2, 2, 32, 7)
    got = tfa.mha(*map(_t, (q, k, v)), causal=True, window=5).numpy()
    oracle = np.asarray(_attn_oracle(*map(jnp.asarray, (q, k, v)), True, 5))
    np.testing.assert_allclose(got, oracle, **ATTN_F32)
    np.testing.assert_allclose(got[0, 50], v.mean(axis=1)[0], atol=1e-6)


def test_mha_row_without_valid_key_vs_reference_kernel_at_tile_multiple():
    """At Sk a multiple of the reference's key tile its kernel averages
    the rows with no valid key over exactly Sk keys, as the port does."""
    q, k, v = _qkv(1, 100, 64, 2, 2, 32, 8)
    got = tfa.mha(*map(_t, (q, k, v)), causal=True, window=5).numpy()
    want = jfa.mha(*map(jnp.asarray, (q, k, v)), causal=True, window=5,
                   interpret=True, bq=64, bk=64)
    np.testing.assert_allclose(got, np.asarray(want), **ATTN_F32)


def test_reference_kernel_averages_empty_rows_over_its_padded_keys():
    """The reference kernel's divergence from its oracle (a caveat, not a
    port fault): at Sk 70 with key tiles of 64 it averages a row with no
    valid key over 128 rows, 58 of them zero padding, so the row reads
    the oracle's value x 70/128.  The port keeps the oracle's."""
    q, k, v = _qkv(1, 100, 70, 2, 2, 32, 9)
    ref = np.asarray(jfa.mha(*map(jnp.asarray, (q, k, v)), causal=True,
                             window=5, interpret=True, bq=64, bk=64))
    oracle = np.asarray(_attn_oracle(*map(jnp.asarray, (q, k, v)), True, 5))
    got = tfa.mha(*map(_t, (q, k, v)), causal=True, window=5).numpy()
    empty = slice(74, 100)          # qpos >= Sk + window - 1
    np.testing.assert_allclose(ref[:, empty], oracle[:, empty] * 70 / 128,
                               atol=1e-6)
    np.testing.assert_allclose(ref[:, :74], oracle[:, :74], **ATTN_F32)
    np.testing.assert_allclose(got, oracle, **ATTN_F32)


@pytest.mark.parametrize("H,Hkv,window", [(4, 4, 0), (8, 2, 0), (4, 2, 96)])
def test_mha_matches_port_chunked_attention(H, Hkv, window):
    q, k, v = _qkv(2, 128, 128, H, Hkv, 32, H * 7 + window)
    tq, tk, tv = map(_t, (q, k, v))
    got = tfa.mha(tq, tk, tv, causal=True, window=window)
    want = chunked_attention(tq, tk, tv, causal=True, window=window,
                             chunk=32)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **ATTN_F32)


# ------------------------------------------------------------ the wrappers
_NEW_MODULES = ("kernels/fxp_qmatmul.py", "kernels/sigmoid_lut.py",
                "kernels/selective_scan.py", "kernels/flash_attention.py",
                "kernels/ops.py")


@pytest.mark.parametrize("rel", _NEW_MODULES)
def test_standalone_modules_import_no_jax_and_no_reference(rel):
    path = ROOT / "src" / "repro_torch" / rel
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "repro"), name


def _cases():
    i32 = torch.ones((4, 8), dtype=torch.int32)
    table = torch.rand(16)
    scan = [torch.rand(1, 6, 8), torch.rand(1, 6, 8), torch.rand(1, 6, 4),
            torch.rand(1, 6, 4), -torch.rand(8, 4), torch.rand(1, 8, 4)]
    q, k = torch.rand(4, 5, 16), torch.rand(2, 5, 16)
    return {
        "qmatmul": (lambda *a: tfxpk.qmatmul(*a, bf=8, bn=3),
                    (i32, i32.T.contiguous())),
        "lut_lookup": (tslut.lut_lookup, (i32, table)),
        "selective_scan": (tss.selective_scan, scan),
        "flash_attention": (tfa.flash_attention, (q, k, k)),
    }


@pytest.mark.parametrize("name", ["qmatmul", "lut_lookup", "selective_scan",
                                  "flash_attention"])
def test_wrappers_plain_on_cpu_refuse_other_devices(name):
    fn, args = _cases()[name]
    tops.reset_launch_counts()
    want = fn(*args)                            # CPU: the plain version
    got = fn(*(a.to("meta") for a in args))     # meta: the plain version
    for g, w in zip(*(t if isinstance(t, tuple) else (t,)
                      for t in (got, want))):
        assert g.device.type == "meta" and g.shape == w.shape
    assert set(tops.launch_counts().values()) == {0}
    with pytest.raises(ValueError, match="cpu, meta or cuda"):
        fn(types.SimpleNamespace(device=torch.device("xpu")), *args[1:])


def test_wrappers_refuse_bad_operands():
    i32 = torch.ones((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        tfxpk.qmatmul(i32.float(), i32.T, bf=8, bn=3)
    with pytest.raises(ValueError, match="shape mismatch"):
        tfxpk.qmatmul(i32, i32, bf=8, bn=3)
    with pytest.raises(ValueError, match="bf"):
        tfxpk.qmatmul(i32, i32.T, bf=0, bn=3)
    with pytest.raises(ValueError, match="int32"):
        tslut.lut_lookup(i32.long(), torch.rand(16))
    with pytest.raises(ValueError, match="float32"):
        tslut.lut_lookup(i32, torch.rand(16).double())
    with pytest.raises(ValueError, match="expected"):
        tops.sigmoid_lut(i32, torch.rand(4, 4))
    scan = [torch.rand(1, 6, 8), torch.rand(1, 6, 8), torch.rand(1, 6, 4),
            torch.rand(1, 6, 4), -torch.rand(8, 4), torch.rand(1, 8, 4)]
    with pytest.raises(ValueError, match="shape mismatch"):
        tss.selective_scan(*scan[:4], -torch.rand(8, 5), scan[5])
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tss.selective_scan(scan[0].half(), *scan[1:])
    with pytest.raises(ValueError, match="outside"):
        tss.selective_scan(scan[0], scan[1], torch.rand(1, 6, 33),
                           torch.rand(1, 6, 33), torch.rand(8, 33),
                           torch.rand(1, 8, 33))
    q, k = torch.rand(4, 5, 16), torch.rand(3, 5, 16)
    with pytest.raises(ValueError, match="shape mismatch"):
        tfa.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tfa.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="q's dtype"):
        tfa.flash_attention(q, q.bfloat16(), q)
    with pytest.raises(ValueError, match="shape mismatch"):
        tfa.mha(torch.rand(2, 5, 4, 16), torch.rand(1, 5, 2, 16),
                torch.rand(1, 5, 2, 16))


def test_standalone_kernels_are_counted():
    counts = tops.launch_counts()
    assert len(counts) == 16
    assert {"flash_attention", "selective_scan", "qmatmul",
            "lut_lookup"} <= set(counts)
