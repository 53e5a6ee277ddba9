"""The rest of the reference's layout in the port, on the CPU.

* ``kernels/ref.py``: each of the six oracles against the reference's
  (``src/repro/kernels/ref.py``) on the same numpy inputs.  The integer
  ones (``fxp_qmatmul``, ``sigmoid_lut``) bit for bit; the floating-point
  ones within the tolerances of their plain versions' own tests
  (``tests/test_torch_train_kernels.py``: fp32 rtol / atol 1e-5, the same
  products summed in another order; bf16 outputs one bf16 ulp, 2^-7
  relative; bf16 dw atol 1e-3, its fp32 sums of bf16-rounded products;
  ``tests/test_torch_standalone_kernels.py``: the scan within 1e-5 of
  max |y|).
* ``configs/<arch>.py``: each module's ``CONFIG`` is ``registry.get``'s
  config, and its fields equal the reference module's ``CONFIG``.
"""
import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.kernels import ref as jref

from repro_torch.configs import registry as treg
from repro_torch.core.sparsity import make_block_pattern
from repro_torch.kernels import ref as tref

FP32 = dict(atol=1e-5, rtol=1e-5)
BF16 = dict(atol=1e-5, rtol=2.0 ** -7)
DW_BF16 = dict(atol=1e-3, rtol=1e-5)
SCAN_REL = 1e-5
N_IN, N_OUT, BS, M = 128, 192, 32, 24
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a, dtype):
    """One numpy array as the reference's and the port's, in ``dtype``."""
    jd, td = DTYPES[dtype]
    j = jnp.asarray(a, jd)
    return j, torch.from_numpy(np.array(j, np.float32)).to(td)


def _f32(t):
    return t.float().numpy() if torch.is_tensor(t) else np.asarray(
        t, np.float32)


def _junction(seed):
    pat = make_block_pattern(N_IN, N_OUT, 0.5, BS, seed=seed)
    nob, kb = pat.idx.shape
    rng = np.random.default_rng(seed)
    return (pat.idx, rng.standard_normal((M, N_IN)).astype(np.float32),
            rng.standard_normal((nob, kb, BS, BS)).astype(np.float32),
            rng.standard_normal((M, N_OUT)).astype(np.float32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_block_sparse_matmul_equals_reference_oracle(dtype):
    idx, x, w, _ = _junction(1)
    (jx, tx), (jw, tw) = _pair(x, dtype), _pair(w, "float32")
    got = tref.block_sparse_matmul(tx, tw, torch.from_numpy(idx))
    want = jref.block_sparse_matmul(jx, jw, jnp.asarray(idx))
    assert got.dtype == DTYPES[dtype][1] and got.shape == (M, N_OUT)
    np.testing.assert_allclose(_f32(got), _f32(want),
                               **(FP32 if dtype == "float32" else BF16))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_block_sparse_dx_equals_reference_oracle(dtype):
    idx, _, w, dy = _junction(2)
    (jdy, tdy), (jw, tw) = _pair(dy, dtype), _pair(w, "float32")
    got = tref.block_sparse_dx(tdy, tw, torch.from_numpy(idx), N_IN // BS)
    want = jref.block_sparse_dx(jdy, jw, jnp.asarray(idx), N_IN // BS)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (M, N_IN)
    np.testing.assert_allclose(_f32(got), _f32(want),
                               **(FP32 if dtype == "float32" else BF16))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_block_sparse_dw_equals_reference_oracle(dtype):
    idx, x, w, dy = _junction(3)
    (jx, tx), (jdy, tdy) = _pair(x, dtype), _pair(dy, dtype)
    got = tref.block_sparse_dw(tx, tdy, torch.from_numpy(idx))
    want = jref.block_sparse_dw(jx, jdy, jnp.asarray(idx))
    assert got.dtype == torch.float32 and got.shape == w.shape
    np.testing.assert_allclose(_f32(got), _f32(want),
                               **(FP32 if dtype == "float32" else DW_BF16))


@pytest.mark.parametrize("bf,bn", [(3, 8), (8, 12)])
def test_fxp_qmatmul_equals_reference_oracle_bit_for_bit(bf, bn):
    rng = np.random.default_rng(bf)
    lim = 1 << (bn + bf)
    a = rng.integers(-lim, lim, (16, 40), dtype=np.int32)
    w = rng.integers(-lim, lim, (40, 24), dtype=np.int32)
    got = tref.fxp_qmatmul(torch.from_numpy(a), torch.from_numpy(w), bf, bn)
    want = np.asarray(jref.fxp_qmatmul(jnp.asarray(a), jnp.asarray(w), bf,
                                       bn))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_sigmoid_lut_equals_reference_oracle_bit_for_bit():
    rng = np.random.default_rng(4)
    table = rng.standard_normal(4096).astype(np.float32)
    codes = rng.integers(-4096, 4096 + 64, (32, 48), dtype=np.int32)
    got = tref.sigmoid_lut(torch.from_numpy(codes), torch.from_numpy(table))
    want = np.asarray(jref.sigmoid_lut(jnp.asarray(codes),
                                       jnp.asarray(table)))
    assert np.array_equal(got.numpy().view(np.uint32),
                          want.view(np.uint32))


def test_selective_scan_equals_reference_oracle():
    B, S, di, N = 2, 24, 32, 8
    rng = np.random.default_rng(5)
    dt = (0.1 * rng.random((B, S, di))).astype(np.float32)
    x, bc, cc = (rng.standard_normal(s).astype(np.float32)
                 for s in ((B, S, di), (B, S, N), (B, S, N)))
    a = -np.exp(rng.standard_normal((di, N))).astype(np.float32)
    h0 = rng.standard_normal((B, di, N)).astype(np.float32)
    ins = (dt, x, bc, cc, a, h0)
    y, h = tref.selective_scan(*map(torch.from_numpy, ins))
    jy, jh = jref.selective_scan(*map(jnp.asarray, ins))
    for got, want in ((y, jy), (h, jh)):
        want = np.asarray(want)
        assert got.shape == want.shape
        assert np.abs(got.numpy() - want).max() <= SCAN_REL * np.abs(
            want).max()


@pytest.mark.parametrize("module", [
    "command_r_plus_104b", "deepseek_7b", "deepseek_v2_lite_16b",
    "falcon_mamba_7b", "llava_next_mistral_7b", "qwen2_72b",
    "qwen3_moe_30b_a3b", "stablelm_3b", "whisper_base", "zamba2_2p7b"])
def test_arch_config_module_equals_reference(module):
    tmod = importlib.import_module(f"repro_torch.configs.{module}")
    jmod = importlib.import_module(f"repro.configs.{module}")
    assert tmod.__all__ == jmod.__all__ == ["CONFIG"]
    assert tmod.CONFIG is treg.get(tmod.CONFIG.name)
    assert jmod.CONFIG is jreg.get(tmod.CONFIG.name)
    want = dataclasses.asdict(jmod.CONFIG)
    got = dataclasses.asdict(tmod.CONFIG)
    assert got == {k: want[k] for k in got}
