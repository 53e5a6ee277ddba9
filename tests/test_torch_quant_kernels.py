"""The port's quantized datapath against the JAX reference on the CPU:
the weight codes and tables of core/quantize.py, and the plain versions
of the three quantized kernels (fwd_int8, gated_fwd_int8, fwd_fxp).  The
CUDA kernels run only on the card (``chip_smoke.py`` holds each against
its plain version there); here the wrappers take their plain versions
because the tensors lie on the CPU.

The reference runs its Pallas kernels in interpret mode (through
``ops.junction_matmul``, which pads ragged rows) and its jnp sims
(``apply_quant_jnp``, ``expert_apply_int8``).  Inputs are made with numpy
from a seed, block 32.

Tolerances:
- codes, scales, fixed-point tables and the whole fixed-point forward:
  exact (integer arithmetic, and the same fp32 roundings on both sides);
- int8 forwards: 1e-5, the reference's own bound between its kernel and
  its jnp sim.  Both sides form the same integer dots and the same fp32
  dequant products; the activations may differ in their last bits.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fixed_point as jfp
from repro.core import quantize as jqz
from repro.core.sparsity import make_block_pattern
from repro.kernels import block_sparse_matmul as jbsm
from repro.kernels import ops as jops

from repro_torch.core import fixed_point as tfp
from repro_torch.core import quantize as tqz
from repro_torch.kernels import block_sparse_matmul as tbsm
from repro_torch.kernels import ops as tops

INT8 = dict(atol=1e-5, rtol=1e-5)
BS = 32
N_IN, N_OUT = 128, 96          # nib 4, nob 3; kb 2 at density 0.5
TRIPLETS = [(f.bw, f.bn, f.bf) for f in jfp.PAPER_TRIPLETS]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pattern():
    pat = make_block_pattern(N_IN, N_OUT, 0.5, BS, seed=0)
    return pat, torch.from_numpy(pat.idx)


def _rev(pat):
    return [torch.from_numpy(a) for a in (pat.rev_ob, pat.rev_t,
                                          pat.rev_cnt)]


def _int8_leaves(rng, E, pat, n=1, bits=8):
    """n int8 weight streams [E, nob, kb, bs, bs] from the reference's
    quantize_weights, as numpy (codes, scales) pairs."""
    out = []
    for _ in range(n):
        w = rng.standard_normal((E, pat.n_out_blocks, pat.fan_in_blocks, BS,
                                 BS)).astype(np.float32) * 0.2
        q, s = jqz.quantize_weights(jnp.asarray(w), bits=bits)
        out.append((np.asarray(q), np.asarray(s)))
    return out


# --------------------------------------------------------------- weights
@pytest.mark.parametrize("bits", [8, 6, 4, 2])
@pytest.mark.parametrize("granularity", ["block", "unit"])
def test_quantize_weights_bit_equal(bits, granularity):
    rng = np.random.default_rng(bits)
    w = rng.standard_normal((3, 3, 2, BS, BS)).astype(np.float32)
    w[0, 1, 1] = 0.0                                  # an all-zero block
    w[2] = 0.0                                        # an all-zero unit
    jq, js = jqz.quantize_weights(jnp.asarray(w), bits=bits,
                                  granularity=granularity)
    tq, ts = tqz.quantize_weights(torch.from_numpy(w), bits=bits,
                                  granularity=granularity)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # a single (4-D) junction too
    jq, js = jqz.quantize_weights(jnp.asarray(w[0]), bits=bits,
                                  granularity=granularity)
    tq, ts = tqz.quantize_weights(torch.from_numpy(w[0]), bits=bits,
                                  granularity=granularity)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("fmt", TRIPLETS, ids=str)
def test_fxp_codes_and_tables_bit_equal(fmt):
    jf, tf = jfp.FxpFormat(*fmt), tfp.FxpFormat(*fmt)
    rng = np.random.default_rng(fmt[0])
    w = (rng.standard_normal((3, 2, BS, BS)) * 2 ** fmt[1]).astype(np.float32)
    got = tqz.fxp_encode_weights(torch.from_numpy(w), tf)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jqz.fxp_encode_weights(w, jf)))
    for act in tqz.FXP_LUT_ACTS:
        got = tqz.act_lut(tf, act)
        assert got.dtype == torch.float32 and got.shape == (2 ** fmt[0],)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jqz.act_lut(jf, act)))
    for a, b in zip(tfp.sigmoid_tables(tf), jfp.sigmoid_tables(jf)):
        np.testing.assert_array_equal(a, b)
    v = (rng.standard_normal(500) * 2 ** (fmt[1] + 1)).astype(np.float32)
    q = tfp.quantize(torch.from_numpy(v), tf)
    np.testing.assert_array_equal(q.numpy(),
                                  np.asarray(jfp.quantize(jnp.asarray(v), jf)))
    codes = tfp.encode(q, tf)
    np.testing.assert_array_equal(codes.numpy(),
                                  np.asarray(jfp.encode(jnp.asarray(q), jf)))
    np.testing.assert_array_equal(tfp.decode(codes, tf).numpy(), q.numpy())


def test_quant_config_and_structure_key_match_reference():
    for kw in [dict(), dict(bits=4, granularity="unit"),
               dict(mode="fxp", fmt=jfp.FxpFormat(16, 4, 11), act="relu")]:
        tkw = dict(kw)
        if "fmt" in kw:
            tkw["fmt"] = tfp.FxpFormat(16, 4, 11)
        j, t = jqz.QuantConfig(**kw), tqz.QuantConfig(**tkw)
        assert t.to_dict() == j.to_dict()
        assert tqz.structure_key(t) == jqz.structure_key(j)
    for bad in [dict(mode="int4"), dict(bits=9), dict(granularity="row"),
                dict(mode="fxp", act="gelu")]:
        with pytest.raises(ValueError):
            tqz.QuantConfig(**bad)


# -------------------------------------------------------------- fwd_int8
def _x(rng, *shape):
    """Activations with row 1's first input block all zeros (the dynamic
    scale of that slot is 1)."""
    x = rng.standard_normal(shape).astype(np.float32)
    x[..., 1, :BS] = 0.0
    return x


@pytest.mark.parametrize("E", [1, 3])
@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
@pytest.mark.parametrize("with_bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("act", tbsm.ACTIVATIONS)
def test_fwd_int8_plain_matches_jnp_sim(act, with_bias, static, E):
    """Every activation, bias, static / dynamic scales, E = 1 (a 4-D
    junction through ``apply_quant``) and E = 3, ragged M = 7 with an
    all-zero row block (its dynamic scale is 1)."""
    rng = np.random.default_rng(7)
    pat, idx = _pattern()
    ((q, s),) = _int8_leaves(rng, E, pat)
    x = _x(rng, E, 7, N_IN)
    b = (rng.standard_normal((E, N_OUT)).astype(np.float32) if with_bias
         else None)
    xs = (np.abs(x).max(axis=(1, 2)) / 127.0).astype(np.float32)
    jp = {"wq": q, "w_scale": s, "idx": pat.idx}
    if with_bias:
        jp["b"] = b
    if static:
        jp["x_scale"] = xs
    if E == 1:
        jp = {k: (v[0] if k in ("wq", "w_scale", "b", "x_scale") else v)
              for k, v in jp.items()}
        xin = x[0]
    else:
        xin = x
    want = jqz.apply_quant_jnp(jax.tree.map(jnp.asarray, jp),
                               jnp.asarray(xin), act=act)
    tp = {k: torch.from_numpy(np.asarray(v)) for k, v in jp.items()}
    got = tqz.apply_quant(tp, torch.from_numpy(xin), act=act)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **INT8)
    if act == "none":   # the same dots and roundings: equal bit for bit
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("case", ["dynamic_E1_ragged", "static_E3",
                                  "dynamic_E3_bf16"])
def test_fwd_int8_plain_matches_reference_kernel(case):
    """Against the reference's Pallas kernel in interpret mode, through
    both junction entries (the reference pads the ragged rows)."""
    rng = np.random.default_rng(11)
    pat, idx = _pattern()
    E = 1 if "E1" in case else 3
    M = 5 if "ragged" in case else 8
    ((q, s),) = _int8_leaves(rng, E, pat)
    x = _x(rng, E, M, N_IN)
    b = rng.standard_normal((E, N_OUT)).astype(np.float32)
    xs = (np.abs(x).max(axis=(1, 2)) / 127.0).astype(np.float32) \
        if "static" in case else None
    dt = "bfloat16" if "bf16" in case else "float32"
    act = "silu"
    single = E == 1
    jx = jnp.asarray(x[0] if single else x, dt)
    lift = (lambda a: a[0]) if single else (lambda a: a)
    want = jops.junction_matmul(
        jx, jnp.asarray(lift(q)), pat.idx, pat.rev_ob, pat.rev_t,
        pat.rev_cnt, bias=jnp.asarray(lift(b)), act=act,
        w_scale=jnp.asarray(lift(s)),
        x_scale=None if xs is None else jnp.asarray(lift(xs)),
        interpret=True)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dt]
    got = tops.junction_matmul(
        torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(tdt),
        torch.from_numpy(lift(q)), idx, *_rev(pat),
        bias=torch.from_numpy(lift(b)), act=act,
        w_scale=torch.from_numpy(lift(s)),
        x_scale=None if xs is None else torch.from_numpy(lift(xs)))
    assert got.dtype == tdt and tuple(got.shape) == tuple(want.shape)
    # bf16 inputs make exact half-way quotients x / sx common, and the
    # reference's kernel in interpret mode rounds some of them to the
    # other activation code than its own jnp sim does (one code moves an
    # output by sx * w_scale * |w|, far above 1e-5): in bf16 the port is
    # held against the sim, which it equals, and not against the kernel
    if dt == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **INT8)
    jp = {"wq": lift(q), "w_scale": lift(s), "idx": pat.idx, "b": lift(b)}
    if xs is not None:
        jp["x_scale"] = lift(xs)
    sim = jqz.apply_quant_jnp(jax.tree.map(jnp.asarray, jp), jx, act=act)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(sim.astype(jnp.float32)), **INT8)


# --------------------------------------------------------- gated int8
@pytest.mark.parametrize("E", [1, 4])
@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
def test_gated_fwd_int8_plain_matches_reference(static, E):
    """Against the reference's gated int8 kernel (interpret) and its jnp
    sim of the expert gate (``expert_apply_int8``), M = 6."""
    rng = np.random.default_rng(5 + E)
    pat, idx = _pattern()
    (qg, sg), (qi, si) = _int8_leaves(rng, E, pat, n=2)
    x = _x(rng, E, 6, N_IN)
    xs = ((np.abs(x).max(axis=(1, 2)) / 127.0).astype(np.float32)
          if static else None)
    want = jbsm.gated_fwd_int8(
        jnp.asarray(x), jnp.asarray(qg), jnp.asarray(qi), pat.idx,
        jnp.asarray(sg), jnp.asarray(si),
        x_scale=None if xs is None else jnp.asarray(xs), bm=6,
        interpret=True)
    t = lambda a: None if a is None else torch.from_numpy(a)
    got = tbsm.gated_fwd_int8(t(x), t(qg), t(qi), idx, t(sg), t(si), t(xs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **INT8)
    # the jnp sim: x as [G=1, E, C=6, d]
    xd = jnp.asarray(x)[None]
    xsj = None if xs is None else jnp.asarray(xs)
    g = jqz.expert_apply_int8(jnp.asarray(qg), jnp.asarray(sg), pat.idx, xd,
                              xsj)
    u = jqz.expert_apply_int8(jnp.asarray(qi), jnp.asarray(si), pat.idx, xd,
                              xsj)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax.nn.silu(g) * u)[0],
                               **INT8)
    tg = tqz.expert_apply_int8(t(qg), t(sg), idx, t(x)[None], t(xs))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(g))


# -------------------------------------------------------------- fwd_fxp
def _fxp_case(fmt, E, M, wrap, seed):
    """Codes and inputs at triplet ``fmt``: values spread over the range,
    or (``wrap``) every code at the top of the range, so the int32 sum
    of 64 products of about 2^(2 bw - 2) wraps."""
    jf = jfp.FxpFormat(*fmt)
    rng = np.random.default_rng(seed)
    pat, idx = _pattern()
    shape = (E, pat.n_out_blocks, pat.fan_in_blocks, BS, BS)
    if wrap:
        w = np.full(shape, jf.max_val, np.float32)
        x = np.full((E, M, N_IN), jf.max_val, np.float32)
        x[:, 1] = jf.min_val
    else:
        w = (rng.standard_normal(shape) * 0.3).astype(np.float32)
        x = (rng.standard_normal((E, M, N_IN)) * 2.0).astype(np.float32)
    q = np.asarray(jqz.fxp_encode_weights(w, jf))
    b = np.asarray(jfp.quantize(jnp.asarray(
        rng.standard_normal((E, N_OUT)).astype(np.float32)), jf))
    lut = np.asarray(jqz.act_lut(jf, "sigmoid"))
    qfmt = np.asarray([jf.bf, jf.bn], np.int32)
    return pat, idx, q, x, b, lut, qfmt


# every triplet with codes spread over its range; at bw 16 (products of
# about 2^30) also every code at the top of the range, where the int32
# sum wraps (narrower triplets cannot reach 2^31 at this fan-in)
@pytest.mark.parametrize("fmt,wrap", [(f, False) for f in TRIPLETS]
                         + [(TRIPLETS[-1], True)],
                         ids=[f"{f}-spread" for f in TRIPLETS]
                         + [f"{TRIPLETS[-1]}-wraps"])
def test_fwd_fxp_plain_bit_exact_against_reference(fmt, wrap):
    pat, idx, q, x, b, lut, qfmt = _fxp_case(fmt, 2, 8, wrap, fmt[0])
    if wrap:    # the exact sum lies beyond int32: the reference wraps it
        s = np.einsum("mi,ic->mc", np.round(x[0][:, :BS] * 2.0 ** fmt[2]),
                      q[0, 0, 0].astype(np.float64))
        assert np.abs(s).max() > 2 ** 31
    want = jbsm.fwd_fxp(jnp.asarray(x), jnp.asarray(q), pat.idx,
                        jnp.asarray(qfmt), jnp.asarray(lut), jnp.asarray(b),
                        bm=8, interpret=True)
    t = torch.from_numpy
    got = tbsm.fwd_fxp(t(x), t(q), idx, t(qfmt), t(lut), t(b))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the jnp sim of a single (4-D) junction: the same bits
    jp = {"wq": q[0], "idx": pat.idx, "qfmt": qfmt, "qlut": lut, "b": b[0]}
    sim = jqz.apply_quant_jnp(jax.tree.map(jnp.asarray, jp),
                              jnp.asarray(x[0]))
    got1 = tqz.apply_quant({k: t(np.asarray(v)) for k, v in jp.items()},
                           t(x[0]))
    np.testing.assert_array_equal(got1.numpy(), np.asarray(sim))


def test_fwd_fxp_bf16_input_and_no_bias():
    fmt = (12, 3, 8)
    pat, idx, q, x, b, lut, qfmt = _fxp_case(fmt, 1, 5, False, 3)
    jx = jnp.asarray(x, jnp.bfloat16)
    want = jops.junction_matmul(
        jx[0], jnp.asarray(q[0]), pat.idx, pat.rev_ob, pat.rev_t,
        pat.rev_cnt, qfmt=jnp.asarray(qfmt), qlut=jnp.asarray(lut),
        interpret=True)
    tx = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).bfloat16()
    got = tops.junction_matmul(
        tx[0], torch.from_numpy(q[0]), idx, *_rev(pat),
        qfmt=torch.from_numpy(qfmt), qlut=torch.from_numpy(lut))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def _codes_summing_to(bs, kb, target, x_code):
    """One column of weight codes near 2^31 - 1 (kb slots of bs) whose
    int32 dot with a row of x codes all equal to x_code (odd) is exactly
    S = x_code * sum(w), S = target (mod 2^32), S in [2^53, 2^54), the
    slots' sums even but the last one's odd: a float64 sum of the slots'
    exact partials meets an odd S past 2^53 at its last addition and
    rounds it to the even neighbour, S + 1 for S = 3 (mod 4)."""
    w = np.full((kb, bs), 2 ** 31 - 1, np.int64)
    w[-1, 0] -= 1                                  # the last slot's sum odd
    want = target * pow(x_code, -1, 2 ** 32) % 2 ** 32
    dec = (int(w.sum()) - want) % 2 ** 32          # even: odd - odd
    assert dec % 2 == 0
    flat = w.reshape(-1)
    half = dec // 2
    flat -= 2 * (half // flat.size + (np.arange(flat.size) < half % flat.size))
    S = x_code * int(w.sum())
    assert S % 2 ** 32 == target and 2 ** 53 <= S < 2 ** 54
    assert all(int(v) % 2 == 0 for v in w[:-1].sum(1)) and w[-1].sum() % 2
    return w


def test_fwd_fxp_plain_exact_past_float64_for_codes_beyond_16_bits():
    """wq codes near 2^31 - 1 and x at its clip, all positive, kb * bs =
    256 products a column: the exact sum lies past 2^53, where summing
    in float64 rounds.  Each column's sum is 1023 + 2048 c mod 2^32, one
    below a rounding step of the shift by bf = 11, so a sum off by +1
    moves every output.  The plain version equals the reference's int32
    dot (interpret mode) bit for bit; the float64 sum of the slots does
    not."""
    jf = jfp.FxpFormat(16, 4, 11)
    pat = make_block_pattern(512, 2 * BS, 0.5, BS, seed=0)
    nob, kb = pat.idx.shape
    assert kb * BS >= 256
    x_code = 2 ** 15 - 1                       # x at the clip of bw 16
    x = np.full((1, 8, 512), x_code / 2.0 ** jf.bf, np.float32)
    q = np.zeros((1, nob, kb, BS, BS), np.int64)
    for o in range(nob):
        for c in range(BS):
            q[0, o, :, :, c] = _codes_summing_to(BS, kb,
                                                 1023 + 2048 * (o * BS + c),
                                                 x_code)
    q = q.astype(np.int32)
    b = np.zeros((1, nob * BS), np.float32)
    lut = np.asarray(jqz.act_lut(jf, "sigmoid"))
    qfmt = np.asarray([jf.bf, jf.bn], np.int32)
    want = jbsm.fwd_fxp(jnp.asarray(x), jnp.asarray(q), pat.idx,
                        jnp.asarray(qfmt), jnp.asarray(lut), jnp.asarray(b),
                        bm=8, interpret=True)
    t = torch.from_numpy
    got = tbsm.fwd_fxp(t(x), t(q), t(pat.idx), t(qfmt), t(lut), t(b))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # s = (S + 2^10) >> 11 = o * 32 + c exactly; a float64 sum of the
    # slots' partials (each exact) gives S + 1 and s + 1 in every column
    xc = np.full(BS, float(x_code))
    for o in range(nob):
        acc = np.zeros(BS)
        for k in range(kb):
            acc += xc @ q[0, o, k].astype(np.float64)
        f64 = (acc.astype(np.int64) % 2 ** 32 + 2 ** 10) >> jf.bf
        np.testing.assert_array_equal(f64, o * BS + np.arange(BS) + 1)
    np.testing.assert_array_equal(
        got.numpy()[0, 0], lut[np.arange(nob * BS)])


# --------------------------------------------------------------- refusals
def test_junction_refuses_codes_without_their_leaves():
    rng = np.random.default_rng(0)
    pat, idx = _pattern()
    ((q, s),) = _int8_leaves(rng, 1, pat, n=1)
    x = torch.zeros((4, N_IN))
    qt = torch.from_numpy(q[0])
    with pytest.raises(ValueError, match="quantization leaves"):
        tops.junction_matmul(x, qt, idx, *_rev(pat))
    with pytest.raises(ValueError, match="wi_scale"):
        tops.junction_matmul(x, qt, idx, *_rev(pat), wi=qt,
                             w_scale=torch.from_numpy(s[0]))
    with pytest.raises(ValueError, match="plain junctions only"):
        tops.junction_matmul(x, qt, idx, *_rev(pat), wi=qt,
                             qfmt=torch.tensor([8, 3], dtype=torch.int32),
                             qlut=torch.zeros(4096))
    with pytest.raises(ValueError, match="qlut"):
        tops.junction_matmul(x, qt.int(), idx, *_rev(pat),
                             qfmt=torch.tensor([8, 3], dtype=torch.int32))
    with pytest.raises(ValueError, match="inference-only"):
        tops.junction_train_update(x.requires_grad_(), qt, idx, *_rev(pat),
                                   hyp=torch.zeros(7))


def test_quantized_wrappers_check_their_operands():
    rng = np.random.default_rng(0)
    pat, idx = _pattern()
    ((q, s),) = _int8_leaves(rng, 1, pat)
    x = torch.zeros((1, 4, N_IN))
    q, s = torch.from_numpy(q), torch.from_numpy(s)
    b = torch.zeros((1, N_OUT))
    with pytest.raises(ValueError, match="int8 weight codes"):
        tbsm.fwd_int8(x, q.int(), idx, s, b)
    with pytest.raises(ValueError, match="bias must be fp32"):
        tbsm.fwd_int8(x, q, idx, s, b.bfloat16())
    with pytest.raises(ValueError, match="w_scale"):
        tbsm.fwd_int8(x, q, idx, s[:, :1], b)
    with pytest.raises(ValueError, match="x_scale"):
        tbsm.fwd_int8(x, q, idx, s, b, x_scale=torch.ones(2))
    big = 2048          # 127^2 * 2048 > 2^24: dots no longer exact in fp32
    with pytest.raises(ValueError, match="not exact in fp32"):
        tbsm.int8_sums(torch.zeros((1, 1, big)),
                       (torch.zeros((1, 1, 1, big, big), dtype=torch.int8),),
                       torch.zeros((1, 1), dtype=torch.int32),
                       (torch.ones((1, 1, 1)),), None)
    with pytest.raises(ValueError, match="power-of-two"):
        tbsm.fwd_fxp(x, q.int(), idx, torch.tensor([8, 3], dtype=torch.int32),
                     torch.zeros(100), b)


# ---------------------------------------------------------- the CUDA route
_QUANT = ("fwd_int8", "gated_fwd_int8", "fwd_fxp")


@pytest.mark.parametrize("name", _QUANT)
def test_cuda_route_never_takes_the_plain_version(name, monkeypatch):
    """A tensor taken for a card tensor launches the kernel or raises,
    and is not counted when it raises; a meta tensor (shapes only) takes
    the plain version; any other device raises."""
    rng = np.random.default_rng(0)
    pat, idx = _pattern()
    (q, s), (q2, s2) = [(torch.from_numpy(a), torch.from_numpy(b))
                        for a, b in _int8_leaves(rng, 1, pat, n=2)]
    x = torch.zeros((1, 4, N_IN))
    b = torch.zeros((1, N_OUT))
    args = {"fwd_int8": (x, q, idx, s, b),
            "gated_fwd_int8": (x, q, q2, idx, s, s2),
            "fwd_fxp": (x, q.int(), idx,
                        torch.tensor([8, 3], dtype=torch.int32),
                        torch.zeros(4096), b)}[name]

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
    getattr(tbsm, name)(*(a.to("meta") if torch.is_tensor(a) else a
                          for a in args))
    assert seen == ["meta"] and getattr(tbsm, name).launches == before
    with pytest.raises(ValueError, match="cpu, meta or cuda"):
        getattr(tbsm, name)(types.SimpleNamespace(
            device=torch.device("xpu")), *args[1:])


def test_quantized_kernels_are_counted():
    counts = tops.launch_counts()
    assert {"junction_fwd_int8", "junction_gated_fwd_int8",
            "junction_fwd_fxp"} <= set(counts)
    tops.reset_launch_counts()
    assert set(tops.launch_counts().values()) == {0}
