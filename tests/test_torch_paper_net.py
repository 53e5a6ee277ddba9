"""The port's bit-faithful paper network against the JAX reference, on the
CPU.

Weights are made by the reference (``init``) and carried across with
``convert.from_jax_paper_params``; both sides train on the same inputs of
``paper_dataset`` (the synthetic set where no MNIST files are present).

Tolerances:
* fixed point (every triplet, sigmoid and both ReLUs): every product is
  rounded once in fp32 and every sum and product lands on the grid, so
  acts, a-dots, deltas, params, outputs and corrects are equal bit for
  bit;
* the loss is floating point on both sides (``log`` and the mean's
  summation order differ): rtol 1e-6, atol 1e-7;
* ``fmt=None``: ``jax.nn.sigmoid`` against ``torch.sigmoid`` and sums in
  another order, a few fp32 ulps an op: forward and one step to 1e-6;
  an epoch of online SGD carries the difference through every update:
  1e-4 after 64 inputs;
* the mini-batch mean in ``up_junction`` is floating point (torch may
  multiply by 1/B where jnp divides by B): params within one grid step
  (2^-b_f) of the reference's, the quantize after the mean may round a
  value that lies on a rounding boundary the other way.
"""
import ast
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper_mnist as jmnist
from repro.core import fixed_point as jfxp
from repro.core import interleaver as jil
from repro.core import junction_pipeline as JJP
from repro.core import paper_net as JPN
from repro.core.sparsity import make_neuron_pattern as jmake_neuron_pattern

from repro_torch.configs import paper_mnist as tmnist
from repro_torch.convert import from_jax_paper_params
from repro_torch.core import fixed_point as fxp
from repro_torch.core import interleaver as il
from repro_torch.core import junction_pipeline as JP
from repro_torch.core import paper_net as PN
from repro_torch.core.sparsity import make_neuron_pattern
from repro_torch.data.mnist import paper_dataset

ROOT = Path(__file__).resolve().parents[1]
ETA = 2.0 ** -3
LOSS_TOL = dict(rtol=1e-6, atol=1e-7)
FLOAT_TOL = dict(rtol=1e-6, atol=1e-6)
N_EPOCH = 256


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread (the test workers share cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    x, y, _ = paper_dataset(2048, seed=0)
    return x, y


def _pair(fmt_i=None, **kw):
    """(reference config, port config) at PAPER_TRIPLETS[fmt_i] (None:
    floating point) and the given fields."""
    jf = None if fmt_i is None else jfxp.PAPER_TRIPLETS[fmt_i]
    tf = None if fmt_i is None else fxp.PAPER_TRIPLETS[fmt_i]
    return JPN.PaperNetConfig(fmt=jf, **kw), PN.PaperNetConfig(fmt=tf, **kw)


def _carry(jcfg):
    """The reference's initial weights as numpy, and the port's copy."""
    jp = jax.tree.map(np.asarray, JPN.init(jcfg))
    return jp, from_jax_paper_params(jp)


def _quickstart():
    """examples/quickstart_torch.py as a module (examples/ is no package)."""
    import importlib.util
    path = ROOT / "examples" / "quickstart_torch.py"
    spec = importlib.util.spec_from_file_location("quickstart_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ref_step(jcfg, jp, x, y):
    """The reference's sgd_step, compiled (its eager ops compile one by
    one)."""
    return jax.jit(lambda p, x, y: JPN.sgd_step(p, x, y, ETA, jcfg))(jp, x, y)


def _np(t):
    return t.numpy() if torch.is_tensor(t) else np.asarray(t)


def _assert_params_equal(jparams, tparams, **tol):
    for jj, tj in zip(jparams["junctions"], tparams["junctions"]):
        assert jj.keys() == tj.keys()
        for k in jj:
            if tol:
                np.testing.assert_allclose(_np(tj[k]), np.asarray(jj[k]),
                                           err_msg=k, **tol)
            else:
                np.testing.assert_array_equal(_np(tj[k]), np.asarray(jj[k]),
                                              err_msg=k)
                assert _np(tj[k]).dtype == np.asarray(jj[k]).dtype, k


# fixed-point cases: each triplet with the sigmoid, and both ReLUs at the
# paper's triplet (index 3 is PAPER_FMT)
FXP_CASES = [(i, "sigmoid") for i in range(5)] + [(3, "relu8"), (3, "relu1")]
FXP_IDS = [f"{jfxp.PAPER_TRIPLETS[i].bw}-{jfxp.PAPER_TRIPLETS[i].bn}-"
           f"{jfxp.PAPER_TRIPLETS[i].bf}-{a}" for i, a in FXP_CASES]
ACTS = ("sigmoid", "relu8", "relu1")


# ------------------------------------------------------------ interleavers
@pytest.mark.parametrize("W,z,seed", [(256, 8, 0), (512, 32, 3),
                                      (4096, 128, 0), (1024, 32, 1),
                                      (65536, 1024, 0), (2048, 64, 7)])
def test_interleavers_equal_reference(W, z, seed):
    np.testing.assert_array_equal(il.affine_interleaver(W, z, seed),
                                  jil.affine_interleaver(W, z, seed))
    pi = il.sv_ss_interleaver(W, z, seed)
    np.testing.assert_array_equal(pi, jil.sv_ss_interleaver(W, z, seed))
    assert pi.dtype == np.int32
    assert sorted(pi.tolist()) == list(range(W)), "must be a permutation"
    assert il.is_clash_free(pi, z) and jil.is_clash_free(pi, z)


def test_repair_permutation_and_clash_check_equal_reference():
    # an affine sweep shifted by colliding multiples of z: duplicates in
    # every bank column, as sv_ss_interleaver meets them
    rng = np.random.default_rng(0)
    base = il.affine_interleaver(256, 16, 0).astype(np.int64)
    sv = np.repeat(rng.integers(0, 4, 16) * 16, 16)
    idx = ((base + sv) % 256).astype(np.int32)
    assert len(np.unique(idx)) < 256
    np.testing.assert_array_equal(il._repair_permutation(idx, 16),
                                  jil._repair_permutation(idx, 16))
    bad = rng.integers(0, 256, 256).astype(np.int32)    # columns unbalanced
    for fn in (il._repair_permutation, jil._repair_permutation):
        with pytest.raises(AssertionError):
            fn(bad, 16)
    idx = rng.integers(0, 256, 256).astype(np.int32)
    for pi in (idx, np.arange(256, dtype=np.int32), np.zeros(256, np.int32)):
        for z in (8, 16, 7):
            assert il.is_clash_free(pi, z) == jil.is_clash_free(pi, z)


@pytest.mark.parametrize("w_mult,z,seed", [(32, 4, 0), (64, 16, 5),
                                           (128, 32, 10), (256, 8, 2)])
def test_affine_and_sv_ss_clash_free(w_mult, z, seed):
    """tests/test_interleaver.py's contracts on the port."""
    W = w_mult * z
    for pi in (il.affine_interleaver(W, z, seed),
               il.sv_ss_interleaver(W, z, seed)):
        assert sorted(pi.tolist()) == list(range(W))
        assert il.is_clash_free(pi, z)
    with pytest.raises(ValueError):
        il.sv_ss_interleaver(W + 1, z, seed)


# ---------------------------------------------------------------- patterns
@pytest.mark.parametrize("n_in,n_out,d_in", [(1024, 64, 64), (64, 32, 32),
                                             (256, 128, 16)])
@pytest.mark.parametrize("seed", [0, 3])
def test_neuron_pattern_equal_reference(n_in, n_out, d_in, seed):
    """The cases of tests/test_sparsity.py: the same arrays, and the
    paper's identity N_{i-1} * d_out = N_i * d_in with no duplicate edge."""
    pat = make_neuron_pattern(n_in, n_out, d_in, seed=seed)
    ref = jmake_neuron_pattern(n_in, n_out, d_in, seed=seed)
    np.testing.assert_array_equal(pat.idx, ref.idx)
    assert pat.idx.dtype == ref.idx.dtype == np.int32
    assert (pat.d_out, pat.n_weights, pat.density) == (
        ref.d_out, ref.n_weights, ref.density)
    counts = np.bincount(pat.idx.reshape(-1), minlength=n_in)
    assert np.all(counts == pat.d_out)
    for j in range(n_out):
        assert len(np.unique(pat.idx[j])) == d_in
    rev = PN.reverse_pattern(pat)
    for a, b in zip(rev, JPN.reverse_pattern(ref)):
        np.testing.assert_array_equal(a, b)


def test_balance_assignment_equal_reference():
    from repro.core.sparsity import _balance_assignment as jbalance
    from repro_torch.core.sparsity import _balance_assignment
    left = (np.arange(96) % 7).astype(np.int32)     # 7 neurons, unbalanced
    left = np.concatenate([left, np.zeros(16, np.int32)])   # 112 = 8 * 14
    got = _balance_assignment(left, 8, 14)
    np.testing.assert_array_equal(got, jbalance(left, 8, 14))
    assert np.all(np.bincount(got, minlength=8) == 14)


@pytest.mark.parametrize("which", ["CONFIG", "FC_BASELINE"])
def test_config_patterns_equal_reference(which):
    """Table I's junctions and the fully connected baseline: the patterns,
    the reverse patterns and the configs' fields."""
    tcfg, jcfg = getattr(tmnist, which), getattr(jmnist, which)
    assert (tcfg.layers, tcfg.d_out, tcfg.z, tcfg.activation) == (
        jcfg.layers, jcfg.d_out, jcfg.z, jcfg.activation)
    assert dataclasses.asdict(tcfg.fmt) == dataclasses.asdict(jcfg.fmt)
    for tp, jp in zip(PN.patterns(tcfg), JPN.patterns(jcfg)):
        np.testing.assert_array_equal(tp.idx, jp.idx)
        for a, b in zip(PN.reverse_pattern(tp), JPN.reverse_pattern(jp)):
            np.testing.assert_array_equal(a, b)
            assert a.min() >= 0, "full fan-out: no -1 entry"


# ---------------------------------------------------- structure and model
def test_table1_structure():
    cfg = PN.PaperNetConfig()
    assert cfg.n_params() == 5216                     # Sec. III-B
    assert abs(cfg.overall_density() - 0.07576) < 1e-4
    assert [cfg.weights(i) for i in range(2)] == [4096, 1024]
    assert [cfg.d_in(i) for i in range(2)] == [64, 32]
    assert [cfg.block_cycles(i) for i in range(2)] == [34, 34]
    assert [cfg.density(i) for i in range(2)] == [0.0625, 0.5]


def test_resource_model_equal_reference():
    for t, j in ((PN.PaperNetConfig(), JPN.PaperNetConfig()),
                 (tmnist.FC_BASELINE, jmnist.FC_BASELINE)):
        assert dataclasses.asdict(JP.resources(t)) == dataclasses.asdict(
            JJP.resources(j))
        assert JP.resources(t).total_multipliers == JJP.resources(
            j).total_multipliers
        assert JP.block_cycle_s(t) == JJP.block_cycle_s(j)
        assert JP.throughput_inputs_per_s(t) == JJP.throughput_inputs_per_s(j)
        assert JP.speedup_vs_sequential(t) == JJP.speedup_vs_sequential(j)
    r = JP.resources(PN.PaperNetConfig())
    assert r.ff_multipliers + r.bp_multipliers == 224    # Sec. III-D-3
    assert r.up_multipliers == 160 and r.sigmoid_luts == 3
    assert abs(JP.block_cycle_s(PN.PaperNetConfig()) - 34 / 15e6) < 1e-12
    assert JP.CLOCK_HZ == JJP.CLOCK_HZ


def test_z_sweep_equal_reference():
    rows = JP.z_sweep_configs(PN.PaperNetConfig())
    assert rows == JJP.z_sweep_configs(JPN.PaperNetConfig())
    assert len(rows) >= 4
    tz = [r["total_z"] for r in rows]
    bc = [r["block_cycle_s"] for r in rows]
    mult = [r["multipliers"] for r in rows]
    assert all(a < b for a, b in zip(tz, tz[1:]))
    assert all(a >= b for a, b in zip(bc, bc[1:]))
    assert all(a <= b for a, b in zip(mult, mult[1:]))


# ------------------------------------------------------------ fixed point
@pytest.mark.parametrize("fmt_i", range(5))
def test_fixed_point_ops_equal_reference(fmt_i):
    """q_mul, q_add, tree_sum_clipped (padded and clipping), lut_sigmoid
    over every code and relu_clipped, bit for bit."""
    jf, tf = jfxp.PAPER_TRIPLETS[fmt_i], fxp.PAPER_TRIPLETS[fmt_i]
    rng = np.random.default_rng(fmt_i)
    a = np.asarray(jfxp.quantize(jnp.asarray(
        rng.uniform(-1.5, 1.5, (6, 37)) * 2 ** jf.bn, jnp.float32), jf))
    b = np.asarray(jfxp.quantize(jnp.asarray(
        rng.uniform(-1.5, 1.5, (6, 37)) * 2 ** jf.bn, jnp.float32), jf))
    ta, tb = torch.tensor(a), torch.tensor(b)
    for tfn, jfn in ((fxp.q_mul, jfxp.q_mul), (fxp.q_add, jfxp.q_add)):
        np.testing.assert_array_equal(tfn(ta, tb, tf).numpy(),
                                      np.asarray(jfn(a, b, jf)))
    for axis in (-1, 0):
        got = fxp.tree_sum_clipped(ta, tf, axis=axis).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(jfxp.tree_sum_clipped(jnp.asarray(a), jf, axis)))
    codes = np.arange(jf.n_codes, dtype=np.int32)
    vals = np.asarray(jfxp.decode(jnp.asarray(codes), jf))
    tables = fxp.sigmoid_tables(tf)
    for t_out, j_out in zip(
            fxp.lut_sigmoid(torch.tensor(vals), tf, tables),
            jfxp.lut_sigmoid(jnp.asarray(vals), jf)):
        np.testing.assert_array_equal(t_out.numpy(), np.asarray(j_out))
    for clip_at in (8.0, 1.0):
        for t_out, j_out in zip(fxp.relu_clipped(ta, tf, clip_at),
                                jfxp.relu_clipped(jnp.asarray(a), jf,
                                                  clip_at)):
            np.testing.assert_array_equal(t_out.numpy(), np.asarray(j_out))


def test_tree_sum_clipping_matters():
    """Per-node clipping differs from clipping the total (the hardware's
    semantics): tests/test_fixed_point.py's case on the port."""
    FMT = fxp.PAPER_FMT
    x = torch.tensor([7.0, 7.0, -7.0, -6.0])
    tree = float(fxp.tree_sum_clipped(x, FMT))
    plain = float(fxp.quantize(torch.sum(x), FMT))
    assert tree != plain and plain == 1.0
    assert tree == float(fxp.quantize(torch.tensor(7.99609375 - 8.0), FMT))
    # no clipping: the tree equals the exact sum of grid values
    rng = np.random.default_rng(0)
    v = fxp.quantize(torch.from_numpy(
        rng.uniform(-0.1, 0.1, 50).astype(np.float32)), FMT)
    assert float(fxp.tree_sum_clipped(v, FMT)) == float(torch.sum(v))


def test_lut_sigmoid_on_grid():
    FMT = fxp.PAPER_FMT
    x = fxp.quantize(torch.linspace(-8, 7.9, 100), FMT)
    s, ds = fxp.lut_sigmoid(x, FMT)
    ideal = 1 / (1 + np.exp(-x.numpy().astype(np.float64)))
    assert np.max(np.abs(s.numpy() - ideal)) < 2 ** -8
    assert float(ds.min()) >= 0.0 and float(ds.max()) <= 0.25


# ------------------------------------------------------------------- init
def test_init_on_the_grid_with_the_reference_structure():
    for mode in ("random", "shared"):
        jcfg, tcfg = _pair(3, init_mode=mode)
        tp = PN.init(tcfg, device="cpu")
        jp = JPN.init(jcfg)
        for tj, jj in zip(tp["junctions"], jp["junctions"]):
            for k in jj:
                assert tuple(tj[k].shape) == jj[k].shape, k
                assert _np(tj[k]).dtype == np.asarray(jj[k]).dtype, k
            for k in ("idx", "rev_j", "rev_f"):
                np.testing.assert_array_equal(tj[k].numpy(),
                                              np.asarray(jj[k]))
            for k in ("w", "b"):
                v = tj[k].numpy() * tcfg.fmt.scale
                assert np.array_equal(v, np.round(v))
                assert v.max() <= tcfg.fmt.max_val * tcfg.fmt.scale
        if mode == "shared":
            w1 = tp["junctions"][0]["w"].reshape(-1)
            n_unique = tcfg.weights(0) // tcfg.z[0]
            assert torch.equal(w1, w1[:n_unique].repeat(tcfg.z[0]))
            assert torch.equal(tp["junctions"][0]["b"],
                               w1[:1].expand(64))
    # seeded: the same weights again; another generator, other weights
    a = PN.init(tcfg, device="cpu")
    b = PN.init(tcfg, device="cpu")
    g = torch.Generator()
    g.manual_seed(1)
    c = PN.init(tcfg, generator=g, device="cpu")
    assert torch.equal(a["junctions"][0]["w"], b["junctions"][0]["w"])
    assert not torch.equal(a["junctions"][0]["w"], c["junctions"][0]["w"])
    # floating point: no quantization
    _, fcfg = _pair(None)
    w = PN.init(fcfg, device="cpu")["junctions"][0]["w"].numpy() * 256
    assert not np.array_equal(w, np.round(w))


def test_entry_points_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PN.init(PN.PaperNetConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _quickstart().main(["--epochs", "1"])


def test_convert_keeps_dtypes_and_device():
    jcfg, _ = _pair(3)
    jp, tp = _carry(jcfg)
    for tj, jj in zip(tp["junctions"], jp["junctions"]):
        for k in jj:
            assert tj[k].device.type == "cpu"
            assert tj[k].numpy().dtype == jj[k].dtype
            np.testing.assert_array_equal(tj[k].numpy(), jj[k])


# ----------------------------------------------------- forward and a step
@pytest.mark.parametrize("fmt_i,act", FXP_CASES, ids=FXP_IDS)
def test_forward_and_sgd_step_bit_for_bit(data, fmt_i, act):
    x, y = data
    jcfg, tcfg = _pair(fmt_i, activation=act)
    jp, tp = _carry(jcfg)
    # forward on a batch: every activation and derivative
    ja, jd = jax.jit(lambda p, x: JPN.forward(p, x, jcfg))(jp, x[:64])
    ta, td = PN.forward(tp, torch.from_numpy(x[:64]), tcfg)
    for i in range(1, 3):
        np.testing.assert_array_equal(ta[i].numpy(), np.asarray(ja[i]))
        np.testing.assert_array_equal(td[i].numpy(), np.asarray(jd[i]))
    # the BP junction and the output delta alone
    tdl = PN.output_delta(ta[2], torch.from_numpy(y[:64]), tcfg)
    jdl = JPN.output_delta(ja[2], jnp.asarray(y[:64]), jcfg)
    np.testing.assert_array_equal(tdl.numpy(), np.asarray(jdl))
    np.testing.assert_array_equal(
        PN.bp_junction(tp["junctions"][1], tdl, td[1], tcfg).numpy(),
        np.asarray(jax.jit(lambda jp, d, a: JPN.bp_junction(jp, d, a, jcfg))(
            jp["junctions"][1], jdl, jd[1])))
    # one online step
    jn, jl, jo = _ref_step(jcfg, jp, x[0], y[0])
    tn, tl, to = PN.sgd_step(tp, torch.from_numpy(x[0]),
                             torch.from_numpy(y[0]), ETA, tcfg)
    _assert_params_equal(jn, tn)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_allclose(float(tl), float(jl), **LOSS_TOL)


@pytest.mark.parametrize("fmt_i,act", FXP_CASES, ids=FXP_IDS)
def test_train_epoch_bit_for_bit(data, fmt_i, act):
    x, y = data[0][:N_EPOCH], data[1][:N_EPOCH]
    jcfg, tcfg = _pair(fmt_i, activation=act)
    jp, tp = _carry(jcfg)
    jn, jl, jc = jax.jit(lambda p: JPN.train_epoch(
        p, jnp.asarray(x), jnp.asarray(y), ETA, jcfg))(jp)
    tn, tl, tc = PN.train_epoch(tp, torch.from_numpy(x), torch.from_numpy(y),
                                ETA, tcfg)
    _assert_params_equal(jn, tn)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOSS_TOL)


@pytest.mark.parametrize("fmt_i,act", FXP_CASES, ids=FXP_IDS)
def test_train_epoch_pipelined_bit_for_bit(data, fmt_i, act):
    x, y = data[0][:N_EPOCH], data[1][:N_EPOCH]
    jcfg, tcfg = _pair(fmt_i, activation=act)
    jp, tp = _carry(jcfg)
    jn, jc = jax.jit(lambda p: JPN.train_epoch_pipelined(
        p, jnp.asarray(x), jnp.asarray(y), ETA, jcfg))(jp)
    tn, tc = PN.train_epoch_pipelined(tp, torch.from_numpy(x),
                                      torch.from_numpy(y), ETA, tcfg)
    _assert_params_equal(jn, tn)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_shared_init_trains_bit_for_bit(data):
    x, y = data[0][:N_EPOCH], data[1][:N_EPOCH]
    jcfg, tcfg = _pair(3, init_mode="shared")
    jp, tp = _carry(jcfg)
    jn, _, jc = jax.jit(lambda p: JPN.train_epoch(
        p, jnp.asarray(x), jnp.asarray(y), ETA, jcfg))(jp)
    tn, _, tc = PN.train_epoch(tp, torch.from_numpy(x), torch.from_numpy(y),
                               ETA, tcfg)
    _assert_params_equal(jn, tn)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


@pytest.mark.parametrize("fmt_i", [3, 4])
@pytest.mark.parametrize("B", [8, 6])
def test_minibatch_step_within_one_grid_step(data, fmt_i, B):
    x, y = data[0][:B], data[1][:B]
    jcfg, tcfg = _pair(fmt_i)
    jp, tp = _carry(jcfg)
    jn, jl, jo = _ref_step(jcfg, jp, x, y)
    tn, tl, to = PN.sgd_step(tp, torch.from_numpy(x), torch.from_numpy(y),
                             ETA, tcfg)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    step = 1.0 / tcfg.fmt.scale
    _assert_params_equal(jn, tn, rtol=0, atol=step)
    for tj in tn["junctions"]:
        v = tj["w"].numpy() * tcfg.fmt.scale
        assert np.array_equal(v, np.round(v)), "off the grid"
    np.testing.assert_allclose(float(tl), float(jl), **LOSS_TOL)


@pytest.mark.parametrize("act", ACTS)
def test_float_path_within_tolerance(data, act):
    x, y = data
    jcfg, tcfg = _pair(None, activation=act)
    jp, tp = _carry(jcfg)
    ja, jd = jax.jit(lambda p, x: JPN.forward(p, x, jcfg))(jp, x[:64])
    ta, td = PN.forward(tp, torch.from_numpy(x[:64]), tcfg)
    for i in range(1, 3):
        np.testing.assert_allclose(ta[i].numpy(), np.asarray(ja[i]),
                                   **FLOAT_TOL)
        np.testing.assert_allclose(td[i].numpy(), np.asarray(jd[i]),
                                   **FLOAT_TOL)
    jn, jl, _ = _ref_step(jcfg, jp, x[0], y[0])
    tn, tl, _ = PN.sgd_step(tp, torch.from_numpy(x[0]),
                            torch.from_numpy(y[0]), ETA, tcfg)
    _assert_params_equal(jn, tn, **FLOAT_TOL)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    n = 64
    jn, _, _ = jax.jit(lambda p: JPN.train_epoch(
        p, jnp.asarray(x[:n]), jnp.asarray(y[:n]), ETA, jcfg))(jp)
    tn, _, _ = PN.train_epoch(tp, torch.from_numpy(x[:n]),
                              torch.from_numpy(y[:n]), ETA, tcfg)
    _assert_params_equal(jn, tn, rtol=0, atol=1e-4)
    jn, _ = jax.jit(lambda p: JPN.train_epoch_pipelined(
        p, jnp.asarray(x[:n]), jnp.asarray(y[:n]), ETA, jcfg))(jp)
    tn, _ = PN.train_epoch_pipelined(tp, torch.from_numpy(x[:n]),
                                     torch.from_numpy(y[:n]), ETA, tcfg)
    _assert_params_equal(jn, tn, rtol=0, atol=1e-4)


# ------------------------------------------------ the reference's contracts
def _epochs(cfg, x, y, n_epochs, pipelined=False, params=None):
    p = params or PN.init(cfg, device="cpu")
    xs, ys = torch.from_numpy(x), torch.from_numpy(y)
    for _ in range(n_epochs):
        if pipelined:
            p, corr = PN.train_epoch_pipelined(p, xs, ys, ETA, cfg)
        else:
            p, _, corr = PN.train_epoch(p, xs, ys, ETA, cfg)
    return p, corr


def test_fxp_training_learns(data):
    _, cfg = _pair(3)
    _, corr = _epochs(cfg, *data, 1)
    assert float(corr[-256:].mean()) > 0.8


def test_pipelined_matches_sequential_convergence(data):
    """Junction pipelining (stale updates) converges like sequential SGD."""
    _, cfg = _pair(3)
    _, corr_s = _epochs(cfg, *data, 2)
    _, corr_p = _epochs(cfg, *data, 2, pipelined=True)
    a_s, a_p = float(corr_s[-512:].mean()), float(corr_p[-512:].mean())
    assert a_p > 0.75 and abs(a_s - a_p) < 0.08


def test_float_vs_fxp_parity(data):
    """Sec. III-D-6: fixed point within a few points of ideal float."""
    accs = {}
    for name, fmt_i in (("float", None), ("fxp", 3)):
        _, cfg = _pair(fmt_i)
        _, corr = _epochs(cfg, *data, 2)
        accs[name] = float(corr[-512:].mean())
    assert abs(accs["float"] - accs["fxp"]) < 0.05


def test_shared_init_mode_trains(data):
    _, cfg = _pair(3, init_mode="shared")
    _, corr = _epochs(cfg, *data, 1)
    assert float(corr[-256:].mean()) > 0.7


@pytest.mark.parametrize("act", ["relu8", "relu1"])
def test_relu_variants_run_and_weights_stay_on_grid(data, act):
    _, cfg = _pair(3, activation=act)
    p, corr = _epochs(cfg, data[0][:512], data[1][:512], 1)
    assert np.isfinite(float(corr.mean()))
    for jp in p["junctions"]:
        for leaf in (jp["w"], jp["b"]):
            v = leaf.numpy() * cfg.fmt.scale
            assert np.array_equal(v, np.round(v))
            assert v.max() <= cfg.fmt.max_val * cfg.fmt.scale
            assert v.min() >= cfg.fmt.min_val * cfg.fmt.scale


def test_quickstart_runs_on_cpu(capsys):
    accs, acc2 = _quickstart().main(["--epochs", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "params=5216" in out and "block cycle = 2.27 us" in out
    assert "epoch 1: eta=2^-3" in out and "junction-pipelined" in out
    assert len(accs) == 1 and 0.0 <= acc2 <= 1.0


def test_paper_modules_import_no_jax_and_no_reference():
    for rel in ("src/repro_torch/core/paper_net.py",
                "src/repro_torch/core/junction_pipeline.py",
                "src/repro_torch/configs/paper_mnist.py",
                "examples/quickstart_torch.py"):
        for node in ast.walk(ast.parse((ROOT / rel).read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "repro"), (
                    rel, name)
