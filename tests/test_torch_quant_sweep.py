"""The port's PTQ sweep path against the JAX reference on the CPU: the
MNIST-class data, cohort bucketing, stacked quantized populations (int8
and every fixed-point triplet) evaluated E at once, one population
train step (fused BP+UP and two-pass), and the ``quant_sweep`` launcher.

Populations: the paper MLP cut to layers (128, 64, 32), block 32,
density 0.5 (fan-in 2 and 1), sigmoid; weights made by the reference and
carried across.  The reference runs its jnp engine for evaluation and
two-pass steps, and its Pallas kernels in interpret mode for the fused
step.

Tolerances: fixed-point outputs are exact (integer pipeline and table);
int8 outputs within 1e-5 (the reference's own kernel-vs-sim bound);
member losses, means of those outputs, within 1e-6 relative.  One train
step: params and slots within rtol 1e-5 / atol 1e-6 (fp32 sums in
another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fixed_point as jfp
from repro.core import quantize as jqz
from repro.data import mnist as jmnist
from repro.search import cohorts as jcoh
from repro.search import population as jpop

from repro_torch.core import fixed_point as tfp
from repro_torch.core import quantize as tqz
from repro_torch.data import mnist as tmnist
from repro_torch.launch import quant_sweep as tsweep
from repro_torch.search import cohorts as tcoh
from repro_torch.search import population as tpop

LAYERS = (128, 64, 32)
STEP_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _specs(lrs=(0.3,), momentum=0.9, opt="sgd", eps=1e-8):
    def make(mod):
        return [mod.CandidateSpec(lr=lr, momentum=momentum, density=0.5,
                                  layers=LAYERS, block=32, init_seed=i,
                                  opt=opt, eps=eps)
                for i, lr in enumerate(lrs)]
    return make(jpop), make(tpop)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_torch(v) for v in tree)
    return torch.tensor(np.asarray(tree))


def _data(n=48, seed=0):
    x, t, _ = jmnist.paper_dataset(n=n, seed=seed)
    return x[:, :LAYERS[0]], t


@pytest.fixture(scope="module")
def trained():
    """A reference MLP after a few jnp steps (the sweep's fp stage)."""
    jspecs, _ = _specs()
    pop = jpop.init_population(jax.random.PRNGKey(0), jspecs)
    slots = jpop.init_slots(pop, jspecs)
    step = jpop.make_population_step("sigmoid", engine="jnp", fused=False)
    x, t = _data()
    for _ in range(3):
        pop, slots, _ = step(pop, slots, jpop.hyp_table(jspecs),
                             jnp.ones((1,)), x, t)
    fp_layers = jpop.member_slice(jax.tree.map(np.asarray, pop), 0)
    return fp_layers, x, t


# ------------------------------------------------------------------- data
def test_mnist_data_matches_reference():
    for fn, kw in ((jmnist.synthetic_mnist, dict(n=40, seed=3)),
                   (jmnist.paper_dataset, dict(n=40, seed=1))):
        want = fn(**kw)
        got = getattr(tmnist, fn.__name__)(**kw)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert tmnist.PAPER_EPOCH == jmnist.PAPER_EPOCH


# ---------------------------------------------------------------- cohorts
def test_cohorts_match_reference():
    fmts = list(zip(jfp.PAPER_TRIPLETS, tfp.PAPER_TRIPLETS))
    jq = [jqz.QuantConfig(bits=b, granularity=g) for b in (8, 4)
          for g in ("block", "unit")] + [
        jqz.QuantConfig(mode="fxp", fmt=f) for f, _ in fmts]
    tq = [tqz.QuantConfig(bits=b, granularity=g) for b in (8, 4)
          for g in ("block", "unit")] + [
        tqz.QuantConfig(mode="fxp", fmt=f) for _, f in fmts]
    for j, t in zip(jcoh.bucket_quant(jq), tcoh.bucket_quant(tq)):
        assert (t.key, t.member_ids, t.size) == (j.key, j.member_ids, j.size)
    jspecs, tspecs = _specs(lrs=(0.1, 0.2))
    jspecs.append(jpop.CandidateSpec(lr=0.1, density=0.25, layers=LAYERS,
                                     block=32))
    tspecs.append(tpop.CandidateSpec(lr=0.1, density=0.25, layers=LAYERS,
                                     block=32))
    jb, tb = jcoh.bucket(jspecs), tcoh.bucket(tspecs)
    assert [(c.key, c.member_ids) for c in tb] == [
        (c.key, c.member_ids) for c in jb]
    assert tpop.structure_key(tspecs[0]) == jpop.structure_key(jspecs[0])
    np.testing.assert_array_equal(tpop.hyp_table(tspecs, "cpu").numpy(),
                                  np.asarray(jpop.hyp_table(jspecs)))


# ------------------------------------------------- quantized populations
def _stack(mod, members):
    """E quantized member layer lists -> one stacked population, as the
    sweep stacks them (patterns and the fxp format shared)."""
    stack = jnp.stack if mod is jqz else torch.stack
    pattern = ("idx", "rev_ob", "rev_t", "rev_cnt")
    popq = []
    for li in range(len(members[0])):
        base = members[0][li]
        layer = {k: base[k] for k in pattern + ("qfmt", "qlut") if k in base}
        for k in ("wq", "w_scale", "b", "x_scale"):
            if k in base:
                layer[k] = stack([m[li][k] for m in members])
        popq.append(layer)
    return popq


@pytest.mark.parametrize("cohort", ["int8", "int8_static"]
                         + [f"fxp{f.bw}_{f.bn}_{f.bf}"
                            for f in jfp.PAPER_TRIPLETS])
def test_quantized_population_eval_matches_reference(trained, cohort):
    fp_layers, x, t = trained
    if cohort.startswith("int8"):
        grid = [dict(bits=b, granularity=g) for b in (8, 6, 4)
                for g in ("block", "unit")]
        jcfgs = [jqz.QuantConfig(**kw) for kw in grid]
        tcfgs = [tqz.QuantConfig(**kw) for kw in grid]
    else:
        bw, bn, bf = map(int, cohort[3:].split("_"))
        jcfgs = [jqz.QuantConfig(mode="fxp", fmt=jfp.FxpFormat(bw, bn, bf))]
        tcfgs = [tqz.QuantConfig(mode="fxp", fmt=tfp.FxpFormat(bw, bn, bf))]
    xs = ([0.0081, 0.0078] if cohort == "int8_static" else [None, None])
    jlayers = jax.tree.map(jnp.asarray, fp_layers)
    tlayers = _to_torch(fp_layers)
    jmem = [[jqz.quantize_junction(
        p, q, x_scale=xs[i] if q.mode == "int8" else None)
        for i, p in enumerate(jlayers)] for q in jcfgs]
    tmem = [[tqz.quantize_junction(
        p, q, x_scale=xs[i] if q.mode == "int8" else None)
        for i, p in enumerate(tlayers)] for q in tcfgs]
    jq, tq = _stack(jqz, jmem), _stack(tqz, tmem)
    E = len(jcfgs)
    assert tpop.population_size(tq) == E
    jy = jpop.population_forward(jq, jnp.asarray(x), act="sigmoid",
                                 engine="jnp")
    ty = tpop.population_forward(tq, torch.from_numpy(x), act="sigmoid")
    if cohort.startswith("fxp"):
        np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    else:
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5,
                                   rtol=1e-5)
    jl = jpop.make_population_eval("sigmoid", engine="jnp")(jq, x, t)
    tl = tpop.make_population_eval("sigmoid")(tq, torch.from_numpy(x),
                                              torch.from_numpy(t))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-6)


def test_calibrated_scales_match_reference(trained):
    fp_layers, x, _ = trained
    want = jqz.calibrate_layer_scales(jax.tree.map(jnp.asarray, fp_layers),
                                      jnp.asarray(x), act="sigmoid")
    got = tqz.calibrate_layer_scales(_to_torch(fp_layers),
                                     torch.from_numpy(x), act="sigmoid")
    np.testing.assert_allclose(got, want, rtol=1e-6)


# ---------------------------------------------------------- population step
@pytest.mark.parametrize("path", ["fused_sgd", "two_pass_adam"])
def test_population_step_matches_reference(path):
    """One step of a 3-member population (three learning rates) from the
    reference's weights: fused BP+UP with momentum against the
    reference's fused step (Pallas, interpret mode), or two-pass Adam
    against its two-pass step (jnp engine).  Adam runs at eps 1e-3: at
    1e-8 its first step is lr * g / |g| wherever a gradient element sits
    at the summation-order noise floor, and such elements differ by up to
    2 lr between any two summation orders."""
    opt = "adam" if "adam" in path else "sgd"
    jspecs, tspecs = _specs(lrs=(0.05, 0.2, 0.5), opt=opt,
                            eps=1e-3 if opt == "adam" else 1e-8)
    pop = jpop.init_population(jax.random.PRNGKey(1), jspecs)
    slots = jpop.init_slots(pop, jspecs)
    hyp = jpop.hyp_table(jspecs)
    mask = jnp.asarray([1.0, 1.0, 0.5])
    x, t = _data(n=16, seed=2)
    fused = path.startswith("fused")
    tp = _to_torch(jax.tree.map(np.asarray, pop))
    ts = _to_torch(jax.tree.map(np.asarray, slots))
    jstep = jpop.make_population_step(
        "sigmoid", engine="pallas" if fused else "jnp", fused=fused,
        jit=False)
    jp, js, jl = jstep(pop, slots, hyp, mask, x, t)
    tstep = tpop.make_population_step("sigmoid", fused=fused)
    tp, ts, tl = tstep(tp, ts, tpop.hyp_table(tspecs, "cpu"),
                       torch.from_numpy(np.array(mask)),
                       torch.from_numpy(x), torch.from_numpy(t))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-6)
    for li, (a, b) in enumerate(zip(tp, jp)):
        for k in ("w", "b"):
            np.testing.assert_allclose(a[k].numpy(), np.asarray(b[k]),
                                       err_msg=f"{li}/{k}", **STEP_TOL)
    for a_tree, b_tree in zip(ts, js):
        for li, (a, b) in enumerate(zip(a_tree, b_tree)):
            for k in ("w", "b"):
                np.testing.assert_allclose(a[k].numpy(), np.asarray(b[k]),
                                           err_msg=f"slot {li}/{k}",
                                           **STEP_TOL)


def test_member_slice_and_init_shapes():
    _, tspecs = _specs(lrs=(0.1, 0.2))
    pop = tpop.init_population(0, tspecs, "cpu")
    assert [tuple(p["w"].shape) for p in pop] == [(2, 2, 2, 32, 32),
                                                 (2, 1, 1, 32, 32)]
    one = tpop.member_slice(pop, 1)
    assert torch.equal(one[0]["w"], pop[0]["w"][1])
    assert one[0]["idx"] is pop[0]["idx"]
    with pytest.raises(ValueError, match="share structure"):
        tpop.init_population(0, [tspecs[0], tpop.CandidateSpec(
            lr=0.1, layers=(128, 32), block=32)], "cpu")


# ------------------------------------------------------------------ launcher
@pytest.mark.parametrize("extra", [["--fxp"], ["--calibrate"]],
                         ids=["fxp", "calibrate"])
def test_quant_sweep_runs_on_cpu_and_names_a_winner(extra, tmp_path, capsys):
    out = tmp_path / "q.json"
    ledger = tsweep.main(["--device", "cpu", "--steps", "2", "--hidden",
                          "64", "--block", "32", "--batch", "8",
                          "--samples", "32", "--eval-samples", "16",
                          "--calib-samples", "8", "--bits", "8,4",
                          "--out", str(out), *extra])
    text = capsys.readouterr().out
    assert "[quant-sweep] winner:" in text and out.exists()
    n = 4 + (5 if "--fxp" in extra else 0)
    assert len(ledger["records"]) == n
    assert np.isfinite(ledger["winner"]["eval_loss"])
    assert ledger["calibrated"] == ("--calibrate" in extra)
