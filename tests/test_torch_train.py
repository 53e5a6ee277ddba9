"""The port's training slice against the JAX reference on the CPU.

Config: the reduced dense model of tests/test_fused_update.py (2 layers,
d_model 128, sparse FFN at density 0.25 and block 32, fp32).  Weights
and optimizer state are made by the reference and carried across with
``convert``; both sides train on the same ``LMTokenPipeline`` batches.
The reference runs its Pallas kernels in interpret mode; the port's
wrappers run their plain versions (the tensors lie on the CPU).

Tolerances: losses agree to 1e-5 relative (fp32, summation order only).
After 3 steps params and slots agree to rtol 5e-4 / atol 5e-5 — the
reference's own bound between its fused and two-pass Adam steps: the
sums run in another order and Adam's m / sqrt(v) divides small
gradients by their own magnitude.
"""
import ast
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as JArchConfig
from repro.core.sparsity import SparsityConfig as JSparsity
from repro.data.pipeline import LMTokenPipeline as JPipeline
from repro.models import model as JM
from repro.optim import adam as jadam
from repro.optim import constant_schedule as jconstant
from repro.optim import fused_adam as jfused_adam
from repro.optim import fused_sgd as jfused_sgd
from repro.train.steps import fused_update_eligible as jeligible
from repro.train.steps import make_train_step as jmake_train_step

from repro_torch.configs.base import ArchConfig
from repro_torch.convert import from_jax_opt_state, from_jax_params
from repro_torch.core.sparsity import SparsityConfig
from repro_torch.data.pipeline import LMTokenPipeline
from repro_torch.kernels import ops
from repro_torch.launch import train as tlaunch
from repro_torch.optim import adam, constant_schedule, fused_adam, fused_sgd
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.steps import fused_update_eligible, make_train_step
from repro_torch.train.train_loop import GuardianConfig, TrainLoopConfig, run
from repro_torch.tree import tree_items

ROOT = Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-5
TREE_TOL = dict(rtol=5e-4, atol=5e-5)
CFG = dict(name="train-test", family="dense", n_layers=2, d_model=128,
           n_heads=4, kv_heads=4, head_dim=32, d_ff=256, vocab=128,
           act="silu", max_seq=64, attn_chunk=32, dtype="float32",
           param_dtype="float32", engine="pallas", fused_update=True)
SEQ, BATCH = 16, 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: the test workers share the
    cores, and oversubscribed BLAS / OpenMP thread teams spin (an fp64
    gradcheck here ran a hundred times slower beside five busy workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    args = dict(CFG, **kw)
    return (JArchConfig(**args, sparsity=JSparsity(0.25, 32, "ffn")),
            ArchConfig(**args, sparsity=SparsityConfig(0.25, 32, "ffn")))


@pytest.fixture(scope="module")
def ref_params():
    jcfg, _ = _cfgs()
    return jax.tree.map(np.asarray, JM.init(jcfg, jax.random.PRNGKey(0)))


def _optimizers(kind):
    """(reference, port) optimizer pairs of the same hyperparameters."""
    if kind == "adam_clip":
        return (jfused_adam(jconstant(1e-3), weight_decay=0.01, grad_clip=1.0),
                fused_adam(constant_schedule(1e-3), weight_decay=0.01,
                           grad_clip=1.0))
    if kind == "sgd_momentum":
        return (jfused_sgd(jconstant(3e-2), momentum=0.9),
                fused_sgd(constant_schedule(3e-2), momentum=0.9))
    raise ValueError(kind)


def _assert_close(got, want, **tol):
    """Port tree against a reference tree already in the port's layout."""
    g, w = dict(tree_items(got)), dict(tree_items(want))
    assert g.keys() == w.keys()
    for k, t in g.items():
        if torch.is_tensor(t) and t.is_floating_point():
            np.testing.assert_allclose(t.float().numpy(),
                                       w[k].float().numpy(), err_msg=k,
                                       **tol)


def _run_ref(jcfg, jopt, params, steps, microbatches=1):
    ts = jmake_train_step(jcfg, jopt, microbatches, donate=False)
    pipe = JPipeline(jcfg, BATCH, SEQ)
    p, s, losses = params, jopt.init(params), []
    for i in range(steps):
        p, s, m = ts(p, s, jax.tree.map(jnp.asarray, next(pipe)),
                     jnp.asarray(i))
        losses.append(float(m["loss"]))
    return (from_jax_params(jax.tree.map(np.asarray, p)),
            from_jax_opt_state(jax.tree.map(np.asarray, s)), losses)


def _run_port(tcfg, topt, ref_params, steps, microbatches=1):
    ts = make_train_step(tcfg, topt, microbatches)
    pipe = LMTokenPipeline(tcfg, BATCH, SEQ)
    p = from_jax_params(ref_params)
    s = topt.init(p)
    losses, nonfinite = [], []
    for i in range(steps):
        p, s, m = ts(p, s, next(pipe), i)
        losses.append(float(m["loss"]))
        nonfinite.append(float(m["nonfinite"]))
    assert nonfinite == [0.0] * steps
    return p, s, losses


@pytest.mark.parametrize("kind,fused,microbatches", [
    ("adam_clip", True, 1), ("adam_clip", False, 1),
    ("sgd_momentum", True, 1), ("sgd_momentum", False, 1),
    ("adam_clip", False, 2)])
def test_train_steps_match_reference(ref_params, kind, fused, microbatches):
    """Three steps of the port against three of the reference, fused or
    two-pass, from the same weights and batches."""
    jcfg, tcfg = _cfgs(fused_update=fused)
    jopt, topt = _optimizers(kind)
    assert jeligible(jcfg, jopt, microbatches)[0] == fused
    assert fused_update_eligible(tcfg, topt, microbatches)[0] == fused
    jp, js, jl = _run_ref(jcfg, jopt, ref_params, 3, microbatches)
    ops.reset_launch_counts()
    tp, ts_, tl = _run_port(tcfg, topt, ref_params, 3, microbatches)
    counts = ops.launch_counts()
    assert sum(counts.values()) == 0           # plain versions on the CPU
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    _assert_close(tp, jp, **TREE_TOL)
    _assert_close(ts_, js, **TREE_TOL)


def test_fused_step_matches_own_two_pass(ref_params):
    """The port's fused Adam step against its own two-pass step over three
    steps; both junction paths are counted through the wrappers' routes."""
    _, tcfg = _cfgs()
    _, topt = _optimizers("adam_clip")
    fp, fs, fl = _run_port(tcfg, topt, ref_params, 3)
    rp, rs, rl = _run_port(dataclasses.replace(tcfg, fused_update=False),
                           topt, ref_params, 3)
    np.testing.assert_allclose(fl, rl, rtol=LOSS_RTOL)
    _assert_close(fp, rp, **TREE_TOL)
    _assert_close(fs, rs, **TREE_TOL)


def test_two_pass_leaves_inputs_and_fused_updates_in_place(ref_params):
    _, tcfg = _cfgs()
    _, topt = _optimizers("sgd_momentum")
    batch = next(LMTokenPipeline(tcfg, BATCH, SEQ))
    p0 = from_jax_params(ref_params)
    w0 = p0["layers"][0]["mlp"]["wg"]["w"].clone()
    ts = make_train_step(dataclasses.replace(tcfg, fused_update=False), topt)
    p1, _, _ = ts(p0, topt.init(p0), batch, 0)
    assert torch.equal(p0["layers"][0]["mlp"]["wg"]["w"], w0)
    ts = make_train_step(tcfg, topt)
    p2, _, _ = ts(p0, topt.init(p0), batch, 0)
    assert p2["layers"][0]["mlp"]["wg"]["w"] is p0["layers"][0]["mlp"]["wg"]["w"]
    torch.testing.assert_close(p2["layers"][0]["mlp"]["wg"]["w"],
                               p1["layers"][0]["mlp"]["wg"]["w"],
                               rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------- eligibility
@pytest.mark.parametrize("case", [
    "eligible", "fused_off", "engine_jnp", "plain_adam", "cast_once",
    "bf16_compute_fp32_params"])
def test_eligibility_refusals_match_reference(case):
    kw = {"fused_off": dict(fused_update=False),
          "engine_jnp": dict(engine="jnp"),
          "cast_once": dict(cast_params_once=True),
          "bf16_compute_fp32_params": dict(dtype="bfloat16")}.get(case, {})
    jcfg, tcfg = _cfgs(**kw)
    if case == "plain_adam":
        jopt, topt = jadam(jconstant(1e-3)), adam(constant_schedule(1e-3))
    else:
        jopt, topt = _optimizers("sgd_momentum")
    jok, _ = jeligible(jcfg, jopt)
    tok, why = fused_update_eligible(tcfg, topt)
    assert tok == jok == (case == "eligible"), why


# ----------------------------------------------------- loop, checkpoints
def _loop(tcfg, topt, ref_params, ckpt_dir, steps, **kw):
    p = from_jax_params(ref_params)
    return run(TrainLoopConfig(total_steps=steps, ckpt_dir=str(ckpt_dir),
                               ckpt_every=1, log_every=1, **kw),
               make_train_step(tcfg, topt), p, topt.init(p),
               LMTokenPipeline(tcfg, BATCH, SEQ), log=lambda s: None)


def test_resume_after_injected_failure_is_bitwise(ref_params, tmp_path):
    """fail_at_step, then a resume from the same directory, gives the same
    params and optimizer state, bit for bit, as an uninterrupted run (on
    the fused path, which updates the loop's tensors in place)."""
    _, tcfg = _cfgs()
    _, topt = _optimizers("adam_clip")
    whole = _loop(tcfg, topt, ref_params, tmp_path / "a", 4)
    with pytest.raises(RuntimeError, match="injected failure at step 2"):
        _loop(tcfg, topt, ref_params, tmp_path / "b", 4, fail_at_step=2)
    assert ckpt.latest_step(tmp_path / "b") == 2
    resumed = _loop(tcfg, topt, ref_params, tmp_path / "b", 4)
    assert resumed["step"] == whole["step"] == 4
    for a, b in ((whole["params"], resumed["params"]),
                 (whole["opt_state"], resumed["opt_state"])):
        ga, gb = dict(tree_items(a)), dict(tree_items(b))
        assert ga.keys() == gb.keys()
        for k in ga:
            assert torch.equal(ga[k], gb[k]), k


def test_corrupt_newest_checkpoint_falls_back(tmp_path):
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "h": torch.ones(3, dtype=torch.bfloat16),
            "i": torch.tensor([1, 2], dtype=torch.int32)}
    for s in (1, 2):
        ckpt.save(tmp_path, s, {k: v * s for k, v in tree.items()},
                  extra={"step": s})
    (tmp_path / "step_0000000002" / "arrays.npz").write_bytes(b"torn")
    logs = []
    s, got, extra = ckpt.restore_latest(tmp_path, tree, log=logs.append)
    assert s == 1 and extra == {"step": 1} and "unreadable" in logs[0]
    for k in tree:
        assert torch.equal(got[k], tree[k]) and got[k].dtype == tree[k].dtype
    ckpt.mark_healthy(tmp_path, 1)
    for s in (3, 4):
        ckpt.save(tmp_path, s, tree)
    assert ckpt.gc_checkpoints(tmp_path, 1) == [2, 3]
    assert ckpt.complete_steps(tmp_path) == [1, 4]


def test_guardian_trip_rolls_back_and_backs_off(ref_params, tmp_path):
    """A non-finite loss at step 2 trips the guardian: the loop restores
    the healthy anchor, halves lr_scale (passed to the step), skips the
    offending batch and finishes."""
    _, tcfg = _cfgs()
    _, topt = _optimizers("sgd_momentum")
    inner = make_train_step(tcfg, topt)
    seen = []

    def step_fn(params, opt_state, batch, step, lr_scale):
        seen.append((step, lr_scale))
        p, s, m = inner(params, opt_state, batch, step, lr_scale)
        if step == 2 and lr_scale == 1.0:
            m = dict(m, loss=torch.tensor(float("nan")))
        return p, s, m

    p = from_jax_params(ref_params)
    res = run(TrainLoopConfig(total_steps=4, ckpt_dir=str(tmp_path),
                              ckpt_every=100, guardian=GuardianConfig()),
              step_fn, p, topt.init(p), LMTokenPipeline(tcfg, BATCH, SEQ),
              log=lambda s: None)
    g = res["guardian"]
    assert len(g["trips"]) == 1 and "non-finite loss" in g["trips"][0]["reason"]
    assert g["lr_scale"] == 0.5 and g["skipped_data_steps"] == [2]
    assert res["step"] == 4
    # rolled back to the step-0 anchor, then every step ran at half the lr
    assert [s for s, _ in seen] == [0, 1, 2, 0, 1, 2, 3]
    assert [ls for _, ls in seen[3:]] == [0.5] * 4


# ------------------------------------------------------------------ guards
def test_launch_train_runs_on_cpu(tmp_path, capsys):
    res = tlaunch.main(["--reduce", "--sparse", "--steps", "2", "--batch",
                        "2", "--seq", "16", "--device", "cpu", "--ckpt",
                        str(tmp_path)])
    assert res["step"] == 2
    out = capsys.readouterr().out
    assert "update path: two-pass" in out and "first loss" in out


_NEW_MODULES = ("tree.py", "optim/optimizers.py", "optim/schedule.py",
                "data/pipeline.py", "train/steps.py", "train/checkpoint.py",
                "train/train_loop.py", "launch/train.py")


@pytest.mark.parametrize("rel", _NEW_MODULES)
def test_training_modules_import_no_jax_and_no_reference(rel):
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
