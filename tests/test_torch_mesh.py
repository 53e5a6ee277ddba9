"""The port's device mesh (``launch/mesh.py``), its mesh train step
(``train/steps.make_mesh_train_step``) and ``launch/train.py --devices /
--data / --model`` on gloo ranks, against one rank and the JAX
reference.

* The twin of tests/test_distributed.py's sharded-train test: 8 gloo
  ranks on a 2 x 4 mesh run one Adam step (constant lr 1e-3, no clip) of
  reduced deepseek-7b on the reference's carried weights and batch
  (4 x 64), once at the config's bf16 compute, held to the reference's
  own bounds (loss within 2e-3, params within 5e-3), and once in fp32,
  held to the train parity tolerance (rtol 5e-4 / atol 5e-5, with the
  noise-floor slack of Adam's first step that tests/test_torch_moe.py
  states): each time against the one-rank step and the reference's
  single-device step.  Each rank holds, of every param and Adam leaf,
  its full numel over the product of the axes its spec shards, and a
  hinted DTensor anchor lands sharded (dp, "model").
* The fused path's gathered route (``make_gathered_mesh_train_step``,
  which a config outside the partitioned route takes; reduced sparse
  stablelm-3b, fp32, clipped fused Adam, 2 steps) on a 2 x 2 mesh equals
  one rank bit for bit: every rank runs the whole batch.  Every family's
  fused step takes the partitioned route
  (tests/test_torch_partitioned_fused*.py).
* The mesh step at world size 1 equals the plain step bit for bit, on
  the two-pass and the fused path.
* ``launch/train.py --device cpu --reduce --sparse --devices 4 --data 2
  --model 2`` gives the losses of ``--devices 1`` within the reference's
  bf16 bound (2e-3: the launcher computes in bf16, and two ranks' rows
  average what one rank sums); ``--devices 1`` equals the plain run
  bit for bit, through a checkpoint resume of its placed tree.
* ``make_local_mesh`` / ``make_production_mesh`` and the launcher raise
  without a matching world size, and for more than one rank on the card.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate

from repro.configs import registry as jreg
from repro.launch.specs import concrete_batch as jconcrete_batch
from repro.models import model as JM
from repro.optim import adam as jadam
from repro.optim import constant_schedule as jconstant
from repro.train.steps import make_train_step as jmake_train_step

from repro_torch.configs import registry as treg
from repro_torch.convert import from_jax_opt_state, from_jax_params
from repro_torch.core.sparsity import SparsityConfig
from repro_torch.data.pipeline import LMTokenPipeline
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train as ttrain
from repro_torch.models import model as TM
from repro_torch.optim import adam, constant_schedule, fused_adam
from repro_torch.parallel import partition
from repro_torch.parallel import sharding as sh
from repro_torch.train.steps import make_mesh_train_step, make_train_step
from repro_torch.tree import tree_items, tree_map
from torch_mesh_workers import fused_case, fused_steps, run_ranks, \
    sharded_step
from torch_parity_helpers import close_trees, noise_slack

TREE_TOL = dict(rtol=5e-4, atol=5e-5)
LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def one_rank_group():
    """A one-rank gloo group in this process, destroyed after the test."""
    tmesh.start_one_rank_group("cpu")
    yield
    dist.destroy_process_group()


def _flat(tree, prefix=""):
    """A reference tree as {"a.b.c": numpy}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _loaded(path):
    """rank 0's results: ({path: tensor}, extras)."""
    raw = dict(np.load(path))
    leaves = {k[5:]: torch.from_numpy(v) for k, v in raw.items()
              if k.startswith("leaf:")}
    return leaves, {k: v for k, v in raw.items() if not k.startswith("leaf:")}


def _sub(leaves, top):
    return {k[len(top) + 1:]: v for k, v in leaves.items()
            if k.startswith(top + "/")}


def _close_flat(got: dict, want_tree, slack=None, **tol):
    want = {k: v.float() if v.is_floating_point() else v
            for k, v in tree_items(want_tree)}
    assert got.keys() == want.keys()
    close_trees(got, want, slack=slack, **tol)


def test_sharded_step_matches_one_rank_and_reference(tmp_path):
    jcfg = jreg.get("deepseek-7b").reduced()
    jparams = jax.tree.map(np.asarray, JM.init(jcfg, jax.random.PRNGKey(0)))
    batch = {k: np.asarray(v) for k, v in jconcrete_batch(
        jcfg, 4, 64, jax.random.PRNGKey(3)).items()}
    np.savez(tmp_path / "in.npz", **_flat(jparams),
             batch_tokens=batch["tokens"])
    run_ranks(sharded_step, 8, str(tmp_path), ("bfloat16", "float32"), 2, 4)
    assert np.load(tmp_path / "ok.npy").tolist() == [True] * 8
    for dtype, tol, loss_tol in (
            ("bfloat16", dict(rtol=0.0, atol=5e-3), 2e-3),
            ("float32", TREE_TOL, None)):
        jc = dataclasses.replace(jcfg, dtype=dtype)
        tcfg = dataclasses.replace(treg.get("deepseek-7b").reduced(),
                                   dtype=dtype)
        jopt = jadam(jconstant(LR), grad_clip=None)
        jp, js, jm = jax.jit(jmake_train_step(jc, jopt, jit=False))(
            jparams, jopt.init(jparams), batch, jnp.asarray(0))
        jp = from_jax_params(jax.tree.map(np.asarray, jp))
        jmom = from_jax_opt_state(jax.tree.map(np.asarray, js))["m"]
        opt = adam(constant_schedule(LR), grad_clip=None)
        params = from_jax_params(jparams)
        p1, s1, m1 = make_train_step(tcfg, opt)(params, opt.init(params),
                                                batch, 0)
        leaves, extra = _loaded(tmp_path / f"out_{dtype}.npz")
        got_p, got_m = _sub(leaves, "params"), _sub(leaves, "m")
        loss = float(extra["loss"])
        if loss_tol is not None:        # the reference's own bounds
            assert abs(loss - float(m1["loss"])) < loss_tol
            assert abs(loss - float(jm["loss"])) < loss_tol
            _close_flat(got_p, p1, **tol)
            _close_flat(got_p, jp, **tol)
            continue
        assert loss == pytest.approx(float(m1["loss"]), rel=1e-5)
        assert loss == pytest.approx(float(jm["loss"]), rel=1e-5)
        for want_p, want_m in ((p1, s1["m"]), (jp, jmom)):
            _close_flat(got_m, want_m, **TREE_TOL)
            slack = noise_slack(got_m, want_m, LR)
            _close_flat(got_p, want_p, slack=slack, **TREE_TOL)


def test_fused_mesh_step_equals_one_rank(tmp_path):
    run_ranks(fused_steps, 4, str(tmp_path), 2, 2, 2)
    cfg, opt, params, batches = fused_case(2)
    step = make_train_step(cfg, opt)
    state = opt.init(params)
    losses = []
    for i, batch in enumerate(batches):
        params, state, m = step(params, state, batch, i)
        losses.append(float(m["loss"]))
    leaves, extra = _loaded(tmp_path / "fused.npz")
    assert extra["losses"].tolist() == losses
    want = dict(tree_items(params))
    assert leaves.keys() == want.keys()
    for k, t in leaves.items():
        assert torch.equal(t, want[k].float() if t.is_floating_point()
                           else want[k]), k


@pytest.mark.parametrize("fused", [False, True], ids=["two_pass", "fused"])
def test_mesh_step_on_one_rank_equals_plain_step(fused, one_rank_group):
    cfg = dataclasses.replace(
        treg.get("stablelm-3b").reduced().with_sparsity(
            SparsityConfig(density=0.5, block=32, where="ffn")),
        dtype="float32", param_dtype="float32", fused_update=fused)
    opt = (fused_adam if fused else adam)(constant_schedule(LR),
                                          grad_clip=1.0)
    batch = next(LMTokenPipeline(cfg, 2, 32))
    mesh = tmesh.make_local_mesh(1, 1, "cpu")
    params = TM.init(cfg, 0, "cpu")
    specs = sh.param_specs(cfg, params, mesh)
    placed = sh.place(params, specs, mesh)
    state = sh.place_state(opt.init(params), specs, mesh)
    p, s, m = make_mesh_train_step(cfg, opt, mesh)(placed, state, batch, 0)
    q, r, n = make_train_step(cfg, opt)(params, opt.init(params), batch, 0)
    assert float(m["loss"]) == float(n["loss"])
    for got, want in ((sh.gather(p), q), (sh.gather(s), r)):
        for (k, a), (_, b) in zip(tree_items(got), tree_items(want)):
            assert torch.equal(a, b), k


def test_wrap_like_and_local_tree_equal_from_local_and_to_local(
        one_rank_group):
    """``sharding.wrap_like`` places each new shard as
    ``DTensor.from_local`` would (a shard of its leaf's dtype that needs
    no gradient reuses the leaf's placement record; another dtype, or a
    shard that needs one, goes through ``from_local``), and
    ``partition.local_tree`` gives each shard itself (``to_local`` where
    the leaf needs a gradient, which then flows back to it)."""
    cfg = treg.get("whisper-base").reduced().with_sparsity(
        SparsityConfig(density=0.5, block=32, where="ffn"))
    mesh = tmesh.make_local_mesh(1, 1, "cpu")
    params = TM.init(cfg, 0, "cpu")
    placed = sh.place(params, sh.param_specs(cfg, params, mesh), mesh)
    local = partition.local_tree(placed)
    new = {k: v for k, v in tree_items(local)}
    for (k, d), (_, t) in zip(tree_items(placed), tree_items(local)):
        assert t is d._local_tensor, k
        new[k] = t + 1 if t.is_floating_point() else t
    casts = {"embed/tok": torch.bfloat16}
    grads = {"final_norm/scale"}
    assert casts.keys() | grads <= new.keys()
    it = iter(tree_items(local))

    def fresh(t):
        k, _ = next(it)
        v = new[k].to(casts.get(k, new[k].dtype))
        return v.requires_grad_() if k in grads else v
    wrapped = sh.wrap_like(tree_map(fresh, local), placed)
    for (k, w), (_, d) in zip(tree_items(wrapped), tree_items(placed)):
        if not d.is_floating_point():
            assert w is d, k
            continue
        want = DTensor.from_local(new[k].to(casts.get(k, d.dtype)),
                                  d.device_mesh, d.placements,
                                  run_check=False, shape=d.shape,
                                  stride=d.stride())
        assert isinstance(w, DTensor), k
        assert (w.placements, w.shape, w.stride(), w.dtype) == (
            want.placements, want.shape, want.stride(), want.dtype), k
        assert w.requires_grad == (k in grads), k
        assert torch.equal(w.full_tensor().detach(), want.full_tensor()), k
    leaf = DTensor.from_local(torch.zeros(3), mesh, [Replicate()] * 2,
                              run_check=False).requires_grad_()
    partition.local_tree({"x": leaf})["x"].sum().backward()
    assert torch.equal(leaf.grad.full_tensor(), torch.ones(3))


def _losses(path):
    return [e["loss"] for e in map(json.loads, open(path))
            if e.get("kind") == "train.step"]


def test_launcher_devices_4_matches_devices_1(tmp_path):
    base = ["--device", "cpu", "--reduce", "--sparse", "--batch", "2",
            "--seq", "16"]

    def run(name, devices, steps, *mesh):
        obs = tmp_path / f"{name}_{steps}.jsonl"
        ttrain.main(base + ["--steps", str(steps), "--devices", str(devices),
                            *mesh, "--ckpt", str(tmp_path / name),
                            "--obs", str(obs)])
        return _losses(obs)

    four = run("four", 4, 3, "--data", "2", "--model", "2")
    one = run("one", 1, 2) + run("one", 1, 3)      # the second resumes
    plain = run("plain", 0, 3)
    assert len(four) == 3 and one == plain
    np.testing.assert_allclose(four, one, rtol=0, atol=2e-3)


def test_meshes_raise_without_matching_world():
    with pytest.raises(RuntimeError, match="world size 4, have none"):
        tmesh.make_local_mesh(2, 2, "cpu")
    with pytest.raises(RuntimeError, match="256 ranks"):
        tmesh.make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="512 ranks"):
        tmesh.make_production_mesh(multi_pod=True, device="cpu")
    tmesh.make_local_mesh(1, 1, "cpu")           # starts a one-rank group
    try:
        with pytest.raises(RuntimeError, match="world size 2, have 1"):
            tmesh.make_local_mesh(2, 1, "cpu")
    finally:
        dist.destroy_process_group()


def test_launcher_refuses_mismatched_world_and_many_ranks_on_card(
        monkeypatch, tmp_path):
    argv = ["--device", "cpu", "--reduce", "--steps", "1", "--ckpt",
            str(tmp_path)]
    with pytest.raises(ValueError, match="--devices 4 needs"):
        ttrain.main(argv + ["--devices", "4", "--data", "2"])
    with pytest.raises(RuntimeError, match="world size 2, have none"):
        ttrain.main(argv + ["--data", "2"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "the card")
    with pytest.raises(RuntimeError, match="one card"):
        ttrain.main(["--device", "cuda", "--devices", "2", "--data", "2"])
    assert not dist.is_initialized()
