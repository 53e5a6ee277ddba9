"""The fused BP+UP train step on the partitioned mesh route
(``steps.make_mesh_train_step`` for the dense, vlm and ssm families: each
fused junction updates the rank's model shard of its weight and slots,
gathered over the dp axes, over every row of the batch,
``partition.HeldJunction``) against one rank, the JAX reference and the
dry run's reckoning, on the CPU.

* ``steps.partitioned`` admits the fused step of every family whose
  two-pass step it admits (the moe and audio families' in
  tests/test_torch_partitioned_fused_moe.py and
  tests/test_torch_partitioned_fused_audio.py); the hybrid is never
  fused.  The partitioned fused step raises for a config outside the
  route, and a fused step's quantized expert pair raises on it.
* 8 gloo ranks on a 2 x 4 (data x model) mesh run ``FUSED_CASES``
  (tests/torch_mesh_workers.py), fp32, FFN density 0.5: reduced
  stablelm-3b at block 64, so that ``wg`` / ``wi`` (4 output blocks, one a
  model rank) are "col" junctions and ``wo`` (2 output blocks on a
  4-wide "model") a "rep" one; reduced llava-next-mistral-7b (8 patches
  ahead of 28 tokens a row, its window 12) and reduced falcon-mamba-7b
  at block 32.  Each takes 3 steps of clipped fused Adam (lr 1e-3, clip
  1.0) and of fused SGD with momentum (lr 3e-2, 0.9), 4 rows a step, on
  weights the reference made, carried through numpy:
  - the losses, the gathered params and slots against the port's
    one-rank fused step and the reference's single-device fused step
    (engine "pallas", its kernels in interpret mode): losses to 1e-5,
    params and slots to rtol 5e-4 / atol 5e-5 (the train parity
    tolerance; an Adam element whose gradient sits at the
    summation-order noise floor may move by 2 lr a step either way,
    tests/torch_parity_helpers.noise_slack's rule, summed over the
    steps);
  - ``nonfinite`` equals the one-rank step's count, 0 here;
  - every rank holds at rest only its shards of the params and slots,
    after each step; it gathers one unit at a time, a fused junction's
    weight and slots included, and no gathered junction weight or slot
    outlives its backward;
  - the collectives, dot FLOPs and held bytes of every rank's first step
    equal ``launch/dryrun.count_cell``'s reckoning of the same step on
    ``AbstractMesh((2, 4))``.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.launch.specs import concrete_batch as jconcrete_batch
from repro.models import model as JM
from repro.optim import constant_schedule as jconstant
from repro.optim import fused_adam as jfused_adam
from repro.optim import fused_sgd as jfused_sgd
from repro.train.steps import fused_update_eligible as jeligible
from repro.train.steps import make_train_step as jmake_train_step

from repro_torch.configs import registry as treg
from repro_torch.configs.base import ShapeSpec
from repro_torch.convert import from_jax_opt_state, from_jax_params
from repro_torch.core import sparse_linear as sl
from repro_torch.core.sparsity import SparsityConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import model as TM
from repro_torch.optim import adam, constant_schedule
from repro_torch.parallel import partition
from repro_torch.parallel import sharding as sh
from repro_torch.train import steps
from repro_torch.tree import tree_items
from torch_mesh_workers import FUSED_CASES, FUSED_OPTS, FUSED_STEPS, \
    PART_B, PART_S, VLM_S, fused_mesh_batches, fused_mesh_case, \
    fused_mesh_opt, fused_partitioned_run, join_ranks, start_ranks
from torch_parity_helpers import close_trees, noise_slack, \
    reference_variant

TREE_TOL = dict(rtol=5e-4, atol=5e-5)
MESH = (2, 4)
RUNS = [(i, kind) for i in range(len(FUSED_CASES)) for kind in FUSED_OPTS]
IDS = [f"{FUSED_CASES[i][0]}-{kind}" for i, kind in RUNS]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seq(i) -> int:
    return VLM_S if FUSED_CASES[i][0] == "llava-next-mistral-7b" else PART_S


def _jcfg(i):
    arch, block, changes = FUSED_CASES[i]
    tcfg = fused_mesh_case(*FUSED_CASES[i])
    jcfg = reference_variant(jreg.get(arch).reduced(), tcfg)
    return dataclasses.replace(jcfg, dtype="float32", engine="pallas",
                               fused_update=True, **changes), tcfg


def _jopt(kind):
    if kind == "adam_clip":
        return jfused_adam(jconstant(1e-3), grad_clip=1.0)
    return jfused_sgd(jconstant(3e-2), momentum=0.9)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _unflat(raw):
    tree = {}
    for k, v in raw.items():
        node = tree
        *head, last = k.split(".")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return tree


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The reference's weights and FUSED_STEPS batches of each case
    (``in_<i>.npz``), and the 8 ranks started on them."""
    d = tmp_path_factory.mktemp("partitioned_fused")
    for i in range(len(FUSED_CASES)):
        jcfg, _ = _jcfg(i)
        jp = jax.tree.map(np.asarray, JM.init(jcfg, jax.random.PRNGKey(0)))
        extra = {}
        for j in range(FUSED_STEPS):
            b = jconcrete_batch(jcfg, PART_B, _seq(i),
                                jax.random.PRNGKey(3 + j))
            for k, v in b.items():
                extra[f"batch{j}_{k}"] = np.asarray(
                    v, np.float32 if k == "patches" else None)
        np.savez(d / f"in_{i}.npz", **_flat(jp), **extra)
    return d, start_ranks(fused_partitioned_run, 8, str(d))


def _inputs(d, i):
    """(reference params (numpy tree), the batches)."""
    raw = dict(np.load(d / f"in_{i}.npz"))
    batches = fused_mesh_batches(raw)
    return _unflat(raw), batches


def _out(d, i, kind):
    """(rank 0's results, every rank's log)."""
    out = dict(np.load(d / f"out_{i}_{kind}.npz"))
    logs = [json.loads((d / f"log_{i}_{kind}_{r}.json").read_text())
            for r in range(8)]
    return out, logs


def _sub(out, top):
    return {k[len(f"leaf:{top}/"):]: torch.from_numpy(v)
            for k, v in out.items() if k.startswith(f"leaf:{top}/")}


@pytest.fixture(scope="module")
def one_rank(inputs):
    """Per run: the port's one-rank fused steps ((params, state, losses,
    nonfinite)) and the reference's ((params, state, losses)), from the
    same weights and batches, made while the ranks run."""
    d, _ = inputs
    got = {}
    for i, kind in RUNS:
        jtree, batches = _inputs(d, i)
        jcfg, tcfg = _jcfg(i)
        opt, jopt = fused_mesh_opt(kind), _jopt(kind)
        assert jeligible(jcfg, jopt)[0]
        p = from_jax_params(jtree)
        s = opt.init(p)
        step = steps.make_train_step(tcfg, opt)
        losses, nonfinite = [], []
        for j, b in enumerate(batches):
            p, s, m = step(p, s, b, j)
            losses.append(float(m["loss"]))
            nonfinite.append(float(m["nonfinite"]))
        jstep = jmake_train_step(jcfg, jopt, 1, donate=False)
        jp, js, jl = jtree, jopt.init(jtree), []
        for j, b in enumerate(batches):
            jp, js, jm = jstep(jp, js, {k: jnp.asarray(v)
                                        for k, v in b.items()},
                               jnp.asarray(j))
            jl.append(float(jm["loss"]))
        got[(i, kind)] = (
            (p, s, losses, nonfinite),
            (from_jax_params(jax.tree.map(np.asarray, jp)),
             from_jax_opt_state(jax.tree.map(np.asarray, js)), jl))
    return got


@pytest.fixture(scope="module")
def runs(inputs, one_rank):
    """The directory of the 8 ranks' results, once they have ended."""
    d, ctx = inputs
    join_ranks(ctx)
    return d


def _noise_slack(got_m, want_m, lr):
    """``noise_slack``'s 2 lr for each of the FUSED_STEPS steps: an Adam
    element whose m sits at the summation-order noise floor may move by
    2 lr a step either way."""
    return {k: FUSED_STEPS * v
            for k, v in noise_slack(got_m, want_m, lr).items()}


# ------------------------------------------------------------ the route
@pytest.mark.parametrize("arch,fused_route", [
    ("stablelm-3b", True), ("qwen2-72b", True),
    ("llava-next-mistral-7b", True), ("falcon-mamba-7b", True),
    ("qwen3-moe-30b-a3b", True), ("deepseek-v2-lite-16b", True),
    ("whisper-base", True)])
def test_fused_step_route_by_family(arch, fused_route):
    cfg = dataclasses.replace(
        treg.get(arch).reduced().with_sparsity(
            SparsityConfig(density=0.5, block=32, where="ffn")),
        dtype="float32", param_dtype="float32", fused_update=True)
    for kind in FUSED_OPTS:
        opt = fused_mesh_opt(kind)
        assert steps.fused_update_eligible(cfg, opt)[0]
        assert steps.partitioned(cfg, opt) == fused_route
        assert steps.partitioned(cfg, opt, 2) == fused_route
    two_pass = adam(constant_schedule(1e-3))
    assert steps.partitioned(cfg, two_pass)
    assert steps.partitioned(cfg)


def test_hybrid_is_never_fused():
    cfg = dataclasses.replace(
        treg.get("zamba2-2.7b").reduced().with_sparsity(
            SparsityConfig(density=0.5, block=32, where="ffn")),
        dtype="float32", param_dtype="float32", fused_update=True)
    opt = fused_mesh_opt("sgd_momentum")
    assert not steps.fused_update_eligible(cfg, opt)[0]
    assert steps.partitioned(cfg, opt)      # its two-pass step


@pytest.mark.parametrize("what", ["outside_the_route", "quantized_experts"])
def test_partitioned_fused_step_refuses_what_it_cannot_serve(what):
    """The partitioned fused step refuses a config outside the route's
    (a dense model on the "sp" strategy), and a fused step's quantized
    expert pair raises on the route."""
    arch = "stablelm-3b" if what == "outside_the_route" else \
        "qwen3-moe-30b-a3b"
    cfg = dataclasses.replace(
        treg.get(arch).reduced().with_sparsity(
            SparsityConfig(density=0.5, block=32, where="ffn")),
        dtype="float32", param_dtype="float32", fused_update=True)
    mesh = AbstractMesh(MESH, ("data", "model"))
    if what == "outside_the_route":
        cfg = dataclasses.replace(cfg, strategy="sp")
        assert not steps.partitioned(cfg, fused_mesh_opt("adam_clip"))
        part = partition.Partition(cfg, partition.ReckonedComm(mesh), {})
        with pytest.raises(ValueError, match="gathered"):
            steps.make_partitioned_train_step(
                cfg, fused_mesh_opt("adam_clip"), part)
        return
    params = TM.init(cfg, 0, "meta")
    specs = sh.param_specs(cfg, params, mesh)
    part = partition.Partition(cfg, partition.ReckonedComm(mesh), specs)
    opt = fused_mesh_opt("sgd_momentum")
    aug = sl.inject_update_ctx(params, opt.slots(opt.init(params)),
                               opt.hyp(0))
    moe = dict(aug["layers"][0]["moe"])
    moe["wgq"] = moe.pop("wg").to(torch.int8)
    with pytest.raises(ValueError, match="inference only"):
        part.gather(moe, specs["layers"][0]["moe"])


def test_stablelm_case_has_col_and_rep_junctions():
    cfg = fused_mesh_case(*FUSED_CASES[0])
    params = TM.init(cfg, 0, "meta")
    specs = sh.param_specs(cfg, params, AbstractMesh(MESH,
                                                     ("data", "model")))
    mlp = specs["layers"][0]["mlp"]
    assert {k: partition.tp_kind(mlp[k]["w"]) for k in mlp} == {
        "wg": "col", "wi": "col", "wo": "rep"}


# ------------------------------------------------------------ 8 ranks
@pytest.mark.parametrize("i,kind", RUNS, ids=IDS)
def test_fused_steps_match_one_rank_and_reference(i, kind, runs, one_rank):
    out, _ = _out(runs, i, kind)
    opt = fused_mesh_opt(kind)
    losses = out["losses"].tolist()
    got_p = _sub(out, "params")
    slots = {k: _sub(out, k) for k in opt.slot_keys()}
    for p, s, want_losses, *_ in one_rank[(i, kind)]:
        np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
        slack = None
        for k in opt.slot_keys():
            want_s = {n: v.float() for n, v in tree_items(s[k])}
            close_trees(slots[k], want_s, **TREE_TOL)
            if k == "m":
                slack = _noise_slack(slots[k], want_s, 1e-3)
        close_trees(got_p, {n: v.float() for n, v in tree_items(p)},
                    slack=slack, **TREE_TOL)


@pytest.mark.parametrize("i,kind", RUNS, ids=IDS)
def test_nonfinite_equals_one_rank(i, kind, runs, one_rank):
    out, logs = _out(runs, i, kind)
    want = one_rank[(i, kind)][0][3]
    assert out["nonfinite"].tolist() == want == [0.0] * FUSED_STEPS
    for log in logs:
        assert log["nonfinite"] == want


@pytest.mark.parametrize("i,kind", RUNS, ids=IDS)
def test_each_rank_holds_only_its_shards_at_rest(i, kind, runs):
    _, logs = _out(runs, i, kind)
    for log in logs:
        assert log["at_rest"] == [True] * FUSED_STEPS
        assert log["after"] == log["held"]


@pytest.mark.parametrize("i,kind", RUNS, ids=IDS)
def test_each_rank_gathers_one_unit_at_a_time(i, kind, runs):
    """The largest unit's leaves, and of the fused junctions' slots no
    more than one unit's, gathered at once; a fused junction's weight and
    slots gathered (forward, recomputation, backward), none alive after
    the step."""
    _, logs = _out(runs, i, kind)
    for log in logs:
        assert log["gathers"] > 0 and log["dtensor"] == [], log
        assert log["largest"] <= log["budget"], log
        assert log["peak"] <= log["budget"] + log["unit_slots"], log
        assert log["junction_gathers"] > 0, log
        assert log["junction_peak"] <= log["junction_budget"], log
        assert log["junction_left"] == 0, log


@pytest.mark.parametrize("i,kind", RUNS, ids=IDS)
def test_collectives_equal_reckoning(i, kind, runs):
    _, logs = _out(runs, i, kind)
    cfg = fused_mesh_case(*FUSED_CASES[i])
    rl, held = dryrun.count_cell(
        cfg, ShapeSpec("mesh", _seq(i), PART_B, "train"),
        AbstractMesh(MESH, ("data", "model")),
        optimizer=fused_mesh_opt(kind))
    want = {k: [v["bytes"], v["count"]] for k, v in rl.coll_detail.items()}
    assert {"all-gather", "all-reduce", "reduce-scatter"} <= set(want)
    for r, log in enumerate(logs):
        assert log["coll"] == want, r
        assert log["dot_flops"] == rl.dot_flops, r
        assert log["held"] == held, r
