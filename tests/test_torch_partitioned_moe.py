"""The MoE family's partitioned mesh steps (``models/moe.moe_apply_tp``:
the experts over "model", routing global over the batch rows; MLA's
``attention.mla_forward_tp`` / ``mla_decode_tp`` on the rank's heads and
its sequence shard of the latent cache) against one rank, the JAX
reference, the dry run's count and the reference's own partitioned
module, on the CPU.

* 8 gloo ranks on a 2 x 4 (data x model) mesh run ``MOE_CASES``, each
  in fp32 and (but the last) bf16 compute, from the reference's carried
  weights, FFN density 0.5 at block 32: reduced qwen3-moe (8 experts
  top-2, 2 a model rank; its 2 kv heads replicated), the same with 6
  experts, which the 4-wide model axis does not divide (the router and
  experts replicated, every rank computing them all), reduced
  deepseek-v2-lite (MLA with its 4 heads split, its dense first layer,
  shared experts), and qwen3-moe with a dispatch group of 128 tokens,
  which spans both data ranks' rows of a 4 x 32 batch, at capacity
  factor 0.5, so that choices are dropped (asserted).  The decode steps'
  4 tokens make one group of 4, which spans the data ranks in every
  case.
  - one two-pass Adam step (lr 1e-3, clip 1.0) of 4 x 32 against the
    one-rank step and the reference's single-device step: bf16 compute
    to the reference's own bounds (loss and aux 2e-3, params 5e-3), fp32
    to rtol 5e-4 / atol 5e-5 with tests/test_torch_moe.py's noise-floor
    slack of Adam's first step, the loss and the aux loss to 1e-5;
  - a prefill of 27 prompt tokens (padded to 32) and 4 greedy decode
    steps: the logits against the one-rank steps fed the mesh's tokens
    (fp32 rtol 5e-4 / atol 5e-5; bf16 2^-5, and from the reference no
    further than the one-rank port's bf16 logits lie from it plus 2^-5),
    greedy tokens equal;
  - each rank's dispatch positions and keep, for its tokens and its
    experts, in every MoE layer of the train step's forward, the prefill
    and each decode step, equal the one-rank step's bit for bit;
  - the spanning case's gathered route (``make_gathered_mesh_train_step``,
    each rank routing its own rows) gives a loss and an aux loss outside
    the fp32 bounds: the fault this route repairs;
  - the spanning case at 2 microbatches (each rank's share of each
    microbatch, one group of 64 tokens across the data ranks) against
    the one-rank and the reference's steps at 2 microbatches, as above;
  - what each rank gathers: no more than one unit at a time (a layer,
    the embedding's tok, its out, the final norm), no DTensor gathered
    or redistributed during the steps (no optimizer-state or cache
    leaf), each rank's cache its [L, B/2, S/4, ...] shard (MLA: latent
    [L, 2, 8, 32], k_rope [L, 2, 8, 16]);
  - the train step's and the first decode step's dot FLOPs, collectives
    by kind and held bytes equal ``launch/dryrun.count_cell`` on
    ``AbstractMesh((2, 4))`` exactly.
* A MoE dict's pattern leaves stay whole under
  ``sharding.with_junction_views`` (experts split on E, not on output
  blocks); the shared experts' junctions take the rank's views.
* The reference's ``launch/dryrun.lower_cell`` for the train step (8 x
  64) on a 2 x 4 mesh of forced host devices of reduced qwen3-moe at 2
  kv heads (``wk`` / ``wv`` replicated: the reference's partitioner
  projects k and v on each rank's sequence shard and gathers them, as
  the port's route does) and at 4 (split over "model"), and of reduced
  deepseek-v2-lite (its replicated ``wkv_a`` and ``kv_norm`` run on the
  rank's positions and the latent is gathered; its dense first layer
  is not recomputed in the backward, as the reference's is not): its
  per-device dot FLOPs agree with the port's count within 2 %, and the
  gathered route's count lies outside it.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.launch.specs import concrete_batch as jconcrete_batch
from repro.models import model as JM
from repro.optim import adam as jadam
from repro.optim import constant_schedule as jconstant
from repro.train.steps import make_decode_step as jmake_decode_step
from repro.train.steps import make_prefill_step as jmake_prefill_step
from repro.train.steps import make_train_step as jmake_train_step

from repro_torch.configs import registry as treg
from repro_torch.configs.base import ShapeSpec
from repro_torch.convert import from_jax_opt_state, from_jax_params
from repro_torch.launch import dryrun
from repro_torch.launch import specs as tspecs
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import model as TM
from repro_torch.optim import adam, constant_schedule
from repro_torch.parallel import sharding as sh
from repro_torch.roofline import analysis
from repro_torch.train import steps
from repro_torch.tree import tree_items
from torch_mesh_workers import MOE_CASES, PART_B, PART_DECODE, \
    PART_PROMPT, PART_S, SPANNING, RouteLog, moe_case, \
    moe_partitioned_run, run_ranks
from torch_parity_helpers import close_trees, noise_slack, \
    reference_variant

ROOT = Path(__file__).resolve().parents[1]
TREE_TOL = dict(rtol=5e-4, atol=5e-5)
BF16_LOGITS = 2 ** -5
BF16_LOSS = 2e-3
LR = 1e-3
MESH = (2, 4)
IDS = ["-".join([a, d] + [f"{k}{v}" for k, v in c.items()])
       for a, d, c in MOE_CASES]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jcfg(i):
    arch, dtype, changes = MOE_CASES[i]
    tcfg = moe_case(*MOE_CASES[i])
    jcfg = reference_variant(jreg.get(arch).reduced(), tcfg)
    return dataclasses.replace(jcfg, dtype=dtype, moe=dataclasses.replace(
        jcfg.moe, **changes)), tcfg


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        elif isinstance(v, list):
            out.update(_flat(dict(enumerate(v)), f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's weights and batch of each case (``in_<i>.npz``),
    then the 8 ranks."""
    d = tmp_path_factory.mktemp("partitioned_moe")
    for i in range(len(MOE_CASES)):
        jcfg, _ = _jcfg(i)
        jp = jax.tree.map(np.asarray, JM.init(jcfg, jax.random.PRNGKey(0)))
        tok = np.asarray(jconcrete_batch(jcfg, PART_B, PART_S,
                                         jax.random.PRNGKey(3))["tokens"])
        np.savez(d / f"in_{i}.npz", **_flat(jp), batch_tokens=tok)
    run_ranks(moe_partitioned_run, 8, str(d))
    return d


def _case(d, i):
    """(reference params (numpy tree), tokens, the port's carried
    params, rank 0's results, every rank's log)."""
    raw = dict(np.load(d / f"in_{i}.npz"))
    tokens = raw.pop("batch_tokens")
    tree = {}
    for k, v in raw.items():
        node = tree
        *head, last = k.split(".")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    out = dict(np.load(d / f"out_{i}.npz"))
    logs = [json.loads((d / f"log_{i}_{r}.json").read_text())
            for r in range(8)]
    return tree, tokens, from_jax_params(tree), out, logs


def _sub(out, top):
    return {k[len(f"leaf:{top}/"):]: torch.from_numpy(v)
            for k, v in out.items() if k.startswith(f"leaf:{top}/")}


@pytest.fixture(scope="module")
def one_rank(runs):
    """Per case: the one-rank train step's (params, Adam state, metrics),
    and its routing ([pos, keep] of each MoE layer call: the train
    step's forward, then the prefill and the decode steps fed the mesh's
    greedy tokens) with the serving logits."""
    out = {}
    for i in range(len(MOE_CASES)):
        _, tokens, params, got, _ = _case(runs, i)
        cfg = moe_case(*MOE_CASES[i])
        with RouteLog() as log:
            opt = adam(constant_schedule(LR), grad_clip=1.0)
            p1, s1, m1 = steps.make_train_step(cfg, opt)(
                params, opt.init(params), {"tokens": tokens}, 0)
            n_moe = cfg.n_layers - cfg.moe.first_dense_layers
            routes = {"train": log.calls[:n_moe]}
            log.calls = []
            logits = _serve(cfg, params, tokens, got["tokens"])
            routes["serve"] = log.calls
        out[i] = (p1, s1, m1, routes, logits)
    return out


def _serve(cfg, params, tokens, picks):
    """The one-rank prefill and decode steps on the mesh's inputs, fed
    the mesh's greedy picks: logits [1 + PART_DECODE, B, 1, V]."""
    prompt = tokens.copy()
    prompt[:, PART_PROMPT:] = 0
    toks = [tokens[:, PART_PROMPT:PART_PROMPT + 1]] + [
        picks[:, t:t + 1] for t in range(PART_DECODE - 1)]
    lg, cache, _ = steps.make_prefill_step(cfg)(
        params, {"tokens": torch.as_tensor(prompt)})
    decode = steps.make_decode_step(cfg)
    logits = [lg]
    for t, tok in enumerate(toks):
        lg, cache = decode(params, cache, torch.as_tensor(tok),
                           PART_PROMPT + t)
        logits.append(lg)
    return torch.stack(logits).float().numpy()


def _serve_reference(jcfg, jtree, tokens, picks):
    prompt = tokens.copy()
    prompt[:, PART_PROMPT:] = 0
    toks = [tokens[:, PART_PROMPT:PART_PROMPT + 1]] + [
        picks[:, t:t + 1] for t in range(PART_DECODE - 1)]
    lg, cache = jax.jit(jmake_prefill_step(jcfg))(
        jtree, {"tokens": jnp.asarray(prompt)})
    decode = jax.jit(jmake_decode_step(jcfg))
    logits = [lg]
    for t, tok in enumerate(toks):
        lg, cache = decode(jtree, cache, jnp.asarray(tok),
                           jnp.asarray(PART_PROMPT + t))
        logits.append(lg)
    return np.stack([np.asarray(x, np.float32) for x in logits])


@pytest.mark.parametrize("i", range(len(MOE_CASES)), ids=IDS)
def test_train_step_matches_one_rank_and_reference(i, runs, one_rank):
    jtree, tokens, _, out, _ = _case(runs, i)
    jcfg, tcfg = _jcfg(i)
    p1, s1, m1, _, _ = one_rank[i]
    jopt = jadam(jconstant(LR), grad_clip=1.0)
    jp, js, jm = jax.jit(jmake_train_step(jcfg, jopt, jit=False))(
        jtree, jopt.init(jtree), {"tokens": tokens}, jnp.asarray(0))
    jp = from_jax_params(jax.tree.map(np.asarray, jp))
    jmom = from_jax_opt_state(jax.tree.map(np.asarray, js))["m"]
    got_p, got_m = _sub(out, "params"), _sub(out, "m")
    loss, aux = float(out["loss"]), float(out["aux"])
    assert aux > 0
    if tcfg.dtype == "bfloat16":
        # the reference's own bounds against one rank; against the
        # reference no further than the one-rank port lies from it plus
        # those bounds (the triangle inequality: the partitioned route
        # rounds in bf16 on its own, and bf16 routing flips between the
        # two packages, tests/test_torch_moe.py)
        assert abs(loss - float(m1["loss"])) < BF16_LOSS
        assert abs(aux - float(m1["aux"])) < BF16_LOSS
        close_trees(got_p, {k: v.float() for k, v in tree_items(p1)},
                    rtol=0.0, atol=5e-3)
        for key, v in (("loss", loss), ("aux", aux)):
            gap = abs(v - float(jm[key]))
            assert gap <= abs(float(m1[key]) - float(jm[key])) + BF16_LOSS, \
                (key, gap)
        one = dict(tree_items(p1))
        for k, w in tree_items(jp):
            gap = (got_p[k].float() - w.float()).abs().max()
            assert gap <= (one[k].float() - w.float()).abs().max() + 5e-3, k
        return
    for want in (m1, jm):
        assert loss == pytest.approx(float(want["loss"]), rel=1e-5)
        assert aux == pytest.approx(float(want["aux"]), rel=1e-5)
    for want_p, want_m in ((p1, s1["m"]), (jp, jmom)):
        want_m = dict(tree_items(want_m))
        close_trees(got_m, want_m, **TREE_TOL)
        slack = noise_slack(got_m, want_m, LR)
        close_trees(got_p, dict(tree_items(want_p)), slack=slack,
                    **TREE_TOL)


@pytest.mark.parametrize("i", range(len(MOE_CASES)), ids=IDS)
def test_prefill_and_decode_match_one_rank_and_reference(i, runs, one_rank):
    jtree, tokens, _, out, logs = _case(runs, i)
    jcfg, tcfg = _jcfg(i)
    got, picks = out["logits"], out["tokens"]
    assert picks.shape == (PART_B, PART_DECODE)
    one = one_rank[i][4]
    ref = _serve_reference(jcfg, jtree, tokens, picks)
    assert np.array_equal(picks, one[1:].argmax(-1)[..., 0].T)
    if tcfg.dtype == "float32":
        np.testing.assert_allclose(got, one, **TREE_TOL)
        np.testing.assert_allclose(got, ref, **TREE_TOL)
    else:
        np.testing.assert_allclose(got, one, rtol=0.0, atol=BF16_LOGITS)
        gap = np.abs(got - ref).max()
        assert gap <= np.abs(one - ref).max() + BF16_LOGITS, gap
    L, B, S = tcfg.n_layers, PART_B // MESH[0], PART_S // MESH[1]
    if tcfg.attn_kind == "mla":
        m, nd = tcfg.mla, tcfg.moe.first_dense_layers
        want = {f"{part}/{k}": [n, B, S, w] for part, n in
                (("dense", nd), ("moe", L - nd))
                for k, w in (("latent", m.kv_lora_rank),
                             ("k_rope", m.qk_rope_head_dim))}
    else:
        want = {k: [L, B, S, tcfg.kv_heads, tcfg.head_dim]
                for k in ("k", "v")}
    for log in logs:
        assert log["serve"]["cache_local"] == want


@pytest.mark.parametrize("i", range(len(MOE_CASES)), ids=IDS)
def test_routing_equals_one_rank_bit_for_bit(i, runs, one_rank):
    """Each rank's [pos, keep] of its tokens and experts against the
    one-rank step's rows of its data rank and columns of its model
    rank."""
    routes = one_rank[i][3]
    E = moe_case(*MOE_CASES[i]).moe.num_experts
    for r in range(8):
        dr, mr = divmod(r, MESH[1])
        got = dict(np.load(runs / f"route_{i}_{r}.npz"))
        for kind, want_calls in routes.items():
            assert len(want_calls) == sum(k.startswith(kind) for k in got)
            for j, want in enumerate(want_calls):
                mine = got[f"{kind}_{j}"]
                T, El = mine.shape[1], mine.shape[3]
                e0 = mr * El if El < E else 0
                rows = want[:, dr * T:(dr + 1) * T, :, e0:e0 + El]
                assert np.array_equal(mine, rows), (kind, j, r)
    if i == SPANNING:             # choices are dropped
        pos, keep = routes["train"][0]
        assert keep.sum() < (pos >= 0).sum() / E


@pytest.mark.parametrize("i", range(len(MOE_CASES)), ids=IDS)
def test_each_rank_gathers_one_unit_at_a_time(i, runs):
    *_, logs = _case(runs, i)
    for log in logs:
        for kind in ("train", "serve"):
            g = log[kind]
            assert g["gathers"] > 0 and g["dtensor"] == [], (kind, g)
            assert g["largest"] <= g["budget"], (kind, g)
            assert g["peak"] <= g["budget"], (kind, g)


@pytest.mark.parametrize("i", range(len(MOE_CASES)), ids=IDS)
def test_counts_equal_dryrun_reckoning(i, runs):
    *_, logs = _case(runs, i)
    cfg = moe_case(*MOE_CASES[i])
    assert dryrun.execution(cfg) == "partitioned"
    mesh = AbstractMesh(MESH, ("data", "model"))
    for kind, key in (("train", "train"), ("decode", "decode")):
        rl, held = dryrun.count_cell(
            cfg, ShapeSpec("mesh", PART_S, PART_B, kind), mesh)
        for log in logs:
            t = log[key]
            assert t["dot_flops"] == rl.dot_flops, kind
            assert t["coll"] == {k: [v["bytes"], v["count"]]
                                 for k, v in rl.coll_detail.items()}, kind
            assert t["held"] == held, kind
            if kind == "train":
                assert t["after"] == held
        assert {"all-gather", "all-reduce"} <= set(logs[0][key]["coll"])


def test_gathered_route_routes_each_rank_alone(runs, one_rank):
    """The fault: on the spanning case each rank of the gathered route
    routes its own 64 tokens as a group of 64 with capacity 8, where the
    reference routes 128 with capacity 16, so its loss and aux loss lie
    outside the bounds the partitioned route holds."""
    out = dict(np.load(runs / f"out_{SPANNING}.npz"))
    m1 = one_rank[SPANNING][2]
    want_loss, want_aux = float(m1["loss"]), float(m1["aux"])
    assert float(out["aux"]) == pytest.approx(want_aux, rel=1e-5)
    assert abs(float(out["gathered_aux"]) / want_aux - 1) > 1e-3
    assert abs(float(out["gathered_loss"]) / want_loss - 1) > 1e-5


def test_microbatches_route_as_the_reference(runs):
    """The spanning case at 2 microbatches: each rank takes its rows of
    each microbatch, so a microbatch's 64 tokens make one group that
    spans the data ranks, as the reference's microbatch of 2 rows does;
    against the one-rank step and the reference's at 2 microbatches."""
    jtree, tokens, params, out, _ = _case(runs, SPANNING)
    jcfg, tcfg = _jcfg(SPANNING)
    opt = adam(constant_schedule(LR), grad_clip=1.0)
    p1, _, m1 = steps.make_train_step(tcfg, opt, 2)(
        params, opt.init(params), {"tokens": tokens}, 0)
    jopt = jadam(jconstant(LR), grad_clip=1.0)
    jp, _, jm = jax.jit(jmake_train_step(jcfg, jopt, 2, jit=False))(
        jtree, jopt.init(jtree), {"tokens": tokens}, jnp.asarray(0))
    jp = from_jax_params(jax.tree.map(np.asarray, jp))
    got = {k[5:]: torch.from_numpy(v) for k, v in
           np.load(runs / "mb2.npz").items() if k.startswith("leaf:")}
    for want, want_p in ((m1, p1), (jm, jp)):
        assert float(out["mb2_loss"]) == pytest.approx(float(want["loss"]),
                                                       rel=1e-5)
        assert float(out["mb2_aux"]) == pytest.approx(float(want["aux"]),
                                                      rel=1e-5)
        # Adam's first step: the noise-floor slack (m not saved here:
        # every element may take it, one in 10^4 at most)
        slack = {k: 2 * LR * (1 + 1e-5) for k, v in got.items()
                 if v.is_floating_point()}
        close_trees(got, dict(tree_items(want_p)), slack=slack, **TREE_TOL)
    assert float(out["mb2_aux"]) != pytest.approx(float(out["aux"]),
                                                  rel=1e-5)


def test_junction_views_leave_expert_patterns_whole():
    cfg = moe_case(*MOE_CASES[4])
    params = TM.init(cfg, 0, "cpu")
    mesh = AbstractMesh(MESH, ("data", "model"))
    specs = sh.param_specs(cfg, params, mesh)
    local = sh.with_junction_views(params, specs, mesh, 1)
    moe = local["layers"][0]["moe"]
    for k in ("idx_in", "idx_out", "rev_in_ob", "rev_out_cnt"):
        assert moe[k] is params["layers"][0]["moe"][k]
    assert sh.spec_axes(specs["layers"][0]["moe"]["wg"][0]) == ("model",)
    mlp = local["dense_layers"][0]["mlp"]["wi"]
    full = params["dense_layers"][0]["mlp"]["wi"]["idx"]
    assert mlp["idx"].shape[0] == full.shape[0] // MESH[1]


# -------------------------------------- the reference's partitioned module
_REFERENCE_COUNT = """
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, {src!r})
import jax
jax.devices()          # 8 devices, before launch/dryrun's import sets 512
from repro.configs import registry
from repro.configs.base import ShapeSpec
from repro.launch import dryrun as D
from repro.launch.mesh import compat_mesh
from repro.parallel import hints
from repro.roofline import hlo as H
cfg = dataclasses.replace(registry.get({arch!r}).reduced(), **{changes!r})
mesh = compat_mesh((2, 4), ("data", "model"), devices=jax.devices()[:8])
with mesh, hints.use_mesh_hints(mesh):
    c = D.lower_cell(cfg, ShapeSpec("mesh", {seq}, {batch}, "train"),
                     mesh).compile()
print(json.dumps({{"dot_flops": H.analyze(c.as_text()).dot_flops}}))
"""
XLA_SEQ, XLA_BATCH, XLA_TOL = 64, 8, 0.02
XLA_CASES = [("qwen3-moe-30b-a3b", {"kv_heads": 2}),
             ("qwen3-moe-30b-a3b", {"kv_heads": 4}),
             ("deepseek-v2-lite-16b", {})]


@pytest.mark.parametrize("arch,changes", XLA_CASES, ids=[
    "-".join([a] + [f"{k}{v}" for k, v in c.items()]) for a, c in XLA_CASES])
def test_dot_flops_agree_with_reference_partitioned_module(arch, changes):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    run = subprocess.run(
        [sys.executable, "-c", _REFERENCE_COUNT.format(
            src=str(ROOT / "src"), arch=arch, changes=changes, seq=XLA_SEQ,
            batch=XLA_BATCH)],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    ref = json.loads(run.stdout.strip().splitlines()[-1])["dot_flops"]
    cfg = dataclasses.replace(treg.get(arch).reduced(), **changes)
    shape = ShapeSpec("mesh", XLA_SEQ, XLA_BATCH, "train")
    rl, _ = dryrun.count_cell(cfg, shape, AbstractMesh(MESH,
                                                       ("data", "model")))
    assert abs(rl.dot_flops / ref - 1) <= XLA_TOL, (rl.dot_flops, ref)
    # the gathered route: the whole model on the rank's rows
    params = TM.init(cfg, 0, "meta")
    opt = adam(constant_schedule(1e-4))
    rows = dryrun._meta_rows(tspecs.batch_struct(cfg, shape), 2)
    gathered = analysis.analyze(steps.make_train_step(cfg, opt), params,
                                opt.init(params), rows, 0).dot_flops
    assert abs(gathered / ref - 1) > XLA_TOL, (gathered, ref)
