"""The vlm family's partitioned mesh steps (llava: its patches ahead of
the text in the embedding's partial sums, attention under the sliding
window on the rank's heads, the prefill's ring of window slots split
over "model" and decoded on the rank's slots) against one rank, the JAX
reference, the dry run's count and the reference's own partitioned
module, on the CPU.

* 8 gloo ranks on a 2 x 4 (data x model) mesh run ``VLM_CASES``, each in
  fp32 and bf16 compute, from the reference's carried weights and batch,
  FFN density 0.5 at block 32: reduced llava at a window of 12, its 8
  patches ahead of 28 tokens (36 positions, 9 a model rank), with 2 kv
  heads (replicated over "model": k / v projected on the rank's
  positions and all-gathered) and with 4 (one a model rank).
  - one two-pass Adam step (lr 1e-3, clip 1.0) of 4 x 36 against the
    one-rank step and the reference's single-device step: fp32 loss to
    1e-5 and params / Adam's m to rtol 5e-4 / atol 5e-5 with
    tests/test_torch_moe.py's noise-floor slack of Adam's first step;
    bf16 to the reference's own bounds against one rank (loss 2e-3,
    params 5e-3) and from the reference no further than one rank lies
    from it plus those bounds;
  - a prefill of the whole batch, whose ring of 12 slots keeps the last
    12 of its 36 positions (position p at slot p % 12), and 4 greedy
    decode steps from position 36, the first of which wraps the ring
    again (slot 0, on model rank 0; the fourth writes slot 3, on rank
    1): the logits against the one-rank steps and against the
    reference's prefill and decode steps on the same ring, fed the
    mesh's tokens (fp32 rtol 5e-4 / atol 5e-5; bf16 2^-5 from one rank,
    and from the reference no further than one rank plus 2^-5), greedy
    tokens equal;
  - each rank's ring after the prefill is its rows and slots of the
    one-rank ring ([L, B/2, 3, Hkv, hd]: slots 3r to 3r + 2), to the
    logits' bounds;
  - no more than one unit gathered at a time (a layer, the embedding's
    tok, its out, the final norm), no DTensor gathered or redistributed
    during the steps;
  - the train step's and the first decode step's dot FLOPs, collectives
    and held bytes on every rank equal ``launch/dryrun.count_cell`` on
    ``AbstractMesh((2, 4))`` exactly.
* The reference's ``launch/dryrun.lower_cell`` for reduced llava's train
  step (8 x 64: 8 patches, 56 tokens) on a 2 x 4 mesh of forced host
  devices, at 2 and at 4 kv heads: its per-device dot FLOPs agree with
  the port's count within 2 %, and the gathered route's count lies
  outside it.
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
from repro_torch.roofline import analysis
from repro_torch.train import steps
from repro_torch.tree import tree_items
from torch_mesh_workers import PART_B, PART_DECODE, VLM_CASES, VLM_S, \
    VLM_WINDOW, run_ranks, ssm_case, vlm_partitioned_run
from torch_parity_helpers import close_trees, noise_slack, \
    reference_variant

ROOT = Path(__file__).resolve().parents[1]
TREE_TOL = dict(rtol=5e-4, atol=5e-5)
BF16_LOGITS = 2 ** -5
BF16_LOSS = 2e-3
LR = 1e-3
MESH = (2, 4)
IDS = ["-".join([a, d] + [f"{k}{v}" for k, v in c.items()])
       for a, d, c in VLM_CASES]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jcfg(i):
    arch, dtype, changes = VLM_CASES[i]
    tcfg = ssm_case(*VLM_CASES[i])
    jcfg = reference_variant(jreg.get(arch).reduced(), tcfg)
    return dataclasses.replace(jcfg, dtype=dtype, **changes), tcfg


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's weights and batch of each case (``in_<i>.npz``),
    then the 8 ranks."""
    d = tmp_path_factory.mktemp("partitioned_vlm")
    for i in range(len(VLM_CASES)):
        jcfg, _ = _jcfg(i)
        jp = jax.tree.map(np.asarray, JM.init(jcfg, jax.random.PRNGKey(0)))
        b = jconcrete_batch(jcfg, PART_B, VLM_S, jax.random.PRNGKey(3))
        np.savez(d / f"in_{i}.npz", **_flat(jp),
                 batch_tokens=np.asarray(b["tokens"]),
                 batch_patches=np.asarray(b["patches"], np.float32))
    run_ranks(vlm_partitioned_run, 8, str(d))
    return d


def _case(d, i):
    """(reference params (numpy tree), batch, the port's carried params,
    rank 0's results, every rank's log)."""
    raw = dict(np.load(d / f"in_{i}.npz"))
    batch = {"tokens": raw.pop("batch_tokens"),
             "patches": raw.pop("batch_patches")}
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
    return tree, batch, from_jax_params(tree), out, logs


def _sub(out, top):
    return {k[len(f"leaf:{top}/"):]: torch.from_numpy(v)
            for k, v in out.items() if k.startswith(f"leaf:{top}/")}


def _ring_slots(S, W):
    """The position each slot of a ring of W slots holds after a prefill
    of S positions: the last W, position p at slot p % W."""
    slots = np.arange(W)
    return S - W + (slots - (S - W)) % W


@pytest.fixture(scope="module")
def one_rank(runs):
    """Per case: the one-rank train step's (params, Adam state, metrics),
    the one-rank prefill's ring (the prefill's cache placed in a ring of
    VLM_WINDOW slots) and the logits [1 + PART_DECODE, B, 1, V] of the
    prefill and the decode steps, fed the mesh's tokens."""
    out = {}
    for i in range(len(VLM_CASES)):
        _, batch, params, got, _ = _case(runs, i)
        cfg = ssm_case(*VLM_CASES[i])
        opt = adam(constant_schedule(LR), grad_clip=1.0)
        p1, s1, m1 = steps.make_train_step(cfg, opt)(
            params, opt.init(params), batch, 0)
        lg, cache, npos = steps.make_prefill_step(cfg)(params, batch)
        assert npos == VLM_S
        pos = torch.as_tensor(_ring_slots(npos, cfg.window))
        ring = {k: v.index_select(2, pos) for k, v in cache.items()}
        first = {k: v.clone() for k, v in ring.items()}
        decode = steps.make_decode_step(cfg)
        logits = [lg]
        for t in range(PART_DECODE):
            tok = torch.as_tensor(got["tokens"][:, t:t + 1])
            lg, ring = decode(params, ring, tok, npos + t)
            logits.append(lg)
        out[i] = (p1, s1, m1, first, torch.stack(logits).float().numpy())
    return out


def _serve_reference(jcfg, jtree, batch, fed):
    """The reference's prefill, its cache placed in the ring as the port
    places it, and its decode steps fed ``fed``."""
    lg, cache = jax.jit(jmake_prefill_step(jcfg))(
        jtree, {k: jnp.asarray(v) for k, v in batch.items()})
    pos = jnp.asarray(_ring_slots(VLM_S, jcfg.window))
    ring = {k: jnp.take(v, pos, axis=2) for k, v in cache.items()}
    decode = jax.jit(jmake_decode_step(jcfg))
    logits = [lg]
    for t in range(PART_DECODE):
        lg, ring = decode(jtree, ring, jnp.asarray(fed[:, t:t + 1]),
                          jnp.asarray(VLM_S + t))
        logits.append(lg)
    return np.stack([np.asarray(x, np.float32) for x in logits])


def test_llava_takes_the_partitioned_route():
    cfg = treg.get("llava-next-mistral-7b")
    assert steps.partitioned(cfg)
    assert dryrun.execution(cfg) == "partitioned"
    for case in VLM_CASES:
        assert dryrun.execution(ssm_case(*case)) == "partitioned"


@pytest.mark.parametrize("i", range(len(VLM_CASES)), ids=IDS)
def test_train_step_matches_one_rank_and_reference(i, runs, one_rank):
    jtree, batch, _, out, _ = _case(runs, i)
    jcfg, tcfg = _jcfg(i)
    p1, s1, m1, _, _ = one_rank[i]
    jopt = jadam(jconstant(LR), grad_clip=1.0)
    jp, js, jm = jax.jit(jmake_train_step(jcfg, jopt, jit=False))(
        jtree, jopt.init(jtree), {k: jnp.asarray(v) for k, v in
                                  batch.items()}, jnp.asarray(0))
    jp = from_jax_params(jax.tree.map(np.asarray, jp))
    jmom = from_jax_opt_state(jax.tree.map(np.asarray, js))["m"]
    got_p, got_m = _sub(out, "params"), _sub(out, "m")
    loss = float(out["loss"])
    if tcfg.dtype == "bfloat16":
        # the reference's own bounds against one rank; against the
        # reference no further than one rank lies from it plus those
        # bounds (the triangle inequality)
        assert abs(loss - float(m1["loss"])) < BF16_LOSS
        close_trees(got_p, {k: v.float() for k, v in tree_items(p1)},
                    rtol=0.0, atol=5e-3)
        one_gap = abs(float(m1["loss"]) - float(jm["loss"]))
        assert abs(loss - float(jm["loss"])) <= one_gap + BF16_LOSS
        one = dict(tree_items(p1))
        for k, w in tree_items(jp):
            gap = (got_p[k].float() - w.float()).abs().max()
            assert gap <= (one[k].float() - w.float()).abs().max() + 5e-3, k
        return
    for want in (m1, jm):
        assert loss == pytest.approx(float(want["loss"]), rel=1e-5)
    for want_p, want_m in ((p1, s1["m"]), (jp, jmom)):
        want_m = dict(tree_items(want_m))
        close_trees(got_m, want_m, **TREE_TOL)
        slack = noise_slack(got_m, want_m, LR)
        close_trees(got_p, dict(tree_items(want_p)), slack=slack,
                    **TREE_TOL)


@pytest.mark.parametrize("i", range(len(VLM_CASES)), ids=IDS)
def test_prefill_and_decode_match_one_rank_and_reference(i, runs, one_rank):
    jtree, batch, _, out, logs = _case(runs, i)
    jcfg, tcfg = _jcfg(i)
    got, fed = out["logits"], out["tokens"]
    assert fed.shape == (PART_B, PART_DECODE)
    one = one_rank[i][4]
    ref = _serve_reference(jcfg, jtree, batch, fed)
    # each fed token is the greedy pick of the step before it
    assert np.array_equal(fed, one[:-1].argmax(-1)[..., 0].T)
    if tcfg.dtype == "float32":
        np.testing.assert_allclose(got, one, **TREE_TOL)
        np.testing.assert_allclose(got, ref, **TREE_TOL)
    else:
        np.testing.assert_allclose(got, one, rtol=0.0, atol=BF16_LOGITS)
        gap = np.abs(got - ref).max()
        assert gap <= np.abs(one - ref).max() + BF16_LOGITS, gap
    B, W = PART_B // MESH[0], VLM_WINDOW // MESH[1]
    want = [tcfg.n_layers, B, W, tcfg.kv_heads, tcfg.head_dim]
    for log in logs:
        assert log["serve"]["npos"] == VLM_S
        assert log["serve"]["cache_local"] == {"k": want, "v": want}


@pytest.mark.parametrize("i", range(len(VLM_CASES)), ids=IDS)
def test_each_ranks_ring_is_its_slots_of_one_ranks(i, runs, one_rank):
    """Rank (dr, mr) holds rows [2 dr, 2 dr + 2) and slots [3 mr, 3 mr
    + 3) of the one-rank ring, whose slot j holds position 24 + (j - 24)
    % 12: the prefill's last 12 positions, wrapped."""
    tcfg = ssm_case(*VLM_CASES[i])
    ring = one_rank[i][3]
    B, W = PART_B // MESH[0], VLM_WINDOW // MESH[1]
    for r in range(8):
        dr, mr = divmod(r, MESH[1])
        got = dict(np.load(runs / f"ring_{i}_{r}.npz"))
        assert set(got) == {"k", "v"}
        for k, v in got.items():
            want = ring[k][:, dr * B:(dr + 1) * B,
                           mr * W:(mr + 1) * W].float().numpy()
            if tcfg.dtype == "float32":
                np.testing.assert_allclose(v, want, **TREE_TOL)
            else:
                np.testing.assert_allclose(v, want, rtol=0.0,
                                           atol=BF16_LOGITS)


@pytest.mark.parametrize("i", range(len(VLM_CASES)), ids=IDS)
def test_each_rank_gathers_one_unit_at_a_time(i, runs):
    *_, logs = _case(runs, i)
    for log in logs:
        for kind in ("train", "serve"):
            g = log[kind]
            assert g["gathers"] > 0 and g["dtensor"] == [], (kind, g)
            assert g["largest"] <= g["budget"], (kind, g)
            assert g["peak"] <= g["budget"], (kind, g)


@pytest.mark.parametrize("i", range(len(VLM_CASES)), ids=IDS)
def test_counts_equal_dryrun_reckoning(i, runs):
    *_, logs = _case(runs, i)
    cfg = ssm_case(*VLM_CASES[i])
    mesh = AbstractMesh(MESH, ("data", "model"))
    for kind in ("train", "decode"):
        rl, held = dryrun.count_cell(
            cfg, ShapeSpec("mesh", VLM_S, PART_B, kind), mesh)
        want = {k: [v["bytes"], v["count"]]
                for k, v in rl.coll_detail.items()}
        for r, log in enumerate(logs):
            t = log[kind]
            assert t["dot_flops"] == rl.dot_flops, (kind, r)
            assert t["coll"] == want, (kind, r)
            assert t["held"] == held, (kind, r)
            if kind == "train":
                assert t["after"] == held
        assert {"all-gather", "all-reduce"} <= set(want), kind


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
cfg = dataclasses.replace(registry.get("llava-next-mistral-7b").reduced(),
                          kv_heads={kv})
mesh = compat_mesh((2, 4), ("data", "model"), devices=jax.devices()[:8])
with mesh, hints.use_mesh_hints(mesh):
    c = D.lower_cell(cfg, ShapeSpec("mesh", {seq}, {batch}, "train"),
                     mesh).compile()
print(json.dumps({{"dot_flops": H.analyze(c.as_text()).dot_flops}}))
"""
XLA_SEQ, XLA_BATCH, XLA_TOL = 64, 8, 0.02


@pytest.mark.parametrize("kv", [2, 4])
def test_dot_flops_agree_with_reference_partitioned_module(kv):
    """At 2 kv heads the specs replicate wk / wv; the reference's
    partitioner projects them on each rank's sequence shard and gathers
    the products, as the port's route does."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    run = subprocess.run(
        [sys.executable, "-c", _REFERENCE_COUNT.format(
            src=str(ROOT / "src"), seq=XLA_SEQ, batch=XLA_BATCH, kv=kv)],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    ref = json.loads(run.stdout.strip().splitlines()[-1])["dot_flops"]
    cfg = dataclasses.replace(treg.get("llava-next-mistral-7b").reduced(),
                              kv_heads=kv)
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
