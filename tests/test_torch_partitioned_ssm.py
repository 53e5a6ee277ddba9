"""The ssm and hybrid families' partitioned mesh steps (``models/ssm.
mamba1_apply_tp`` / ``mamba2_apply_tp``: the mixer, its state and its
cache on the rank's channels or heads, the columns they need regrouped
to it over "model"; the hybrid's shared block a dense block at each of
its uses, its gradient summed over them before it is reduced) against
one rank, the JAX reference, the dry run's count and the reference's own
partitioned module, on the CPU.

* 8 gloo ranks on a 2 x 4 (data x model) mesh run ``SSM_CASES``, each in
  fp32 and bf16 compute, from the reference's carried weights, FFN
  density 0.5 at block 32: reduced falcon-mamba (in_proj's xs half on
  model ranks 0-1, its z half on 2-3), reduced zamba2 at two super-blocks
  (its 8 heads 2 a rank, in_xbc's 384 columns 96 a rank, across the
  64-channel head boundary; the shared block used twice) and at d_state
  48 (in_xbc's 11 output blocks replicated, every rank computing the
  whole junction and cutting the conv's 88 columns from it).
  - one two-pass Adam step (lr 1e-3, clip 1.0) of 4 x 32 against the
    one-rank step and the reference's single-device step: fp32 loss to
    1e-5 and params / Adam's m to rtol 5e-4 / atol 5e-5 with
    tests/test_torch_moe.py's noise-floor slack of Adam's first step;
    bf16 to the reference's own bounds against one rank (loss 2e-3,
    params 5e-3) and from the reference no further than one rank lies
    from it plus those bounds;
  - a prefill of 27 prompt tokens (padded to 32) and 4 greedy decode
    steps: the logits against the one-rank steps fed the mesh's tokens
    (fp32 rtol 5e-4 / atol 5e-5; bf16 2^-5, and from the reference no
    further than one rank plus 2^-5), greedy tokens equal;
  - each rank's cache is its shard: Mamba-1 conv [L, B/2, K-1, di/4],
    ssm [L, B/2, di/4, N]; Mamba-2 conv [ns, ev, B/2, K-1, (di+2N)/4],
    ssm [ns, ev, B/2, H/4, hd, N], the shared block's K / V [ns, B/2,
    S/4, Hkv, hd];
  - no more than one unit gathered at a time (a Mamba layer, the shared
    block, the embedding's tok, its out, the final norm), no DTensor
    gathered or redistributed during the steps (no optimizer-state or
    cache leaf);
  - the train step's and the first decode step's dot FLOPs, collectives
    and held bytes on rank 0 equal ``launch/dryrun.count_cell`` on
    ``AbstractMesh((2, 4))`` exactly; every rank issues the same calls
    and the same bytes, but for the hybrid's all-to-all, whose backward
    returns B and C's gradients from every rank to the ranks that hold
    them.
* Each case's specs split what the list above says, and
  ``Partition.regroup``'s plans agree across ranks (what one rank sends
  another receives) at the reduced and the full widths.
* The reference's ``launch/dryrun.lower_cell`` for reduced falcon-mamba's
  train step (8 x 64) on a 2 x 4 mesh of forced host devices: its
  per-device dot FLOPs agree with the port's count within 2 %, and the
  gathered route's count lies outside it; likewise for reduced zamba2
  (two super-blocks), whose shared block runs once a use, outside any
  checkpoint, as the reference's super-block scan runs it.  The
  one-device programs agree within 2 % too, and the partitioning moves
  the ratio by no more than 1 %.
* The hybrid's shared block runs its forward once a use in a training
  step, on one device and on the partitioned route, while each Mamba-2
  layer runs twice (forward and recomputation).
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
from repro_torch.parallel import partition
from repro_torch.parallel import sharding as sh
from repro_torch.roofline import analysis
from repro_torch.train import steps
from repro_torch.tree import tree_items
from torch_mesh_workers import PART_B, PART_DECODE, PART_PROMPT, PART_S, \
    SSM_CASES, run_ranks, ssm_case, ssm_partitioned_run
from torch_parity_helpers import close_trees, noise_slack, \
    reference_variant

ROOT = Path(__file__).resolve().parents[1]
TREE_TOL = dict(rtol=5e-4, atol=5e-5)
BF16_LOGITS = 2 ** -5
BF16_LOSS = 2e-3
LR = 1e-3
MESH = (2, 4)
IDS = ["-".join([a, d] + [f"{k}{v}" for k, v in c.items()])
       for a, d, c in SSM_CASES]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jcfg(i):
    arch, dtype, changes = SSM_CASES[i]
    tcfg = ssm_case(*SSM_CASES[i])
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
    d = tmp_path_factory.mktemp("partitioned_ssm")
    for i in range(len(SSM_CASES)):
        jcfg, _ = _jcfg(i)
        jp = jax.tree.map(np.asarray, JM.init(jcfg, jax.random.PRNGKey(0)))
        tok = np.asarray(jconcrete_batch(jcfg, PART_B, PART_S,
                                         jax.random.PRNGKey(3))["tokens"])
        np.savez(d / f"in_{i}.npz", **_flat(jp), batch_tokens=tok)
    run_ranks(ssm_partitioned_run, 8, str(d))
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


def _prompt_and_feeds(tokens, picks):
    prompt = tokens.copy()
    prompt[:, PART_PROMPT:] = 0
    feeds = [tokens[:, PART_PROMPT:PART_PROMPT + 1]] + [
        picks[:, t:t + 1] for t in range(PART_DECODE - 1)]
    return prompt, feeds


@pytest.fixture(scope="module")
def one_rank(runs):
    """Per case: the one-rank train step's (params, Adam state, metrics)
    and the one-rank prefill and decode steps' logits [1 + PART_DECODE,
    B, 1, V], fed the mesh's greedy picks."""
    out = {}
    for i in range(len(SSM_CASES)):
        _, tokens, params, got, _ = _case(runs, i)
        cfg = ssm_case(*SSM_CASES[i])
        opt = adam(constant_schedule(LR), grad_clip=1.0)
        p1, s1, m1 = steps.make_train_step(cfg, opt)(
            params, opt.init(params), {"tokens": tokens}, 0)
        prompt, feeds = _prompt_and_feeds(tokens, got["tokens"])
        lg, cache, _ = steps.make_prefill_step(cfg)(
            params, {"tokens": torch.as_tensor(prompt)})
        decode = steps.make_decode_step(cfg)
        logits = [lg]
        for t, tok in enumerate(feeds):
            lg, cache = decode(params, cache, torch.as_tensor(tok),
                               PART_PROMPT + t)
            logits.append(lg)
        out[i] = (p1, s1, m1, torch.stack(logits).float().numpy())
    return out


def _serve_reference(jcfg, jtree, tokens, picks):
    prompt, feeds = _prompt_and_feeds(tokens, picks)
    lg, cache = jax.jit(jmake_prefill_step(jcfg))(
        jtree, {"tokens": jnp.asarray(prompt)})
    decode = jax.jit(jmake_decode_step(jcfg))
    logits = [lg]
    for t, tok in enumerate(feeds):
        lg, cache = decode(jtree, cache, jnp.asarray(tok),
                           jnp.asarray(PART_PROMPT + t))
        logits.append(lg)
    return np.stack([np.asarray(x, np.float32) for x in logits])


@pytest.mark.parametrize("i", range(len(SSM_CASES)), ids=IDS)
def test_train_step_matches_one_rank_and_reference(i, runs, one_rank):
    jtree, tokens, _, out, _ = _case(runs, i)
    jcfg, tcfg = _jcfg(i)
    assert steps.partitioned(tcfg)
    p1, s1, m1, _ = one_rank[i]
    jopt = jadam(jconstant(LR), grad_clip=1.0)
    jp, js, jm = jax.jit(jmake_train_step(jcfg, jopt, jit=False))(
        jtree, jopt.init(jtree), {"tokens": tokens}, jnp.asarray(0))
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


def _cache_shapes(cfg):
    """Each cache leaf's shard on a rank of the 2 x 4 mesh."""
    B, S = PART_B // MESH[0], PART_S // MESH[1]
    K, N, m = cfg.conv_width, cfg.ssm_state, MESH[1]
    di, L = cfg.d_inner_, cfg.n_layers
    if cfg.family == "ssm":
        return {"conv": [L, B, K - 1, di // m], "ssm": [L, B, di // m, N]}
    ev = cfg.hybrid_attn_every
    ns = L // ev
    kv = [ns, B, S, cfg.kv_heads, cfg.head_dim]
    return {"attn/k": kv, "attn/v": kv,
            "ssm/conv": [ns, ev, B, K - 1, (di + 2 * N) // m],
            "ssm/ssm": [ns, ev, B, cfg.ssm_heads // m, cfg.ssm_head_dim, N]}


@pytest.mark.parametrize("i", range(len(SSM_CASES)), ids=IDS)
def test_prefill_and_decode_match_one_rank_and_reference(i, runs, one_rank):
    jtree, tokens, _, out, logs = _case(runs, i)
    jcfg, tcfg = _jcfg(i)
    got, picks = out["logits"], out["tokens"]
    assert picks.shape == (PART_B, PART_DECODE)
    one = one_rank[i][3]
    ref = _serve_reference(jcfg, jtree, tokens, picks)
    assert np.array_equal(picks, one[1:].argmax(-1)[..., 0].T)
    if tcfg.dtype == "float32":
        np.testing.assert_allclose(got, one, **TREE_TOL)
        np.testing.assert_allclose(got, ref, **TREE_TOL)
    else:
        np.testing.assert_allclose(got, one, rtol=0.0, atol=BF16_LOGITS)
        gap = np.abs(got - ref).max()
        assert gap <= np.abs(one - ref).max() + BF16_LOGITS, gap
    for log in logs:
        assert log["serve"]["cache_local"] == _cache_shapes(tcfg)


@pytest.mark.parametrize("i", range(len(SSM_CASES)), ids=IDS)
def test_each_rank_gathers_one_unit_at_a_time(i, runs):
    *_, logs = _case(runs, i)
    for log in logs:
        for kind in ("train", "serve"):
            g = log[kind]
            assert g["gathers"] > 0 and g["dtensor"] == [], (kind, g)
            assert g["largest"] <= g["budget"], (kind, g)
            assert g["peak"] <= g["budget"], (kind, g)


@pytest.mark.parametrize("i", range(len(SSM_CASES)), ids=IDS)
def test_counts_equal_dryrun_reckoning(i, runs):
    *_, logs = _case(runs, i)
    cfg = ssm_case(*SSM_CASES[i])
    assert dryrun.execution(cfg) == "partitioned"
    mesh = AbstractMesh(MESH, ("data", "model"))
    for kind in ("train", "decode"):
        rl, held = dryrun.count_cell(
            cfg, ShapeSpec("mesh", PART_S, PART_B, kind), mesh)
        want = {k: [v["bytes"], v["count"]]
                for k, v in rl.coll_detail.items()}
        assert "all-to-all" in want, kind      # the regroup
        for r, log in enumerate(logs):
            t = log[kind]
            assert t["dot_flops"] == rl.dot_flops, (kind, r)
            assert t["held"] == held, (kind, r)
            if kind == "train":
                assert t["after"] == held
            mine = dict(t["coll"])
            if r and cfg.family == "hybrid" and kind == "train":
                # the regroup's backward: B and C's gradients from every
                # rank go back to the ranks that hold them
                assert mine.pop("all-to-all")[1] == want["all-to-all"][1]
                mine["all-to-all"] = want["all-to-all"]
            assert mine == want, (kind, r)


def test_cases_reach_the_splits_they_name():
    """Each case's specs on the 2 x 4 mesh split what its docstring says:
    falcon-mamba's in_proj by output blocks (xs and z on different
    ranks), zamba2's in_xbc by output blocks across the heads' boundary
    or replicated, its conv and heads over "model"."""
    mesh = AbstractMesh(MESH, ("data", "model"))
    kinds = {}
    for i, case in enumerate(SSM_CASES):
        cfg = ssm_case(*case)
        params = TM.init(cfg, 0, "meta")
        specs = sh.param_specs(cfg, params, mesh)
        layer = specs["layers"][0]
        ssm = (layer[0] if cfg.family == "hybrid" else layer)["ssm"]
        local = sh.attach(params, specs, mesh)["layers"][0]
        lssm = (local[0] if cfg.family == "hybrid" else local)["ssm"]
        heads = lssm["A_log"].shape[0]
        conv = lssm["conv_w"].shape[1]
        junction = "in_xbc" if cfg.family == "hybrid" else "in_proj"
        kinds[i] = (partition.tp_kind(ssm[junction]["w"]), heads, conv)
    assert kinds[0] == ("col", 64, 64)                # di 256: 64 a rank
    assert kinds[2] == ("col", 2, 96)                 # 384 cols, 2 heads
    assert kinds[4] == ("rep", 2, 88)                 # 11 blocks; 352 cols


def _plans(m, held, want):
    """Each rank's (columns it sends to each rank, counts it receives
    from each) under ``Partition.regroup`` (its all-to-all recorded)."""
    class Comm(partition.ReckonedComm):
        def _all_to_all(self, t, axis, out_splits, in_splits):
            self.seen = (list(in_splits), list(out_splits))
            return super()._all_to_all(t, axis, out_splits, in_splits)

    comm = Comm(AbstractMesh((1, m), ("data", "model")))
    part = partition.Partition(None, comm, {})
    out = []
    for r in range(m):
        part.r = r
        lo, hi = held[r]
        got = part.regroup(torch.empty((2, hi - lo), device="meta"), held,
                           want)
        assert got.shape == (2, sum(b - a for a, b in want[r]))
        out.append(comm.seen)
    return out


@pytest.mark.parametrize("kind,m,di,N", [("mamba1", 4, 256, 16),
                                         ("mamba1", 16, 8192, 16),
                                         ("mamba2", 4, 256, 64),
                                         ("mamba2", 4, 256, 48),
                                         ("mamba2", 16, 5120, 64)])
def test_regroup_plans_agree_across_ranks(kind, m, di, N):
    """What rank p sends rank q is what q expects from p, and each rank
    receives exactly its columns: Mamba-1's xs and z of its channels from
    in_proj's split, Mamba-2's heads' xs and all of B and C from the
    conv's split (zamba2: 328 columns a rank against 320 channels)."""
    if kind == "mamba1":
        c = di // m
        held = [(q * 2 * c, (q + 1) * 2 * c) for q in range(m)]
        want = [[(q * c, (q + 1) * c), (di + q * c, di + (q + 1) * c)]
                for q in range(m)]
    else:
        c, cc = di // m, (di + 2 * N) // m
        held = [(q * cc, (q + 1) * cc) for q in range(m)]
        want = [[(q * c, (q + 1) * c), (di, di + 2 * N)] for q in range(m)]
    plans = _plans(m, held, want)
    for p in range(m):
        for q in range(m):
            assert plans[p][0][q] == plans[q][1][p], (p, q)
    if kind == "mamba1":        # each rank sends to two ranks, not all
        assert all(sum(n > 0 for n in sends) == 2 for sends, _ in plans)


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
out = {{}}
for name, shape in (("mesh", (2, 4)), ("one", (1, 1))):
    n = shape[0] * shape[1]
    mesh = compat_mesh(shape, ("data", "model"), devices=jax.devices()[:n])
    with mesh, hints.use_mesh_hints(mesh):
        c = D.lower_cell(cfg, ShapeSpec("mesh", {seq}, {batch}, "train"),
                         mesh).compile()
    out[name] = H.analyze(c.as_text()).dot_flops
print(json.dumps(out))
"""
XLA_SEQ, XLA_BATCH, XLA_TOL = 64, 8, 0.02
XLA_CASES = [("falcon-mamba-7b", {}), ("zamba2-2.7b", {"n_layers": 4})]


@pytest.mark.parametrize("arch,changes", XLA_CASES,
                         ids=[a for a, _ in XLA_CASES])
def test_dot_flops_agree_with_reference_partitioned_module(arch, changes):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    run = subprocess.run(
        [sys.executable, "-c", _REFERENCE_COUNT.format(
            src=str(ROOT / "src"), arch=arch, changes=changes, seq=XLA_SEQ,
            batch=XLA_BATCH)],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    ref = json.loads(run.stdout.strip().splitlines()[-1])
    cfg = dataclasses.replace(treg.get(arch).reduced(), **changes)
    shape = ShapeSpec("mesh", XLA_SEQ, XLA_BATCH, "train")
    rl, _ = dryrun.count_cell(cfg, shape, AbstractMesh(MESH,
                                                       ("data", "model")))
    params = TM.init(cfg, 0, "meta")
    opt = adam(constant_schedule(1e-4))

    def plain(rows):
        batch = dryrun._meta_rows(tspecs.batch_struct(cfg, shape), rows)
        return analysis.analyze(steps.make_train_step(cfg, opt), params,
                                opt.init(params), batch, 0).dot_flops
    # the one-device programs: the port's against the reference's
    base = plain(1) / ref["one"]
    assert abs(base - 1) <= XLA_TOL, base
    got = rl.dot_flops / ref["mesh"]
    assert abs(got / base - 1) <= XLA_TOL / 2, (got, base)
    assert abs(got - 1) <= XLA_TOL, (rl.dot_flops, ref["mesh"])
    # the gathered route: the whole model on the rank's rows
    gathered = plain(2) / ref["mesh"]
    assert abs(gathered - 1) > XLA_TOL, gathered


# ------------------------------------------- the shared block, run once
class _Calls:
    """Counts the calls of ``module.name`` while installed."""

    def __init__(self, monkeypatch, module, name):
        self.n, orig = 0, getattr(module, name)

        def spy(*a, **k):
            self.n += 1
            return orig(*a, **k)
        monkeypatch.setattr(module, name, spy)


def test_shared_block_forward_runs_once_a_use(monkeypatch):
    """Reduced zamba2 at two super-blocks: the shared block's attention
    (its one ``chunked_attention``) runs once for each of its 2 uses in a
    training step, as the reference's super-block scan runs it outside
    any checkpoint, while each of the 4 Mamba-2 mixers runs twice (its
    forward and its recomputation), on one device and on the partitioned
    route (the dry run's rank of a 2 x 4 mesh)."""
    from repro_torch.models import attention, ssm
    cfg = dataclasses.replace(treg.get("zamba2-2.7b").reduced(), n_layers=4,
                              dtype="float32")
    shape = ShapeSpec("mesh", 32, 4, "train")
    n_super = cfg.n_layers // cfg.hybrid_attn_every
    params = TM.init(cfg, 0, "cpu")
    opt = adam(constant_schedule(1e-4))
    batch = {"tokens": np.random.default_rng(0).integers(
        0, cfg.vocab, (shape.global_batch, shape.seq_len), np.int32)}

    def calls(fn):
        att = _Calls(monkeypatch, attention, "chunked_attention")
        mix = _Calls(monkeypatch, ssm, "_mamba2_mix")
        fn()
        return att.n, mix.n

    one = calls(lambda: steps.make_train_step(cfg, opt)(
        params, opt.init(params), batch, 0))
    mesh = calls(lambda: dryrun.count_cell(
        cfg, shape, AbstractMesh(MESH, ("data", "model"))))
    assert one == mesh == (n_super, 2 * cfg.n_layers), (one, mesh)
