"""The partitioned mesh steps (``parallel/partition.py``: compute follows
the specs) against one rank, the JAX reference, the dry run's count and
the reference's own partitioned module, on the CPU.

* 8 gloo ranks on a 2 x 4 (data x model) mesh run ``PART_CASES``:
  reduced deepseek-7b (dense, 4 heads and 4 kv heads) and reduced sparse
  stablelm-3b (FFN junctions at density 0.5, block 32: 4 and 8 output
  blocks, split over "model"), fp32 and bf16 compute, and sparse
  stablelm-3b with 2 kv heads and 6-block FFN junctions, which the
  4-wide model axis does not divide (wk / wv and wi / wg replicated and
  computed whole, as qwen2-72b's kv heads and stablelm-3b's 54-block
  junctions are at full size), and bf16 deepseek-7b over 33 positions,
  which the model axis does not divide (the residual replicated, the
  cache whole), its loss in chunks of 8, from the reference's carried
  weights:
  - one two-pass Adam step (lr 1e-3, clip 1.0) of 4 x 32 against the
    one-rank step and the reference's single-device step: bf16 compute
    to the reference's own bounds (loss 2e-3, params 5e-3), fp32 to rtol
    5e-4 / atol 5e-5 with tests/test_torch_moe.py's noise-floor slack of
    Adam's first step (and the loss to 1e-5);
  - a prefill of 27 prompt tokens (padded to 32 or 33, the cache's
    size) and 4 greedy decode steps from position 27: the logits against
    the one-rank steps fed the mesh's tokens (fp32 rtol 5e-4 / atol 5e-5;
    bf16 2^-5, four ulps at magnitude 1, and no further from the
    reference than the one-rank port's bf16 logits lie from it), and
    the greedy tokens equal the one-rank steps';
  - what each rank gathers: no leaf gather returns more than one unit's
    leaves (a layer, the embedding's tok, its out, the final norm, each
    gathered over the dp axes), nor do the gathered leaves alive at once
    ever exceed one unit, in the forward and in the backward; no DTensor
    is gathered or redistributed during the steps (so no optimizer-state
    and no cache leaf), and each rank's cache is its [L, B/2, S/4, Hkv,
    hd] shard;
  - the train step's dot FLOPs, collectives by kind and held bytes equal
    ``launch/dryrun.count_cell`` on ``AbstractMesh((2, 4))`` exactly.
* The same ranks as a 2 x 2 x 2 (pod, data, model) mesh, the dp axes
  two deep as on the multi-pod mesh: reduced deepseek-7b's fp32 step
  against one rank (as above) and its counts against ``count_cell`` on
  ``AbstractMesh((2, 2, 2))``, exactly.
* A junction whose output blocks are split: each rank's ``fwd`` and
  ``dw`` on its blocks equal the full junction's rows bit for bit, and
  the ranks' ``dx`` through their own reverse tables sum to the full
  ``dx``; the tables against a brute-force build.
* The reference's ``launch/dryrun.lower_cell`` for reduced deepseek-7b's
  train step on a 2 x 4 mesh of forced host devices: its per-device dot
  FLOPs (``repro.roofline.hlo.analyze``) agree with the port's count
  within 2 % (the reference's backward recomputes each attention chunk's
  q k^T, which the port's does not: 1.1 % here, as PR 31 found on one
  device), and the gathered route's count lies outside it.
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
from repro_torch.kernels import block_sparse_matmul as bsm
from repro_torch.core.sparsity import make_block_pattern
from repro_torch.launch import dryrun
from repro_torch.launch import specs as tspecs
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import model as TM
from repro_torch.optim import adam, constant_schedule
from repro_torch.parallel import sharding as sh
from repro_torch.roofline import analysis
from repro_torch.train import steps
from repro_torch.tree import tree_items
from torch_mesh_workers import PART_B, PART_CASES, PART_DECODE, \
    PART_PROMPT, PART_S, part_case, part_seq, partitioned_run, run_ranks
from torch_parity_helpers import close_trees, noise_slack, \
    reference_variant

ROOT = Path(__file__).resolve().parents[1]
TREE_TOL = dict(rtol=5e-4, atol=5e-5)
BF16_LOGITS = 2 ** -5
LR = 1e-3
IDS = ["-".join([a, d] + [f"{k}{v}" for k, v in c.items()])
       for a, d, c in PART_CASES]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jcfg(i):
    tcfg = part_case(*PART_CASES[i])
    jcfg = reference_variant(jreg.get(PART_CASES[i][0]).reduced(), tcfg)
    return dataclasses.replace(jcfg, dtype=tcfg.dtype,
                               **PART_CASES[i][2]), tcfg


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
    d = tmp_path_factory.mktemp("partitioned")
    for i in range(len(PART_CASES)):
        jcfg, _ = _jcfg(i)
        jp = jax.tree.map(np.asarray, JM.init(jcfg, jax.random.PRNGKey(0)))
        tok = np.asarray(jconcrete_batch(
            jcfg, PART_B, part_seq(PART_CASES[i]),
            jax.random.PRNGKey(3))["tokens"])
        np.savez(d / f"in_{i}.npz", **_flat(jp), batch_tokens=tok)
    run_ranks(partitioned_run, 8, str(d))
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


@pytest.mark.parametrize("i", range(len(PART_CASES)), ids=IDS)
def test_train_step_matches_one_rank_and_reference(i, runs):
    jtree, tokens, params, out, _ = _case(runs, i)
    jcfg, tcfg = _jcfg(i)
    batch = {"tokens": tokens}
    jopt = jadam(jconstant(LR), grad_clip=1.0)
    jp, js, jm = jax.jit(jmake_train_step(jcfg, jopt, jit=False))(
        jtree, jopt.init(jtree), batch, jnp.asarray(0))
    jp = from_jax_params(jax.tree.map(np.asarray, jp))
    jmom = from_jax_opt_state(jax.tree.map(np.asarray, js))["m"]
    opt = adam(constant_schedule(LR), grad_clip=1.0)
    p1, s1, m1 = steps.make_train_step(tcfg, opt)(params, opt.init(params),
                                                  batch, 0)
    got_p, got_m, loss = _sub(out, "params"), _sub(out, "m"), \
        float(out["loss"])
    if tcfg.dtype == "bfloat16":          # the reference's own bounds
        for want_loss, want_p in ((m1["loss"], p1), (jm["loss"], jp)):
            assert abs(loss - float(want_loss)) < 2e-3
            close_trees(got_p, {k: v.float() for k, v in
                                tree_items(want_p)}, rtol=0.0, atol=5e-3)
        return
    assert loss == pytest.approx(float(m1["loss"]), rel=1e-5)
    assert loss == pytest.approx(float(jm["loss"]), rel=1e-5)
    for want_p, want_m in ((p1, s1["m"]), (jp, jmom)):
        want_m = dict(tree_items(want_m))
        close_trees(got_m, want_m, **TREE_TOL)
        slack = noise_slack(got_m, want_m, LR)
        close_trees(got_p, dict(tree_items(want_p)), slack=slack,
                    **TREE_TOL)


def _serve_one_rank(cfg, params, tokens, picks, jcfg=None, jtree=None):
    """The one-rank (or, with ``jcfg``, the reference's) prefill and
    decode steps on the mesh's inputs, fed the mesh's greedy picks:
    (logits [1 + PART_DECODE, B, 1, V], each step's own greedy pick)."""
    prompt = tokens.copy()
    prompt[:, PART_PROMPT:] = 0
    toks = [tokens[:, PART_PROMPT:PART_PROMPT + 1]] + [
        picks[:, t:t + 1] for t in range(PART_DECODE - 1)]
    if jcfg is None:
        lg, cache, _ = steps.make_prefill_step(cfg)(
            params, {"tokens": torch.as_tensor(prompt)})
        decode = steps.make_decode_step(cfg)
        logits = [lg]
        for t, tok in enumerate(toks):
            lg, cache = decode(params, cache, torch.as_tensor(tok),
                               PART_PROMPT + t)
            logits.append(lg)
        logits = torch.stack(logits).float().numpy()
    else:
        lg, cache = jax.jit(jmake_prefill_step(jcfg))(
            jtree, {"tokens": jnp.asarray(prompt)})
        decode = jax.jit(jmake_decode_step(jcfg))
        logits = [lg]
        for t, tok in enumerate(toks):
            lg, cache = decode(jtree, cache, jnp.asarray(tok),
                               jnp.asarray(PART_PROMPT + t))
            logits.append(lg)
        logits = np.stack([np.asarray(x, np.float32) for x in logits])
    return logits, logits[1:].argmax(-1)[..., 0].T


@pytest.mark.parametrize("i", range(len(PART_CASES)), ids=IDS)
def test_prefill_and_decode_match_one_rank_and_reference(i, runs):
    jtree, tokens, params, out, logs = _case(runs, i)
    jcfg, tcfg = _jcfg(i)
    got, picks = out["logits"], out["tokens"]
    assert picks.shape == (PART_B, PART_DECODE)
    one, one_picks = _serve_one_rank(tcfg, params, tokens, picks)
    ref, _ = _serve_one_rank(None, None, tokens, picks, jcfg, jtree)
    assert np.array_equal(picks, one_picks)
    if tcfg.dtype == "float32":
        np.testing.assert_allclose(got, one, **TREE_TOL)
        np.testing.assert_allclose(got, ref, **TREE_TOL)
    else:
        np.testing.assert_allclose(got, one, rtol=0.0, atol=BF16_LOGITS)
        gap = np.abs(got - ref).max()
        assert gap <= max(np.abs(one - ref).max(), BF16_LOGITS), gap
    S = part_seq(PART_CASES[i])
    S = S // 4 if S % 4 == 0 else S
    for log in logs:
        assert log["serve"]["cache_local"] == [
            [tcfg.n_layers, PART_B // 2, S, tcfg.kv_heads,
             tcfg.head_dim]] * 2


@pytest.mark.parametrize("i", range(len(PART_CASES)), ids=IDS)
def test_each_rank_gathers_one_unit_at_a_time(i, runs):
    *_, logs = _case(runs, i)
    for log in logs:
        for kind in ("train", "serve"):
            g = log[kind]
            assert g["gathers"] > 0 and g["dtensor"] == [], (kind, g)
            assert g["largest"] <= g["budget"], (kind, g)
            assert g["peak"] <= g["budget"], (kind, g)


@pytest.mark.parametrize("i", range(len(PART_CASES)), ids=IDS)
def test_train_counts_equal_dryrun_reckoning(i, runs):
    *_, logs = _case(runs, i)
    cfg = part_case(*PART_CASES[i])
    rl, held = dryrun.count_cell(cfg, ShapeSpec("mesh",
                                                part_seq(PART_CASES[i]),
                                                PART_B, "train"),
                                 AbstractMesh((2, 4), ("data", "model")))
    assert dryrun.execution(cfg) == "partitioned"
    for log in logs:
        t = log["train"]
        assert t["dot_flops"] == rl.dot_flops
        assert t["coll"] == {k: [v["bytes"], v["count"]]
                             for k, v in rl.coll_detail.items()}
        assert t["held"] == held == t["after"]
        assert {"all-gather", "reduce-scatter", "all-reduce"} <= set(
            t["coll"])


def test_pod_mesh_step_matches_one_rank_and_dryrun(runs):
    _, tokens, params, _, _ = _case(runs, 0)
    cfg = part_case(*PART_CASES[0])
    opt = adam(constant_schedule(LR), grad_clip=1.0)
    state = opt.init(params)
    p1, s1, m1 = steps.make_train_step(cfg, opt)(params, state,
                                                 {"tokens": tokens}, 0)
    out = dict(np.load(runs / "pod.npz"))
    assert float(out["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-5)
    got = {k[5:]: torch.from_numpy(v) for k, v in out.items()
           if k.startswith("leaf:")}
    # Adam's first step: an element whose gradient sits at the noise
    # floor may move 2 lr on either side (noise_slack's rule, m not
    # saved here: every element may take it, one in 10^4 at most)
    slack = {k: 2 * LR * (1 + 1e-5) for k, v in got.items()
             if v.is_floating_point()}
    close_trees(got, dict(tree_items(p1)), slack=slack, **TREE_TOL)
    rl, _ = dryrun.count_cell(cfg, ShapeSpec("mesh", PART_S, PART_B,
                                             "train"),
                              AbstractMesh((2, 2, 2),
                                           ("pod", "data", "model")))
    for r in range(8):
        got = json.loads((runs / f"pod_{r}.json").read_text())
        assert got["dot_flops"] == rl.dot_flops
        assert got["coll"] == {k: [v["bytes"], v["count"]]
                               for k, v in rl.coll_detail.items()}


# ----------------------------------------------------- a junction's slice
@pytest.mark.parametrize("n", [2, 4])
def test_junction_slices_recombine(n):
    pat = make_block_pattern(8 * 32, 8 * 32, 0.375, 32, seed=3)
    full = [torch.as_tensor(getattr(pat, k), dtype=torch.int32)
            for k in ("idx", "rev_ob", "rev_t", "rev_cnt")]
    gen = torch.Generator().manual_seed(0)
    nob, kb = pat.idx.shape
    w = torch.randn((1, nob, kb, 32, 32), generator=gen)
    x = torch.randn((1, 24, 8 * 32), generator=gen)
    b = torch.randn((1, nob * 32), generator=gen)
    y = bsm.fwd_ref(x, w, full[0], b, "gelu", save_pre=True)[0]
    dy = torch.randn(y.shape, generator=gen)
    pre = bsm.fwd_ref(x, w, full[0], b, "gelu", save_pre=True)[1]
    dx = bsm.dx_ref(dy, w, *full[1:], pre, "gelu")
    dw, db = bsm.dw_ref(x, dy, full[0], pre, "gelu")
    nl, sum_dx = nob // n, torch.zeros_like(dx)
    for at in range(n):
        idx, rev_ob, rev_t, rev_cnt = sh.junction_view(*full, n, at)
        cols = slice(at * nl * 32, (at + 1) * nl * 32)
        wl = w[:, at * nl:(at + 1) * nl]
        yl, pl = bsm.fwd_ref(x, wl, idx, b[:, cols], "gelu", save_pre=True)
        assert torch.equal(yl, y[..., cols])
        assert torch.equal(pl, pre[..., cols])
        dwl, dbl = bsm.dw_ref(x, dy[..., cols], idx, pl, "gelu")
        assert torch.equal(dwl, dw[:, at * nl:(at + 1) * nl])
        assert torch.equal(dbl, db[:, cols])
        sum_dx += bsm.dx_ref(dy[..., cols].contiguous(), wl, rev_ob, rev_t,
                             rev_cnt, pl, "gelu")
        # the tables against a brute-force build of the rank's blocks
        for ib in range(pat.idx.max() + 1):
            want = [(o - at * nl, t) for o in range(at * nl, (at + 1) * nl)
                    for t in range(kb) if pat.idx[o, t] == ib]
            c = int(rev_cnt[ib])
            assert list(zip(rev_ob[ib, :c].tolist(),
                            rev_t[ib, :c].tolist())) == want
            assert rev_ob[ib, c:].eq(0).all() and rev_t[ib, c:].eq(0).all()
        assert rev_ob.shape == full[1].shape
    torch.testing.assert_close(sum_dx, dx, rtol=1e-5, atol=1e-5)


# -------------------------------------- the reference's partitioned module
_REFERENCE_COUNT = """
import json, os, sys
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
cfg = registry.get("deepseek-7b").reduced()
mesh = compat_mesh((2, 4), ("data", "model"), devices=jax.devices()[:8])
with mesh, hints.use_mesh_hints(mesh):
    c = D.lower_cell(cfg, ShapeSpec("mesh", {seq}, {batch}, "train"),
                     mesh).compile()
print(json.dumps({{"dot_flops": H.analyze(c.as_text()).dot_flops}}))
"""
XLA_SEQ, XLA_BATCH, XLA_TOL = 64, 8, 0.02


def test_dot_flops_agree_with_reference_partitioned_module():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    run = subprocess.run(
        [sys.executable, "-c", _REFERENCE_COUNT.format(
            src=str(ROOT / "src"), seq=XLA_SEQ, batch=XLA_BATCH)],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    ref = json.loads(run.stdout.strip().splitlines()[-1])["dot_flops"]
    cfg = treg.get("deepseek-7b").reduced()
    shape = ShapeSpec("mesh", XLA_SEQ, XLA_BATCH, "train")
    mesh = AbstractMesh((2, 4), ("data", "model"))
    rl, _ = dryrun.count_cell(cfg, shape, mesh)
    assert abs(rl.dot_flops / ref - 1) <= XLA_TOL, (rl.dot_flops, ref)
    # the gathered route: the whole model on the rank's rows
    params = TM.init(cfg, 0, "meta")
    opt = adam(constant_schedule(1e-4))
    rows = dryrun._meta_rows(tspecs.batch_struct(cfg, shape), 2)
    gathered = analysis.analyze(steps.make_train_step(cfg, opt), params,
                                opt.init(params), rows, 0).dot_flops
    assert abs(gathered / ref - 1) > XLA_TOL, (gathered, ref)
