"""The audio family's partitioned mesh steps on the "sp" strategy
(whisper-base: every weight whole over "model" and FSDP over the dp
axes, the decoder's positions and the encoder's frames split over
"model") against one rank, the JAX reference, the dry run's count and
the reference's own partitioned module, on the CPU.

* 8 gloo ranks on a 2 x 4 (data x model) mesh run ``AUDIO_CASES`` from
  the reference's carried weights and batch, FFN density 0.5 at block
  32: reduced whisper-base (2 encoder and 2 decoder layers, 16 frames, 4
  a model rank) on 8 x 64 (16 positions a model rank) in fp32 and bf16
  compute, and with the loss in chunks of 8 positions; and on 8 x 66,
  which the model axis does not divide, so that every rank holds every
  position (the frames still split).
  - one two-pass Adam step (lr 1e-3, clip 1.0) against the one-rank
    step and the reference's single-device step: fp32 loss to 1e-5 and
    params / Adam's m to rtol 5e-4 / atol 5e-5 with
    tests/test_torch_moe.py's noise-floor slack of Adam's first step;
    bf16 to the reference's own bounds against one rank (loss 2e-3,
    params 5e-3) and from the reference no further than one rank lies
    from it plus those bounds;
  - a prefill of 46 prompt tokens padded to the case's positions and 4
    greedy decode steps from position 46 (on 64 positions 46-47 on model
    rank 2, 48-49 on rank 3):
    the logits against the one-rank steps and the reference's fed the
    mesh's tokens (fp32 rtol 5e-4 / atol 5e-5; bf16 2^-5 from one rank,
    and from the reference no further than one rank plus 2^-5), greedy
    tokens equal;
  - each rank's cache after the prefill is its rows, positions (K / V;
    every position on 66) and frames (cross K / V) of the one-rank cache,
    to the logits' bounds;
  - no more than one unit gathered at a time (a decoder or encoder
    layer, the encoder's norm, the embedding's tok, its out, the final
    norm), no DTensor gathered or redistributed during the steps;
  - the train step's and the first decode step's dot FLOPs, collectives
    and held bytes on every rank equal ``launch/dryrun.count_cell`` on
    ``AbstractMesh((2, 4))`` exactly.
* The reference's ``launch/dryrun.lower_cell`` for reduced whisper-base's
  train step (8 x 64) on a 2 x 4 mesh of forced host devices: its
  per-device dot FLOPs agree with the port's count within 2 %, and the
  gathered route's count (the whole model on the rank's rows) lies
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
from torch_mesh_workers import AUDIO_B, AUDIO_CASES, AUDIO_PROMPT, \
    PART_DECODE, audio_case, audio_partitioned_run, run_ranks
from torch_parity_helpers import close_trees, noise_slack, \
    reference_variant

ROOT = Path(__file__).resolve().parents[1]
TREE_TOL = dict(rtol=5e-4, atol=5e-5)
BF16_LOGITS = 2 ** -5
BF16_LOSS = 2e-3
LR = 1e-3
MESH = (2, 4)
IDS = ["-".join([d, f"S{S}"] + [f"{k}{v}" for k, v in c.items()])
       for d, c, S in AUDIO_CASES]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jcfg(i):
    dtype, changes, _ = AUDIO_CASES[i]
    tcfg = audio_case(dtype, changes)
    jcfg = reference_variant(jreg.get("whisper-base").reduced(), tcfg)
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
    d = tmp_path_factory.mktemp("partitioned_audio")
    for i in range(len(AUDIO_CASES)):
        jcfg, _ = _jcfg(i)
        jp = jax.tree.map(np.asarray, JM.init(jcfg, jax.random.PRNGKey(0)))
        b = jconcrete_batch(jcfg, AUDIO_B, AUDIO_CASES[i][2],
                            jax.random.PRNGKey(3))
        np.savez(d / f"in_{i}.npz", **_flat(jp),
                 batch_tokens=np.asarray(b["tokens"]),
                 batch_frames=np.asarray(b["frames"], np.float32))
    run_ranks(audio_partitioned_run, 8, str(d))
    return d


def _case(d, i):
    """(reference params (numpy tree), batch, the port's carried params,
    rank 0's results, every rank's log)."""
    raw = dict(np.load(d / f"in_{i}.npz"))
    batch = {"tokens": raw.pop("batch_tokens"),
             "frames": raw.pop("batch_frames")}
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


def _prompt_and_feeds(batch, picks):
    prompt = dict(batch, tokens=batch["tokens"].copy())
    prompt["tokens"][:, AUDIO_PROMPT:] = 0
    feeds = [batch["tokens"][:, AUDIO_PROMPT:AUDIO_PROMPT + 1]] + [
        picks[:, t:t + 1] for t in range(PART_DECODE - 1)]
    return prompt, feeds


@pytest.fixture(scope="module")
def one_rank(runs):
    """Per case: the one-rank train step's (params, Adam state, metrics),
    the one-rank prefill's cache and the logits [1 + PART_DECODE, B, 1,
    V] of the prefill and the decode steps, fed the mesh's picks."""
    out = {}
    for i in range(len(AUDIO_CASES)):
        _, batch, params, got, _ = _case(runs, i)
        cfg = audio_case(*AUDIO_CASES[i][:2])
        opt = adam(constant_schedule(LR), grad_clip=1.0)
        p1, s1, m1 = steps.make_train_step(cfg, opt)(
            params, opt.init(params), batch, 0)
        prompt, feeds = _prompt_and_feeds(batch, got["tokens"])
        lg, cache, npos = steps.make_prefill_step(cfg)(params, prompt)
        assert npos == AUDIO_CASES[i][2]
        first = {k: v.clone() for k, v in cache.items()}
        decode = steps.make_decode_step(cfg)
        logits = [lg]
        for t, tok in enumerate(feeds):
            lg, cache = decode(params, cache, torch.as_tensor(tok),
                               AUDIO_PROMPT + t)
            logits.append(lg)
        out[i] = (p1, s1, m1, first, torch.stack(logits).float().numpy())
    return out


def _serve_reference(jcfg, jtree, batch, picks):
    """The reference's prefill and decode steps on the mesh's inputs."""
    prompt, feeds = _prompt_and_feeds(batch, picks)
    lg, cache = jax.jit(jmake_prefill_step(jcfg))(
        jtree, {k: jnp.asarray(v) for k, v in prompt.items()})
    decode = jax.jit(jmake_decode_step(jcfg))
    logits = [lg]
    for t, tok in enumerate(feeds):
        lg, cache = decode(jtree, cache, jnp.asarray(tok),
                           jnp.asarray(AUDIO_PROMPT + t))
        logits.append(lg)
    return np.stack([np.asarray(x, np.float32) for x in logits])


def test_whisper_takes_the_partitioned_route():
    cfg = treg.get("whisper-base")
    assert cfg.strategy == "sp" and steps.partitioned(cfg)
    assert dryrun.execution(cfg) == "partitioned"
    for case in AUDIO_CASES:
        assert dryrun.execution(audio_case(*case[:2])) == "partitioned"


@pytest.mark.parametrize("i", range(len(AUDIO_CASES)), ids=IDS)
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


@pytest.mark.parametrize("i", range(len(AUDIO_CASES)), ids=IDS)
def test_prefill_and_decode_match_one_rank_and_reference(i, runs, one_rank):
    jtree, batch, _, out, logs = _case(runs, i)
    jcfg, tcfg = _jcfg(i)
    got, picks = out["logits"], out["tokens"]
    assert picks.shape == (AUDIO_B, PART_DECODE)
    one = one_rank[i][4]
    ref = _serve_reference(jcfg, jtree, batch, picks)
    # each pick is the greedy choice of the step that made it
    assert np.array_equal(picks, one[1:].argmax(-1)[..., 0].T)
    if tcfg.dtype == "float32":
        np.testing.assert_allclose(got, one, **TREE_TOL)
        np.testing.assert_allclose(got, ref, **TREE_TOL)
    else:
        np.testing.assert_allclose(got, one, rtol=0.0, atol=BF16_LOGITS)
        gap = np.abs(got - ref).max()
        assert gap <= np.abs(one - ref).max() + BF16_LOGITS, gap
    n = _shard_lengths(i, tcfg)
    B = AUDIO_B // MESH[0]
    for log in logs:
        assert log["serve"]["npos"] == AUDIO_CASES[i][2]
        assert log["serve"]["cache_local"] == {
            k: [tcfg.n_layers, B, n[k], tcfg.kv_heads, tcfg.head_dim]
            for k in ("k", "v", "ck", "cv")}


def _shard_lengths(i, tcfg):
    """The positions (K / V) and frames (cross K / V) a model rank holds:
    its share where the count divides "model", else all of them."""
    S, F = AUDIO_CASES[i][2], tcfg.enc_frames
    s = S // MESH[1] if S % MESH[1] == 0 else S
    f = F // MESH[1] if F % MESH[1] == 0 else F
    return {"k": s, "v": s, "ck": f, "cv": f}


@pytest.mark.parametrize("i", range(len(AUDIO_CASES)), ids=IDS)
def test_each_ranks_cache_is_its_slice_of_one_ranks(i, runs, one_rank):
    """Rank (dr, mr) holds rows [4 dr, 4 dr + 4), positions [16 mr, 16 mr
    + 16) of the self-attention K / V (on 66 positions all of them) and
    frames [4 mr, 4 mr + 4) of the cross K / V of the one-rank cache."""
    tcfg = audio_case(*AUDIO_CASES[i][:2])
    cache = one_rank[i][3]
    B = AUDIO_B // MESH[0]
    n = _shard_lengths(i, tcfg)
    for r in range(8):
        dr, mr = divmod(r, MESH[1])
        got = dict(np.load(runs / f"cache_{i}_{r}.npz"))
        assert set(got) == set(n)
        for k, v in got.items():
            at = mr * n[k] if n[k] < cache[k].shape[2] else 0
            want = cache[k][:, dr * B:(dr + 1) * B,
                            at:at + n[k]].float().numpy()
            if tcfg.dtype == "float32":
                np.testing.assert_allclose(v, want, **TREE_TOL)
            else:
                np.testing.assert_allclose(v, want, rtol=0.0,
                                           atol=BF16_LOGITS)


@pytest.mark.parametrize("i", range(len(AUDIO_CASES)), ids=IDS)
def test_each_rank_gathers_one_unit_at_a_time(i, runs):
    *_, logs = _case(runs, i)
    for log in logs:
        for kind in ("train", "serve"):
            g = log[kind]
            assert g["gathers"] > 0 and g["dtensor"] == [], (kind, g)
            assert g["largest"] <= g["budget"], (kind, g)
            assert g["peak"] <= g["budget"], (kind, g)


@pytest.mark.parametrize("i", range(len(AUDIO_CASES)), ids=IDS)
def test_counts_equal_dryrun_reckoning(i, runs):
    *_, logs = _case(runs, i)
    cfg = audio_case(*AUDIO_CASES[i][:2])
    mesh = AbstractMesh(MESH, ("data", "model"))
    for kind in ("train", "decode"):
        rl, held = dryrun.count_cell(
            cfg, ShapeSpec("mesh", AUDIO_CASES[i][2], AUDIO_B, kind), mesh)
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
cfg = registry.get("whisper-base").reduced()
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
    cfg = treg.get("whisper-base").reduced()
    shape = ShapeSpec("mesh", XLA_SEQ, XLA_BATCH, "train")
    rl, _ = dryrun.count_cell(cfg, shape, AbstractMesh(MESH,
                                                       ("data", "model")))
    assert abs(rl.dot_flops / ref - 1) <= XLA_TOL, (rl.dot_flops, ref)
    # the gathered route: the whole model on the rank's rows
    params = TM.init(cfg, 0, "meta")
    opt = adam(constant_schedule(1e-4))
    rows = dryrun._meta_rows(tspecs.batch_struct(cfg, shape), MESH[0])
    gathered = analysis.analyze(steps.make_train_step(cfg, opt), params,
                                opt.init(params), rows, 0).dot_flops
    assert abs(gathered / ref - 1) > XLA_TOL, (gathered, ref)
