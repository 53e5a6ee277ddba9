"""Every architecture of the registry (the dense, vlm, moe, ssm, hybrid
and audio families) at its ``reduced()`` config on the CPU, and the five
configs no port test named before this file held against the JAX
reference.

* Smoke (the twin of tests/test_archs_smoke.py): forward and loss, one
  Adam step that moves the params, one decode step, and the sparse
  variant, on every arch (whisper-base on frames and tokens): shapes and
  finite values.
* Parity with the reference on weights it made, carried across with
  ``convert``: qwen2-72b (QKV bias), deepseek-7b, command-r-plus-104b
  (tied embeddings), falcon-mamba-7b (ssm) and zamba2-2.7b (hybrid, at
  ``n_layers=4``: two super-blocks share the attention block, so its
  gradient sums over both uses).  FFN density 0.5 at block 32, fp32
  compute; the reference runs engine "jnp".
* Contracts: the static cache's state leaves (shapes, axes, growth copied
  whole), the paged path's refusals equal to the reference's, a hybrid
  checkpoint that restores bit for bit, the fused update paths on the ssm tree, and the
  launchers on both new families.

Tolerances: fp32 logits within 2e-4 absolute (the reference's static
serving bound: sums in another order); one two-pass Adam step within
rtol 5e-4 / atol 5e-5 on params and slots, losses within 1e-5 relative
(tests/test_torch_train.py's bounds: Adam's m / sqrt(v) divides a small
gradient by its own magnitude), and where a gradient element sits at the
summation-order noise floor its weight within 2 lr, for at most one
element in 10^4 of a leaf (tests/test_torch_moe.py's rule); caches
within 2e-4; greedy tokens exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core.sparsity import SparsityConfig as JSparsity
from repro.data.pipeline import LMTokenPipeline as JPipeline
from repro.models import model as JM
from repro.optim import adam as jadam
from repro.optim import constant_schedule as jconstant
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro.train.steps import make_train_step as jmake_train_step

from repro_torch.configs import registry as treg
from repro_torch.convert import from_jax_opt_state, from_jax_params
from repro_torch.core.sparsity import SparsityConfig
from repro_torch.data.pipeline import LMTokenPipeline
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import model as TM
from repro_torch.optim import adam, constant_schedule, fused_adam, fused_sgd
from repro_torch.serve import engine as tengine
from repro_torch.serve.engine import ContinuousEngine, Engine, ServeConfig
from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.train.steps import fused_update_eligible, make_train_step
from repro_torch.tree import tree_items, tree_map
from torch_parity_helpers import close_trees, noise_slack

LOGIT_ATOL = 2e-4
LOSS_RTOL = 1e-5
TREE_TOL = dict(rtol=5e-4, atol=5e-5)
PORTED = list(treg.ARCHS)
PARITY = ("qwen2-72b", "deepseek-7b", "command-r-plus-104b",
          "falcon-mamba-7b", "zamba2-2.7b")
STATE_ARCHS = ("falcon-mamba-7b", "zamba2-2.7b")
B, S = 2, 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tokens(cfg, b=B, s=S, seed=7):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, size=(b, s)).astype(np.int32)


def _batch(cfg):
    """Tokens, and for the audio family its encoder's frames."""
    batch = {"tokens": _tokens(cfg)}
    if cfg.family == "audio":
        batch["frames"] = np.random.default_rng(8).standard_normal(
            (B, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    return batch


def _floats(tree):
    return [t for _, t in tree_items(tree)
            if torch.is_tensor(t) and t.is_floating_point()]


# ----------------------------------------------------------------- smoke
def test_ported_archs_are_the_four_families():
    """Every arch of the registry: dense, vlm, moe (with MLA and a dense
    first layer), ssm, hybrid and audio."""
    assert set(PORTED) == {"stablelm-3b", "qwen2-72b", "deepseek-7b",
                           "command-r-plus-104b", "falcon-mamba-7b",
                           "zamba2-2.7b", "qwen3-moe-30b-a3b",
                           "llava-next-mistral-7b", "deepseek-v2-lite-16b",
                           "whisper-base"}
    assert {c.family for c in treg.ARCHS.values()} == set(TM.FAMILIES)


@pytest.mark.parametrize("arch", PORTED)
def test_forward_and_loss(arch):
    cfg = treg.get(arch).reduced()
    params = TM.init(cfg, 0, "cpu")
    batch = _batch(cfg)
    with torch.no_grad():
        loss, _ = TM.loss_fn(cfg, params, batch)
        logits, _, _ = TM.forward(cfg, params, batch)
    assert torch.isfinite(loss), f"{arch}: loss not finite"
    assert tuple(logits.shape) == (B, S, cfg.vocab)
    assert bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("arch", PORTED)
def test_train_step(arch):
    cfg = treg.get(arch).reduced()
    params = TM.init(cfg, 0, "cpu")
    opt = adam(constant_schedule(1e-3))
    p2, _, metrics = make_train_step(cfg, opt)(
        params, opt.init(params), _batch(cfg), 0)
    assert torch.isfinite(metrics["loss"])
    moved = any(not torch.equal(a, b)
                for a, b in zip(_floats(params), _floats(p2)))
    assert moved, f"{arch}: no parameter changed after a step"


@pytest.mark.parametrize("arch", PORTED)
def test_decode_step(arch):
    cfg = treg.get(arch).reduced()
    params = TM.init(cfg, 0, "cpu")
    cache = TM.make_cache(cfg, B, 96)
    shapes = [tuple(t.shape) for _, t in tree_items(cache)]
    with torch.no_grad():
        logits, cache2 = TM.decode_step(cfg, params, cache,
                                        torch.zeros((B, 1), dtype=torch.int32),
                                        3)
    assert tuple(logits.shape) == (B, 1, cfg.vocab)
    assert bool(torch.isfinite(logits).all())
    assert cache2 is cache
    assert [tuple(t.shape) for _, t in tree_items(cache2)] == shapes


@pytest.mark.parametrize("arch", PORTED)
def test_sparse_variant_train_step(arch):
    """The paper's technique applies on every ported arch: at least one
    sparse junction, and a finite loss through it."""
    cfg = treg.get(arch).reduced().with_sparsity(
        SparsityConfig(density=0.5, block=32, where="ffn"))
    params = TM.init(cfg, 0, "cpu")
    n_sparse = sum(1 for p, _ in tree_items(params) if p.endswith("/idx")
                   or p.endswith("/idx_in"))
    assert n_sparse > 0, f"{arch}: technique not applied anywhere"
    with torch.no_grad():
        loss, _ = TM.loss_fn(cfg, params, _batch(cfg))
    assert torch.isfinite(loss)


# ---------------------------------------------------------------- parity
def _pair(name):
    kw = dict(n_layers=4) if name == "zamba2-2.7b" else {}
    jcfg = dataclasses.replace(
        jreg.get(name).reduced().with_sparsity(
            JSparsity(density=0.5, block=32, where="ffn")),
        dtype="float32", engine="jnp", **kw)
    tcfg = dataclasses.replace(
        treg.get(name).reduced().with_sparsity(
            SparsityConfig(density=0.5, block=32, where="ffn")),
        dtype="float32", **kw)
    jparams = jax.tree.map(np.asarray, JM.init(jcfg, jax.random.PRNGKey(0)))
    return jcfg, tcfg, jparams, from_jax_params(jparams)


@pytest.fixture(scope="module", params=PARITY)
def pair(request):
    return _pair(request.param)




def test_params_carry_in_the_ports_layout(pair):
    """from_jax_params gives the tree the port's init builds: the same
    leaf paths, shapes and dtypes (the hybrid's layers a list of
    n_super lists of ev)."""
    _, tcfg, _, tparams = pair
    own = TM.init(tcfg, 0, "cpu")
    got = {p: (tuple(t.shape), t.dtype) for p, t in tree_items(tparams)}
    assert got == {p: (tuple(t.shape), t.dtype)
                   for p, t in tree_items(own)}
    if tcfg.family == "hybrid":
        assert [len(s) for s in tparams["layers"]] == [2, 2]


def test_logits_and_loss_match_reference(pair):
    jcfg, tcfg, jparams, tparams = pair
    toks = _tokens(tcfg)
    jl, _, _ = JM.forward(jcfg, jparams, {"tokens": jnp.asarray(toks)})
    jloss, _ = JM.loss_fn(jcfg, jparams, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        tl, _, _ = TM.forward(tcfg, tparams, {"tokens": toks})
        tloss, _ = TM.loss_fn(tcfg, tparams, {"tokens": toks})
    assert tuple(tl.shape) == jl.shape
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL,
                               rtol=0)
    assert abs(float(tloss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))


def test_two_pass_adam_step_matches_reference(pair):
    jcfg, tcfg, jparams, tparams = pair
    jopt, topt = jadam(jconstant(1e-3)), adam(constant_schedule(1e-3))
    batch = next(JPipeline(jcfg, B, S))
    tbatch = next(LMTokenPipeline(tcfg, B, S))
    np.testing.assert_array_equal(tbatch["tokens"], batch["tokens"])
    jp, js, jm = jmake_train_step(jcfg, jopt, donate=False)(
        jax.tree.map(jnp.asarray, jparams), jopt.init(jparams),
        jax.tree.map(jnp.asarray, batch), jnp.asarray(0))
    tp, ts, tm = make_train_step(tcfg, topt)(tparams, topt.init(tparams),
                                             tbatch, 0)
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= LOSS_RTOL * abs(
        float(jm["loss"]))
    jstate = from_jax_opt_state(jax.tree.map(np.asarray, js))
    slack = noise_slack(ts["m"], jstate["m"], 1e-3)
    close_trees(tp, from_jax_params(jax.tree.map(np.asarray, jp)), slack,
           **TREE_TOL)
    close_trees(ts, jstate, **TREE_TOL)


def test_prefill_and_decode_step_match_reference(pair):
    """The static prefill with its cache, the cache grown to S + 2
    positions (state leaves whole), then one decode step: logits and
    every cache leaf."""
    jcfg, tcfg, jparams, tparams = pair
    toks = _tokens(tcfg, 3, 16, seed=1)
    jl, jc, _ = JM.forward(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                           return_cache=True, last_only=True)
    with torch.no_grad():
        tl, tc, _ = TM.forward(tcfg, tparams, {"tokens": toks},
                               return_cache=True, last_only=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL,
                               rtol=0)
    jc = from_jax_params({"layers": {}, "c": jax.tree.map(np.asarray, jc)}
                         )["c"]
    close_trees(tc, jc, atol=LOGIT_ATOL, rtol=0)
    n = toks.shape[1]
    tok = np.argmax(np.asarray(jl)[:, -1], axis=-1).astype(np.int32)[:, None]
    jfull = JEngine(jcfg, jparams)._grow_cache(
        JM.forward(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                   return_cache=True, last_only=True)[1], 3, n + 2, n)
    jd, jnew = JM.decode_step(jcfg, jparams, jfull, jnp.asarray(tok),
                              jnp.asarray(n, jnp.int32))
    tfull = tengine.Engine(tcfg, tparams, device="cpu")._grow_cache(
        tc, 3, n + 2, n)
    with torch.no_grad():
        td, tnew = TM.decode_step(tcfg, tparams, tfull,
                                  torch.from_numpy(tok), n)
    assert tnew is tfull
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=LOGIT_ATOL,
                               rtol=0)
    close_trees(tnew, from_jax_params({"layers": {}, "c": jax.tree.map(
        np.asarray, jnew)})["c"], atol=LOGIT_ATOL, rtol=0)


def test_static_greedy_tokens_match_reference(pair):
    jcfg, tcfg, jparams, tparams = pair
    prompts = _tokens(tcfg, 3, 8, seed=1)
    want = JEngine(jcfg, jparams, JServeConfig(max_new_tokens=6)
                   ).generate(prompts)
    eng = Engine(tcfg, tparams, ServeConfig(max_new_tokens=6), device="cpu")
    got = eng.generate(prompts)
    np.testing.assert_array_equal(got, want)
    assert eng.nonfinite_terminated == 0


# ------------------------------------------------------------- contracts
@pytest.mark.parametrize("arch", STATE_ARCHS)
def test_make_cache_and_seq_axes_match_reference(arch):
    jcfg, tcfg = jreg.get(arch).reduced(), treg.get(arch).reduced()
    assert TM.cache_seq_axes(tcfg) == JM.cache_seq_axes(jcfg)
    for b, s in ((1, 8), (3, 16)):
        jc = jax.tree_util.tree_leaves_with_path(JM.make_cache(jcfg, b, s))
        tc = list(tree_items(TM.make_cache(tcfg, b, s)))
        assert len(jc) == len(tc)
        for (jpath, ja), (tpath, ta) in zip(jc, tc):
            assert tpath.split("/") == [k.key for k in jpath]
            assert tuple(ta.shape) == ja.shape
            assert ta.dtype == getattr(torch, str(ja.dtype))
            assert not ta.any()


@pytest.mark.parametrize("arch", STATE_ARCHS)
def test_grow_cache_copies_state_leaves_whole(arch):
    """The twin of tests/test_engine.py's growth check: a sequence leaf
    lands at position 0 of its axis with zeros beyond, a state leaf is
    copied whole; a state leaf of another shape is refused."""
    cfg = treg.get(arch).reduced()
    eng = Engine(cfg, {}, ServeConfig(max_new_tokens=4), device="cpu")
    src = tree_map(lambda t: torch.full_like(t, 2.0),
                   TM.make_cache(cfg, 2, 8))
    grown = eng._grow_cache(src, 2, 12, 8)
    axes = dict(tree_items(TM.cache_seq_axes(cfg)))
    srcs = dict(tree_items(src))
    n_state = 0
    for path, dst in tree_items(grown):
        ax = axes[path]
        if ax < 0:
            n_state += 1
            assert torch.equal(dst, srcs[path])
            assert dst.data_ptr() != srcs[path].data_ptr()
        else:
            assert dst.shape[ax] == 12
            d = dst.movedim(ax, 0)
            assert bool((d[:8] == 2).all()) and not d[8:].any()
    assert n_state == 2
    bad = tree_map(lambda t: t, src)
    states = bad if cfg.family == "ssm" else bad["ssm"]
    states["ssm"] = states["ssm"][..., :1]
    with pytest.raises(ValueError, match="state leaf"):
        eng._grow_cache(bad, 2, 12, 8)


@pytest.mark.parametrize("arch", sorted(treg.ARCHS))
def test_paged_supported_matches_reference(arch):
    assert TM.paged_supported(treg.get(arch)) == JM.paged_supported(
        jreg.get(arch))


@pytest.mark.parametrize("arch", STATE_ARCHS)
def test_continuous_engine_and_launcher_refuse_state_families(arch):
    cfg = treg.get(arch).reduced()
    with pytest.raises(ValueError, match="static engine only"):
        ContinuousEngine(cfg, {}, device="cpu")
    with pytest.raises(ValueError, match="paged cache unsupported"):
        TM.make_paged_cache(cfg, 4, 8)
    with pytest.raises(SystemExit, match="--continuous unsupported"):
        tserve.main(["--arch", arch, "--reduce", "--sparse", "--continuous",
                     "--device", "cpu"])


@pytest.mark.parametrize("arch", STATE_ARCHS)
def test_pipeline_makes_the_references_token_batches(arch):
    jcfg, tcfg = jreg.get(arch).reduced(), treg.get(arch).reduced()
    jp, tp = JPipeline(jcfg, 3, 24, seed=2), LMTokenPipeline(tcfg, 3, 24,
                                                              seed=2)
    for _ in range(2):
        np.testing.assert_array_equal(next(tp)["tokens"],
                                      next(jp)["tokens"])


def test_hybrid_checkpoint_restores_bit_for_bit(tmp_path):
    """The hybrid's nested layer lists and its shared block, with Adam's
    slots, through train/checkpoint.py: every leaf equal bit for bit,
    bf16 included."""
    cfg = dataclasses.replace(treg.get("zamba2-2.7b").reduced(), n_layers=4)
    params = TM.init(cfg, 3, "cpu")
    params["shared_attn"]["norm1"]["scale"] = torch.randn(
        cfg.d_model).to(torch.bfloat16)
    opt = adam(constant_schedule(1e-3))
    tree = {"params": params, "opt": opt.init(params)}
    ckpt_mod.save(tmp_path, 5, tree, extra={"n": 1})
    like = tree_map(lambda t: torch.zeros_like(t) if torch.is_tensor(t)
                    else t, tree)
    step, got, extra = ckpt_mod.restore_latest(tmp_path, like)
    assert step == 5 and extra == {"n": 1}
    want = dict(tree_items(tree))
    for path, t in tree_items(got):
        if torch.is_tensor(t):
            assert t.dtype == want[path].dtype, path
            assert t.view(torch.uint8).numpy().tobytes() == want[
                path].view(torch.uint8).numpy().tobytes(), path
    assert [len(s) for s in got["params"]["layers"]] == [2, 2]
    _, part, _ = ckpt_mod.restore_latest(tmp_path, {"params": like["params"]})
    assert torch.equal(part["params"]["layers"][1][1]["ssm"]["in_dt"]["w"],
                       params["layers"][1][1]["ssm"]["in_dt"]["w"])


@pytest.mark.parametrize("kind", ["sgd", "adam_clip"])
def test_fused_update_on_the_ssm_tree(kind):
    """falcon-mamba's junctions (in_proj, out_proj) updated inside their
    backward: one fused step equals the two-pass step of the same
    optimizer (the plain versions of update_dw against dw and
    optimizer.update)."""
    cfg = dataclasses.replace(
        treg.get("falcon-mamba-7b").reduced().with_sparsity(
            SparsityConfig(density=0.5, block=32, where="ffn")),
        dtype="float32", param_dtype="float32")
    opt = (fused_sgd(constant_schedule(3e-2), momentum=0.9) if kind == "sgd"
           else fused_adam(constant_schedule(1e-3), grad_clip=1.0))
    batch = {"tokens": _tokens(cfg)}
    out = {}
    for fused in (False, True):
        c = dataclasses.replace(cfg, fused_update=fused)
        assert fused_update_eligible(c, opt)[0] == fused
        params = TM.init(c, 0, "cpu")
        out[fused] = make_train_step(c, opt)(params, opt.init(params),
                                             batch, 0)
    (p0, s0, m0), (p1, s1, m1) = out[False], out[True]
    assert abs(float(m1["loss"]) - float(m0["loss"])) <= LOSS_RTOL * abs(
        float(m0["loss"]))
    assert float(m1["nonfinite"]) == 0
    close_trees(p1, p0, **TREE_TOL)
    close_trees(s1, s0, **TREE_TOL)


def test_hybrid_refuses_the_fused_update():
    cfg = dataclasses.replace(treg.get("zamba2-2.7b").reduced(),
                              fused_update=True, dtype="float32",
                              param_dtype="float32")
    ok, why = fused_update_eligible(cfg, fused_adam(constant_schedule(1e-3)))
    assert not ok and "hybrid" in why


@pytest.mark.parametrize("arch", STATE_ARCHS)
def test_launchers_train_then_serve_the_checkpoint(arch, tmp_path, capsys):
    ck = tmp_path / "ck"
    res = ttrain.main(["--arch", arch, "--reduce", "--sparse", "--steps", "1",
                       "--batch", "2", "--seq", "16", "--device", "cpu",
                       "--ckpt", str(ck)])
    text = capsys.readouterr().out
    assert res["step"] == 1 and "update path: two-pass" in text
    out = tserve.main(["--arch", arch, "--reduce", "--sparse", "--device",
                       "cpu", "--ckpt", str(ck), "--requests", "2",
                       "--prompt-len", "8", "--max-new", "3"])
    text = capsys.readouterr().out
    assert out.shape == (2, 3)
    assert "restored params from step 1" in text
    if arch == "falcon-mamba-7b":
        out8 = tserve.main(["--arch", arch, "--reduce", "--sparse",
                            "--quantize", "int8", "--device", "cpu",
                            "--requests", "2", "--prompt-len", "8",
                            "--max-new", "3"])
        assert out8.shape == (2, 3)
        assert "quantize=int8 datapath: int8" in capsys.readouterr().out


# ------------------------------------------------ kernels at the new shapes
def _cu_int(name, const):
    """An integer constant of a CUDA source, read from its text."""
    import re
    from pathlib import Path
    src = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
           / "csrc" / name).read_text()
    m = re.search(rf"constexpr int {const} = ([0-9]+)( \* 1024)?;", src)
    return int(m.group(1)) * (1024 if m.group(2) else 1)


@pytest.mark.parametrize("arch,junction,n_in,n_out,kb", [
    ("falcon-mamba-7b", "in_proj", 4096, 16384, 8),
    ("falcon-mamba-7b", "out_proj", 8192, 4096, 16),
    ("zamba2-2.7b", "in_z", 2560, 5120, 5),
    ("zamba2-2.7b", "in_xbc", 2560, 5248, 5),
    ("zamba2-2.7b", "out_proj", 5120, 2560, 10),
    ("zamba2-2.7b", "wi", 2560, 10240, 5),
    ("zamba2-2.7b", "wo", 10240, 2560, 20),
    ("qwen2-72b", "wo", 29568, 8192, 58),
    ("command-r-plus-104b", "wo", 33792, 12288, 66),
    ("llava-next-mistral-7b", "wi", 4096, 14336, 8),
    ("llava-next-mistral-7b", "wo", 14336, 4096, 28),
    ("deepseek-v2-lite-16b", "expert in", 2048, 1408, 4),
    ("deepseek-v2-lite-16b", "expert out", 1408, 2048, 3),
    ("deepseek-v2-lite-16b", "shared wi", 2048, 2816, 4),
    ("deepseek-v2-lite-16b", "shared wo", 2816, 2048, 6)])
def test_new_junction_shapes_fit_the_kernels(arch, junction, n_in, n_out,
                                             kb):
    """The junctions these configs bring to the kernels (kb up to 66, 41
    output blocks): the block pattern the model builds has the stated
    fan-in; the bf16 route takes the tensor cores at every row count the
    paths give them (8 decode rows, 256 prefill rows, 2048 train rows);
    the int8 plan covers every slot, and its dynamic shared memory (the
    launcher's ``int8_smem``) stays within ``kMaxSmem`` on both paths;
    and the grids stay within CUDA's limits."""
    from repro_torch.core.sparsity import make_block_pattern
    from repro_torch.kernels import block_sparse_matmul as bsm
    bs = 128
    pat = make_block_pattern(n_in, n_out, 0.25, bs, seed=0)
    assert (pat.n_out_blocks, pat.fan_in_blocks) == (n_out // bs, kb)
    assert (pat.rev_cnt >= 1).all() and pat.rev_cnt.sum() == pat.n_out_blocks * kb
    max_smem = _cu_int("junction_quant.cu", "kMaxSmem")
    stages = _cu_int("junction_quant.cu", "kInt8Stages")
    mma_vals = _cu_int("junction_quant.cu", "kMmaVals")
    nob = n_out // bs
    for M in (1, 8, 256, 2048):
        if M >= bsm.TC_MIN_M:
            assert bsm.junction_variant(torch.bfloat16, M, bs) == "tc"
        for gated in (False, True):
            variant, rows, run, nsplit = bsm.int8_plan(1, M, nob, kb, bs)
            assert run * nsplit >= kb > run * (nsplit - 1)
            rt = bsm.int8_rows_pad(variant, rows)
            warps, vals = 4, (mma_vals if variant == "mma" else rt * 4)
            tiles = (2 if gated else 1) * run
            smem = (min(tiles, stages) * bs * bs + warps * vals * 32 * 4
                    + run * rt * 4 + run * rt * (bs + 16))
            assert smem <= max_smem, (M, gated, smem)
            assert nob * nsplit <= 2 ** 31 - 1 and -(-M // rows) <= 65535
        assert -(-M // _cu_int("junction_tc.cu", "kBM")) <= 65535
    assert kb * bs <= 2 ** 31 - 1 and nob <= 65535
