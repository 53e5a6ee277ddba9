"""The port's static engine and checkpoint serving against the JAX
reference on the CPU: ``decode_attention`` / ``gqa_decode``, the static
cache (``make_cache``, ``cache_seq_axes``), the prefill forward with its
cache, ``Engine.generate`` (greedy tokens, the non-finite guard, eos
masking, seeded temperature sampling, refusals), static against
continuous serving, ``launch/serve.py`` without ``--continuous`` and
with ``--ckpt`` on a checkpoint ``launch/train.py`` wrote, and the two
example scripts.

Configs: reduced stablelm-3b and qwen3-moe-30b-a3b, FFN density 0.5,
block 32, fp32; weights made by the reference and carried across with
``convert.from_jax_params``.  Tolerances: attention within 2e-5 and
whole-model logits within 2e-4 (fp32 sums in another order); tokens
exact.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core.sparsity import SparsityConfig as JSparsity
from repro.models import attention as JA
from repro.models import model as JM
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig

from repro_torch.configs import registry as treg
from repro_torch.convert import from_jax_params
from repro_torch.core.sparsity import SparsityConfig
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import attention as TA
from repro_torch.models import model as TM
from repro_torch.serve import engine as tengine
from repro_torch.serve.engine import (ContinuousEngine, Engine, Request,
                                      ServeConfig)
from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.tree import tree_items, tree_map

ROOT = Path(__file__).resolve().parents[1]
ATTN_TOL = dict(atol=2e-5, rtol=2e-5)
LOGIT_ATOL = 2e-4
ARCHS = ("stablelm-3b", "qwen3-moe-30b-a3b")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(name):
    jcfg = dataclasses.replace(
        jreg.get(name).reduced().with_sparsity(
            JSparsity(density=0.5, block=32, where="ffn")),
        dtype="float32", engine="jnp")
    tcfg = dataclasses.replace(
        treg.get(name).reduced().with_sparsity(
            SparsityConfig(density=0.5, block=32, where="ffn")),
        dtype="float32")
    jparams = JM.init(jcfg, jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams))
    prompts = np.random.default_rng(1).integers(
        0, tcfg.vocab, size=(3, 8)).astype(np.int32)
    return jcfg, tcfg, jparams, tparams, prompts


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    return _setup(request.param)


def _layer0(jparams):
    return jax.tree.map(lambda t: t[0], jparams["layers"])


# ------------------------------------------------------------- attention
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos", [0, 5, 11])
def test_decode_attention_matches_reference(dtype, pos):
    rng = np.random.default_rng(pos)
    B, S, H, Hkv, D = 2, 12, 8, 2, 32
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = JA.decode_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                               pos)
    got = TA.decode_attention(*(torch.from_numpy(a).to(tdt)
                                for a in (q, k, v)), pos)
    assert got.dtype == tdt and tuple(got.shape) == (B, 1, H, D)
    tol = ATTN_TOL if dtype == "float32" else dict(atol=1e-2, rtol=1e-2)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)
    # positions past pos take no part: finite garbage there changes
    # nothing (their probability is exactly 0, as in the reference)
    k2, v2 = k.copy(), v.copy()
    k2[:, pos + 1:] = 1e6
    v2[:, pos + 1:] = -1e6
    got2 = TA.decode_attention(*(torch.from_numpy(a).to(tdt)
                                 for a in (q, k2, v2)), pos)
    assert torch.equal(got2, got)


def test_gqa_decode_matches_reference(setup):
    """One decode token at pos 6 of a cache holding 6 tokens: the output,
    and the cache with the new K / V written at slot 6."""
    jcfg, tcfg, jparams, tparams, _ = setup
    rng = np.random.default_rng(2)
    B, S, pos = 2, 10, 6
    x = rng.standard_normal((B, 1, tcfg.d_model)).astype(np.float32)
    shape = (B, S, tcfg.kv_heads, tcfg.head_dim)
    k = np.zeros(shape, np.float32)
    v = np.zeros(shape, np.float32)
    k[:, :pos] = rng.standard_normal((B, pos) + shape[2:])
    v[:, :pos] = rng.standard_normal((B, pos) + shape[2:])
    jout, jc = JA.gqa_decode(_layer0(jparams)["attn"], jnp.asarray(x), jcfg,
                             {"k": jnp.asarray(k), "v": jnp.asarray(v)},
                             pos)
    tc = {"k": torch.from_numpy(k), "v": torch.from_numpy(v)}
    tout, tc2 = TA.gqa_decode(tparams["layers"][0]["attn"],
                              torch.from_numpy(x), tcfg, tc, pos)
    assert tc2["k"] is tc["k"]          # written in place
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **ATTN_TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   **ATTN_TOL)


# ------------------------------------------------------------------ cache
def test_make_cache_and_seq_axes_match_reference(setup):
    jcfg, tcfg, _, _, _ = setup
    for b, s in ((1, 8), (3, 16)):
        jc, tc = JM.make_cache(jcfg, b, s), TM.make_cache(tcfg, b, s)
        assert set(tc) == set(jc)
        for key in jc:
            assert tuple(tc[key].shape) == jc[key].shape
            assert tc[key].dtype == tcfg.compute_dtype
            assert not tc[key].any()
    assert TM.cache_seq_axes(tcfg) == JM.cache_seq_axes(jcfg)


def test_grow_cache_places_by_metadata(setup):
    _, tcfg, _, tparams, _ = setup
    eng = Engine(tcfg, tparams, ServeConfig(max_new_tokens=4), device="cpu")
    src = {k: torch.ones_like(v) for k, v in
           TM.make_cache(tcfg, 2, 8).items()}
    grown = eng._grow_cache(src, 2, 12, 8)
    for key, ax in TM.cache_seq_axes(tcfg).items():
        d = grown[key].movedim(ax, 0)
        assert d.shape[0] == 12
        assert bool((d[:8] == 1).all()) and not d[8:].any()


def test_prefill_forward_matches_reference(setup):
    jcfg, tcfg, jparams, tparams, prompts = setup
    jl, jc, _ = JM.forward(jcfg, jparams, {"tokens": jnp.asarray(prompts)},
                           return_cache=True, last_only=True)
    with torch.no_grad():
        tl, tc, _ = TM.forward(tcfg, tparams,
                               {"tokens": torch.from_numpy(prompts)},
                               return_cache=True, last_only=True)
    assert tuple(tl.shape) == jl.shape == (3, 1, tcfg.vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL,
                               rtol=0)
    for key in ("k", "v"):
        assert tuple(tc[key].shape) == jc[key].shape
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   atol=LOGIT_ATOL, rtol=0)
    # one decode step from that cache, as the reference's
    S = prompts.shape[1]
    tok = np.argmax(np.asarray(jl)[:, -1], axis=-1).astype(np.int32)[:, None]
    jfull = JM.make_cache(jcfg, 3, S + 2)
    jfull = {k: jfull[k].at[:, :, :S].set(jc[k]) for k in jfull}
    jd, _ = JM.decode_step(jcfg, jparams, jfull, jnp.asarray(tok), S)
    tfull = TM.make_cache(tcfg, 3, S + 2)
    for k in tfull:
        tfull[k][:, :, :S] = tc[k]
    with torch.no_grad():
        td, tfull2 = TM.decode_step(tcfg, tparams, tfull,
                                    torch.from_numpy(tok), S)
    assert tfull2["k"] is tfull["k"]
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=LOGIT_ATOL,
                               rtol=0)


# ----------------------------------------------------------------- engine
def test_generate_greedy_matches_reference(setup):
    jcfg, tcfg, jparams, tparams, prompts = setup
    want = JEngine(jcfg, jparams, JServeConfig(max_new_tokens=6)
                   ).generate(prompts)
    eng = Engine(tcfg, tparams, ServeConfig(max_new_tokens=6), device="cpu")
    got = eng.generate(prompts)
    assert got.dtype == np.int32 and got.shape == (3, 6)
    np.testing.assert_array_equal(got, want)
    assert eng.nonfinite_terminated == 0


def test_generate_int8_matches_reference(setup):
    jcfg, tcfg, jparams, tparams, prompts = setup
    want = JEngine(jcfg, jparams, JServeConfig(max_new_tokens=4,
                                               quantize="int8")
                   ).generate(prompts)
    got = Engine(tcfg, tparams, ServeConfig(max_new_tokens=4,
                                            quantize="int8"),
                 device="cpu").generate(prompts)
    np.testing.assert_array_equal(got, want)


def test_static_equals_continuous_on_uniform_prompts():
    """The reference's contract (tests/test_serve_continuous.py), on the
    dense family: a MoE layer's expert capacity follows the tokens of a
    call (the static batch's prefill against one slot's chunk), so its
    drops, and its tokens, may differ between the engines."""
    _, tcfg, _, tparams, prompts = _setup("stablelm-3b")
    static = Engine(tcfg, tparams, ServeConfig(max_new_tokens=6),
                    device="cpu").generate(prompts)
    ce = ContinuousEngine(tcfg, tparams, ServeConfig(
        max_new_tokens=6, slots=2, page_size=8, prefill_chunk=8,
        max_seq=32), device="cpu")
    outs = ce.serve([Request(i, prompts[i], 6) for i in range(3)])
    for i in range(3):
        np.testing.assert_array_equal(outs[i], static[i])


def _poison(eng, rows, value, from_call):
    orig, calls = eng._decode, {"n": 0}

    def poisoned(params, cache, tok, pos):
        logits, cache = orig(params, cache, tok, pos)
        calls["n"] += 1
        if calls["n"] >= from_call:
            logits = logits.clone()
            logits[rows] = value
        return logits, cache

    eng._decode = poisoned


def test_guard_terminates_nonfinite_slot(setup):
    """Non-finite logits in one row from decode call 2 on: that row is
    eos-filled from output column 2 and counted; the others are
    untouched (tests/test_guardian.py's contract)."""
    _, tcfg, _, tparams, prompts = setup
    eos = 5
    eng = Engine(tcfg, tparams, ServeConfig(max_new_tokens=6, eos_token=eos),
                 device="cpu")
    clean = eng.generate(prompts)
    assert eng.nonfinite_terminated == 0
    _poison(eng, 0, float("nan"), 2)
    out = eng.generate(prompts)
    assert eng.nonfinite_terminated == 1
    assert (out[0, 2:] == eos).all()
    np.testing.assert_array_equal(out[1:], clean[1:])


def test_guard_without_eos_masks_slot(setup):
    _, tcfg, _, tparams, prompts = setup
    eng = Engine(tcfg, tparams, ServeConfig(max_new_tokens=5), device="cpu")
    clean = eng.generate(prompts[:2])
    _poison(eng, 1, float("inf"), 1)
    out = eng.generate(prompts[:2])
    assert eng.nonfinite_terminated == 1
    assert (out[1, 1:] == 0).all()
    np.testing.assert_array_equal(out[0], clean[0])
    # the count is refreshed a call, never stale
    eng._decode = tengine.make_decode_step(tcfg)
    eng.generate(prompts[:2])
    assert eng.nonfinite_terminated == 0


def test_eos_slot_masking_keeps_decode_shape_stable(setup):
    _, tcfg, _, tparams, prompts = setup
    n_new = 6
    free = Engine(tcfg, tparams, ServeConfig(max_new_tokens=n_new),
                  device="cpu").generate(prompts)
    eos = int(free[0, 1])
    eng = Engine(tcfg, tparams, ServeConfig(max_new_tokens=n_new,
                                            eos_token=eos), device="cpu")
    calls = []
    orig = eng._decode

    def spy(params, cache, tok, pos):
        calls.append(tuple(tok.shape))
        return orig(params, cache, tok, pos)

    eng._decode = spy
    tok = eng.generate(prompts)
    assert tok.shape == (3, n_new)
    assert len(calls) == n_new - 1 and all(s == (3, 1) for s in calls)
    for b in range(3):
        row = tok[b]
        hits = np.flatnonzero(row == eos)
        if hits.size:
            np.testing.assert_array_equal(row[hits[0]:], eos)
        stop = hits[0] + 1 if hits.size else n_new
        np.testing.assert_array_equal(row[:stop], free[b, :stop])


def test_temperature_sampling_deterministic_under_seed(setup):
    """One generator seeded from ServeConfig.seed, advanced once a sample
    (every sample sees a fresh generator state): the same seed gives the
    same tokens, another seed other tokens."""
    _, tcfg, _, tparams, prompts = setup

    def gen(seed):
        scfg = ServeConfig(max_new_tokens=8, temperature=1.0, seed=seed)
        return Engine(tcfg, tparams, scfg, device="cpu").generate(prompts)

    np.testing.assert_array_equal(gen(3), gen(3))
    assert not np.array_equal(gen(3), gen(4))
    eng = Engine(tcfg, tparams, ServeConfig(max_new_tokens=4,
                                            temperature=1.0, seed=3),
                 device="cpu")
    states = []
    orig = eng._sample

    def spy(logits, g):
        states.append(g.get_state().clone())
        return orig(logits, g)

    eng._sample = spy
    eng.generate(prompts)
    assert len(states) == 4
    assert all(not torch.equal(a, b) for i, a in enumerate(states)
               for b in states[i + 1:])


def test_quantize_fxp_refused(setup):
    _, tcfg, _, tparams, _ = setup
    with pytest.raises(ValueError, match="int8"):
        Engine(tcfg, tparams, ServeConfig(quantize="fxp"), device="cpu")


def test_engine_refuses_a_missing_card(setup):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    _, tcfg, _, tparams, _ = setup
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(tcfg, tparams)


# ---------------------------------------------------- launchers, ckpt
def test_serve_launcher_static_on_cpu(capsys):
    out = tserve.main(["--reduce", "--sparse", "--device", "cpu",
                       "--requests", "3", "--prompt-len", "8",
                       "--max-new", "4"])
    text = capsys.readouterr().out
    assert out.shape == (3, 4)
    assert "[serve] generated (3, 4) in" in text and "tok/s" in text
    out8 = tserve.main(["--reduce", "--sparse", "--device", "cpu",
                        "--quantize", "int8", "--requests", "2",
                        "--prompt-len", "8", "--max-new", "3"])
    assert out8.shape == (2, 3)
    assert "quantize=int8 datapath" in capsys.readouterr().out


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A checkpoint of one SGD step of the reduced sparse stablelm-3b,
    written by ``launch/train.py``, and its in-memory result."""
    ck = tmp_path_factory.mktemp("ckpt")
    res = ttrain.main(["--reduce", "--sparse", "--optim", "sgd", "--steps",
                       "1", "--batch", "2", "--seq", "16", "--device", "cpu",
                       "--ckpt", str(ck)])
    return ck, res


def _spy_engines(monkeypatch):
    """Record (engine class, cfg, params, args, kwargs) of every engine
    the launcher builds."""
    seen = []
    for name in ("Engine", "ContinuousEngine"):
        base = getattr(tengine, name)

        def spy(cfg, params, *a, _base=base, **kw):
            seen.append((_base, cfg, params, a, kw))
            return _base(cfg, params, *a, **kw)

        monkeypatch.setattr(tengine, name, spy)
    return seen


@pytest.mark.parametrize("mode", ["static", "continuous"])
def test_serve_ckpt_restores_what_train_saved(trained, mode, monkeypatch,
                                              capsys):
    ck, res = trained
    seen = _spy_engines(monkeypatch)
    argv = ["--reduce", "--sparse", "--device", "cpu", "--ckpt", str(ck),
            "--requests", "3", "--prompt-len", "8", "--max-new", "4"]
    out = tserve.main(argv + (["--continuous"] if mode == "continuous"
                              else []))
    assert "[serve] restored params from step 1" in capsys.readouterr().out
    ((cls, cfg, served, a, kw),) = seen
    assert (cls is Engine) == (mode == "static")
    got, want = dict(tree_items(served)), dict(tree_items(res["params"]))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert got[k].numpy().tobytes() == want[k].numpy().tobytes(), k
    # the same tokens as the same engine serving the trained params held
    # in memory
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, size=(3, 8)).astype(np.int32)
    eng = cls(cfg, res["params"], *a, **kw)
    if mode == "static":
        np.testing.assert_array_equal(out, eng.generate(prompts))
    else:
        ref = eng.serve([Request(i, prompts[i], 4) for i in range(3)])
        for i in range(3):
            np.testing.assert_array_equal(out[i], ref[i])


def test_ckpt_restore_refuses_another_shape_and_casts_dtype(trained):
    ck, res = trained
    cfg = treg.get("stablelm-3b").reduced()
    other = TM.init(cfg.with_sparsity(SparsityConfig(
        density=0.5, block=32, where="ffn")), 0, "cpu")
    with pytest.raises(ckpt_mod.CheckpointMismatch, match="saved"):
        ckpt_mod.restore_latest(ck, {"params": other})
    with pytest.raises(ckpt_mod.CheckpointMismatch, match="subtree"):
        ckpt_mod.restore_latest(ck, {"params": TM.init(cfg, 0, "cpu")})
    like = {"params": tree_map(
        lambda t: t.to(torch.bfloat16) if t.is_floating_point() else t,
        res["params"])}
    _, tree, _ = ckpt_mod.restore_latest(ck, like)
    got, want = dict(tree_items(tree["params"])), dict(
        tree_items(res["params"]))
    for k in want:
        if want[k].is_floating_point():
            assert got[k].dtype == torch.bfloat16
            assert torch.equal(got[k], want[k].to(torch.bfloat16))
    # the whole tree still restores as before
    step, full, _ = ckpt_mod.restore_latest(
        ck, {"params": res["params"], "opt": res["opt_state"]})
    assert step == 1 and full["opt"] is not None


# ----------------------------------------------------------------- examples
def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", ARCHS)
def test_example_serve_batched_runs_on_cpu(arch, capsys):
    out = _example("serve_batched_torch").main([
        "--arch", arch, "--device", "cpu", "--requests", "2",
        "--prompt-len", "8", "--max-new", "3"])
    assert out.shape == (2, 3)
    assert "tok/s" in capsys.readouterr().out


def test_example_train_sparse_lm_runs_on_cpu(tmp_path, capsys):
    res = _example("train_sparse_lm_torch").main([
        "--reduce", "--device", "cpu", "--steps", "2", "--batch", "2",
        "--seq", "16", "--ckpt", str(tmp_path / "ck")])
    assert res["step"] == 2
    assert "sparse model:" in capsys.readouterr().out
    assert ckpt_mod.latest_step(tmp_path / "ck") == 2
