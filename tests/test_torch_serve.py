"""The PyTorch port's serving slice against the JAX reference on the CPU:
the same weights (carried across with ``from_jax_params``) serve the
same requests through both continuous-batching engines; plus the port's
guards (no JAX import, no silent CPU fallback, no fallback build)."""
import ast
import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core.sparsity import SparsityConfig as JSparsity
from repro.models import model as JM
from repro.serve.engine import ContinuousEngine as JEngine
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeConfig as JServeConfig

from repro_torch.configs import registry as treg
from repro_torch.convert import from_jax_params
from repro_torch.core.sparsity import SparsityConfig
from repro_torch.kernels import build, ops
from repro_torch.launch import serve as tserve
from repro_torch.models import model as TM
from repro_torch.serve.engine import ContinuousEngine, Request, ServeConfig
from repro_torch.serve.paged import PagePool

ROOT = Path(__file__).resolve().parents[1]
LOGIT_ATOL = 2e-4   # fp32 through 2 layers: summation order only
TRACE = [(12, 5, 0), (20, 4, 0), (7, 6, 3)]    # (prompt len, max_new, arrival)
SERVE = dict(slots=2, page_size=8, prefill_chunk=8, max_seq=32)


@pytest.fixture(scope="module")
def slice_setup():
    jcfg = dataclasses.replace(
        jreg.get("stablelm-3b").reduced().with_sparsity(
            JSparsity(density=0.5, block=32, where="ffn")),
        dtype="float32", engine="jnp")
    tcfg = dataclasses.replace(
        treg.get("stablelm-3b").reduced().with_sparsity(
            SparsityConfig(density=0.5, block=32, where="ffn")),
        dtype="float32")
    jparams = JM.init(jcfg, jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, tcfg.vocab, size=n).astype(np.int32)
               for n, _, _ in TRACE]
    return jcfg, tcfg, jparams, tparams, prompts


def test_from_jax_params_keeps_every_leaf(slice_setup):
    jcfg, tcfg, jparams, tparams, _ = slice_setup
    assert len(tparams["layers"]) == tcfg.n_layers
    jl = jax.tree_util.tree_leaves_with_path(jparams["layers"])
    for path, leaf in jl:
        keys = [p.key for p in path]
        t = tparams["layers"][1]
        for k in keys:
            t = t[k]
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf)[1])
    assert tparams["layers"][0]["mlp"]["wg"]["idx"].dtype == torch.int32


def test_engines_serve_identical_greedy_tokens(slice_setup):
    jcfg, tcfg, jparams, tparams, prompts = slice_setup
    jreqs = [JRequest(i, p, new, arr)
             for i, (p, (_, new, arr)) in enumerate(zip(prompts, TRACE))]
    treqs = [Request(i, p, new, arr)
             for i, (p, (_, new, arr)) in enumerate(zip(prompts, TRACE))]
    jeng = JEngine(jcfg, jparams, JServeConfig(engine="jnp", **SERVE))
    teng = ContinuousEngine(tcfg, tparams, ServeConfig(**SERVE), device="cpu")
    jout, tout = jeng.serve(jreqs), teng.serve(treqs)
    assert sorted(tout) == sorted(jout) == [0, 1, 2]
    for rid in jout:
        np.testing.assert_array_equal(tout[rid], jout[rid])
    for key in ("ticks", "decode_ticks", "prefill_chunks", "peak_pages"):
        assert teng.stats[key] == jeng.stats[key], key
    # on the CPU the wrappers run their plain versions: no kernel launch
    assert teng.stats["launches"] == dict.fromkeys(ops.launch_counts(), 0)


def test_prefill_and_decode_logits_match_reference(slice_setup):
    """Two prefill chunks of one slot (the second attends over the first
    chunk's pages) and one decode tick with a free slot on the scratch
    page, step by step against the reference."""
    jcfg, tcfg, jparams, tparams, prompts = slice_setup
    P, ps, C, maxp = 9, 8, 8, 4
    jpool = JM.make_paged_cache(jcfg, P, ps)
    tpool = TM.make_paged_cache(tcfg, P, ps)
    row = np.array([3, 5, 7, 0], np.int32)
    prompt = prompts[0]                          # 12 tokens: chunks 8 + 4
    for base in (0, 8):
        cl = min(C, len(prompt) - base)
        buf = np.zeros((1, C), np.int32)
        buf[0, :cl] = prompt[base:base + cl]
        jl, jpool = JM.paged_prefill_chunk(jcfg, jparams, jpool, buf, base,
                                           row, cl)
        tl, tpool = TM.paged_prefill_chunk(
            tcfg, tparams, tpool, torch.from_numpy(buf), base,
            torch.from_numpy(row), cl)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL, rtol=0)
    tok = np.array([[int(np.argmax(np.asarray(jl)[0, -1]))], [0]], np.int32)
    pos = np.array([len(prompt), 0], np.int32)
    pt = np.stack([row, np.zeros(maxp, np.int32)])
    jl, jpool = JM.paged_decode_step(jcfg, jparams, jpool, tok, pos, pt)
    tl, tpool = TM.paged_decode_step(
        tcfg, tparams, tpool, torch.from_numpy(tok), torch.from_numpy(pos),
        torch.from_numpy(pt))
    np.testing.assert_allclose(tl[0].numpy(), np.asarray(jl)[0],
                               atol=LOGIT_ATOL, rtol=0)
    live = [3, 5]                                # pages holding the slot's tokens
    np.testing.assert_allclose(tpool["k"][:, live].numpy(),
                               np.asarray(jpool["k"])[:, live],
                               atol=LOGIT_ATOL, rtol=0)


def test_engine_guard_terminates_nonfinite_slot(slice_setup):
    _, tcfg, _, tparams, prompts = slice_setup
    bad = {**tparams, "embed": {**tparams["embed"],
                                "out": torch.full_like(
                                    tparams["embed"]["out"], float("nan"))}}
    eng = ContinuousEngine(tcfg, bad, ServeConfig(**SERVE), device="cpu")
    out = eng.serve([Request(0, prompts[0], 4)])
    assert eng.nonfinite_terminated == 1
    np.testing.assert_array_equal(out[0], [0])
    assert eng.stats["latency"][0]["outcome"] == "guard"


@pytest.mark.parametrize("prompt,match", [
    (np.array([], np.int32), "non-empty"),
    (np.array([1, 256], np.int32), "token ids"),
    (np.array([-1, 2], np.int32), "token ids"),
    (np.arange(40, dtype=np.int32), "exceeds max_seq"),
])
def test_engine_refuses_bad_requests(slice_setup, prompt, match):
    _, tcfg, _, tparams, _ = slice_setup
    eng = ContinuousEngine(tcfg, tparams, ServeConfig(**SERVE), device="cpu")
    with pytest.raises(ValueError, match=match):
        eng.serve([Request(0, prompt, 2)])


def test_temperature_sampling_is_seeded(slice_setup):
    _, tcfg, _, tparams, prompts = slice_setup
    runs = []
    for _ in range(2):
        eng = ContinuousEngine(
            tcfg, tparams, ServeConfig(temperature=1.0, seed=3, **SERVE),
            device="cpu")
        runs.append(eng.serve([Request(0, prompts[1], 6)])[0])
    np.testing.assert_array_equal(runs[0], runs[1])
    assert len(runs[0]) == 6


def test_page_pool_accounting():
    pool = PagePool(num_pages=5, page_size=4)
    assert pool.pages_for(9) == 3
    a = pool.alloc(3)
    assert 0 not in a and pool.in_use == 3
    assert pool.alloc(2) is None            # all-or-nothing
    pool.release(a)
    assert pool.free_pages == 4 and pool.peak_in_use == 3
    with pytest.raises(ValueError):
        pool.release([0])


# ------------------------------------------------------------------ guards
def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"] + sorted(
        (ROOT / "examples").glob("*_torch.py"))


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_reference(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, name)


def test_entry_points_refuse_a_missing_card(slice_setup):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    _, tcfg, _, tparams, _ = slice_setup
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.init(tcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ContinuousEngine(tcfg, tparams, ServeConfig(**SERVE))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--reduce", "--sparse", "--continuous"])


def test_build_raises_without_nvcc_or_card(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            build.build_all()
        with pytest.raises(RuntimeError):
            build.load("junction_fwd")


def test_launch_serve_runs_on_cpu(capsys):
    outs = tserve.main(["--reduce", "--sparse", "--continuous",
                        "--device", "cpu", "--requests", "3",
                        "--prompt-len", "10", "--max-new", "4",
                        "--slots", "2", "--page-size", "8",
                        "--prefill-chunk", "8"])
    assert sorted(outs) == [0, 1, 2]
    assert all(len(v) == 4 for v in outs.values())
    assert "3/3 requests" in capsys.readouterr().out


def test_port_init_matches_reference_structure():
    """The port's own init builds the reference's tree (list of layers in
    place of the stacked axis) with the same patterns."""
    jcfg = jreg.get("stablelm-3b").reduced().with_sparsity(
        JSparsity(density=0.5, block=32, where="ffn"))
    tcfg = treg.get("stablelm-3b").reduced().with_sparsity(
        SparsityConfig(density=0.5, block=32, where="ffn"))
    jp = jax.tree.map(np.asarray, JM.init(jcfg, jax.random.PRNGKey(0)))
    tp = TM.init(tcfg, seed=0, device="cpu")
    ref = from_jax_params(jp)
    flat_t = jax.tree_util.tree_flatten_with_path(tp)[0]
    flat_r = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert [p for p, _ in flat_t] == [p for p, _ in flat_r]
    for (path, t), (_, r) in zip(flat_t, flat_r):
        assert t.shape == r.shape and t.dtype == r.dtype, path
        if path[-1].key in ("idx", "rev_ob", "rev_t", "rev_cnt"):
            assert torch.equal(t, r), path
    assert ops.launch_counts() == dict.fromkeys(
        ("junction_fwd", "junction_dx", "junction_dw", "junction_update_dw",
         "junction_gated_fwd", "junction_gated_dx", "junction_gated_dw",
         "junction_update_gated_dw", "junction_fwd_int8",
         "junction_gated_fwd_int8", "junction_fwd_fxp", "flash_decode",
         "flash_attention", "selective_scan", "qmatmul", "lut_lookup"), 0)
