"""The port's quantized serving slice against the JAX reference on the
CPU: ``quantize_tree``, weights carried across with ``convert``, int8
serving of reduced stablelm-3b and qwen3-moe through both continuous
engines (``quantize="int8"``), and the refusals of the inference-only
datapath.

Configs: reduced stablelm-3b with FFN sparsity 0.5, block 32, and the
reduced qwen3-moe of ``test_torch_moe.py`` (GQA rep 8, head_dim 128,
d_expert 128, fan-in 2 on both expert junctions), fp32.  The reference
serves on its jnp engine (``apply_quant_jnp`` / ``expert_apply_int8``);
the port's wrappers run their plain versions.

Tolerances: logits 2e-4 after 2 layers, as the fp32 slices.  The
activation codes come from the same fp32 values on both sides; an input
that lands within its summation-order noise of a half-way point between
two codes would move one code, which did not happen at these seeds
(greedy tokens equal, logits within the fp32 bound).
"""
import ast
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core import quantize as jqz
from repro.core.sparsity import SparsityConfig as JSparsity
from repro.models import model as JM
from repro.serve.engine import ContinuousEngine as JEngine
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeConfig as JServeConfig

from repro_torch.configs import registry as treg
from repro_torch.convert import from_jax_params
from repro_torch.core import quantize as tqz
from repro_torch.core import sparse_linear as tsl
from repro_torch.core.sparsity import SparsityConfig
from repro_torch.launch import serve as tserve
from repro_torch.models import model as TM
from repro_torch.serve.engine import ContinuousEngine, Request, ServeConfig
from repro_torch.tree import tree_items

ROOT = Path(__file__).resolve().parents[1]
LOGIT_ATOL = 2e-4
TRACE = [(12, 5, 0), (20, 4, 0), (7, 6, 3)]    # (prompt len, max_new, arrival)
SERVE = dict(slots=2, page_size=8, prefill_chunk=8, max_seq=32)
Q8 = tqz.QuantConfig(mode="int8")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dense_cfgs():
    def cfg(reg, sp):
        return dataclasses.replace(
            reg.get("stablelm-3b").reduced().with_sparsity(
                sp(density=0.5, block=32, where="ffn")), dtype="float32")
    return cfg(jreg, JSparsity), cfg(treg, SparsityConfig)


def _moe_cfgs():
    def cfg(reg, sp):
        c = reg.get("qwen3-moe-30b-a3b").reduced()
        c = dataclasses.replace(
            c, n_heads=8, kv_heads=1, head_dim=128, dtype="float32",
            moe=dataclasses.replace(c.moe, d_expert=128))
        return c.with_sparsity(sp(density=0.5, block=32, where="ffn"))
    return cfg(jreg, JSparsity), cfg(treg, SparsityConfig)


def _setup(cfgs):
    jcfg, tcfg = cfgs
    jparams = JM.init(jcfg, jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jparams)
    return jcfg, tcfg, jparams, np_params, from_jax_params(np_params)


@pytest.fixture(scope="module")
def dense():
    return _setup(_dense_cfgs())


@pytest.fixture(scope="module")
def moe():
    return _setup(_moe_cfgs())


def _prompts(vocab, seed=2):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32)
            for n, _, _ in TRACE]


# ---------------------------------------------------------- quantize_tree
@pytest.mark.parametrize("which", ["dense", "moe"])
def test_quantize_tree_matches_reference_and_is_idempotent(which, request):
    jcfg, tcfg, jparams, np_params, tparams = request.getfixturevalue(which)
    tq = tqz.quantize_tree(tparams, Q8)
    # the reference's quantized tree, carried across: every leaf equal
    jq = from_jax_params(jax.tree.map(np.asarray,
                                      jqz.quantize_tree(jparams, jqz.QuantConfig())))
    ft, fr = dict(tree_items(tq)), dict(tree_items(jq))
    assert ft.keys() == fr.keys()
    for path, t in ft.items():
        assert t.dtype == fr[path].dtype, path
        assert torch.equal(t, fr[path]), path
    for lp, fp_lp in zip(tq["layers"], tparams["layers"]):
        if which == "dense":
            for k in ("wg", "wi", "wo"):
                j = lp["mlp"][k]
                assert tsl.is_sparse(j) and tsl.is_quantized(j)
                assert "w" not in j and j["wq"].dtype == torch.int8
                assert "w" in fp_lp["mlp"][k]      # the caller's tree stays fp
            # attention projections stay dense and fp
            assert all(v.is_floating_point()
                       for _, v in tree_items(lp["attn"]))
        else:
            m = lp["moe"]
            assert not {"wg", "wi", "wo"} & set(m) and "wg" in fp_lp["moe"]
            assert all(m[k].dtype == torch.int8 for k in ("wgq", "wiq", "woq"))
            assert m["router"].dtype == torch.float32
    # idempotent: a quantized tree comes back with the same tensors
    again = tqz.quantize_tree(tq, Q8)
    assert all(a is b for (_, a), (_, b) in zip(tree_items(again),
                                                  tree_items(tq)))


def test_convert_keeps_integer_widths(dense):
    """A quantized reference tree carried across reaches the kernels with
    int8 codes, int32 patterns and int32 fxp codes (int64 narrows)."""
    _, _, jparams, _, _ = dense
    jq = jax.tree.map(np.asarray, jqz.quantize_tree(jparams,
                                                    jqz.QuantConfig()))
    tq = from_jax_params(jq)
    wg = tq["layers"][0]["mlp"]["wg"]
    assert wg["wq"].dtype == torch.int8 and wg["idx"].dtype == torch.int32
    assert wg["w_scale"].dtype == torch.float32
    jf = {"wq": np.asarray(jqz.fxp_encode_weights(
              np.ones((2, 1, 32, 32), np.float32), jqz.PAPER_FMT)),
          "n": np.arange(3, dtype=np.int64)}
    tf = from_jax_params({"layers": {"norm1": {"scale": np.ones((1, 4))}},
                          **jf})
    assert tf["wq"].dtype == torch.int32 and tf["n"].dtype == torch.int32


# ------------------------------------------------------------------ serving
@pytest.mark.parametrize("which", ["dense", "moe"])
def test_int8_serving_gives_reference_greedy_tokens(which, request):
    jcfg, tcfg, jparams, _, tparams = request.getfixturevalue(which)
    prompts = _prompts(tcfg.vocab)
    jreqs = [JRequest(i, p, new, arr)
             for i, (p, (_, new, arr)) in enumerate(zip(prompts, TRACE))]
    treqs = [Request(i, p, new, arr)
             for i, (p, (_, new, arr)) in enumerate(zip(prompts, TRACE))]
    jeng = JEngine(jcfg, jparams, JServeConfig(engine="jnp", quantize="int8",
                                               **SERVE))
    teng = ContinuousEngine(tcfg, tparams, ServeConfig(quantize="int8",
                                                       **SERVE), device="cpu")
    jout, tout = jeng.serve(jreqs), teng.serve(treqs)
    assert sorted(tout) == sorted(jout) == [0, 1, 2]
    for rid in jout:
        np.testing.assert_array_equal(tout[rid], jout[rid])
    # every FFN junction of the served tree is quantized
    assert all(tqz.is_quantized(lp["moe"] if which == "moe"
                                else lp["mlp"]["wg"])
               for lp in teng.params["layers"])


@pytest.mark.parametrize("which", ["dense", "moe"])
def test_int8_prefill_and_decode_logits_match_reference(which, request):
    """One prefill chunk and one decode tick on the quantized trees, the
    port's through its engine-facing model functions."""
    jcfg, tcfg, jparams, _, tparams = request.getfixturevalue(which)
    jcfg = dataclasses.replace(jcfg, engine="jnp")
    jq = jqz.quantize_tree(jparams, jqz.QuantConfig())
    tq = tqz.quantize_tree(tparams, Q8)
    P, ps, C = 9, 8, 8
    jpool = JM.make_paged_cache(jcfg, P, ps)
    tpool = TM.make_paged_cache(tcfg, P, ps)
    row = np.array([3, 5, 7, 0], np.int32)
    buf = _prompts(tcfg.vocab)[1][None, :C]
    jl, jpool = JM.paged_prefill_chunk(jcfg, jq, jpool, buf, 0, row, C)
    tl, tpool = TM.paged_prefill_chunk(tcfg, tq, tpool, torch.from_numpy(buf),
                                       0, torch.from_numpy(row), C)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL,
                               rtol=0)
    tok = np.array([[int(np.argmax(np.asarray(jl)[0, -1]))], [0]], np.int32)
    pos = np.array([C, 0], np.int32)
    pt = np.stack([row, np.zeros(4, np.int32)])
    jl, _ = JM.paged_decode_step(jcfg, jq, jpool, tok, pos, pt)
    tl, _ = TM.paged_decode_step(tcfg, tq, tpool, torch.from_numpy(tok),
                                 torch.from_numpy(pos), torch.from_numpy(pt))
    np.testing.assert_allclose(tl[0].numpy(), np.asarray(jl)[0],
                               atol=LOGIT_ATOL, rtol=0)


_MOE_SCALES = {
    "dynamic": {},
    "per_expert": {"x_scale_in": np.full(8, 0.03, np.float32),
                   "x_scale_out": np.full(8, 0.002, np.float32)},
}


def _moe_layer_and_x(moe, scales):
    jcfg, tcfg, _, np_params, _ = moe
    layer = jax.tree.map(lambda a: a[0], np_params["layers"]["moe"])
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 32, 128)).astype(np.float32)
    jl = jqz.quantize_junction(jax.tree.map(jnp.asarray, layer),
                               jqz.QuantConfig(), **scales)
    tl = {k: torch.from_numpy(np.array(v)) for k, v in jl.items()}
    return jcfg, tcfg, jl, tl, x


@pytest.mark.parametrize("scales", sorted(_MOE_SCALES))
def test_moe_quantized_experts_match_reference_on_both_engines(moe, scales):
    """moe_apply on a quantized layer: the kernel route (gated_fwd_int8
    then fwd_int8) and the plain route (expert_apply_int8) against the
    reference's jnp route, with dynamic and calibrated static scales."""
    from repro.models import moe as jmoe
    from repro_torch.models import moe as tmoe
    jcfg, tcfg, jl, tl, x = _moe_layer_and_x(moe, _MOE_SCALES[scales])
    jy, _ = jmoe.moe_apply(jl, jnp.asarray(x),
                           dataclasses.replace(jcfg, engine="jnp"))
    for engine in ("pallas", "jnp"):
        ty, _ = tmoe.moe_apply(tl, torch.from_numpy(x),
                               dataclasses.replace(tcfg, engine=engine))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5,
                                   rtol=1e-5)


def test_moe_refuses_one_scale_for_all_experts_on_both_engines(moe):
    """A calibrated expert scale is one per expert: a single scale for
    all eight is refused by the kernel route and the plain route alike,
    as the reference's own route refuses it."""
    from repro.models import moe as jmoe
    from repro_torch.models import moe as tmoe
    jcfg, tcfg, jl, tl, x = _moe_layer_and_x(
        moe, {"x_scale_in": np.float32(0.03),
              "x_scale_out": np.float32(0.002)})
    with pytest.raises(TypeError, match="reshape"):
        jmoe.moe_apply(jl, jnp.asarray(x),
                       dataclasses.replace(jcfg, engine="jnp"))
    for engine in ("pallas", "jnp"):
        with pytest.raises(ValueError, match="1 scale.s. for 8 units"):
            tmoe.moe_apply(tl, torch.from_numpy(x),
                           dataclasses.replace(tcfg, engine=engine))


# ----------------------------------------------------------------- refusals
def test_serve_refuses_fxp_and_unknown_modes(dense):
    _, tcfg, _, _, tparams = dense
    for mode in ("fxp", "int4"):
        with pytest.raises(ValueError, match="'int8' only"):
            ContinuousEngine(tcfg, tparams, ServeConfig(quantize=mode,
                                                        **SERVE), device="cpu")


def test_fxp_refused_for_moe_experts(moe):
    _, _, _, _, tparams = moe
    with pytest.raises(ValueError, match="plain junctions only"):
        tqz.quantize_junction(tparams["layers"][0]["moe"],
                              tqz.QuantConfig(mode="fxp"))


def test_training_refuses_quantized_junctions(dense, moe):
    """The fused context on a quantized junction, a quantized junction
    carrying that context into apply, and a quantized expert FFN inside
    a fused step all refuse."""
    from repro_torch.models import moe as tmoe
    _, _, _, _, tparams = dense
    jn = tqz.quantize_junction(tparams["layers"][0]["mlp"]["wg"], Q8)
    with pytest.raises(ValueError, match="inference only"):
        tsl.inject_update_ctx([jn], None, torch.zeros(7))
    with pytest.raises(ValueError, match="inference only"):
        tsl.apply({**jn, tsl.UPDATE_HYP_LEAF: torch.zeros(7)},
                  torch.zeros((2, 128)))
    mq = tqz.quantize_junction(moe[4]["layers"][0]["moe"], Q8)
    with pytest.raises(ValueError, match="inference only"):
        tsl.inject_update_ctx([mq], None, torch.zeros(7))
    with pytest.raises(ValueError, match="inference only"):
        tmoe._expert_ffn({**mq, tsl.UPDATE_HYP_LEAF: torch.zeros(7)},
                         torch.zeros((1, 8, 4, 128)), 8)


# ----------------------------------------------------------------- launcher
def test_launch_serve_int8_runs_on_cpu(capsys):
    outs = tserve.main(["--reduce", "--sparse", "--continuous", "--quantize",
                        "int8", "--device", "cpu", "--requests", "2",
                        "--prompt-len", "10", "--max-new", "3", "--slots",
                        "2", "--page-size", "8", "--prefill-chunk", "8"])
    assert sorted(outs) == [0, 1]
    out = capsys.readouterr().out
    assert "[serve] quantize=int8 datapath: int8 junction kernels" in out
    assert "2/2 requests" in out


_NEW_MODULES = ("core/fixed_point.py", "core/quantize.py", "data/mnist.py",
                "search/population.py", "search/cohorts.py",
                "launch/quant_sweep.py")


@pytest.mark.parametrize("rel", _NEW_MODULES)
def test_quant_modules_import_no_jax_and_no_reference(rel):
    path = ROOT / "src" / "repro_torch" / rel
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "repro"), name
