"""The port's multi-head latent attention and a MoE model's dense first
layers (deepseek-v2-lite-16b) against the JAX reference on the CPU.

* MLA's params (``wq``, dense ``wkv_a``, the rmsnorm ``kv_norm``, dense
  ``wkv_b``, ``wo``) and the split layer stack (``dense_layers`` then
  ``layers``) carried across in the port's layout;
* ``mla_forward`` (the expanded form) and ``mla_decode`` (the absorbed
  form, its latent cache written in place) against the reference's, in
  fp32 and bf16, and the absorbed form against the expanded one;
* the model: forward and loss through the dense first layer and the MoE
  layers, ``make_cache`` and ``cache_seq_axes`` ({"dense", "moe"} of
  {"latent", "k_rope"}), the prefill with its cache and decode steps;
* one two-pass Adam step against the reference, and the fused Adam (with
  clipping) and fused SGD steps against the two-pass step of the same
  optimizer;
* static greedy tokens against the reference's ``Engine`` and against
  its forward recomputed over the whole sequence;
* the launchers on the CPU, ``--continuous`` refused.

Config: reduced deepseek-v2-lite (d_model 128, 2 layers: one dense, one
MoE of 8 experts top-2 with shared experts; 4 heads, kv_lora 32, nope /
rope / v head dims 32 / 16 / 32), FFN density 0.5 at block 32, fp32
compute.  Weights made by the reference and carried across with
``convert.from_jax_params``.

Tolerances: attention outputs and caches within 2e-5 (fp32 sums in
another order); bf16 attention within 2 bf16 ulps of each element of
the reference's (both round q_abs, the probabilities, o_lat and the
output to bf16 at the same points; a decode that keeps those four in
fp32 misses the bound by tens to hundreds of ulps, which a control
asserts); the absorbed form against the expanded one the reference's
3e-3; fp32 logits within 2e-4 absolute; loss within 1e-5 relative; an
Adam step within rtol 5e-4 / atol 5e-5, a weight whose gradient sits at
the summation-order noise floor within 2 lr (tests/test_torch_archs.py's
rule); greedy tokens exact.
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
from repro.models import attention as JA
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
from repro_torch.models import attention as TA
from repro_torch.models import model as TM
from repro_torch.optim import adam, constant_schedule, fused_adam, fused_sgd
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.train.steps import fused_update_eligible, make_train_step
from repro_torch.tree import tree_items
from torch_parity_helpers import close_trees, noise_slack

ARCH = "deepseek-v2-lite-16b"
ATTN_TOL = dict(atol=2e-5, rtol=2e-5)
BF16_ULPS = 2
LOGIT_ATOL = 2e-4
LOSS_RTOL = 1e-5
TREE_TOL = dict(rtol=5e-4, atol=5e-5)
B, S = 2, 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    sp = dict(density=0.5, block=32, where="ffn")
    jcfg = dataclasses.replace(
        jreg.get(ARCH).reduced().with_sparsity(JSparsity(**sp)),
        dtype="float32", engine="jnp")
    tcfg = dataclasses.replace(
        treg.get(ARCH).reduced().with_sparsity(SparsityConfig(**sp)),
        dtype="float32")
    jparams = jax.tree.map(np.asarray, JM.init(jcfg, jax.random.PRNGKey(0)))
    return jcfg, tcfg, jparams, from_jax_params(jparams)


def _tokens(cfg, b=B, s=S, seed=7):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, size=(b, s)).astype(np.int32)


def _bf16_ulps(got, want):
    """|got - want| in bf16 ulps of |want|, elementwise (fp32 arrays)."""
    w = np.maximum(np.abs(want), np.finfo(np.float32).tiny)
    return np.abs(got - want) / 2.0 ** (np.floor(np.log2(w)) - 7)


def _attn(jparams, tparams, stack="layers"):
    """Layer 0's attention params of ``stack`` on both sides."""
    j = jax.tree.map(lambda t: jnp.asarray(t[0]), jparams[stack])["attn"]
    return j, tparams[stack][0]["attn"]



# ---------------------------------------------------------------- params
def test_params_carry_in_the_ports_layout(pair):
    """The carried tree is the one the port's init builds: a list of one
    dense layer (a dense-MLP block) and a list of the MoE layers, MLA's
    five leaves in each."""
    _, tcfg, _, tparams = pair
    own = TM.init(tcfg, 0, "cpu")
    got = {p: (tuple(t.shape), t.dtype) for p, t in tree_items(tparams)}
    assert got == {p: (tuple(t.shape), t.dtype) for p, t in tree_items(own)}
    assert len(tparams["dense_layers"]) == tcfg.moe.first_dense_layers == 1
    assert len(tparams["layers"]) == tcfg.n_layers - 1
    assert "mlp" in tparams["dense_layers"][0]
    assert "moe" in tparams["layers"][0]
    assert set(tparams["layers"][0]["attn"]) == {"wq", "wkv_a", "kv_norm",
                                                 "wkv_b", "wo"}


def test_full_config_keeps_the_dense_layers_ffn_dense():
    """At full width 10944 does not tile at block 128, so the dense first
    layer's FFN stays dense in both packages, while the shared experts
    (2816) are sparse."""
    from repro.core import sparse_linear as jsl
    from repro_torch.core import sparse_linear as tsl
    sp = dict(density=0.25, block=128, where="ffn")
    tcfg = treg.get(ARCH).with_sparsity(SparsityConfig(**sp))
    jcfg = jreg.get(ARCH).with_sparsity(JSparsity(**sp))
    gen = torch.Generator().manual_seed(0)
    wi = tsl.init_linear(gen, tcfg.d_model, tcfg.d_ff, family="ffn",
                         sp=tcfg.sparsity)
    jwi = jsl.init_linear(jax.random.PRNGKey(0), jcfg.d_model, jcfg.d_ff,
                          family="ffn", sp=jcfg.sparsity)
    assert "idx" not in wi and "idx" not in jwi
    shared = tsl.init_linear(gen, tcfg.d_model, tcfg.moe.d_shared,
                             family="ffn", sp=tcfg.sparsity)
    assert tuple(shared["w"].shape) == (22, 4, 128, 128)


# ------------------------------------------------------------- attention
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_forward_matches_reference(pair, dtype):
    jcfg, tcfg, jparams, tparams = pair
    jcfg, tcfg = (dataclasses.replace(c, dtype=dtype) for c in (jcfg, tcfg))
    jp, tp = _attn(jparams, tparams)
    x = np.random.default_rng(1).standard_normal(
        (B, 20, tcfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x, jnp.dtype(dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jout, (jlat, jkr) = JA.mla_forward(jp, jx, jcfg,
                                       positions=jnp.arange(20))
    tout, (tlat, tkr) = TA.mla_forward(tp, tx, tcfg,
                                       positions=torch.arange(20))
    assert tout.dtype == tx.dtype
    for got, want in ((tout, jout), (tlat, jlat), (tkr, jkr)):
        got, want = got.float().numpy(), np.asarray(want, np.float32)
        assert got.shape == want.shape
        if dtype == "float32":
            np.testing.assert_allclose(got, want, **ATTN_TOL)
        else:
            assert _bf16_ulps(got, want).max() <= BF16_ULPS


def _latent_cache(cfg, rng, pos, size):
    m = cfg.mla
    lat = np.zeros((B, size, m.kv_lora_rank), np.float32)
    kr = np.zeros((B, size, m.qk_rope_head_dim), np.float32)
    lat[:, :pos] = rng.standard_normal((B, pos, m.kv_lora_rank))
    kr[:, :pos] = rng.standard_normal((B, pos, m.qk_rope_head_dim))
    return lat, kr


def _decode_pair(pair, dtype, pos):
    """The reference's and the port's decode of one token at ``pos`` of
    a 16-slot latent cache holding the positions before it: (reference
    output and cache, a function running the port's on the same inputs
    and returning its output and cache, the port's cache dict)."""
    jcfg, tcfg, jparams, tparams = pair
    jcfg, tcfg = (dataclasses.replace(c, dtype=dtype) for c in (jcfg, tcfg))
    jp, tp = _attn(jparams, tparams, "dense_layers")
    rng = np.random.default_rng(pos)
    x = rng.standard_normal((B, 1, tcfg.d_model)).astype(np.float32)
    lat, kr = _latent_cache(tcfg, rng, pos, 16)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = JA.mla_decode(jp, jnp.asarray(x, jdt), jcfg,
                         {"latent": jnp.asarray(lat, jdt),
                          "k_rope": jnp.asarray(kr, jdt)},
                         jnp.asarray(pos))
    tc = {"latent": torch.tensor(lat).to(tdt),
          "k_rope": torch.tensor(kr).to(tdt)}
    return want, lambda: TA.mla_decode(tp, torch.from_numpy(x).to(tdt),
                                       tcfg, tc, pos), tc


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos", [0, 7, 15])
def test_mla_decode_matches_reference(pair, dtype, pos):
    """One token at ``pos`` of a 16-slot latent cache holding the
    positions before it: the output, and the cache with the new latent
    and k_rope at slot ``pos``."""
    (jout, jc), run, tc = _decode_pair(pair, dtype, pos)
    tout, tc2 = run()
    assert tc2["latent"] is tc["latent"]
    assert tout.dtype == getattr(torch, dtype)
    pairs = [(tout, jout)] + [(tc[k], jc[k]) for k in ("latent", "k_rope")]
    for got, want in pairs:
        got, want = got.float().numpy(), np.asarray(want, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(got, want, **ATTN_TOL)
        else:
            assert _bf16_ulps(got, want).max() <= BF16_ULPS


@pytest.mark.parametrize("pos", [0, 7, 15])
def test_mla_decode_bf16_bound_catches_unrounded_intermediates(
        pair, pos, monkeypatch):
    """The control of the bf16 decode bound: the same decode with q_abs,
    the probabilities, o_lat and the output kept in fp32 (its result
    rounded to bf16 once, at the end) misses it."""
    (jout, _), run, _ = _decode_pair(pair, "bfloat16", pos)
    monkeypatch.setattr(TA, "_rounded", lambda t, dtype: t)
    tout, _ = run()
    got = tout.to(torch.bfloat16).float().numpy()
    assert _bf16_ulps(got, np.asarray(jout, np.float32)).max() > BF16_ULPS


def test_absorbed_decode_matches_expanded_forward(pair):
    """The absorbed form scored in latent space equals the expanded form
    at the same position (the reference's own check, at its 3e-3)."""
    _, tcfg, _, tparams = pair
    tp = tparams["layers"][0]["attn"]
    n = 9
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (B, n + 1, tcfg.d_model)).astype(np.float32))
    full, (lat, kr) = TA.mla_forward(tp, x, tcfg,
                                     positions=torch.arange(n + 1))
    cache = {"latent": torch.zeros((B, n + 4, lat.shape[-1])),
             "k_rope": torch.zeros((B, n + 4, kr.shape[-1]))}
    cache["latent"][:, :n] = lat[:, :n]
    cache["k_rope"][:, :n] = kr[:, :n]
    out, _ = TA.mla_decode(tp, x[:, n:n + 1], tcfg, cache, n)
    np.testing.assert_allclose(out[:, 0].detach().numpy(),
                               full[:, n].detach().numpy(),
                               rtol=3e-3, atol=3e-3)
    np.testing.assert_allclose(cache["latent"][:, n].detach().numpy(),
                               lat[:, n].detach().numpy(), **ATTN_TOL)


# ----------------------------------------------------------------- model
def test_forward_and_loss_through_the_dense_first_layer(pair):
    jcfg, tcfg, jparams, tparams = pair
    toks = _tokens(tcfg)
    jl, _, (jaux, _) = JM.forward(jcfg, jparams, {"tokens": jnp.asarray(toks)})
    jloss, _ = JM.loss_fn(jcfg, jparams, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        tl, _, (taux, off) = TM.forward(tcfg, tparams, {"tokens": toks})
        tloss, _ = TM.loss_fn(tcfg, tparams, {"tokens": toks})
    assert off == 0 and tuple(tl.shape) == jl.shape
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL,
                               rtol=0)
    assert abs(float(taux) - float(jaux)) <= LOSS_RTOL * abs(float(jaux))
    assert abs(float(tloss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))


def test_dense_first_layer_runs_first(pair, monkeypatch):
    """The layers run in the reference's order: the dense layer (its MLP),
    then the MoE layers."""
    _, tcfg, _, tparams = pair
    order = []
    real = TM._attn_mlp_block

    def spy(lp, *a, **kw):
        order.append("mlp" if "mlp" in lp else "moe")
        return real(lp, *a, **kw)

    monkeypatch.setattr(TM, "_attn_mlp_block", spy)
    with torch.no_grad():
        TM.forward(tcfg, tparams, {"tokens": _tokens(tcfg, 1, 8)})
    assert order == ["mlp"] + ["moe"] * (tcfg.n_layers - 1)


@pytest.mark.parametrize("b,s", [(1, 8), (3, 16)])
def test_make_cache_and_seq_axes_match_reference(pair, b, s):
    jcfg, tcfg, _, _ = pair
    assert TM.cache_seq_axes(tcfg) == JM.cache_seq_axes(jcfg) == {
        "dense": {"latent": 2, "k_rope": 2},
        "moe": {"latent": 2, "k_rope": 2}}
    jc = {"/".join(k.key for k in path): a for path, a in
          jax.tree_util.tree_leaves_with_path(JM.make_cache(jcfg, b, s))}
    tc = dict(tree_items(TM.make_cache(tcfg, b, s)))
    assert tc.keys() == jc.keys() and len(tc) == 4
    for path, ta in tc.items():
        assert tuple(ta.shape) == jc[path].shape
        assert ta.dtype == tcfg.compute_dtype
        assert not ta.any()


def test_prefill_and_decode_steps_match_reference(pair):
    """The prefill with its cache, the cache grown to n + 3 positions,
    then three decode steps: logits and every cache leaf."""
    jcfg, tcfg, jparams, tparams = pair
    toks = _tokens(tcfg, 3, 16, seed=1)
    n = toks.shape[1]
    jl, jc, _ = JM.forward(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                           return_cache=True, last_only=True)
    with torch.no_grad():
        tl, tc, _ = TM.forward(tcfg, tparams, {"tokens": toks},
                               return_cache=True, last_only=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL,
                               rtol=0)
    close_trees(tc, jax.tree.map(lambda t: torch.tensor(np.asarray(t)), jc),
           atol=LOGIT_ATOL, rtol=0)
    jfull = JEngine(jcfg, jparams)._grow_cache(jc, 3, n + 3, n)
    tfull = Engine(tcfg, tparams, device="cpu")._grow_cache(tc, 3, n + 3, n)
    for i in range(3):
        tok = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
        jl, jfull = JM.decode_step(jcfg, jparams, jfull, jnp.asarray(tok),
                                   jnp.asarray(n + i, jnp.int32))
        with torch.no_grad():
            tl, tnew = TM.decode_step(tcfg, tparams, tfull,
                                      torch.from_numpy(tok), n + i)
        assert tnew is tfull
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL, rtol=0)
        close_trees(tfull, jax.tree.map(lambda t: torch.tensor(np.asarray(t)),
                                   jfull), atol=LOGIT_ATOL, rtol=0)


# ----------------------------------------------------------------- train
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


@pytest.mark.parametrize("kind", ["sgd", "adam_clip"])
def test_fused_steps_match_the_two_pass_step(pair, kind):
    """The expert, shared-expert and dense-layer junctions updated inside
    their backward, MLA's dense leaves by the optimizer: one fused step
    equals the two-pass step of the same optimizer."""
    _, tcfg, jparams, _ = pair
    opt = (fused_sgd(constant_schedule(3e-2), momentum=0.9) if kind == "sgd"
           else fused_adam(constant_schedule(1e-3), grad_clip=1.0))
    batch = {"tokens": _tokens(tcfg)}
    out = {}
    for fused in (False, True):
        c = dataclasses.replace(tcfg, fused_update=fused)
        assert fused_update_eligible(c, opt)[0] == fused
        params = from_jax_params(jparams)
        out[fused] = make_train_step(c, opt)(params, opt.init(params),
                                             batch, 0)
    (p0, s0, m0), (p1, s1, m1) = out[False], out[True]
    assert abs(float(m1["loss"]) - float(m0["loss"])) <= LOSS_RTOL * abs(
        float(m0["loss"]))
    assert float(m1["nonfinite"]) == 0
    close_trees(p1, p0, **TREE_TOL)
    close_trees(s1, s0, **TREE_TOL)


# ---------------------------------------------------------------- serve
@pytest.mark.parametrize("capacity_factor", [1.25, 4.0])
def test_static_greedy_tokens_match_reference(pair, capacity_factor):
    """The reference's engine is sound for MLA: the port's tokens equal
    its engine's.  With a capacity of every token (factor E / K = 4) no
    expert choice is dropped, so routing does not follow the call's token
    count and the tokens also equal the reference's forward recomputed
    over the whole sequence (at the default factor a prefill and a
    decode step drop other choices than a forward over the sequence)."""
    jcfg, tcfg, jparams, tparams = pair
    jcfg, tcfg = (dataclasses.replace(c, moe=dataclasses.replace(
        c.moe, capacity_factor=capacity_factor)) for c in (jcfg, tcfg))
    prompts = _tokens(tcfg, 3, 8, seed=1)
    want = JEngine(jcfg, jparams, JServeConfig(max_new_tokens=6)
                   ).generate(prompts)
    eng = Engine(tcfg, tparams, ServeConfig(max_new_tokens=6), device="cpu")
    got = eng.generate(prompts)
    np.testing.assert_array_equal(got, want)
    assert eng.nonfinite_terminated == 0
    if capacity_factor < tcfg.moe.num_experts / tcfg.moe.top_k:
        return
    last = jax.jit(lambda b: JM.forward(jcfg, jparams, b)[0][:, -1])
    seq = prompts
    for i in range(6):
        tok = np.asarray(jnp.argmax(last({"tokens": jnp.asarray(seq)}),
                                    -1)).astype(np.int32)
        np.testing.assert_array_equal(got[:, i], tok)
        seq = np.concatenate([seq, tok[:, None]], axis=1)


def test_int8_serving_matches_reference(pair):
    jcfg, tcfg, jparams, tparams = pair
    prompts = _tokens(tcfg, 2, 8, seed=3)
    want = JEngine(jcfg, jparams, JServeConfig(max_new_tokens=4,
                                               quantize="int8")
                   ).generate(prompts)
    got = Engine(tcfg, tparams, ServeConfig(max_new_tokens=4,
                                            quantize="int8"),
                 device="cpu").generate(prompts)
    np.testing.assert_array_equal(got, want)


def test_paged_path_refuses_mla_as_the_reference(pair):
    jcfg, tcfg, _, _ = pair
    assert TM.paged_supported(tcfg) == JM.paged_supported(jcfg)
    assert not TM.paged_supported(tcfg)[0]


def test_launchers_train_then_serve_the_checkpoint(tmp_path, capsys):
    ck = tmp_path / "ck"
    res = ttrain.main(["--arch", ARCH, "--reduce", "--sparse", "--steps",
                       "2", "--batch", "2", "--seq", "16", "--device", "cpu",
                       "--ckpt", str(ck)])
    text = capsys.readouterr().out
    assert res["step"] == 2 and "update path: two-pass" in text
    assert all(np.isfinite(h["loss"]) for h in res["history"])
    out = tserve.main(["--arch", ARCH, "--reduce", "--sparse", "--device",
                       "cpu", "--ckpt", str(ck), "--requests", "2",
                       "--prompt-len", "8", "--max-new", "3"])
    assert out.shape == (2, 3)
    assert "restored params from step 2" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="--continuous unsupported"):
        tserve.main(["--arch", ARCH, "--reduce", "--continuous",
                     "--device", "cpu"])


def test_fused_sgd_trains_in_bf16():
    """The fused path as the card runs it (bf16 params and compute): two
    finite steps that move the weights."""
    cfg = dataclasses.replace(
        treg.get(ARCH).reduced().with_sparsity(
            SparsityConfig(density=0.5, block=32, where="ffn")),
        fused_update=True, param_dtype="bfloat16")
    opt = fused_sgd(constant_schedule(1e-2), momentum=0.9)
    assert fused_update_eligible(cfg, opt)[0]
    params = TM.init(cfg, 0, "cpu")
    w0 = params["layers"][0]["moe"]["wg"].clone()
    state = opt.init(params)
    step = make_train_step(cfg, opt)
    pipe = LMTokenPipeline(cfg, 2, 16)
    for i in range(2):
        params, state, m = step(params, state, next(pipe), i)
        assert np.isfinite(float(m["loss"])) and float(m["nonfinite"]) == 0
    assert not torch.equal(params["layers"][0]["moe"]["wg"], w0)
