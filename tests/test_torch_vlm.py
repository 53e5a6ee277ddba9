"""The port's sliding-window attention and vlm family (llava-next-mistral-7b)
against the JAX reference on the CPU.

* ``decode_attention`` over a ring against the reference's
  ``decode_attention(window=)``, and ``gqa_decode``'s ring (slot pos % S),
  before and after the wrap;
* ``forward`` and ``loss_fn`` with patches ahead of the tokens (whole and
  chunked CE), the pipeline's vlm batches bit for bit, ``make_cache`` and
  ``cache_seq_axes`` (a ring of min(seq, window) slots);
* one two-pass Adam step against the reference, and the fused Adam (with
  clipping) and fused SGD steps against the two-pass step of the same
  optimizer;
* static greedy tokens: against the reference's ``Engine`` where it is
  sound (no patches; a prompt within the window or a multiple of it),
  and against the reference's forward recomputed over the whole sequence
  at each step otherwise (patches; a prompt longer than the window that
  is not a multiple of it).  Two tests pin where the reference's engine
  parts from its own forward: it counts decode positions from the text
  alone, and it writes a long prompt's ring tail from slot 0;
* the launchers on the CPU, ``--continuous`` refused.

Config: reduced llava (d_model 128, 2 layers, 4 heads on 2 kv heads of
32, window 64, 8 patches), FFN density 0.5 at block 32, fp32 compute; a
window of 16 where a short prompt must wrap.  Weights made by the
reference and carried across with ``convert.from_jax_params``.

Tolerances: attention outputs and caches within 2e-5 (fp32 sums in
another order), bf16 attention 1e-2; fp32 logits within 2e-4 absolute
(the reference's static serving bound); loss within 1e-5 relative; an
Adam step within rtol 5e-4 / atol 5e-5 (tests/test_torch_train.py's
bounds), a weight whose gradient sits at the summation-order noise floor
within 2 lr (tests/test_torch_archs.py's rule); batches and greedy
tokens exact.
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
from torch_parity_helpers import close_trees, noise_slack

ARCH = "llava-next-mistral-7b"
ATTN_TOL = dict(atol=2e-5, rtol=2e-5)
LOGIT_ATOL = 2e-4
LOSS_RTOL = 1e-5
TREE_TOL = dict(rtol=5e-4, atol=5e-5)
B = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(**kw):
    sp = dict(density=0.5, block=32, where="ffn")
    jcfg = dataclasses.replace(
        jreg.get(ARCH).reduced().with_sparsity(JSparsity(**sp)),
        dtype="float32", engine="jnp", **kw)
    tcfg = dataclasses.replace(
        treg.get(ARCH).reduced().with_sparsity(SparsityConfig(**sp)),
        dtype="float32", **kw)
    jparams = jax.tree.map(np.asarray, JM.init(jcfg, jax.random.PRNGKey(0)))
    return jcfg, tcfg, jparams, from_jax_params(jparams)


@pytest.fixture(scope="module")
def pair():
    return _pair()


@pytest.fixture(scope="module")
def pair16():
    """A window of 16: a short prompt wraps the ring."""
    return _pair(window=16)


def _tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, size=(b, s)).astype(np.int32)


def _patches(cfg, b, p, seed=3):
    return np.random.default_rng(seed).standard_normal(
        (b, p, cfg.d_model)).astype(np.float32)


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _recompute(jcfg, jparams, prompts, new, patches=None):
    """Greedy tokens from the reference's forward over the whole sequence
    at every step (the oracle the static engine must reproduce)."""
    last = jax.jit(lambda b: JM.forward(jcfg, jparams, b)[0][:, -1])
    seq = prompts
    out = []
    for _ in range(new):
        batch = {"tokens": jnp.asarray(seq)}
        if patches is not None:
            batch["patches"] = jnp.asarray(patches)
        tok = np.asarray(jnp.argmax(last(batch), -1)).astype(np.int32)
        out.append(tok)
        seq = np.concatenate([seq, tok[:, None]], axis=1)
    return np.stack(out, axis=1)


# ------------------------------------------------------------- attention
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos", [3, 11, 12, 29])
def test_decode_attention_window_matches_reference(dtype, pos):
    """A ring of S = 12 slots: slots past ``pos`` masked until the ring
    is full (pos < 12), every slot valid after the wrap."""
    rng = np.random.default_rng(pos)
    Bq, S, H, Hkv, D = 2, 12, 8, 2, 32
    q = rng.standard_normal((Bq, 1, H, D)).astype(np.float32)
    k = rng.standard_normal((Bq, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((Bq, S, Hkv, D)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = JA.decode_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                               jnp.asarray(pos), window=S)
    got = TA.decode_attention(*(torch.from_numpy(a).to(tdt)
                                for a in (q, k, v)), pos)
    assert got.dtype == tdt and tuple(got.shape) == (Bq, 1, H, D)
    tol = ATTN_TOL if dtype == "float32" else dict(atol=1e-2, rtol=1e-2)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("pos", [6, 15, 16, 21, 40])
def test_gqa_decode_ring_matches_reference(pair16, pos):
    """One token at ``pos`` into a 16-slot ring holding the positions
    before it at slot p % 16: the output, and the ring with the new K / V
    at slot pos % 16, before and after the wrap."""
    jcfg, tcfg, jparams, tparams = pair16
    rng = np.random.default_rng(pos)
    W = tcfg.window
    x = rng.standard_normal((B, 1, tcfg.d_model)).astype(np.float32)
    shape = (B, W, tcfg.kv_heads, tcfg.head_dim)
    filled = min(pos, W)
    k, v = np.zeros(shape, np.float32), np.zeros(shape, np.float32)
    k[:, :filled] = rng.standard_normal((B, filled) + shape[2:])
    v[:, :filled] = rng.standard_normal((B, filled) + shape[2:])
    lp = jax.tree.map(lambda t: t[0], jparams["layers"])["attn"]
    jout, jc = JA.gqa_decode(lp, jnp.asarray(x), jcfg,
                             {"k": jnp.asarray(k), "v": jnp.asarray(v)},
                             jnp.asarray(pos))
    tc = {"k": torch.tensor(k), "v": torch.tensor(v)}
    tout, tc2 = TA.gqa_decode(tparams["layers"][0]["attn"],
                              torch.from_numpy(x), tcfg, tc, pos)
    assert tc2["k"] is tc["k"]
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **ATTN_TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   **ATTN_TOL)
    written = tc["k"][:, pos % W]
    assert not torch.equal(written, torch.from_numpy(k[:, pos % W]))


# ----------------------------------------------------------------- model
@pytest.mark.parametrize("loss_chunk", [0, 8])
def test_forward_and_loss_with_patches_match_reference(pair, loss_chunk):
    jcfg, tcfg, jparams, tparams = pair
    jcfg = dataclasses.replace(jcfg, loss_chunk=loss_chunk)
    tcfg = dataclasses.replace(tcfg, loss_chunk=loss_chunk)
    batch = {"tokens": _tokens(tcfg, B, 25),
             "patches": _patches(tcfg, B, tcfg.num_patches)}
    jl, _, (_, joff) = JM.forward(jcfg, jparams, _jbatch(batch))
    jloss, _ = JM.loss_fn(jcfg, jparams, _jbatch(batch))
    with torch.no_grad():
        tl, _, (_, toff) = TM.forward(tcfg, tparams, batch)
        tloss, _ = TM.loss_fn(tcfg, tparams, batch)
    assert toff == joff == tcfg.num_patches
    assert tuple(tl.shape) == jl.shape == (B, 33, tcfg.vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL,
                               rtol=0)
    assert abs(float(tloss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))


def test_patches_change_the_text_logits(pair):
    """The patches are attended to: the same tokens without them give
    other logits, and the text's offset falls to 0."""
    _, tcfg, _, tparams = pair
    toks = _tokens(tcfg, B, 12)
    with torch.no_grad():
        with_p, _, (_, off) = TM.forward(
            tcfg, tparams, {"tokens": toks,
                            "patches": _patches(tcfg, B, 4)})
        without, _, (_, off0) = TM.forward(tcfg, tparams, {"tokens": toks})
    assert (off, off0) == (4, 0)
    assert not torch.allclose(with_p[:, 4:], without, atol=1e-3)


@pytest.mark.parametrize("seq", [8, 16, 24, 64])
def test_pipeline_makes_the_references_vlm_batches(seq):
    """P = min(num_patches, seq // 2) fp32 patches and the first seq - P
    tokens, bit for bit, over two steps."""
    jcfg, tcfg = jreg.get(ARCH).reduced(), treg.get(ARCH).reduced()
    jp, tp = JPipeline(jcfg, 3, seq, seed=2), LMTokenPipeline(tcfg, 3, seq,
                                                               seed=2)
    for _ in range(2):
        want, got = next(jp), next(tp)
        assert got.keys() == want.keys() == {"tokens", "patches"}
        P = min(tcfg.num_patches, seq // 2)
        assert got["patches"].shape == (3, P, tcfg.d_model)
        assert got["tokens"].shape == (3, seq - P)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("window,seq", [(64, 8), (64, 96), (16, 16),
                                        (16, 40)])
def test_make_cache_and_seq_axes_match_reference(window, seq):
    """A ring of min(seq, window) slots."""
    jcfg = dataclasses.replace(jreg.get(ARCH).reduced(), window=window)
    tcfg = dataclasses.replace(treg.get(ARCH).reduced(), window=window)
    assert TM.cache_seq_axes(tcfg) == JM.cache_seq_axes(jcfg)
    jc, tc = JM.make_cache(jcfg, 3, seq), TM.make_cache(tcfg, 3, seq)
    assert set(tc) == set(jc) == {"k", "v"}
    for key in jc:
        assert tuple(tc[key].shape) == jc[key].shape
        assert tc[key].shape[2] == min(seq, window)
        assert tc[key].dtype == tcfg.compute_dtype
        assert not tc[key].any()


@pytest.mark.parametrize("S", [10, 16, 37])
def test_grow_cache_places_position_p_at_slot_p_mod_window(pair16, S):
    """A prefill of S positions into a 16-slot ring: the last min(S, 16)
    positions, position p at slot p % 16, zeros in slots not yet
    written."""
    _, tcfg, _, _ = pair16
    W = tcfg.window
    eng = Engine(tcfg, {}, ServeConfig(max_new_tokens=4), device="cpu")
    pos = torch.arange(S, dtype=torch.float32)
    src = {k: pos[None, None, :, None, None].expand(
        tcfg.n_layers, B, S, tcfg.kv_heads, tcfg.head_dim).clone() + 1
           for k in ("k", "v")}
    grown = eng._grow_cache(src, B, S + 4, S)
    for key in ("k", "v"):
        assert grown[key].shape[2] == min(S + 4, W)
        slots = grown[key][0, 0, :, 0, 0]
        for p in range(max(0, S - W), S):
            assert float(slots[p % W]) == p + 1
        if S < W:
            assert not slots[S:].any()


def test_decode_step_matches_reference_past_the_wrap(pair16):
    """A 24-position prefill into a 16-slot ring (placed as the
    reference's own test places it, at arange(S) % W), then three decode
    steps: logits and the ring, each step."""
    jcfg, tcfg, jparams, tparams = pair16
    toks = _tokens(tcfg, B, 24, seed=4)
    jl, jc, _ = JM.forward(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                           return_cache=True, last_only=True)
    with torch.no_grad():
        tl, tc, _ = TM.forward(tcfg, tparams, {"tokens": toks},
                               return_cache=True, last_only=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL,
                               rtol=0)
    W = tcfg.window
    slots = jnp.arange(24 - W, 24) % W
    jring = {k: jnp.zeros(jc[k].shape[:2] + (W,) + jc[k].shape[3:])
             .at[:, :, slots].set(jc[k][:, :, 24 - W:]) for k in jc}
    tring = Engine(tcfg, tparams, device="cpu")._grow_cache(tc, B, 30, 24)
    for i in range(3):
        tok = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
        jl, jring = JM.decode_step(jcfg, jparams, jring, jnp.asarray(tok),
                                   jnp.asarray(24 + i, jnp.int32))
        with torch.no_grad():
            tl, tring = TM.decode_step(tcfg, tparams, tring,
                                       torch.from_numpy(tok), 24 + i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL, rtol=0)
        for k in ("k", "v"):
            np.testing.assert_allclose(tring[k].numpy(),
                                       np.asarray(jring[k]), atol=LOGIT_ATOL,
                                       rtol=0)


# ----------------------------------------------------------------- train


def test_two_pass_adam_step_matches_reference(pair):
    """One step on the pipeline's vlm batch (patches and tokens)."""
    jcfg, tcfg, jparams, tparams = pair
    jopt, topt = jadam(jconstant(1e-3)), adam(constant_schedule(1e-3))
    batch = next(JPipeline(jcfg, B, 32))
    tbatch = next(LMTokenPipeline(tcfg, B, 32))
    assert set(tbatch) == {"tokens", "patches"}
    jp, js, jm = jmake_train_step(jcfg, jopt, donate=False)(
        jax.tree.map(jnp.asarray, jparams), jopt.init(jparams),
        _jbatch(batch), jnp.asarray(0))
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
    """llava's FFN junctions updated inside their backward: one fused
    step equals the two-pass step of the same optimizer on the same vlm
    batch."""
    _, tcfg, jparams, _ = pair
    cfg = dataclasses.replace(tcfg, param_dtype="float32")
    opt = (fused_sgd(constant_schedule(3e-2), momentum=0.9) if kind == "sgd"
           else fused_adam(constant_schedule(1e-3), grad_clip=1.0))
    batch = next(LMTokenPipeline(cfg, B, 32))
    out = {}
    for fused in (False, True):
        c = dataclasses.replace(cfg, fused_update=fused)
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
@pytest.mark.parametrize("prompt_len", [8, 16, 32])
def test_static_greedy_matches_reference_engine_where_sound(pair16,
                                                            prompt_len):
    """No patches, and a prompt within the window (8, whose decode then
    wraps) or a multiple of it (16, 32): the reference's engine places
    the ring where its decode reads it, and the tokens agree."""
    jcfg, tcfg, jparams, tparams = pair16
    prompts = _tokens(tcfg, 3, prompt_len, seed=5)
    want = JEngine(jcfg, jparams, JServeConfig(max_new_tokens=12)
                   ).generate(prompts)
    eng = Engine(tcfg, tparams, ServeConfig(max_new_tokens=12), device="cpu")
    got = eng.generate(prompts)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _recompute(jcfg, jparams, prompts,
                                                  12))
    assert eng.nonfinite_terminated == 0


def test_static_greedy_matches_reference_forward_recompute(pair16):
    """8 patches and a 20-token prompt into a 16-slot ring (not a
    multiple of it): the port's engine gives the greedy tokens of the
    reference's forward recomputed over the whole sequence.  Patches
    alone and a long prompt alone are held so by the two pins of the
    reference engine's caveats below."""
    jcfg, tcfg, jparams, tparams = pair16
    prompts = _tokens(tcfg, B, 20, seed=6)
    patches = _patches(tcfg, B, tcfg.num_patches)
    want = _recompute(jcfg, jparams, prompts, 6, patches)
    got = Engine(tcfg, tparams, ServeConfig(max_new_tokens=6),
                 device="cpu").generate(prompts, {"patches": patches})
    np.testing.assert_array_equal(got, want)


def test_reference_engine_counts_decode_positions_from_the_text(pair):
    """A reference caveat, pinned: with patches its ``Engine.generate``
    decodes from position S (the text's length) though the prefill wrote
    P + S positions, so its tokens part from its own forward's; the
    port's follow the forward."""
    jcfg, tcfg, jparams, tparams = pair
    prompts = _tokens(tcfg, B, 12, seed=6)
    patches = _patches(tcfg, B, tcfg.num_patches)
    want = _recompute(jcfg, jparams, prompts, 6, patches)
    ref = JEngine(jcfg, jparams, JServeConfig(max_new_tokens=6)).generate(
        prompts, {"patches": patches})
    got = Engine(tcfg, tparams, ServeConfig(max_new_tokens=6),
                 device="cpu").generate(prompts, {"patches": patches})
    np.testing.assert_array_equal(ref[:, 0], want[:, 0])    # the prefill's
    assert not np.array_equal(ref, want)
    np.testing.assert_array_equal(got, want)


def test_reference_engine_writes_a_long_prompts_ring_from_slot_0(pair16):
    """A reference caveat, pinned: a 20-token prompt into a 16-slot ring
    keeps positions 4..19 at slots 0..15, but decode reads position p at
    slot p % 16, so its tokens part from its own forward's; the port
    places p at p % 16 and follows the forward."""
    jcfg, tcfg, jparams, tparams = pair16
    prompts = _tokens(tcfg, B, 20, seed=6)
    want = _recompute(jcfg, jparams, prompts, 6)
    ref = JEngine(jcfg, jparams, JServeConfig(max_new_tokens=6)).generate(
        prompts)
    got = Engine(tcfg, tparams, ServeConfig(max_new_tokens=6),
                 device="cpu").generate(prompts)
    np.testing.assert_array_equal(ref[:, 0], want[:, 0])
    assert not np.array_equal(ref, want)
    np.testing.assert_array_equal(got, want)


def test_paged_path_refuses_the_vlm_as_the_reference(pair):
    jcfg, tcfg, _, _ = pair
    assert TM.paged_supported(tcfg) == JM.paged_supported(jcfg)
    assert not TM.paged_supported(tcfg)[0]


def test_launchers_train_then_serve_the_checkpoint(tmp_path, capsys):
    """launch/train.py on vlm batches (8 patches of the 16 positions),
    then launch/serve.py --ckpt with the launcher's own patches; int8;
    --continuous refused."""
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
    out8 = tserve.main(["--arch", ARCH, "--reduce", "--sparse", "--quantize",
                        "int8", "--device", "cpu", "--requests", "2",
                        "--prompt-len", "8", "--max-new", "3"])
    assert out8.shape == (2, 3)
    assert "quantize=int8 datapath: int8" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="--continuous unsupported"):
        tserve.main(["--arch", ARCH, "--reduce", "--continuous",
                     "--device", "cpu"])


def test_serve_launcher_makes_the_references_patches(monkeypatch):
    """The static launcher's patches come after its prompts from the same
    rng, min(num_patches, prompt_len // 2) a request, as the
    reference's."""
    seen = {}

    def generate(self, prompts, extra_inputs=None):
        seen.update(prompts=prompts, extra=extra_inputs)
        return np.zeros((prompts.shape[0], self.scfg.max_new_tokens),
                        np.int32)

    monkeypatch.setattr(Engine, "generate", generate)
    tserve.main(["--arch", ARCH, "--reduce", "--device", "cpu",
                 "--requests", "3", "--prompt-len", "10", "--max-new", "2"])
    cfg = treg.get(ARCH).reduced()
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, size=(3, 10)).astype(np.int32)
    patches = rng.standard_normal((3, 5, cfg.d_model)).astype(np.float32)
    np.testing.assert_array_equal(seen["prompts"], prompts)
    np.testing.assert_array_equal(seen["extra"]["patches"], patches)
