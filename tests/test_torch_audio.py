"""The port's audio family (whisper-base: encoder, cross-attention,
learned decoder positions) against the JAX reference on the CPU.

* ``sinusoidal_pos``, the encoder block, and the decoder block in prefill
  (its self K / V and the cross K / V of the encoder output) and in
  decode (the self cache written in place, the cross cache untouched);
* ``forward`` and ``loss_fn`` on frames and tokens (whole and chunked
  CE), the pipeline's audio batches bit for bit, ``make_cache`` and
  ``cache_seq_axes`` (the cross K / V a state leaf);
* one two-pass Adam step against the reference, and the fused Adam (with
  clipping) and fused SGD steps against the two-pass step of the same
  optimizer;
* the prefill cache and decode steps against the reference's; static
  greedy tokens against the reference's ``Engine`` with the same frames
  and against its forward recomputed over the whole sequence; int8
  serving against the reference's ``quantize="int8"``;
* the paged path's refusal, an encoder-bearing checkpoint restored bit
  for bit, both launchers on the CPU and the serve launcher's frames.

Config: reduced whisper-base (d_model 128, 2 encoder and 2 decoder
layers, 4 heads of 32, 16 frames), FFN density 0.5 at block 32, fp32
compute.  Weights made by the reference and carried across with
``convert.from_jax_params``.

Tolerances: sinusoidal positions within 1e-6 absolute (values of at most
1; XLA's sin / cos and torch's may differ by an ulp); blocks and caches
within 2e-5 (fp32 sums in another order); fp32 logits within 2e-4
absolute (the reference's static serving bound); loss within 1e-5
relative; an Adam step within rtol 5e-4 / atol 5e-5
(tests/test_torch_train.py's bounds), a weight whose gradient sits at
the summation-order noise floor within 2 lr (tests/test_torch_archs.py's
rule); batches, frames and greedy tokens exact.
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
from repro.models import layers as JL
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
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.optim import adam, constant_schedule, fused_adam, fused_sgd
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.train.steps import fused_update_eligible, make_train_step
from repro_torch.tree import tree_items, tree_map
from torch_parity_helpers import close_trees, noise_slack

ARCH = "whisper-base"
POS_ATOL = 1e-6
BLOCK_TOL = dict(atol=2e-5, rtol=2e-5)
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


def _tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, size=(b, s)).astype(np.int32)


def _frames(cfg, b, seed=3):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.enc_frames, cfg.d_model)).astype(np.float32)


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _jlayer(jparams, i, key="layers"):
    tree = jparams["encoder"]["layers"] if key == "encoder" else jparams[key]
    return jax.tree.map(lambda t: jnp.asarray(t[i]), tree)


def _recompute(jcfg, jparams, prompts, frames, new):
    """Greedy tokens from the reference's forward over the whole sequence
    at every step."""
    last = jax.jit(lambda b: JM.forward(jcfg, jparams, b)[0][:, -1])
    seq, out = prompts, []
    for _ in range(new):
        batch = {"tokens": jnp.asarray(seq), "frames": jnp.asarray(frames)}
        tok = np.asarray(jnp.argmax(last(batch), -1)).astype(np.int32)
        out.append(tok)
        seq = np.concatenate([seq, tok[:, None]], axis=1)
    return np.stack(out, axis=1)


# ---------------------------------------------------------------- layers
@pytest.mark.parametrize("seq,d", [(16, 128), (1500, 512), (33, 64)])
def test_sinusoidal_pos_matches_reference(seq, d):
    want = np.asarray(JL.sinusoidal_pos(seq, d, jnp.float32))
    got = TL.sinusoidal_pos(seq, d, torch.float32)
    assert got.dtype == torch.float32 and tuple(got.shape) == (seq, d)
    np.testing.assert_allclose(got.numpy(), want, atol=POS_ATOL, rtol=0)
    assert float(got.abs().max()) <= 1.0


def test_sinusoidal_pos_rounds_to_the_dtype_last():
    """bf16 positions are the fp32 ones rounded once."""
    got = TL.sinusoidal_pos(1500, 512, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, TL.sinusoidal_pos(1500, 512,
                                              torch.float32).bfloat16())


def test_learned_positions_and_encoder_in_the_params(pair):
    """``embed["pos"]`` [max_seq, d] and ``encoder`` {"layers", "norm"}, in
    the reference's layout and key order."""
    jcfg, tcfg, jparams, tparams = pair
    own = TM.init(tcfg, 0, "cpu")
    got = {p: (tuple(t.shape), t.dtype) for p, t in tree_items(tparams)}
    assert got == {p: (tuple(t.shape), t.dtype) for p, t in tree_items(own)}
    assert tuple(own["embed"]["pos"].shape) == (tcfg.max_seq, tcfg.d_model)
    assert 0.01 < float(own["embed"]["pos"].std()) < 0.03
    assert len(own["encoder"]["layers"]) == tcfg.enc_layers
    assert set(own["layers"][0]) == set(jparams["layers"])
    assert list(tparams) == list(jparams)
    assert list(tparams["encoder"]) == list(jparams["encoder"])


def test_encoder_block_matches_reference(pair):
    jcfg, tcfg, jparams, tparams = pair
    x = _frames(tcfg, B, seed=5)
    want = JM._enc_block(_jlayer(jparams, 1, "encoder"), jnp.asarray(x),
                         jcfg)
    with torch.no_grad():
        got = TM._enc_block(tparams["encoder"]["layers"][1],
                            torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)


def test_decoder_block_prefill_matches_reference(pair):
    """Self-attention (no rope), cross-attention on the encoder output and
    the MLP; the layer's cache {"k", "v", "ck", "cv"}."""
    jcfg, tcfg, jparams, tparams = pair
    rng = np.random.default_rng(6)
    x = rng.standard_normal((B, 12, tcfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((B, tcfg.enc_frames, tcfg.d_model)
                              ).astype(np.float32)
    jx, jc = JM._dec_block(_jlayer(jparams, 0), jnp.asarray(x), jcfg,
                           jnp.arange(12), enc_kv=jnp.asarray(enc))
    with torch.no_grad():
        tx, tc = TM._dec_block(tparams["layers"][0], torch.from_numpy(x),
                               tcfg, torch.arange(12), torch.from_numpy(enc))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **BLOCK_TOL)
    assert list(tc) == ["k", "v", "ck", "cv"]
    for k in tc:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   **BLOCK_TOL)


def test_decoder_block_decode_matches_reference(pair):
    """One token at position 7: the self K / V written at slot 7 in
    place, the cross K / V read and left as they were."""
    jcfg, tcfg, jparams, tparams = pair
    rng = np.random.default_rng(7)
    S, F = 10, tcfg.enc_frames
    shape = (B, S, tcfg.kv_heads, tcfg.head_dim)
    cache = {"k": np.zeros(shape, np.float32), "v": np.zeros(shape,
                                                              np.float32)}
    cache["k"][:, :7] = rng.standard_normal((B, 7) + shape[2:])
    cache["v"][:, :7] = rng.standard_normal((B, 7) + shape[2:])
    for k in ("ck", "cv"):
        cache[k] = rng.standard_normal((B, F) + shape[2:]).astype(np.float32)
    x = rng.standard_normal((B, 1, tcfg.d_model)).astype(np.float32)
    jx, jc = JM._dec_block(_jlayer(jparams, 1), jnp.asarray(x), jcfg, None,
                           cache=_jbatch(cache), pos=jnp.asarray(7),
                           decode=True)
    tc = {k: torch.tensor(v) for k, v in cache.items()}
    cross = {k: tc[k].clone() for k in ("ck", "cv")}
    with torch.no_grad():
        tx, _ = TM._dec_block(tparams["layers"][1], torch.from_numpy(x),
                              tcfg, None, cache=tc, pos=7, decode=True)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **BLOCK_TOL)
    for k in tc:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   **BLOCK_TOL)
    for k in cross:
        assert torch.equal(tc[k], cross[k])
    assert float(tc["k"][:, 7].abs().max()) > 0


# ----------------------------------------------------------------- model
@pytest.mark.parametrize("loss_chunk", [0, 8])
def test_forward_and_loss_match_reference(pair, loss_chunk):
    jcfg, tcfg, jparams, tparams = pair
    jcfg = dataclasses.replace(jcfg, loss_chunk=loss_chunk)
    tcfg = dataclasses.replace(tcfg, loss_chunk=loss_chunk)
    batch = {"tokens": _tokens(tcfg, B, 25), "frames": _frames(tcfg, B)}
    jl, _, (_, joff) = JM.forward(jcfg, jparams, _jbatch(batch))
    jloss, _ = JM.loss_fn(jcfg, jparams, _jbatch(batch))
    with torch.no_grad():
        tl, _, (_, toff) = TM.forward(tcfg, tparams, batch)
        tloss, _ = TM.loss_fn(tcfg, tparams, batch)
    assert toff == joff == 0
    assert tuple(tl.shape) == jl.shape == (B, 25, tcfg.vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL,
                               rtol=0)
    assert abs(float(tloss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))


def test_frames_reach_the_logits(pair):
    """The decoder attends to the encoder: other frames give other
    logits."""
    _, tcfg, _, tparams = pair
    toks = _tokens(tcfg, B, 12)
    with torch.no_grad():
        a = TM.forward(tcfg, tparams, {"tokens": toks,
                                       "frames": _frames(tcfg, B, 1)})[0]
        b = TM.forward(tcfg, tparams, {"tokens": toks,
                                       "frames": _frames(tcfg, B, 2)})[0]
    assert not torch.allclose(a, b, atol=1e-3)


@pytest.mark.parametrize("seq", [8, 32])
def test_pipeline_makes_the_references_audio_batches(seq):
    """Tokens, then enc_frames fp32 frames from the same generator, bit
    for bit over two steps."""
    jcfg, tcfg = jreg.get(ARCH).reduced(), treg.get(ARCH).reduced()
    jp, tp = JPipeline(jcfg, 3, seq, seed=2), LMTokenPipeline(tcfg, 3, seq,
                                                               seed=2)
    for _ in range(2):
        want, got = next(jp), next(tp)
        assert got.keys() == want.keys() == {"tokens", "frames"}
        assert got["frames"].shape == (3, tcfg.enc_frames, tcfg.d_model)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_make_cache_and_seq_axes_match_reference():
    """{"k", "v": [L, B, S, Hkv, hd], "ck", "cv": [L, B, enc_frames,
    Hkv, hd]}; the cross K / V are state leaves."""
    jcfg, tcfg = jreg.get(ARCH).reduced(), treg.get(ARCH).reduced()
    assert TM.cache_seq_axes(tcfg) == JM.cache_seq_axes(jcfg)
    for b, s in ((1, 8), (3, 40)):
        jc, tc = JM.make_cache(jcfg, b, s), TM.make_cache(tcfg, b, s)
        assert list(tc) == ["k", "v", "ck", "cv"] and set(jc) == set(tc)
        for key in jc:
            assert tuple(tc[key].shape) == jc[key].shape
            assert tc[key].dtype == tcfg.compute_dtype
            assert not tc[key].any()


def test_prefill_cache_and_decode_steps_match_reference(pair):
    """The static prefill with its cache, the cache grown to S + 3 (the
    cross K / V copied whole), then three decode steps from position S
    (the text's length): logits and every cache leaf, each step."""
    jcfg, tcfg, jparams, tparams = pair
    toks, frames = _tokens(tcfg, 3, 9, seed=4), _frames(tcfg, 3, seed=4)
    batch = {"tokens": toks, "frames": frames}
    jl, jc, _ = JM.forward(jcfg, jparams, _jbatch(batch), return_cache=True,
                           last_only=True)
    with torch.no_grad():
        tl, tc, _ = TM.forward(tcfg, tparams, batch, return_cache=True,
                               last_only=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL,
                               rtol=0)
    for k in jc:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   **BLOCK_TOL)
    n = toks.shape[1]
    jfull = JEngine(jcfg, jparams)._grow_cache(jc, 3, n + 3, n)
    tfull = Engine(tcfg, tparams, device="cpu")._grow_cache(tc, 3, n + 3, n)
    assert torch.equal(tfull["ck"], tc["ck"])
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
        for k in jfull:
            np.testing.assert_allclose(tfull[k].numpy(),
                                       np.asarray(jfull[k]), **BLOCK_TOL)


# ----------------------------------------------------------------- train
def test_two_pass_adam_step_matches_reference(pair):
    """One step on the pipeline's audio batch (tokens and frames): the
    encoder's weights move too."""
    jcfg, tcfg, jparams, tparams = pair
    jopt, topt = jadam(jconstant(1e-3)), adam(constant_schedule(1e-3))
    batch = next(JPipeline(jcfg, B, 32))
    tbatch = next(LMTokenPipeline(tcfg, B, 32))
    assert set(tbatch) == {"tokens", "frames"}
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
    enc0 = tparams["encoder"]["layers"][0]["mlp"]["wi"]["w"]
    assert not torch.equal(tp["encoder"]["layers"][0]["mlp"]["wi"]["w"],
                           enc0)


@pytest.mark.parametrize("kind", ["sgd", "adam_clip"])
def test_fused_steps_match_the_two_pass_step(pair, kind):
    """whisper's FFN junctions, the encoder's and the decoder's, updated
    inside their backward: one fused step equals the two-pass step of the
    same optimizer on the same audio batch."""
    _, tcfg, jparams, _ = pair
    opt = (fused_sgd(constant_schedule(3e-2), momentum=0.9) if kind == "sgd"
           else fused_adam(constant_schedule(1e-3), grad_clip=1.0))
    batch = next(LMTokenPipeline(tcfg, B, 32))
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
def test_static_greedy_matches_reference_engine(pair):
    """The same prompts and frames: the port's static engine gives the
    reference engine's tokens and those of its forward recomputed over
    the whole sequence (decode positions count from the text)."""
    jcfg, tcfg, jparams, tparams = pair
    prompts, frames = _tokens(tcfg, 3, 8, seed=5), _frames(tcfg, 3, seed=5)
    want = JEngine(jcfg, jparams, JServeConfig(max_new_tokens=8)).generate(
        prompts, {"frames": frames})
    eng = Engine(tcfg, tparams, ServeConfig(max_new_tokens=8), device="cpu")
    got = eng.generate(prompts, {"frames": frames})
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _recompute(jcfg, jparams, prompts,
                                                  frames, 8))
    assert eng.nonfinite_terminated == 0


def test_int8_serving_matches_reference(pair):
    """Every FFN junction of the encoder and the decoder from int8 codes."""
    jcfg, tcfg, jparams, tparams = pair
    prompts, frames = _tokens(tcfg, 2, 8, seed=3), _frames(tcfg, 2, seed=3)
    want = JEngine(jcfg, jparams, JServeConfig(
        max_new_tokens=4, quantize="int8")).generate(prompts,
                                                     {"frames": frames})
    eng = Engine(tcfg, tparams, ServeConfig(max_new_tokens=4,
                                            quantize="int8"), device="cpu")
    got = eng.generate(prompts, {"frames": frames})
    np.testing.assert_array_equal(got, want)
    assert "wq" in eng.params["encoder"]["layers"][0]["mlp"]["wi"]


def test_paged_path_refuses_audio_as_the_reference(pair):
    jcfg, tcfg, _, _ = pair
    assert TM.paged_supported(tcfg) == JM.paged_supported(jcfg)
    assert not TM.paged_supported(tcfg)[0]
    with pytest.raises(ValueError, match="paged cache unsupported"):
        TM.make_paged_cache(tcfg, 4, 8)


def test_encoder_checkpoint_restores_bit_for_bit(tmp_path):
    """The encoder's layer list and the learned positions, with Adam's
    slots, through train/checkpoint.py: every leaf equal bit for bit,
    bf16 included; the params alone restore from the same checkpoint."""
    cfg = treg.get(ARCH).reduced()
    params = TM.init(cfg, 3, "cpu")
    params["encoder"]["norm"]["scale"] = torch.randn(cfg.d_model).to(
        torch.bfloat16)
    opt = adam(constant_schedule(1e-3))
    tree = {"params": params, "opt": opt.init(params)}
    ckpt_mod.save(tmp_path, 4, tree, extra={"n": 2})
    like = tree_map(lambda t: torch.zeros_like(t) if torch.is_tensor(t)
                    else t, tree)
    step, got, extra = ckpt_mod.restore_latest(tmp_path, like)
    assert step == 4 and extra == {"n": 2}
    want = dict(tree_items(tree))
    for path, t in tree_items(got):
        assert t.dtype == want[path].dtype, path
        assert t.view(torch.uint8).numpy().tobytes() == want[
            path].view(torch.uint8).numpy().tobytes(), path
    assert len(got["params"]["encoder"]["layers"]) == cfg.enc_layers
    _, part, _ = ckpt_mod.restore_latest(tmp_path, {"params": like["params"]})
    assert torch.equal(part["params"]["embed"]["pos"],
                       params["embed"]["pos"])


def test_launchers_train_then_serve_the_checkpoint(tmp_path, capsys):
    """launch/train.py on audio batches, then launch/serve.py --ckpt with
    the launcher's own frames; int8; --continuous refused."""
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


def test_serve_launcher_makes_the_references_frames(monkeypatch):
    """The static launcher's frames come after its prompts from the same
    rng, enc_frames a request, as the reference's."""
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
    frames = rng.standard_normal((3, cfg.enc_frames, cfg.d_model)
                                 ).astype(np.float32)
    np.testing.assert_array_equal(seen["prompts"], prompts)
    assert list(seen["extra"]) == ["frames"]
    np.testing.assert_array_equal(seen["extra"]["frames"], frames)
