"""The port's int8 gradient compression with error feedback
(``train/grad_compress.py``) against the JAX reference on the CPU.

* ``quantize_int8`` / ``compress_decompress`` bit for bit against the
  reference on random, all-zero and tiny gradients, a half-way value and
  bf16 input; the error-feedback property of tests/test_distributed.py;
* 3 steps of ``compressed(adam)`` against the reference's on reduced
  stablelm-3b and whisper-base, end to end and fed the reference's own
  gradients (the residual bit for bit: one scale a stack of layers, as
  the reference's one a stacked leaf), and the 30-step loss gap of
  tests/test_system.py;
* ``convert.from_jax_opt_state`` of a compressed state, a resume through
  train/checkpoint.py that keeps the residual, and ``launch/train.py
  --compress-grads`` printing the two-pass path with its reason.

Config: reduced stablelm-3b and whisper-base, FFN density 0.5 at block
32, fp32 compute; weights made by the reference and carried across with
``convert.from_jax_params``.  Tolerances: compression exact, and the
residual exact given the same gradients; params and Adam's slots within
rtol 5e-4 / atol 5e-5 (tests/test_torch_train.py's bounds); losses
within 1e-5 relative.  End to end the two sides' gradients differ in
summation order, so a corrected gradient at a rounding boundary of the
codes may restore to the neighbouring code on one side: at most one
weight in 10^4 of a leaf a step may then sit up to 2 lr a step apart.
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
from repro.train import grad_compress as JGC
from repro.train.steps import make_train_step as jmake_train_step

from repro_torch.configs import registry as treg
from repro_torch.convert import from_jax_opt_state, from_jax_params
from repro_torch.core.sparsity import SparsityConfig
from repro_torch.data.pipeline import LMTokenPipeline
from repro_torch.launch import train as ttrain
from repro_torch.models import model as TM
from repro_torch.optim import adam, constant_schedule
from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.train import grad_compress as GC
from repro_torch.train.steps import make_train_step
from repro_torch.tree import tree_items, tree_map
from torch_parity_helpers import close_trees

TREE_TOL = dict(rtol=5e-4, atol=5e-5)
LOSS_RTOL = 1e-5
LR = 1e-3
B, S = 2, 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(arch):
    sp = dict(density=0.5, block=32, where="ffn")
    jcfg = dataclasses.replace(
        jreg.get(arch).reduced().with_sparsity(JSparsity(**sp)),
        dtype="float32", engine="jnp")
    tcfg = dataclasses.replace(
        treg.get(arch).reduced().with_sparsity(SparsityConfig(**sp)),
        dtype="float32")
    jparams = jax.tree.map(np.asarray, JM.init(jcfg, jax.random.PRNGKey(0)))
    return jcfg, tcfg, jparams, from_jax_params(jparams)


@pytest.fixture(scope="module", params=["stablelm-3b", "whisper-base"])
def pair(request):
    return _pair(request.param)


def _grads(kind, shape=(64, 48), seed=0):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal(shape).astype(np.float32)
    return {"random": g * 0.01, "zero": np.zeros(shape, np.float32),
            "tiny": g * 1e-30, "large": g * 1e4,
            "halfway": np.array([0.5, 1.5, 2.5, -0.5, -2.5, 127.0],
                                np.float32)}[kind]


def _bits(t):
    return np.atleast_1d(np.asarray(t)).view(np.uint8).tobytes()


# ------------------------------------------------------------ compression
@pytest.mark.parametrize("kind", ["random", "zero", "tiny", "large",
                                  "halfway"])
def test_compress_decompress_bit_for_bit(kind):
    """Codes, scale, restored gradient and residual equal the reference's
    bit for bit, from a zero residual and from a non-zero one."""
    g = _grads(kind)
    err = np.zeros_like(g)
    for _ in range(2):
        jq, js = JGC.quantize_int8(jnp.asarray(g + err))
        tq, ts = GC.quantize_int8(torch.from_numpy(g + err))
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        assert _bits(tq.numpy()) == _bits(jq)
        assert _bits(ts.numpy()) == _bits(js)
        jr, je = JGC.compress_decompress(jnp.asarray(g), jnp.asarray(err))
        tr, te = GC.compress_decompress(torch.from_numpy(g),
                                        torch.from_numpy(err))
        assert tr.dtype == te.dtype == torch.float32
        assert _bits(tr.numpy()) == _bits(jr)
        assert _bits(te.numpy()) == _bits(je)
        err = np.array(je)


def test_halfway_codes_round_to_even():
    """x / scale exactly half-way between two codes goes to the even one,
    and the codes clip at +-127."""
    g = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5, 127.0])
    q, scale = GC.quantize_int8(g)
    assert float(scale) == pytest.approx(1.0)
    assert q.tolist() == [0, 2, 2, 0, -2, 127]


def test_bf16_gradient_is_widened_first():
    g = torch.from_numpy(_grads("random")).bfloat16()
    jr, je = JGC.compress_decompress(jnp.asarray(g.float().numpy(),
                                                 jnp.bfloat16),
                                     jnp.zeros(g.shape, jnp.float32))
    tr, te = GC.compress_decompress(g, torch.zeros(g.shape))
    assert _bits(tr.numpy()) == _bits(jr) and _bits(te.numpy()) == _bits(je)


def test_error_feedback_bounds_the_residual():
    """tests/test_distributed.py's property: the restored gradient within
    2 % of it, and a second step's residual no larger than 1.5 x the
    first's."""
    g = torch.randn(1000, generator=torch.Generator().manual_seed(0)) * 0.01
    restored, err2 = GC.compress_decompress(g, torch.zeros_like(g))
    rel = float(torch.linalg.norm(restored - g) / torch.linalg.norm(g))
    assert rel < 0.02, rel
    _, err3 = GC.compress_decompress(g, err2)
    assert float(torch.linalg.norm(err3)) <= float(
        torch.linalg.norm(err2)) * 1.5 + 1e-6


def test_state_mirrors_the_params():
    """An fp32 residual a trainable leaf (zeros), a 0-d placeholder at
    each integer pattern leaf; the wrapped optimizer's state under
    "base"."""
    cfg = treg.get("stablelm-3b").reduced().with_sparsity(
        SparsityConfig(density=0.5, block=32, where="ffn"))
    params = TM.init(cfg, 0, "cpu")
    st = GC.compressed(adam(constant_schedule(LR))).init(params)
    assert set(st) == {"base", "err"} and set(st["base"]) == {"m", "v"}
    errs = dict(tree_items(st["err"]))
    n_int = 0
    for path, p in tree_items(params):
        e = errs[path]
        assert e.dtype == torch.float32 and not e.any()
        if p.is_floating_point():
            assert e.shape == p.shape
        else:
            n_int += 1
            assert e.dim() == 0
    assert n_int > 0


# ---------------------------------------------------------------- training
def _ref_steps(jcfg, jparams, n):
    jopt = JGC.compressed(jadam(jconstant(LR)))
    ts = jmake_train_step(jcfg, jopt, donate=False)
    p, s, losses = jax.tree.map(jnp.asarray, jparams), None, []
    s = jopt.init(p)
    pipe = JPipeline(jcfg, B, S)
    for i in range(n):
        p, s, m = ts(p, s, jax.tree.map(jnp.asarray, next(pipe)),
                     jnp.asarray(i))
        losses.append(float(m["loss"]))
    return (from_jax_params(jax.tree.map(np.asarray, p)),
            from_jax_opt_state(jax.tree.map(np.asarray, s)), losses)


def _port_steps(tcfg, tparams, n):
    opt = GC.compressed(adam(constant_schedule(LR)))
    step = make_train_step(tcfg, opt)
    p, s, losses = tparams, opt.init(tparams), []
    pipe = LMTokenPipeline(tcfg, B, S)
    for i in range(n):
        p, s, m = step(p, s, next(pipe), i)
        losses.append(float(m["loss"]))
    return p, s, losses


def _held_but_flips(got, want, bound, flip, n_steps):
    """Each leaf of ``got`` within ``bound(want leaf)`` of ``want``'s but
    for at most one element in 10^4 a step (at least one a step), which
    may sit up to ``flip(want leaf)`` apart: where a corrected gradient
    lies at a rounding boundary of the int8 codes, the summation-order
    noise of the two sides restores it to neighbouring codes."""
    w = dict(tree_items(want))
    for path, t in tree_items(got):
        if not (t.is_floating_point() and t.dim()):
            continue
        a, b = t.numpy(), w[path].numpy()
        d = np.abs(a - b)
        wide = d > bound(b)
        assert wide.sum() <= n_steps * max(1, a.size // 10 ** 4), (
            path, int(wide.sum()))
        assert (d[wide] <= flip(b)).all(), (path, float(d.max()))


def test_compressed_adam_tracks_reference_over_3_steps(pair):
    """3 train steps end to end: losses, and params within the train
    tolerance; an element whose restored gradient took the neighbouring
    code on one side (``_held_but_flips``) may move its weight by 2 lr a
    step."""
    jcfg, tcfg, jparams, tparams = pair
    jp, _, jl = _ref_steps(jcfg, jparams, 3)
    tp, _, tl = _port_steps(tcfg, tparams, 3)
    for a, b in zip(tl, jl):
        assert abs(a - b) <= LOSS_RTOL * abs(b)
    _held_but_flips(tp, jp, lambda b: TREE_TOL["atol"]
                    + TREE_TOL["rtol"] * np.abs(b),
                    lambda b: 2 * LR * 3 * (1 + 1e-5), 3)


def _carried_grads(jgrads):
    """The reference's gradients in the port's layout; its float0
    placeholders of the integer leaves become int32 zeros, which the
    optimizers skip as they skip None."""
    return from_jax_params(jax.tree.map(
        lambda g: (np.zeros(g.shape, np.int32)
                   if g.dtype == jax.dtypes.float0 else np.asarray(g)),
        jgrads))


def test_compressed_update_on_the_references_gradients(pair):
    """``compressed(adam).update`` fed the reference's own gradients of 3
    steps: the residual bit for bit every step (one scale a stacked leaf
    of the reference, a stack of layers here), params and Adam's m / v
    within the train tolerance."""
    jcfg, tcfg, jparams, tparams = pair
    jopt = JGC.compressed(jadam(jconstant(LR)))
    topt = GC.compressed(adam(constant_schedule(LR)))
    jpipe = JPipeline(jcfg, B, S)
    p = jax.tree.map(jnp.asarray, jparams)
    js, tp, ts = jopt.init(p), tparams, topt.init(tparams)
    for i in range(3):
        batch = jax.tree.map(jnp.asarray, next(jpipe))
        g = jax.grad(lambda q: JM.loss_fn(jcfg, q, batch)[0],
                     allow_int=True)(p)
        p, js = jopt.update(g, js, p, jnp.asarray(i))
        tp, ts = topt.update(_carried_grads(g), ts, tp, i)
        want = from_jax_opt_state(jax.tree.map(np.asarray, js))
        errs = dict(tree_items(want["err"]))
        for path, e in tree_items(ts["err"]):
            assert _bits(e.numpy()) == _bits(errs[path].numpy()), (i, path)
        close_trees(ts["base"], want["base"], **TREE_TOL)
        close_trees(tp, from_jax_params(jax.tree.map(np.asarray, p)),
                    **TREE_TOL)


def test_thirty_step_loss_gap_of_compression():
    """tests/test_system.py's contract on the port: 30 Adam steps with
    and without compression end within 0.25 of each other."""
    cfg = treg.get("stablelm-3b").reduced()
    params = TM.init(cfg, 0, "cpu")
    losses = {}
    for name, wrap in (("plain", lambda o: o), ("int8", GC.compressed)):
        opt = wrap(adam(constant_schedule(1e-3)))
        step = make_train_step(cfg, opt)
        p, st = params, opt.init(params)
        pipe = LMTokenPipeline(cfg, 4, 64)
        for i in range(30):
            p, st, m = step(p, st, next(pipe), i)
        losses[name] = float(m["loss"])
    assert abs(losses["plain"] - losses["int8"]) < 0.25, losses


def test_from_jax_opt_state_carries_a_compressed_state(pair):
    """{"base": {"m", "v"}, "err"} one level deeper, in the port's layout:
    the leaves of ``compressed(adam).init`` of the port's params."""
    jcfg, tcfg, jparams, tparams = pair
    jst = JGC.compressed(jadam(jconstant(LR))).init(
        jax.tree.map(jnp.asarray, jparams))
    got = from_jax_opt_state(jax.tree.map(np.asarray, jst))
    own = GC.compressed(adam(constant_schedule(LR))).init(tparams)
    shapes = {p: tuple(t.shape) for p, t in tree_items(got)}
    assert shapes == {p: tuple(t.shape) for p, t in tree_items(own)}
    assert set(got) == {"base", "err"} and set(got["base"]) == {"m", "v"}


def test_resume_keeps_the_residual(tmp_path):
    """Two compressed steps, a checkpoint, two more from the restored
    state: the same params, slots and residual bit for bit as four steps
    in one go."""
    cfg = treg.get("stablelm-3b").reduced().with_sparsity(
        SparsityConfig(density=0.5, block=32, where="ffn"))
    opt = GC.compressed(adam(constant_schedule(LR)))
    step = make_train_step(cfg, opt)
    batches = list(zip(range(4), LMTokenPipeline(cfg, B, 16)))

    def run(p, s, part):
        for i, b in part:
            p, s, _ = step(p, s, b, i)
        return p, s

    params = TM.init(cfg, 0, "cpu")
    p2, s2 = run(params, opt.init(params), batches[:2])
    assert any(e.abs().max() > 0 for _, e in tree_items(s2["err"]))
    ckpt_mod.save(tmp_path, 2, {"params": p2, "opt": s2})
    like = tree_map(lambda t: torch.zeros_like(t), {"params": p2,
                                                    "opt": s2})
    _, got, _ = ckpt_mod.restore_latest(tmp_path, like)
    for (path, a), (_, b) in zip(tree_items(got["opt"]), tree_items(s2)):
        assert _bits(a.numpy()) == _bits(b.numpy()), path
    resumed = run(got["params"], got["opt"], batches[2:])
    whole = run(p2, s2, batches[2:])
    for (path, a), (_, b) in zip(tree_items(resumed), tree_items(whole)):
        assert _bits(a.numpy()) == _bits(b.numpy()), path


def test_train_launcher_compress_grads(tmp_path, capsys):
    """--compress-grads trains on the two-pass path, printed with its
    reason, and the checkpoint carries the residual."""
    res = ttrain.main(["--reduce", "--sparse", "--compress-grads",
                       "--steps", "2", "--batch", "2", "--seq", "16",
                       "--device", "cpu", "--ckpt", str(tmp_path / "ck")])
    text = capsys.readouterr().out
    assert "update path: two-pass (ArchConfig.fused_update is off)" in text
    assert res["step"] == 2
    assert all(np.isfinite(h["loss"]) for h in res["history"])
    cfg = treg.get("stablelm-3b").reduced().with_sparsity(
        SparsityConfig(density=0.25, block=32, where="ffn"))
    params = TM.init(cfg, 0, "cpu")
    opt = GC.compressed(adam(constant_schedule(LR)))
    _, tree, _ = ckpt_mod.restore_latest(
        tmp_path / "ck", {"params": params, "opt": opt.init(params)})
    assert set(tree["opt"]) == {"base", "err"}
    assert any(e.abs().max() > 0 for _, e in tree_items(tree["opt"]["err"]))
