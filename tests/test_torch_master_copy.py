"""``adam(master_copy=True)`` against the JAX reference on the CPU.

* The optimizer alone: bf16 params, fp32 grads and fp32 masters carried
  across through numpy, three ``update`` calls on each side.  Masters,
  m and v agree within the train parity tolerance (rtol 5e-4 / atol
  5e-5: the same fp32 formula, whose ``sqrt`` and ``pow`` may round apart
  between the two libraries, over three steps), and each side's params
  are its own masters rounded to bf16, bit for bit.
* The default path is today's ``adam``, bit for bit: one step of fp32
  and of bf16 params against a copy of its formula kept here.
* The ``perf-sparse`` train step (the reference's ``_apply_variant``,
  ``src/repro/launch/dryrun.py:76-82``: density 0.125 at block 128 on
  the FFN, bf16-resident params, ``loss_chunk`` 2048) on reduced
  stablelm-3b: three two-pass steps of master-copy Adam on carried
  weights and the same batches.  Adam's m and v and each master's
  displacement from the start agree per leaf by norm (``STATE_REL``, set
  from readings; a planted wrong junction gradient breaks it).  The
  reference's own bf16 bounds (``tests/test_distributed.py:89``,
  ``:96``) hold too: losses within 2e-3 (in bf16 compute, the losses
  evaluated in fp32: the test says why), masters within 5e-3, though
  three Adam steps at lr 1e-4 part two masters by at most about 6e-4
  whatever their gradients.  The port's junctions run their plain
  versions (the tensors lie on the CPU); the reference runs its jnp
  engine (its ``auto`` engine on the CPU).
* The state travels: ``from_jax_opt_state`` carries ``master``, a
  checkpoint round-trips it bit for bit, and ``place_state`` on a
  one-rank mesh places it as it places ``m``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import registry as jreg
from repro.data.pipeline import LMTokenPipeline as JPipeline
from repro.models import model as JM
from repro.optim import adam as jadam
from repro.optim import constant_schedule as jconstant
from repro.train.steps import make_train_step as jmake_train_step

from repro_torch.configs import registry as treg
from repro_torch.convert import from_jax_opt_state, from_jax_params
from repro_torch.data.pipeline import LMTokenPipeline
from repro_torch.kernels import block_sparse_matmul as bsm
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.dryrun import _apply_variant
from repro_torch.models import model as TM
from repro_torch.optim import adam, constant_schedule, fused_adam
from repro_torch.optim.optimizers import clip_by_global_norm
from repro_torch.parallel import sharding as sh
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.steps import fused_update_eligible, make_train_step
from repro_torch.tree import tree_items, tree_map
from torch_parity_helpers import reference_variant

TREE_TOL = dict(rtol=5e-4, atol=5e-5)
LOSS_ATOL, MASTER_ATOL = 2e-3, 5e-3       # the reference's bf16 bounds
LR = 1e-4
SHAPES = {"w": (16, 24), "b": (24,), "deep": {"u": (3, 8, 8)}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(rng, shapes, scale=1.0):
    if isinstance(shapes, dict):
        return {k: _np_tree(rng, v, scale) for k, v in shapes.items()}
    return (scale * rng.standard_normal(shapes)).astype(np.float32)


def _with_pattern(tree, idx):
    """``tree`` with an int32 leaf, as a junction's block pattern."""
    return dict(tree, idx=idx)


def _trees(seed=0):
    """(params as fp32 numpy rounded to bf16 values, [grads of 3 steps])."""
    rng = np.random.default_rng(seed)
    p = _np_tree(rng, SHAPES)
    p = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16),
                                          np.float32), p)
    grads = [jax.tree.map(np.asarray, _np_tree(rng, SHAPES, 0.3))
             for _ in range(3)]              # keys in the params' order
    return p, grads


def _ref_tree(tree, dtype):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def _port_tree(tree, dtype):
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(dtype), tree)


def _f32(t):
    return t.float().numpy() if torch.is_tensor(t) else np.asarray(
        t, np.float32)


def _close(port, ref, **tol):
    got, want = dict(tree_items(port)), dict(tree_items(
        jax.tree.map(np.asarray, ref)))
    assert got.keys() == want.keys()
    for k, t in got.items():
        np.testing.assert_allclose(_f32(t), np.asarray(want[k], np.float32),
                                   err_msg=k, **tol)


@pytest.mark.parametrize("wd", [0.0, 0.1])
@pytest.mark.parametrize("clip", [None, 1.0])
def test_master_copy_updates_match_reference(wd, clip):
    p, grads = _trees()
    idx = np.arange(6, dtype=np.int32).reshape(2, 3)
    jopt = jadam(jconstant(LR), weight_decay=wd, grad_clip=clip,
                 master_copy=True)
    topt = adam(constant_schedule(LR), weight_decay=wd, grad_clip=clip,
                master_copy=True)
    jp = _with_pattern(_ref_tree(p, jnp.bfloat16), jnp.asarray(idx))
    tp = _with_pattern(_port_tree(p, torch.bfloat16), torch.from_numpy(idx))
    js, ts = jopt.init(jp), topt.init(tp)
    for i, g in enumerate(grads):
        jg = _with_pattern(_ref_tree(g, jnp.float32), jnp.asarray(idx))
        tg = _with_pattern(_port_tree(g, torch.float32),
                           torch.from_numpy(idx))
        jp, js = jopt.update(jg, js, jp, jnp.asarray(i, jnp.int32))
        tp, ts = topt.update(tg, ts, tp, i)
    assert set(ts) == {"m", "v", "master"}
    for key in ("master", "m", "v"):
        _close(ts[key], js[key], **TREE_TOL)
    for (k, t), (_, m) in zip(tree_items(tp), tree_items(ts["master"])):
        if t.is_floating_point():
            assert t.dtype == torch.bfloat16 and m.dtype == torch.float32
            assert torch.equal(t, m.to(torch.bfloat16)), k
        else:
            assert torch.equal(t, torch.from_numpy(idx)), k
    for (k, t), (_, m) in zip(tree_items(jax.tree.map(np.asarray, jp)),
                              tree_items(jax.tree.map(np.asarray,
                                                      js["master"]))):
        if np.issubdtype(t.dtype, np.floating) or t.dtype == jnp.bfloat16:
            assert np.array_equal(t.view(np.uint16), np.asarray(
                jnp.asarray(m).astype(jnp.bfloat16)).view(np.uint16)), k


def test_master_copy_init_matches_reference():
    p, _ = _trees(1)
    idx = np.arange(6, dtype=np.int32).reshape(2, 3)
    tp = _with_pattern(_port_tree(p, torch.bfloat16), torch.from_numpy(idx))
    st = adam(constant_schedule(LR), master_copy=True).init(tp)
    js = jadam(jconstant(LR), master_copy=True).init(
        _with_pattern(_ref_tree(p, jnp.bfloat16), jnp.asarray(idx)))
    carried = from_jax_opt_state(jax.tree.map(np.asarray, js))
    assert set(st) == set(carried) == {"m", "v", "master"}
    m, c, params = (dict(tree_items(t)) for t in (st["m"],
                                                  carried["master"], tp))
    for k, t in tree_items(st["master"]):
        assert t.dtype == torch.float32 and torch.equal(t, c[k]), k
        if k == "idx":
            assert t.shape == m[k].shape == () and torch.equal(t, m[k]), k
        else:
            assert torch.equal(t, params[k].float()), k
    st["master"]["w"].add_(1.0)                   # a copy, not the param
    assert not torch.equal(st["master"]["w"], tp["w"].float())


def _adam_as_before(grads, state, params, step, lr, wd, clip,
                    b1=0.9, b2=0.95, eps=1e-8):
    """The port's ``adam`` update as it stood before ``master_copy``."""
    if clip is not None:
        grads, _ = clip_by_global_norm(grads, clip)
    t = torch.as_tensor(step, dtype=torch.float32) + 1.0
    c1 = 1.0 - torch.pow(torch.as_tensor(b1, dtype=torch.float32), t)
    c2 = 1.0 - torch.pow(torch.as_tensor(b2, dtype=torch.float32), t)
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        if not p.is_floating_point():
            new_p[k], new_m[k], new_v[k] = p, state["m"][k], state["v"][k]
            continue
        gf = grads[k].float()
        m = b1 * state["m"][k] + (1 - b1) * gf
        v = b2 * state["v"][k] + (1 - b2) * torch.square(gf)
        ref = p.float()
        step_ = (m / c1) / (torch.sqrt(v / c2) + eps)
        if wd:
            step_ = step_ + wd * ref
        new_p[k], new_m[k], new_v[k] = (ref - lr * step_).to(p.dtype), m, v
    return new_p, {"m": new_m, "v": new_v}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_default_adam_is_bit_for_bit_as_before(dtype):
    p, grads = _trees(2)
    p = {"w": p["w"], "b": p["b"]}
    idx = torch.arange(4, dtype=torch.int32)
    tp = dict(_port_tree(p, dtype), idx=idx)
    tg = dict(_port_tree({"w": grads[0]["w"], "b": grads[0]["b"]},
                         torch.float32), idx=idx)
    opt = adam(constant_schedule(LR), weight_decay=0.1)
    st = opt.init(tp)
    assert set(st) == {"m", "v"}
    st["m"]["w"].normal_(generator=torch.Generator().manual_seed(3))
    got_p, got_s = opt.update(tg, st, tp, 4)
    want_p, want_s = _adam_as_before(tg, st, tp, 4, LR, 0.1, 1.0)
    for got, want in ((got_p, want_p), (got_s, want_s)):
        for (k, a), (_, b) in zip(tree_items(got), tree_items(want)):
            assert a.dtype == b.dtype and torch.equal(a, b), k
    assert set(fused_adam(constant_schedule(LR)).init(tp)) == {"m", "v"}


# ------------------------------------------------- the perf-sparse step
SEQ, BATCH, STEPS = 16, 2, 3
# after the steps, per leaf, ||port - reference|| / ||reference|| of
# Adam's m and v and of each master's displacement from the carried
# start (an Adam step moves a master by about lr whatever its gradient,
# so the masters themselves could not tell a wrong gradient; m carries
# the gradients and the displacement their direction).  Measured on
# seed 0: bf16 compute m 2.10e-2, v 2.21e-2, moved 0.131 (the two
# frameworks round bf16 at their own points; an early Adam step is about
# lr times a gradient's sign, so elements at the noise floor move apart);
# fp32 compute 1.64e-3, 2.84e-3, 4.99e-4 (gradients of bf16 params are
# bf16 on both sides, and a value next to a half-way point rounds apart).
# A planted wrong gradient moves m by 0.49 to 1.05
# (``test_perf_sparse_gaps_catch_a_wrong_gradient``).
STATE_REL = {"bfloat16": {"m": 5e-2, "v": 5e-2, "moved": 0.3},
             "float32": {"m": 5e-3, "v": 1e-2, "moved": 2e-3}}


@pytest.fixture(scope="module")
def perf_cfgs():
    """The dry run's ``perf-sparse`` variant of reduced stablelm-3b, on
    both sides."""
    tcfg = _apply_variant(treg.get("stablelm-3b").reduced(), "perf-sparse")
    jcfg = reference_variant(jreg.get("stablelm-3b").reduced(), tcfg)
    assert tcfg.d_model % 128 == 0 and tcfg.d_ff % 128 == 0
    return jcfg, tcfg


def _bf16_params(jparams):
    """Reference params (bf16) carried into the port's layout, bf16."""
    as32 = jax.tree.map(lambda a: np.asarray(a, np.float32)
                        if a.dtype == jnp.bfloat16 else np.asarray(a),
                        jparams)
    return tree_map(lambda t: t.to(torch.bfloat16) if t.is_floating_point()
                    else t, from_jax_params(as32))


def _reference_steps(jcfg, compute):
    """STEPS two-pass master-copy steps of the reference at ``compute``:
    (its init params, its losses, the same steps' losses evaluated in
    fp32 before each update, its final state in the port's layout)."""
    cfg = dataclasses.replace(jcfg, dtype=compute)
    c32 = dataclasses.replace(jcfg, dtype="float32")
    params = JM.init(cfg, jax.random.PRNGKey(0))
    opt = jadam(jconstant(LR), master_copy=True)
    step = jmake_train_step(cfg, opt, donate=False)
    p, s, pipe = params, opt.init(params), JPipeline(cfg, BATCH, SEQ)
    losses, losses32 = [], []
    for i in range(STEPS):
        b = jax.tree.map(jnp.asarray, next(pipe))
        losses32.append(float(JM.loss_fn(c32, p, b)[0]))
        p, s, m = step(p, s, b, jnp.asarray(i))
        losses.append(float(m["loss"]))
    state = from_jax_opt_state(jax.tree.map(
        lambda a: np.asarray(a, np.float32) if a.dtype == jnp.bfloat16
        else np.asarray(a), s))
    return _bf16_params(jax.tree.map(np.asarray, params)), losses, \
        losses32, state


@pytest.fixture(scope="module")
def reference_steps(perf_cfgs):
    """``_reference_steps`` at a compute dtype, run once a module."""
    done = {}

    def get(compute):
        if compute not in done:
            done[compute] = _reference_steps(perf_cfgs[0], compute)
        return done[compute]
    return get


def _port_steps(tcfg, compute, start):
    """The port's side of ``_reference_steps`` from the carried ``start``:
    (params, state, losses, fp32 losses)."""
    cfg = dataclasses.replace(tcfg, dtype=compute)
    c32 = dataclasses.replace(tcfg, dtype="float32")
    opt = adam(constant_schedule(LR), master_copy=True)
    assert not fused_update_eligible(cfg, opt)[0]
    step = make_train_step(cfg, opt)
    p = tree_map(torch.clone, start)
    s, pipe = opt.init(p), LMTokenPipeline(cfg, BATCH, SEQ)
    losses, losses32 = [], []
    for i in range(STEPS):
        b = next(pipe)
        losses32.append(float(TM.loss_fn(c32, p, b)[0]))
        p, s, m = step(p, s, b, i)
        assert float(m["nonfinite"]) == 0.0
        losses.append(float(m["loss"]))
    return p, s, losses, losses32


def _state_gaps(port, ref, start) -> dict:
    """The largest, over leaves, of ``STATE_REL``'s three norms."""
    gaps = dict.fromkeys(("m", "v", "moved"), 0.0)
    start = dict(tree_items(start))
    for key, ports, refs in (("m", port["m"], ref["m"]),
                             ("v", port["v"], ref["v"]),
                             ("moved", port["master"], ref["master"])):
        for (k, a), (_, b) in zip(tree_items(ports), tree_items(refs)):
            if not a.dim():
                continue
            if key == "moved":
                a, b = a - start[k].float(), b - start[k].float()
            num = torch.linalg.vector_norm(a - b)
            den = torch.linalg.vector_norm(b)
            gap = float(num / den) if den else float(num) * float("inf")
            gaps[key] = max(gaps[key], gap if num else 0.0)
    return gaps


@pytest.mark.parametrize("compute", ["bfloat16", "float32"])
def test_perf_sparse_steps_match_reference(perf_cfgs, reference_steps,
                                           compute):
    """Three two-pass master-copy steps, at the variant's bf16 compute and
    at fp32 compute (bf16-resident params either way).

    Adam's m, v and the masters' displacements agree within
    ``STATE_REL``.  The losses see weights that moved by at most 3 lr, so
    they mostly hold the forward.  In bf16 each framework rounds at its
    own points (XLA's CPU fusions keep fp32 inside a fusion, eager
    PyTorch rounds every op), which moves each side's loss by up to
    5.1e-3 from its own fp32 loss on seeds 0-2, though the two sides'
    fp32 losses agree within 1.5e-4.  So in bf16 the 2e-3 bound holds
    each step's loss evaluated in fp32 (the same weights and batch on
    both sides), and each side's bf16 loss lies within 1e-2 relative of
    its own fp32 one (``chip_smoke.STEP_TOL``'s bf16 bound); in fp32 it
    holds the steps' losses themselves."""
    start, jl, jl32, js = reference_steps(compute)
    tp, ts, tl, tl32 = _port_steps(perf_cfgs[1], compute, start)
    for i in range(STEPS):
        if compute == "float32":
            assert abs(tl[i] - jl[i]) < LOSS_ATOL, i
            continue
        assert abs(tl32[i] - jl32[i]) < LOSS_ATOL, i
        assert abs(tl[i] - tl32[i]) <= 1e-2 * abs(tl32[i]), i
        assert abs(jl[i] - jl32[i]) <= 1e-2 * abs(jl32[i]), i
    gaps = _state_gaps(ts, js, start)
    print(f"[perf-sparse {compute}] largest per-leaf gaps {gaps}")
    for key, lim in STATE_REL[compute].items():
        assert gaps[key] <= lim, (key, gaps[key])
    worst = max(float((a - b).abs().max()) for (_, a), (_, b) in zip(
        tree_items(ts["master"]), tree_items(js["master"])) if a.dim())
    assert worst < MASTER_ATOL, worst
    for (k, t), (_, m) in zip(tree_items(tp), tree_items(ts["master"])):
        assert m.dtype == torch.float32, k
        if t.is_floating_point():
            assert t.dtype == torch.bfloat16
            assert torch.equal(t, m.to(torch.bfloat16)), k


def _scaled(fn, by):
    """``fn`` with every tensor it returns times ``by``."""
    def wrong(*a, **kw):
        out = fn(*a, **kw)
        if torch.is_tensor(out):
            return by * out
        return tuple(None if t is None else by * t for t in out)
    return wrong


@pytest.mark.parametrize("fault", ["dx zeroed", "dx halved", "dw halved"])
def test_perf_sparse_gaps_catch_a_wrong_gradient(perf_cfgs, reference_steps,
                                                 fault, monkeypatch):
    """The same steps with a wrong junction gradient planted in the port
    (its dx or dw outputs, at every sparse junction): m leaves
    ``STATE_REL``'s bf16 bound, which the right gradients keep."""
    name, how = fault.split()
    got = getattr(bsm, name)
    monkeypatch.setattr(bsm, name, _scaled(got, 0.5 if how == "halved"
                                           else 0.0))
    start, _, _, js = reference_steps("bfloat16")
    _, ts, _, _ = _port_steps(perf_cfgs[1], "bfloat16", start)
    gaps = _state_gaps(ts, js, start)
    print(f"[perf-sparse {fault}] largest per-leaf gaps {gaps}")
    assert gaps["m"] > STATE_REL["bfloat16"]["m"], gaps


# ------------------------------------------------ the state travels
def _state(tcfg):
    params = TM.init(tcfg, 0, "cpu")
    opt = adam(constant_schedule(LR), master_copy=True)
    return params, opt.init(params)


def test_master_state_checkpoint_round_trips(perf_cfgs, tmp_path):
    _, tcfg = perf_cfgs
    params, st = _state(tcfg)
    tree = {"params": params, "opt_state": st}
    ckpt.save(tmp_path, 1, tree)
    got, _ = ckpt.restore(tmp_path, 1, tree)
    assert set(got["opt_state"]) == {"m", "v", "master"}
    for (k, a), (_, b) in zip(tree_items(got), tree_items(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b), k


def test_place_state_places_master_like_m(perf_cfgs):
    _, tcfg = perf_cfgs
    params, st = _state(tcfg)
    tmesh.start_one_rank_group("cpu")
    try:
        mesh = tmesh.make_local_mesh(1, 1, "cpu")
        placed = sh.place_state(st, sh.param_specs(tcfg, params, mesh), mesh)
        for (k, a), (_, m), (_, full) in zip(
                tree_items(placed["master"]), tree_items(placed["m"]),
                tree_items(st["master"])):
            assert type(a) is type(m), k
            if hasattr(a, "placements"):
                assert a.placements == m.placements, k
                a = a.full_tensor()
            assert torch.equal(a, full), k
    finally:
        dist.destroy_process_group()
