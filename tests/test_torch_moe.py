"""The port's MoE slice (routing, capacity, the expert FFN through the
gated junction, serving and training) against the JAX reference on the
CPU.

Config: reduced qwen3-moe-30b-a3b (2 layers, d_model 128, 8 experts
top-2, group 64, rmsnorm, full rotary, rope_theta 1e6) with qwen3's
attention shape kept where it matters to the port: 8 query heads on one
kv head (GQA rep 8) of head_dim 128.  The experts are widened to
d_expert 128 and made sparse at density 0.5, block 32, so both expert
junctions have fan-in 2 (at the reduced defaults both have fan-in 1,
which never exercises the fan-in loop).  fp32 throughout.  Weights and
optimizer state are made by the reference and carried across with
``convert``.  The reference runs its Pallas kernels in interpret mode or
its gather-and-einsum engine ("jnp"); the port's wrappers run their plain
versions (the tensors lie on the CPU).

Tolerances: fp32 outputs differ in summation order only (1e-5; logits
2e-4 after 2 layers, as the dense slice).  After 3 train steps params
and slots agree to rtol 5e-4 / atol 5e-5, the reference's own bound
between its fused and two-pass Adam steps: Adam's m / sqrt(v) divides
small gradients by their own magnitude.  Where a gradient element sits at
the summation-order noise floor in a step (below 1e-5 of its leaf's
largest, or of opposite signs on the two sides), Adam's step there is lr
times a ratio of noise-sized numbers, anything from -lr to lr on either
side: such an element may differ by 2 lr more for each such step, and at
most one element in 10^4 of a leaf may be one.

Routing: the two packages' router probabilities differ by summation-order
noise (measured by ``near_tie`` on equal inputs), so a token whose k-th
and (k+1)-th probabilities lie within that noise may take either expert
in either package, whatever the machine.  The train steps run the port
under every order of such near-tied choices and hold the reference to
one of them, with the tolerances above unchanged.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core.sparsity import SparsityConfig as JSparsity
from repro.data.pipeline import LMTokenPipeline as JPipeline
from repro.models import attention as jattn
from repro.models import model as JM
from repro.models import moe as jmoe
from repro.models.layers import norm_apply as jnorm
from repro.optim import constant_schedule as jconstant
from repro.optim import fused_adam as jfused_adam
from repro.optim import fused_sgd as jfused_sgd
from repro.serve.engine import ContinuousEngine as JEngine
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeConfig as JServeConfig
from repro.train.steps import make_train_step as jmake_train_step

from repro_torch.configs import registry as treg
from repro_torch.convert import from_jax_opt_state, from_jax_params
from repro_torch.core.sparsity import SparsityConfig
from repro_torch.data.pipeline import LMTokenPipeline
from repro_torch.kernels import ops
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as tlaunch
from repro_torch.models import model as TM
from repro_torch.models import moe as tmoe
from repro_torch.optim import constant_schedule, fused_adam, fused_sgd
from repro_torch.serve.engine import ContinuousEngine, Request, ServeConfig
from repro_torch.train.steps import make_train_step
from repro_torch.tree import tree_items, tree_map

FP32 = dict(atol=1e-5, rtol=1e-5)
LOGIT_ATOL = 2e-4
LOSS_RTOL = 1e-5
TREE_TOL = dict(rtol=5e-4, atol=5e-5)
TRACE = [(12, 5, 0), (20, 4, 0), (7, 6, 3)]    # (prompt len, max_new, arrival)
SERVE = dict(slots=2, page_size=8, prefill_chunk=8, max_seq=32)
SEQ, BATCH = 16, 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: the test workers share the
    cores, and oversubscribed BLAS / OpenMP thread teams spin (an fp64
    gradcheck here ran a hundred times slower beside five busy workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(reg, sparsity, **kw):
    cfg = reg.get("qwen3-moe-30b-a3b").reduced()
    cfg = dataclasses.replace(
        cfg, n_heads=8, kv_heads=1, head_dim=128, dtype="float32",
        moe=dataclasses.replace(cfg.moe, d_expert=128), **kw)
    return cfg.with_sparsity(sparsity(density=0.5, block=32, where="ffn"))


def _cfgs(**kw):
    return _cfg(jreg, JSparsity, **kw), _cfg(treg, SparsityConfig, **kw)


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = _cfgs()
    jparams = JM.init(jcfg, jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jparams)
    return jcfg, tcfg, jparams, np_params, from_jax_params(np_params)


def test_config_reaches_qwen3_attention_and_fan_in_two(setup):
    _, tcfg, _, _, tparams = setup
    assert tcfg.n_heads // tcfg.kv_heads == 8 and tcfg.head_dim == 128
    assert (tcfg.partial_rotary, tcfg.norm, tcfg.rope_theta) == (
        1.0, "rmsnorm", 1e6)
    moe = tparams["layers"][0]["moe"]
    assert tuple(moe["wg"].shape) == (8, 4, 2, 32, 32)
    assert tuple(moe["wo"].shape) == (8, 4, 2, 32, 32)


# ------------------------------------------------------------- routing
def test_top_k_breaks_ties_as_the_reference():
    rng = np.random.default_rng(0)
    p = rng.integers(0, 4, size=(3, 5, 16)).astype(np.float32)  # many ties
    jv, ji = jax.lax.top_k(jnp.asarray(p), 6)
    tv, ti = tmoe._top_k(torch.from_numpy(p), 6)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def _moe_inputs(case, layer):
    """x [2, 32, 128] (64 tokens, one dispatch group, capacity 20) and the
    layer's MoE params with the router changed for the case: "drops"
    sends every token to expert 0 first (64 tokens for 20 places);
    "tied" makes experts 1 and 2, and 5 and 6, tie exactly."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 32, 128)).astype(np.float32)
    router = np.array(layer["router"])
    if case == "drops":
        x += 1.0
        router[:, 0] = 0.5
        top1 = np.argmax(x.reshape(-1, 128) @ router, axis=-1)
        assert (top1 == 0).sum() > 20           # more than capacity C
    else:
        router[:, 2] = router[:, 1]
        router[:, 6] = router[:, 5]
    return x, dict(layer, router=router)


@pytest.mark.parametrize("engine", ["pallas", "jnp"])
@pytest.mark.parametrize("case", ["drops", "tied"])
def test_moe_apply_matches_reference(setup, engine, case):
    jcfg, tcfg, _, np_params, _ = setup
    layer = jax.tree.map(lambda a: a[0], np_params["layers"]["moe"])
    x, layer = _moe_inputs(case, layer)
    g, G, C = tmoe.moe_dispatch_dims(tcfg.moe, 64)
    assert (g, G, C) == jmoe.moe_dispatch_dims(jcfg.moe, 64) == (64, 1, 20)
    jy, jaux = jmoe.moe_apply(jax.tree.map(jnp.asarray, layer),
                              jnp.asarray(x),
                              dataclasses.replace(jcfg, engine=engine))
    tlayer = {k: torch.from_numpy(np.array(v)) for k, v in layer.items()}
    ty, taux = tmoe.moe_apply(tlayer, torch.from_numpy(x),
                              dataclasses.replace(tcfg, engine=engine))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **FP32)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


def test_from_jax_params_keeps_every_moe_leaf(setup):
    _, tcfg, _, np_params, tparams = setup
    assert len(tparams["layers"]) == tcfg.n_layers
    ref = np_params["layers"]["moe"]
    for i, lp in enumerate(tparams["layers"]):
        got = lp["moe"]
        assert set(got) == set(ref)
        for k, v in ref.items():
            np.testing.assert_array_equal(got[k].numpy(), v[i], err_msg=k)
            if k.startswith(("idx", "rev")):
                assert got[k].dtype == torch.int32, k


def test_port_moe_init_matches_reference_structure():
    jcfg, tcfg = _cfgs()
    jp = jax.tree.map(np.asarray, JM.init(jcfg, jax.random.PRNGKey(0)))
    tp = TM.init(tcfg, seed=0, device="cpu")
    ref = from_jax_params(jp)
    flat_t = dict(tree_items(tp))
    flat_r = dict(tree_items(ref))
    assert flat_t.keys() == flat_r.keys()
    for path, t in flat_t.items():
        r = flat_r[path]
        assert t.shape == r.shape and t.dtype == r.dtype, path
        if path.split("/")[-1].startswith(("idx", "rev")):
            assert torch.equal(t, r), path


# ------------------------------------------------------------- serving
def test_engines_serve_identical_greedy_tokens(setup):
    jcfg, tcfg, jparams, _, tparams = setup
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, tcfg.vocab, size=n).astype(np.int32)
               for n, _, _ in TRACE]
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
    assert teng.stats["launches"] == dict.fromkeys(ops.launch_counts(), 0)


def test_prefill_and_decode_logits_match_reference(setup):
    """Two prefill chunks of one slot (the tail of the second is padding
    that takes expert capacity, as in the reference) and one decode tick
    with a free slot on the scratch page."""
    jcfg, tcfg, jparams, _, tparams = setup
    P, ps, C, maxp = 9, 8, 8, 4
    jpool = JM.make_paged_cache(jcfg, P, ps)
    tpool = TM.make_paged_cache(tcfg, P, ps)
    row = np.array([3, 5, 7, 0], np.int32)
    prompt = np.random.default_rng(3).integers(0, tcfg.vocab, 12
                                               ).astype(np.int32)
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


# ------------------------------------------------------------ training
def _optimizers(kind):
    """(reference, port) optimizer pairs of the same hyperparameters."""
    if kind in ("adam_clip", "two_pass_adam"):
        return (jfused_adam(jconstant(1e-3), weight_decay=0.01, grad_clip=1.0),
                fused_adam(constant_schedule(1e-3), weight_decay=0.01,
                           grad_clip=1.0))
    return (jfused_sgd(jconstant(3e-2), momentum=0.9),
            fused_sgd(constant_schedule(3e-2), momentum=0.9))


def _assert_close(got, want, slack=None, **tol):
    """Port tree against the reference's; ``slack`` (a tree of per-element
    bounds, None where there is none) widens the comparison elementwise,
    for at most one element in 10^4 of a leaf."""
    g, w = dict(tree_items(got)), dict(tree_items(want))
    assert g.keys() == w.keys()
    sl = {} if slack is None else dict(tree_items(slack))
    for k, t in g.items():
        if not (torch.is_tensor(t) and t.is_floating_point()):
            continue
        a, b = t.float().numpy(), w[k].float().numpy()
        bound = tol["atol"] + tol["rtol"] * np.abs(b)
        if sl.get(k) is not None:
            wide = np.abs(a - b) > bound     # the elements the slack covers
            assert wide.sum() <= max(1, a.size // 10 ** 4), k
            bound = bound + sl[k]
        if not (np.abs(a - b) <= bound).all():
            np.testing.assert_allclose(a, b, err_msg=k, **tol)


def _noise_floor(tm, jm, tm0, jm0, b1=0.9):
    """Elements whose gradient this step (recovered from the first moment,
    g = (m - b1 m_prev) / (1 - b1)) sits at the summation-order noise
    floor: below 1e-5 of the leaf's largest, or of opposite signs on the
    two sides.  None for a leaf without a moment."""
    if not tm.dim():
        return None
    g = ((tm - b1 * tm0) / (1 - b1)).numpy()
    gr = ((jm - b1 * jm0) / (1 - b1)).numpy()
    return ((np.sign(g) != np.sign(gr))
            | (np.abs(gr) <= 1e-5 * np.abs(gr).max()))


def _reference_probs(jcfg, params, tokens):
    """The reference's router probabilities [G, g, E] of each MoE layer:
    its blocks run one by one, each layer's router input made as its
    ``_attn_mlp_block`` makes it, softmax of the router logits as its
    ``moe_apply`` takes it."""
    x, positions, _ = JM._embed_in(jcfg, params, {"tokens": tokens})
    out = []
    for l in range(jcfg.n_layers):
        lp = jax.tree.map(lambda t, l=l: t[l], params["layers"])
        h = jnorm(lp["norm1"], x, jcfg.norm, jcfg.norm_eps)
        a, _ = jattn.gqa_forward(lp["attn"], h, jcfg, positions=positions)
        h = jnorm(lp["norm2"], x + a, jcfg.norm, jcfg.norm_eps)
        g, G, _ = jmoe.moe_dispatch_dims(jcfg.moe, h.shape[0] * h.shape[1])
        logits = jnp.einsum("Ggd,de->Gge", h.reshape(G, g, -1),
                            lp["moe"]["router"].astype(h.dtype))
        out.append(jax.nn.softmax(logits.astype(jnp.float32), axis=-1))
        x, _, _ = JM._attn_mlp_block(lp, x, jcfg, positions)
    return out


_PORT_TOP_K = tmoe._top_k         # the port's own, whatever a test patches


class TieOrder:
    """``moe._top_k`` that may swap near-tied choices.  Where two adjacent
    probabilities among a token's top k + 1 lie within ``bound`` of each
    other, the two packages may order them either way (their router
    probabilities differ by summation-order noise); every such pair is
    recorded in ``seen`` by its key (the token's probabilities as bytes,
    and the pair's rank), and a pair whose key is in ``swap`` takes the
    other order.  Everywhere else the routing is the port's own.  A pure
    function of the probabilities, so the backward's recomputation of a
    layer routes as its forward did."""

    def __init__(self, bound: float, swap=frozenset()):
        self.bound, self.swap, self.seen = bound, swap, []

    def __call__(self, probs, k: int):
        vals, idx = _PORT_TOP_K(probs, probs.shape[-1])
        near = (vals[..., :k] - vals[..., 1:k + 1]) <= self.bound
        order = torch.arange(probs.shape[-1]).expand(probs.shape).clone()
        for at in near.nonzero().tolist():
            *row, j = at
            key = (probs[tuple(row)].detach().numpy().tobytes(), j)
            if key not in self.seen:
                self.seen.append(key)
            if key in self.swap:
                order[(*row, j)], order[(*row, j + 1)] = j + 1, j
        # a gather, not an in-place swap: the sort's saved indices stay
        # as the sort left them, so its backward sends each gradient to
        # the probability it took
        vals, idx = vals.gather(-1, order), idx.gather(-1, order)
        return vals[..., :k], idx[..., :k]


@pytest.fixture(scope="module")
def near_tie(setup):
    """The bound on a top-k margin under which the two packages may route
    a token differently, from a measurement: the largest gap between the
    reference's and the port's router probabilities on equal inputs (the
    same weights and each of the three train batches, every MoE layer).
    Two probabilities each off by at most that gap can swap only if they
    lie within twice it; the bound doubles that again, for gaps the three
    batches do not show.  Measured here at 3e-7 to 7e-7 (relative
    2e-6 to 3e-6): the bound is about 3e-6, against top-k margins of
    1e-4 and more on every token but the one near-tie (2.1e-7 apart at
    step 1 of the Adam steps, which summation order decides)."""
    jcfg, tcfg, jparams, _, tparams = setup
    probs = jax.jit(functools.partial(_reference_probs, jcfg))
    pipe = JPipeline(jcfg, BATCH, SEQ)
    seen = []

    def spy(p, k):
        seen.append(p.detach().clone())
        return _PORT_TOP_K(p, k)
    gap = 0.0
    for _ in range(3):
        tokens = next(pipe)["tokens"]
        seen.clear()
        with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
            mp.setattr(tmoe, "_top_k", spy)
            TM.loss_fn(tcfg, tparams, {"tokens": torch.as_tensor(
                np.asarray(tokens))})
        ref = probs(jparams, tokens)
        assert len(seen) == len(ref) == tcfg.n_layers
        gap = max([gap] + [float(np.abs(t.numpy() - np.asarray(r)).max())
                           for t, r in zip(seen, ref)])
    assert 0 < 4 * gap <= 1e-5, gap    # well under the other margins
    return 4 * gap


def _orders(run, bound, limit: int = 8):
    """``run(order)`` (a TieOrder) under every order of the near-tied
    pairs it meets: [(order, result)].  A run takes the port's own order
    at each pair it meets that the order does not swap; each such pair
    met for the first time starts a run that swaps it too."""
    out, todo = [], [frozenset()]
    while todo:
        swap = todo.pop(0)
        order = TieOrder(bound, swap)
        out.append((order, run(order)))
        assert len(order.seen) <= 4, len(order.seen)      # a handful
        fixed = set()
        for key in order.seen:
            if key not in swap and key not in fixed:
                todo.append(swap | fixed | {key})
            fixed.add(key)
        assert len(out) + len(todo) <= limit
    return out


def _matches(got, want, slack=None, **tol) -> bool:
    try:
        _assert_close(got, want, slack, **tol)
    except AssertionError:
        return False
    return True


@pytest.mark.parametrize("kind", ["two_pass_adam", "sgd_momentum",
                                  "adam_clip"])
def test_train_steps_match_reference(setup, near_tie, kind):
    """Three steps of the port against three of the reference from the
    same weights and batches: two-pass Adam with clip, fused SGD with
    momentum, fused Adam with clip.  Losses, aux, params and slots; the
    fused steps' health sum is 0.

    A token whose top-k choice the two packages may order either way
    (``near_tie``) is routed both ways: each step runs under every order
    of its near-tied pairs (``TieOrder``), and one order must meet the
    bounds; the next step goes on from that one."""
    fused = kind != "two_pass_adam"
    adam = kind != "sgd_momentum"
    jcfg, tcfg = _cfgs(fused_update=fused, engine="pallas")
    jopt, topt = _optimizers(kind)
    _, _, _, np_params, _ = setup
    jstep = jmake_train_step(jcfg, jopt, 1, donate=False)
    jpipe = JPipeline(jcfg, BATCH, SEQ)
    jp = jax.tree.map(jnp.asarray, np_params)
    js = jopt.init(jp)
    step = make_train_step(tcfg, topt)
    pipe = LMTokenPipeline(tcfg, BATCH, SEQ)
    tp = from_jax_params(np_params)
    ts = topt.init(tp)
    jm_prev = tm_prev = slack = None
    if adam:
        jm_prev = from_jax_opt_state(jax.tree.map(np.asarray, js))["m"]
        tm_prev = ts["m"]
    ops.reset_launch_counts()
    for i in range(3):
        jp, js, jm = jstep(jp, js, jax.tree.map(jnp.asarray, next(jpipe)),
                           jnp.asarray(i))
        want_p = from_jax_params(jax.tree.map(np.asarray, jp))
        want_s = from_jax_opt_state(jax.tree.map(np.asarray, js))
        batch = next(pipe)

        def run(order):     # the fused step consumes its inputs: copies
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(tmoe, "_top_k", order)
                return step(tree_map(torch.clone, tp),
                            tree_map(torch.clone, ts), batch, i)

        fits = []
        for order, (p1, s1, m) in _orders(run, near_tie):
            now = slack
            if adam:    # each noise-floor element may move by 2 lr more
                floor = tree_map(_noise_floor, s1["m"], want_s["m"],
                                 tm_prev, jm_prev)
                now = tree_map(
                    lambda f, s_: None if f is None
                    else (0 if s_ is None else s_) + 2e-3 * f, floor,
                    slack if slack is not None else tree_map(
                        lambda _: None, floor))
            ok = all(float(m[k]) == pytest.approx(float(jm[k]),
                                                  rel=LOSS_RTOL)
                     for k in ("loss", "aux"))
            if ok and _matches(p1, want_p, now, **TREE_TOL) and _matches(
                    s1, want_s, **TREE_TOL):
                fits.append((order, p1, s1, m, now))
        assert fits, (i, float(jm["loss"]))
        _, tp, ts, m, slack = fits[0]
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL)
        assert float(m["aux"]) > 0
        np.testing.assert_allclose(float(m["aux"]), float(jm["aux"]),
                                   rtol=LOSS_RTOL)
        assert float(m["nonfinite"]) == 0.0
        if adam:
            jm_prev, tm_prev = want_s["m"], tree_map(torch.clone, ts["m"])
    assert sum(ops.launch_counts().values()) == 0   # plain versions
    _assert_close(tp, from_jax_params(jax.tree.map(np.asarray, jp)), slack,
                  **TREE_TOL)
    _assert_close(ts, from_jax_opt_state(jax.tree.map(np.asarray, js)),
                  **TREE_TOL)


def test_fused_step_updates_experts_in_place_and_router_densely(setup):
    """One fused SGD step: wg, wi and wo are the same tensors, updated in
    place by the junctions' backward; the router is a new tensor stepped
    by the optimizer's dense rule.  Both agree with a two-pass step."""
    _, _, _, np_params, _ = setup
    _, tcfg = _cfgs(fused_update=True)
    _, topt = _optimizers("sgd_momentum")
    batch = next(LMTokenPipeline(tcfg, BATCH, SEQ))
    p0 = from_jax_params(np_params)
    moe0 = p0["layers"][0]["moe"]
    before = {k: moe0[k].clone() for k in ("wg", "wi", "wo", "router")}
    two = make_train_step(dataclasses.replace(tcfg, fused_update=False),
                          topt)
    p_two, _, _ = two(p0, topt.init(p0), batch, 0)
    for k, v in before.items():                     # two-pass: inputs kept
        assert torch.equal(moe0[k], v), k
    p1, _, _ = make_train_step(tcfg, topt)(p0, topt.init(p0), batch, 0)
    moe1 = p1["layers"][0]["moe"]
    for k in ("wg", "wi", "wo"):
        assert moe1[k] is moe0[k], k
    assert moe1["router"] is not moe0["router"]
    assert torch.equal(moe0["router"], before["router"])
    for k in ("wg", "wi", "wo", "router"):
        assert not torch.equal(moe1[k], before[k]), k
        torch.testing.assert_close(moe1[k], p_two["layers"][0]["moe"][k],
                                   rtol=1e-5, atol=1e-6)


# ----------------------------------------------------------- launchers
def test_launch_serve_moe_runs_on_cpu(capsys):
    outs = tserve.main(["--arch", "qwen3-moe-30b-a3b", "--reduce", "--sparse",
                        "--continuous", "--device", "cpu", "--requests", "3",
                        "--prompt-len", "10", "--max-new", "4", "--slots",
                        "2", "--page-size", "8", "--prefill-chunk", "8"])
    assert sorted(outs) == [0, 1, 2]
    assert all(len(v) == 4 for v in outs.values())
    assert "3/3 requests" in capsys.readouterr().out


def test_launch_train_moe_runs_on_cpu(tmp_path, capsys):
    res = tlaunch.main(["--arch", "qwen3-moe-30b-a3b", "--reduce",
                        "--sparse", "--steps", "2", "--batch", "2", "--seq",
                        "16", "--device", "cpu", "--ckpt", str(tmp_path)])
    assert res["step"] == 2
    out = capsys.readouterr().out
    assert "update path: two-pass" in out and "first loss" in out
