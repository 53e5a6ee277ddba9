"""The port's state-space blocks (``models/ssm.py``) against the JAX
reference on the CPU: the depthwise causal conv, Mamba-1 (falcon-mamba)
and Mamba-2 / SSD (zamba2) through their chunked prefill (more than one
chunk), a prefill that starts from a non-zero cache, and the decode
step; the scan elements in fp32 and in bf16 (``ssm_scan_dtype``); the
port's chunked scan against its own stepwise decode; gradients, with and
without the per-chunk recompute.

Configs: reduced falcon-mamba-7b and zamba2-2.7b (d_model 128, d_inner
256, chunk 16), FFN density 0.5 at block 32 so that ``in_proj`` /
``out_proj`` / ``in_z`` / ``in_xbc`` are sparse junctions (their plain
versions run here), fp32 compute; weights made by the reference and
carried across with ``convert.from_jax_params``.

Tolerances: fp32 outputs and states within 2e-5 of the reference (the
same ops summed in another order: the log-step scan against
``associative_scan``, matmuls against einsums).  bf16 scan elements:
within 2e-2 of max |y| (each scan step rounds its products and sums to
bf16, and the two scans combine the chunk's elements in different
trees).  Chunked against stepwise: 2e-3 / 3e-3, the reference's own
(tests/test_models.py).  Gradients: 1e-4 relative to the largest
element (fp32 backward through the same ops in another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core.sparsity import SparsityConfig as JSparsity
from repro.models import model as JM
from repro.models import ssm as JS

from repro_torch.configs import registry as treg
from repro_torch.convert import from_jax_params
from repro_torch.core.sparsity import SparsityConfig
from repro_torch.models import ssm as TS

TOL = dict(atol=2e-5, rtol=2e-5)
BF16_REL = 2e-2
GRAD_REL = 1e-4
KINDS = ("mamba1", "mamba2")
ARCH = {"mamba1": "falcon-mamba-7b", "mamba2": "zamba2-2.7b"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(kind, **kw):
    name = ARCH[kind]
    jcfg = dataclasses.replace(
        jreg.get(name).reduced().with_sparsity(
            JSparsity(density=0.5, block=32, where="ffn")),
        dtype="float32", engine="jnp", **kw)
    tcfg = dataclasses.replace(
        treg.get(name).reduced().with_sparsity(
            SparsityConfig(density=0.5, block=32, where="ffn")),
        dtype="float32", **kw)
    return jcfg, tcfg


@pytest.fixture(scope="module", params=KINDS)
def setup(request):
    """(kind, jcfg, tcfg, reference layer params, port layer params): the
    first ssm block of a reference model (the hybrid's first super-block's
    first layer), carried across."""
    kind = request.param
    jcfg, tcfg = _cfgs(kind)
    jparams = JM.init(jcfg, jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams))
    first = (lambda t: t[0, 0]) if kind == "mamba2" else (lambda t: t[0])
    jp = jax.tree.map(first, jparams["layers"])["ssm"]
    tl = tparams["layers"][0]
    tp = (tl[0] if kind == "mamba2" else tl)["ssm"]
    return kind, jcfg, tcfg, jp, tp


def _apply(kind, side):
    if side == "ref":
        return JS.mamba2_apply if kind == "mamba2" else JS.mamba1_apply
    return TS.mamba2_apply if kind == "mamba2" else TS.mamba1_apply


def _state_shapes(kind, cfg, B):
    K, di, N = cfg.conv_width, cfg.d_inner_, cfg.ssm_state
    if kind == "mamba2":
        return (B, K - 1, di + 2 * N), (B, cfg.ssm_heads, cfg.ssm_head_dim,
                                        N)
    return (B, K - 1, di), (B, di, N)


def _cache(kind, cfg, B, rng=None):
    conv, ssm = _state_shapes(kind, cfg, B)
    if rng is None:
        return {"conv": np.zeros(conv, np.float32),
                "ssm": np.zeros(ssm, np.float32)}
    return {"conv": rng.standard_normal(conv).astype(np.float32),
            "ssm": (0.5 * rng.standard_normal(ssm)).astype(np.float32)}


def _both(kind, jcfg, tcfg, jp, tp, x, cache, decode=False):
    jc = None if cache is None else jax.tree.map(jnp.asarray, cache)
    tc = None if cache is None else {k: torch.from_numpy(v.copy())
                                     for k, v in cache.items()}
    jy, jnew = _apply(kind, "ref")(jp, jnp.asarray(x), jcfg, cache=jc,
                                   decode=decode)
    with torch.no_grad():
        ty, tnew = _apply(kind, "port")(tp, torch.from_numpy(x), tcfg,
                                        cache=tc, decode=decode)
    return (np.asarray(jy), jnew), (ty.numpy(), tnew)


def _check_cache(tnew, jnew):
    assert set(tnew) == set(jnew)
    for k in jnew:
        assert tuple(tnew[k].shape) == jnew[k].shape
        assert tnew[k].dtype == getattr(torch, str(jnew[k].dtype))
        np.testing.assert_allclose(tnew[k].float().numpy(),
                                   np.asarray(jnew[k], np.float32), **TOL)


# ------------------------------------------------------------------ conv
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    rng = np.random.default_rng(3)
    B, S, C, K = 2, 7, 24, 4
    x = rng.standard_normal((B, S, C)).astype(np.float32)
    w = rng.standard_normal((K, C)).astype(np.float32)
    b = rng.standard_normal((C,)).astype(np.float32)
    st = (rng.standard_normal((B, K - 1, C)).astype(np.float32)
          if with_state else None)
    jy, js = JS._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                             None if st is None else jnp.asarray(st))
    ty, ts = TS._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(b),
                             None if st is None else torch.from_numpy(st))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


# ------------------------------------------------------------------ scan
@pytest.mark.parametrize("c", [1, 5, 16, 128])
def test_chunk_scan_solves_the_recurrence(c):
    """The log-step scan against the recurrence one step at a time (and
    against the reference's associative scan), at chunk lengths that are
    and are not powers of two."""
    rng = np.random.default_rng(c)
    d = rng.uniform(0.5, 1.0, (2, c, 3, 4)).astype(np.float32)
    u = rng.standard_normal((2, c, 3, 4)).astype(np.float32)
    h0 = rng.standard_normal((2, 3, 4)).astype(np.float32)
    h, last = TS._ssm_chunk_scan(torch.from_numpy(d), torch.from_numpy(u),
                                 torch.from_numpy(h0))
    want, hs = h0.astype(np.float64), []
    for t in range(c):
        want = d[:, t] * want + u[:, t]
        hs.append(want)
    np.testing.assert_allclose(h.numpy(), np.stack(hs, 1), rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(last, h[:, -1])
    jh, _ = JS._ssm_chunk_scan(jnp.asarray(d), jnp.asarray(u),
                               jnp.asarray(h0))
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)


# ---------------------------------------------------------------- blocks
@pytest.mark.parametrize("scan_dtype", ["float32", "bfloat16"])
def test_prefill_matches_reference(setup, scan_dtype):
    """Two chunks of 16 from a zero cache: the output and the state the
    prefill hands back."""
    kind, jcfg, tcfg, jp, tp = setup
    jcfg = dataclasses.replace(jcfg, ssm_scan_dtype=scan_dtype)
    tcfg = dataclasses.replace(tcfg, ssm_scan_dtype=scan_dtype)
    B, S = 2, 32
    x = np.random.default_rng(4).standard_normal(
        (B, S, tcfg.d_model)).astype(np.float32)
    (jy, jnew), (ty, tnew) = _both(kind, jcfg, tcfg, jp, tp, x,
                                   _cache(kind, tcfg, B))
    assert ty.shape == jy.shape == (B, S, tcfg.d_model)
    if scan_dtype == "float32":
        np.testing.assert_allclose(ty, jy, **TOL)
        _check_cache(tnew, jnew)
    else:
        scale = np.abs(jy).max()
        assert np.abs(ty - jy).max() <= BF16_REL * scale
        if kind == "mamba1":    # Mamba-2's SSD has no scan elements
            f32 = _both(kind, *_cfgs(kind), jp, tp, x,
                        _cache(kind, tcfg, B))[1][0]
            assert np.abs(ty - f32).max() > 0   # the bf16 scan really ran


def test_prefill_without_cache_equals_zero_cache(setup):
    """A prefill without a cache (the training forward) computes what a
    zero cache gives, and hands back no state."""
    kind, _, tcfg, _, tp = setup
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 32, tcfg.d_model)).astype(np.float32))
    apply = _apply(kind, "port")
    with torch.no_grad():
        y0, none = apply(tp, x, tcfg)
        y1, _ = apply(tp, x, tcfg, cache={
            k: torch.from_numpy(v) for k, v in _cache(kind, tcfg, 2).items()})
    assert none is None
    assert torch.equal(y0, y1)


def test_prefill_from_nonzero_cache_matches_reference(setup):
    kind, jcfg, tcfg, jp, tp = setup
    rng = np.random.default_rng(6)
    B, S = 2, 32
    x = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    (jy, jnew), (ty, tnew) = _both(kind, jcfg, tcfg, jp, tp, x,
                                   _cache(kind, tcfg, B, rng))
    np.testing.assert_allclose(ty, jy, **TOL)
    _check_cache(tnew, jnew)


def test_decode_step_matches_reference(setup):
    kind, jcfg, tcfg, jp, tp = setup
    rng = np.random.default_rng(7)
    B = 3
    x = rng.standard_normal((B, 1, tcfg.d_model)).astype(np.float32)
    (jy, jnew), (ty, tnew) = _both(kind, jcfg, tcfg, jp, tp, x,
                                   _cache(kind, tcfg, B, rng), decode=True)
    assert ty.shape == (B, 1, tcfg.d_model)
    np.testing.assert_allclose(ty, jy, **TOL)
    _check_cache(tnew, jnew)


def test_chunked_matches_stepwise(setup):
    """The port's chunked prefill against its own decode step run token by
    token from a zero cache (tests/test_models.py's twin)."""
    kind, _, tcfg, _, tp = setup
    B, S = 2, 32
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (B, S, tcfg.d_model)).astype(np.float32))
    apply = _apply(kind, "port")
    zero = {k: torch.from_numpy(v)
            for k, v in _cache(kind, tcfg, B).items()}
    with torch.no_grad():
        y_chunked, last = apply(tp, x, tcfg, cache=zero)
        cache, ys = zero, []
        for t in range(S):
            y, cache = apply(tp, x[:, t:t + 1], tcfg, cache=cache,
                             decode=True)
            ys.append(y)
    tol = (dict(rtol=3e-3, atol=3e-3) if kind == "mamba2"
           else dict(rtol=2e-3, atol=2e-3))
    np.testing.assert_allclose(y_chunked.numpy(), torch.cat(ys, 1).numpy(),
                               **tol)
    np.testing.assert_allclose(last["ssm"].numpy(), cache["ssm"].numpy(),
                               **tol)


def test_sequence_not_a_chunk_multiple_is_refused(setup):
    kind, _, tcfg, _, tp = setup
    x = torch.zeros((1, 20, tcfg.d_model))
    with pytest.raises(ValueError, match="not divisible by ssm chunk"):
        _apply(kind, "port")(tp, x, tcfg)


# ------------------------------------------------------------- gradients
def _paths(tree):
    """{(key, subkey | None): leaf} of a block's float leaves."""
    out = {}
    for k, v in tree.items():
        for kk, vv in (v.items() if isinstance(v, dict) else [(None, v)]):
            if np.issubdtype(np.asarray(vv).dtype, np.floating):
                out[(k, kk)] = vv
    return out


def _with(tree, leaves):
    out = {k: dict(v) if isinstance(v, dict) else v for k, v in tree.items()}
    for (k, kk), v in leaves.items():
        if kk is None:
            out[k] = v
        else:
            out[k][kk] = v
    return out


def test_gradients_match_reference(setup):
    """d sum(y * r) / d (x, every float leaf), the port (plain versions of
    the junctions' backward) against jax.grad of the reference."""
    kind, jcfg, tcfg, jp, tp = setup
    rng = np.random.default_rng(9)
    B, S = 2, 32
    x = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    r = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)

    def jloss(leaves, xx):
        y, _ = _apply(kind, "ref")(_with(jp, leaves), xx, jcfg)
        return jnp.sum(y * r)

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(_paths(jp), jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_(True)
              for k, v in _paths(tp).items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    y, _ = _apply(kind, "port")(_with(tp, leaves), tx, tcfg)
    (y * torch.from_numpy(r)).sum().backward()
    assert leaves.keys() == jg.keys() and len(leaves) >= 8
    pairs = [("x", tx.grad, jgx)] + [(k, v.grad, jg[k])
                                      for k, v in leaves.items()]
    for k, got, want in pairs:
        want = np.asarray(want)
        scale = np.abs(want).max() or 1.0
        assert np.abs(got.numpy() - want).max() <= GRAD_REL * scale, k


def test_chunk_recompute_keeps_gradients(setup):
    """cfg.remat wraps each chunk in torch.utils.checkpoint: the same
    output and the same gradients as without."""
    kind, _, tcfg, _, tp = setup
    x = np.random.default_rng(10).standard_normal(
        (2, 32, tcfg.d_model)).astype(np.float32)
    out = {}
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat)
        p = {k: (v.clone().requires_grad_(True) if torch.is_tensor(v)
                 else v) for k, v in tp.items()}
        tx = torch.from_numpy(x).requires_grad_(True)
        y, _ = _apply(kind, "port")(p, tx, cfg)
        y.square().sum().backward()
        out[remat] = (y.detach(), tx.grad, p["A_log"].grad, p["D"].grad)
    for a, b in zip(out[False], out[True]):
        assert torch.equal(a, b)


def test_mamba2_long_chunk_backward_is_finite():
    """A 128-step SSD chunk whose decays sum past fp32's exp range above
    the diagonal: the masked entries take no part in the forward and give
    the backward zeros (the mask is applied before the exp)."""
    _, tcfg = _cfgs("mamba2", ssm_chunk=128)
    gen = torch.Generator().manual_seed(0)
    p = TS.mamba2_init(gen, tcfg)
    p["dt_bias"] = torch.full_like(p["dt_bias"], 2.0)   # softplus ~ 2.1
    p = {k: (v.requires_grad_(True) if torch.is_tensor(v) else v)
         for k, v in p.items()}
    x = torch.randn((1, 128, tcfg.d_model), generator=gen)
    y, _ = TS.mamba2_apply(p, x, tcfg)
    y.sum().backward()
    assert torch.isfinite(y).all()
    for k in ("A_log", "dt_bias", "D", "conv_w"):
        assert torch.isfinite(p[k].grad).all(), k
