"""The port's pipeline schedules (``parallel/pipeline.py``) against the
JAX reference's, which run in a subprocess on 4 forced host devices (as
tests/test_distributed.py runs them); arrays cross through an .npz.

* the reference's tanh stage (D 16, 4 stages, 8 microbatches of 4 rows):
  ``gpipe_forward`` against the reference's and against the stages
  applied in order; ``gpipe_step``; ``async_pipeline_epoch``'s losses
  and params after 1 epoch and after 25, whose warm loss falls below
  0.7 x the first epoch's (tests/test_distributed.py's contract);
* a sparse-junction stage (x + wo(silu(wi(x))), 64 <-> 128 at block 32,
  density 0.5): the port's plain path, its pattern leaves stacked with
  the weights, against the reference's jnp junction stage (its vjp takes
  float params only, so its stage closes over the pattern), forward and
  one async epoch;
* ``bubble_fraction`` for both schedules.

Tolerances (fp32): the forward 1e-5 absolute (the reference's own bound
against the stages in order); a step or one epoch of updates rtol 1e-5
/ atol 1e-6 (the same products in another summation order); after 25
epochs of stale updates rtol 1e-4 / atol 1e-5.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.sparsity import make_block_pattern

from repro_torch.core import sparse_linear as sl
from repro_torch.parallel import pipeline as PP

SRC = str(Path(__file__).resolve().parents[1] / "src")
D, S, M, MB = 16, 4, 8, 4
LR = 0.05
EPOCHS = 25
JD, JF, JBS = 64, 128, 32          # the junction stage's widths and block
PATTERN_LEAVES = ("idx", "rev_ob", "rev_t", "rev_cnt")

REFERENCE = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, SRC)
import jax, jax.numpy as jnp, numpy as np
from repro.launch.mesh import compat_mesh
from repro.parallel import pipeline as PP
from repro.core import sparse_linear as sl

mesh = compat_mesh((4,), ("stage",), devices=jax.devices())
a = dict(np.load(IN))
out = {}
def tanh_stage(p, x): return jnp.tanh(x @ p["w"] + p["b"])
def lg(y, yt): return 2 * (y - yt) / y.size, jnp.mean((y - yt) ** 2)
def mse(y, yt): return jnp.mean((y - yt) ** 2)
params = {"w": jnp.asarray(a["w"]), "b": jnp.asarray(a["b"])}
xs, ys = jnp.asarray(a["xs"]), jnp.asarray(a["ys"])
out["gpipe"] = PP.gpipe_forward(tanh_stage, params, xs, mesh)
p1, out["step_loss"] = PP.gpipe_step(tanh_stage, mse, params, xs, ys, mesh,
                                     LR)
out["step_w"], out["step_b"] = p1["w"], p1["b"]
# one compile for the 25 epochs (eager, each epoch traces anew)
epoch = jax.jit(lambda p: PP.async_pipeline_epoch(tanh_stage, lg, p, xs, ys,
                                                  mesh, LR))
p, warm = params, []
for ep in range(EPOCHS):
    p, losses = epoch(p)
    warm.append(float(losses[losses > 0].mean()))
    if ep == 0:
        out["async1_w"], out["async1_b"] = p["w"], p["b"]
        out["async1_losses"] = losses
out["async_w"], out["async_b"] = p["w"], p["b"]
out["async_losses"] = losses
out["warm"] = np.asarray(warm)

# the pattern leaves ride in the closure: the reference's vjp takes
# float params only
pats = {k: {n: jnp.asarray(a[k + "_" + n][0]) for n in PATTERN}
        for k in ("wi", "wo")}
def junction_stage(p, x):
    h = sl.apply({**p["wi"], **pats["wi"]}, x, engine="jnp", act="silu")
    return x + sl.apply({**p["wo"], **pats["wo"]}, h, engine="jnp")
jp = {k: {n: jnp.asarray(a[k + "_" + n]) for n in ("w", "b")}
      for k in ("wi", "wo")}
jxs, jys = jnp.asarray(a["jxs"]), jnp.asarray(a["jys"])
out["jgpipe"] = PP.gpipe_forward(junction_stage, jp, jxs, mesh)
jp1, out["jlosses"] = PP.async_pipeline_epoch(junction_stage, lg, jp, jxs,
                                              jys, mesh, LR)
for k in ("wi", "wo"):
    for n in ("w", "b"):
        out["j1_" + k + "_" + n] = jp1[k][n]
out["bubble"] = np.asarray([PP.bubble_fraction(S, M, s)
                            for s in ("gpipe", "async")])
np.savez(OUT, **{k: np.asarray(v) for k, v in out.items()})
"""


def _inputs():
    rng = np.random.default_rng(0)
    a = {"w": (rng.standard_normal((S, D, D)) * 0.5).astype(np.float32),
         "b": (rng.standard_normal((S, D)) * 0.1).astype(np.float32),
         "xs": rng.standard_normal((M, MB, D)).astype(np.float32),
         "ys": (rng.standard_normal((M, MB, D)) * 0.1).astype(np.float32),
         "jxs": rng.standard_normal((M, MB, JD)).astype(np.float32),
         "jys": (rng.standard_normal((M, MB, JD)) * 0.1).astype(np.float32)}
    for k, (n_in, n_out) in (("wi", (JD, JF)), ("wo", (JF, JD))):
        pat = make_block_pattern(n_in, n_out, 0.5, JBS, seed=1)
        shape = (S, pat.n_out_blocks, pat.fan_in_blocks, JBS, JBS)
        a[f"{k}_w"] = (rng.standard_normal(shape)
                       * np.sqrt(2.0 / (pat.fan_in_blocks * JBS
                                        + pat.fan_out_blocks * JBS))
                       ).astype(np.float32)
        a[f"{k}_b"] = (rng.standard_normal((S, n_out)) * 0.1
                       ).astype(np.float32)
        for n in PATTERN_LEAVES:
            a[f"{k}_{n}"] = np.stack([getattr(pat, n).astype(np.int32)] * S)
    return a


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's results on 4 forced host devices, and the inputs."""
    d = tmp_path_factory.mktemp("pipeline")
    a = _inputs()
    np.savez(d / "in.npz", **a)
    consts = (f"SRC = {SRC!r}\nIN = {str(d / 'in.npz')!r}\n"
              f"OUT = {str(d / 'out.npz')!r}\nLR = {LR}\nEPOCHS = {EPOCHS}\n"
              f"S, M = {S}, {M}\nPATTERN = {PATTERN_LEAVES!r}\n")
    r = subprocess.run([sys.executable, "-c", consts
                        + textwrap.dedent(REFERENCE)],
                       capture_output=True, text=True, env=dict(os.environ),
                       timeout=600)
    assert r.returncode == 0, (r.stdout[-1000:], r.stderr[-3000:])
    return a, dict(np.load(d / "out.npz"))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def tanh_stage(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def loss_grad(y, yt):
    return 2 * (y - yt) / y.numel(), torch.mean((y - yt) ** 2)


def mse(y, yt):
    return torch.mean((y - yt) ** 2)


def junction_stage(p, x):
    return x + sl.apply(p["wo"], sl.apply(p["wi"], x, act="silu"))


def _tanh_params(a):
    return {"w": _t(a["w"]), "b": _t(a["b"])}


def _junction_params(a):
    return {k: {n: _t(a[f"{k}_{n}"]) for n in ("w", "b") + PATTERN_LEAVES}
            for k in ("wi", "wo")}


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), want, **tol)


def test_gpipe_forward_matches_reference_and_stages_in_order(ref):
    a, r = ref
    params = _tanh_params(a)
    xs = _t(a["xs"])
    outs = PP.gpipe_forward(tanh_stage, params, xs)
    _close(outs, r["gpipe"], rtol=0, atol=1e-5)
    x = xs
    for s in range(S):
        x = tanh_stage({"w": params["w"][s], "b": params["b"][s]}, x)
    _close(outs, x.numpy(), rtol=0, atol=1e-5)


def test_gpipe_step_matches_reference(ref):
    a, r = ref
    new, loss = PP.gpipe_step(tanh_stage, mse, _tanh_params(a), _t(a["xs"]),
                              _t(a["ys"]), LR)
    _close(loss, r["step_loss"], rtol=1e-5, atol=1e-6)
    _close(new["w"], r["step_w"], rtol=1e-5, atol=1e-6)
    _close(new["b"], r["step_b"], rtol=1e-5, atol=1e-6)


def test_async_epoch_matches_reference_and_converges(ref):
    a, r = ref
    p = _tanh_params(a)
    xs, ys = _t(a["xs"]), _t(a["ys"])
    warm = []
    for ep in range(EPOCHS):
        p, losses = PP.async_pipeline_epoch(tanh_stage, loss_grad, p, xs, ys,
                                            LR)
        assert losses.shape == (S * (M + 2 * S),)
        warm.append(float(losses[losses > 0].mean()))
        if ep == 0:
            _close(losses, r["async1_losses"], rtol=1e-5, atol=1e-6)
            _close(p["w"], r["async1_w"], rtol=1e-5, atol=1e-6)
            _close(p["b"], r["async1_b"], rtol=1e-5, atol=1e-6)
    _close(losses, r["async_losses"], rtol=1e-4, atol=1e-5)
    _close(p["w"], r["async_w"], rtol=1e-4, atol=1e-5)
    _close(p["b"], r["async_b"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(warm, r["warm"], rtol=1e-4)
    assert warm[-1] < 0.7 * warm[0], warm


def test_junction_stage_matches_reference(ref):
    a, r = ref
    p = _junction_params(a)
    xs, ys = _t(a["jxs"]), _t(a["jys"])
    _close(PP.gpipe_forward(junction_stage, p, xs), r["jgpipe"],
           rtol=1e-5, atol=1e-5)
    new, losses = PP.async_pipeline_epoch(junction_stage, loss_grad, p, xs,
                                          ys, LR)
    _close(losses, r["jlosses"], rtol=1e-5, atol=1e-6)
    for k in ("wi", "wo"):
        for n in ("w", "b"):
            _close(new[k][n], r[f"j1_{k}_{n}"], rtol=1e-5, atol=1e-6)
        for n in PATTERN_LEAVES:
            assert torch.equal(new[k][n], p[k][n])


def test_bubble_fraction_matches_reference(ref):
    _, r = ref
    got = [PP.bubble_fraction(S, M, s) for s in ("gpipe", "async")]
    assert got == r["bubble"].tolist()
