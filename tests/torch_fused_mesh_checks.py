"""Shared parts of tests/test_torch_partitioned_fused_moe.py and
tests/test_torch_partitioned_fused_audio.py: the reference's weights and
batches of a case, the port's one-rank and the reference's
single-device fused steps on them, and the checks of the 8 ranks'
results (tests/torch_mesh_workers.fused_mesh_runs) against those and
against the dry run's reckoning.  Plain module (tests/ is on sys.path
under pytest's default import mode)."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.launch.specs import concrete_batch as jconcrete_batch
from repro.models import model as JM
from repro.optim import constant_schedule as jconstant
from repro.optim import fused_adam as jfused_adam
from repro.optim import fused_sgd as jfused_sgd
from repro.train.steps import fused_update_eligible as jeligible
from repro.train.steps import make_train_step as jmake_train_step

from repro_torch.configs.base import ShapeSpec
from repro_torch.convert import from_jax_opt_state, from_jax_params
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.train import steps
from repro_torch.tree import tree_items
from torch_mesh_workers import FUSED_STEPS, fused_mesh_batches, \
    fused_mesh_opt
from torch_parity_helpers import close_trees, noise_slack, \
    reference_variant

TREE_TOL = dict(rtol=5e-4, atol=5e-5)
MESH = (2, 4)


def reference_cfg(jcfg, tcfg, **changes):
    """The reference's config of a port case ``tcfg``: its variant
    (``reference_variant``), fp32, the kernels' engine, fused."""
    return dataclasses.replace(reference_variant(jcfg, tcfg),
                               dtype="float32", engine="pallas",
                               fused_update=True, **changes)


def jopt(kind):
    if kind == "adam_clip":
        return jfused_adam(jconstant(1e-3), grad_clip=1.0)
    return jfused_sgd(jconstant(3e-2), momentum=0.9)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _unflat(raw):
    tree = {}
    for k, v in raw.items():
        node = tree
        *head, last = k.split(".")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return tree


def write_inputs(path, jcfg, B: int, S: int) -> None:
    """The reference's weights and FUSED_STEPS batches of B x S."""
    jp = jax.tree.map(np.asarray, JM.init(jcfg, jax.random.PRNGKey(0)))
    extra = {}
    for j in range(FUSED_STEPS):
        b = jconcrete_batch(jcfg, B, S, jax.random.PRNGKey(3 + j))
        for k, v in b.items():
            extra[f"batch{j}_{k}"] = np.asarray(
                v, np.float32 if k in ("patches", "frames") else None)
    np.savez(path, **_flat(jp), **extra)


def one_rank(path, jcfg, tcfg, kind, blocks=None, reference=True):
    """From ``path``'s weights and batches: ((the port's one-rank fused
    params, state, losses, nonfinite counts), (the reference's params,
    state, losses), or None without ``reference``, the noise slack of
    Adam's elements, ``step_slack``, or None); ``blocks`` (an
    ``ExpertOperandLog``) keeps the port's first step's expert update
    operands in ``blocks.kept``."""
    raw = dict(np.load(path))
    batches = fused_mesh_batches(raw)
    jtree = _unflat(raw)
    opt, jo = fused_mesh_opt(kind), jopt(kind)
    assert jeligible(jcfg, jo)[0]
    p = from_jax_params(jtree)
    s = opt.init(p)
    step = steps.make_train_step(tcfg, opt)
    losses, nonfinite, ms = [], [], []
    for j, b in enumerate(batches):
        if blocks is not None:
            blocks.calls, blocks.armed = [], j == 0
        p, s, m = step(p, s, b, j)
        if blocks is not None:
            blocks.armed = False
            if j == 0:
                blocks.kept = blocks.arrays()
        losses.append(float(m["loss"]))
        nonfinite.append(float(m["nonfinite"]))
        if "m" in s:        # updated in place by the next step: a copy
            ms.append({k: v.detach().clone().float()
                       for k, v in tree_items(s["m"])})
    if not reference:
        return (p, s, losses, nonfinite), None, None
    jstep = jmake_train_step(jcfg, jo, 1, donate=False)
    jp, js, jl, jms = jtree, jo.init(jtree), [], []
    for j, b in enumerate(batches):
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()},
                           jnp.asarray(j))
        jl.append(float(jm["loss"]))
        jms.append(js)
    slack = None
    if ms:
        slack = step_slack(ms, [dict(tree_items(from_jax_opt_state(
            jax.tree.map(np.asarray, t))["m"])) for t in jms], 1e-3)
    return ((p, s, losses, nonfinite),
            (from_jax_params(jax.tree.map(np.asarray, jp)),
             from_jax_opt_state(jax.tree.map(np.asarray, js)), jl), slack)


def step_slack(ms, jms, lr, b1=0.9):
    """``noise_slack`` summed over the steps: for each step, 2 lr for an
    element whose gradient that step, g_j = (m_j - b1 m_(j-1)) / (1 -
    b1), sits at the summation-order noise floor on the port's one-rank
    side ``ms`` or the reference's ``jms`` (each Adam's m after each
    step, {path: tensor}).  Such a step moves the element by anything in
    [-lr, lr] on either side, however large its later gradients."""
    total, prev, jprev = {}, None, None
    for m, jm in zip(ms, jms):
        g = m if prev is None else {k: v - b1 * prev[k] for k, v in m.items()}
        jg = jm if jprev is None else {k: v.float() - b1 * jprev[k].float()
                                       for k, v in jm.items()}
        for k, v in noise_slack(g, jg, lr, b1).items():
            total[k] = total.get(k, 0) + v
        prev, jprev = m, jm
    return total


def rank_out(d, i, kind):
    """(rank 0's results, every rank's log) of case ``i`` under ``kind``."""
    out = dict(np.load(d / f"out_{i}_{kind}.npz"))
    logs = [json.loads((d / f"log_{i}_{kind}_{r}.json").read_text())
            for r in range(8)]
    return out, logs


def _sub(out, top):
    return {k[len(f"leaf:{top}/"):]: torch.from_numpy(v)
            for k, v in out.items() if k.startswith(f"leaf:{top}/")}


def check_parity(out, runs, kind, slack=None) -> None:
    """The losses to 1e-5, the gathered params and slots to TREE_TOL
    against each of ``runs`` (the one-rank port's and the reference's);
    ``slack``: ``step_slack``'s for Adam's params (an element whose
    gradient sits at the summation-order noise floor may move by 2 lr a
    step either way)."""
    opt = fused_mesh_opt(kind)
    losses = out["losses"].tolist()
    got_p = _sub(out, "params")
    slots = {k: _sub(out, k) for k in opt.slot_keys()}
    for p, s, want_losses, *_ in runs:
        np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
        for k in opt.slot_keys():
            close_trees(slots[k], {n: v.float() for n, v in tree_items(s[k])},
                        **TREE_TOL)
        close_trees(got_p, {n: v.float() for n, v in tree_items(p)},
                    slack=slack, **TREE_TOL)


def check_nonfinite(out, logs, want) -> None:
    assert out["nonfinite"].tolist() == want == [0.0] * FUSED_STEPS
    for log in logs:
        assert log["nonfinite"] == want


def check_at_rest(logs) -> None:
    for log in logs:
        assert log["at_rest"] == [True] * FUSED_STEPS
        assert log["after"] == log["held"]


def check_gathers(logs, junction_gathers: bool) -> None:
    """The largest unit's leaves, and of the fused junctions' slots no
    more than one unit's, gathered at once; a fused junction gathered
    over the dp axes (where the case has one: ``junction_gathers``) no
    more than one at a time, none alive after the step."""
    for log in logs:
        assert log["gathers"] > 0 and log["dtensor"] == [], log
        assert log["largest"] <= log["budget"], log
        assert log["peak"] <= log["budget"] + log["unit_slots"], log
        assert (log["junction_gathers"] > 0) == junction_gathers, log
        assert log["junction_peak"] <= log["junction_budget"], log
        assert log["junction_left"] == 0, log


def check_collectives(logs, cfg, B: int, S: int, kind) -> None:
    """Every rank's first step's collectives, dot FLOPs and held bytes
    against ``launch/dryrun.count_cell`` on ``AbstractMesh((2, 4))``."""
    rl, held = dryrun.count_cell(
        cfg, ShapeSpec("mesh", S, B, "train"),
        AbstractMesh(MESH, ("data", "model")),
        optimizer=fused_mesh_opt(kind))
    want = {k: [v["bytes"], v["count"]] for k, v in rl.coll_detail.items()}
    assert {"all-gather", "all-reduce"} <= set(want)
    for r, log in enumerate(logs):
        assert log["coll"] == want, r
        assert log["dot_flops"] == rl.dot_flops, r
        assert log["held"] == held, r
