"""The port's dry run (``launch/dryrun.py``), ``sharding.attach``, the
mesh prefill and decode steps and ``DispatchCounter.peak_bytes``, against
the JAX reference and the port's own mesh steps on the CPU.

* ``attach``'s per-rank shapes equal the reference's
  ``attach(...)[leaf].sharding.shard_shape(shape)`` on
  ``jax.sharding.AbstractMesh``, leaf for leaf, for every arch on both
  production meshes: params (the dry run's dense and ``sparse``
  variants), Adam's state with fp32 masters (``perf``, specs as the
  reference's ``lower_cell`` gives them), every valid cell's batch and
  decode token, the cache (batch 128, 32768 positions).  A reference
  layer stack maps to the port's layer list as
  tests/test_torch_sharding.py maps it.
* ``SWEEP_ORDER``, ``cell_id`` for every arch x shape x mesh x variant
  and ``_apply_variant``'s fields equal the reference's, read in a
  subprocess (``repro.launch.dryrun`` sets ``XLA_FLAGS`` on import).
* On 8 gloo ranks of a 2 x 4 mesh (reduced deepseek-7b and reduced sparse
  stablelm-3b, fp32 and bf16 compute), each rank's count of the real
  ``make_mesh_train_step`` (batch 4) and of the mesh prefill and decode
  steps (batch 4, split over the data axis, and 3, which it does not
  divide) under ``DispatchCounter``: its dot FLOPs, its collectives by
  kind (bytes and count) and ``held_bytes`` of each placed tree equal
  the dry run's reckoning (``count_cell`` on ``AbstractMesh((2, 4))``),
  exactly.
* The mesh prefill and decode steps equal the one-rank steps: logits and
  cache within the train parity tolerance where the data axis splits
  the rows (fp32: rtol 5e-4 / atol 5e-5; bf16 compute: the reference's
  mesh bound, atol 5e-3), bit for bit where every rank runs the whole
  batch.  (Measured here: bit for bit in both.)
* Importing the dry run sets no environment variable, starts no process
  group, touches no card and loads neither JAX nor the reference.
* ``peak_bytes`` of a matmul, an elementwise op and a ``del`` equals the
  closed form, on CPU tensors and on ``meta``.
* The CLI writes a record with the reference's keys, skips it when
  present, redoes it under ``--force``, records a cell that raises as
  ``ok: false`` and exits 1; the microbatch plan keeps the first that
  fits and records every attempt.
* At full size (perf-sparse stablelm-3b ``train_4k`` single, stablelm-3b
  ``prefill_32k`` single, qwen3-moe ``decode_32k`` multi):
  ``per_device_gb`` = at-rest shards + the step's peak,
  ``useful_fraction`` = model_flops / (dot_flops x n_chips), no tensor
  off ``meta``, no kernel launched.
* Every arch's ``decode_32k`` counts on both meshes at a cut depth (two
  layers; the hybrid one super-block, so its shared attention runs).
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh
from jax.sharding import PartitionSpec as JP

from repro.configs import base as jbase
from repro.configs import registry as jreg
from repro.launch import specs as jspecs
from repro.models import model as JM
from repro.optim import adam as jadam
from repro.optim import constant_schedule as jconstant
from repro.parallel import sharding as jsh

from repro_torch.configs import registry as treg
from repro_torch.configs.base import SHAPES, ShapeSpec, valid_cells
from repro_torch.kernels import ops
from repro_torch.launch import dryrun
from repro_torch.launch import specs as tspecs
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import model as TM
from repro_torch.optim import adam, constant_schedule
from repro_torch.parallel import sharding as sh
from repro_torch.roofline import analysis, dispatch
from repro_torch.train import steps
from repro_torch.tree import tree_leaves
from torch_mesh_workers import DRYRUN_CASES, DRYRUN_ROWS, DRYRUN_SEQ, \
    dryrun_case, dryrun_counts, dryrun_inputs, run_ranks
from torch_parity_helpers import reference_variant

ROOT = Path(__file__).resolve().parents[1]
ARCHS = list(treg.ARCHS)
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
TREE_TOL = dict(rtol=5e-4, atol=5e-5)
# the partitioned route sums partial products over "model" in another
# order than one rank does, so in bf16 a layer's outputs round to the
# neighbouring bf16 value here and there and the logits move by a few
# ulps: held to 2^-5, four ulps at magnitude 1, no further than the
# one-rank port's bf16 logits lie from the reference's
# (tests/test_torch_partitioned.py holds the two gaps against each other)
TP_TOL = {"float32": TREE_TOL, "bfloat16": dict(rtol=0.0, atol=2 ** -5)}
RECORD_KEYS = {"cell", "arch", "shape", "mesh", "variant", "n_chips",
               "params", "active_params", "microbatches", "fit_attempts",
               "roofline", "model_flops", "useful_fraction",
               "per_device_gb", "ok", "count_s", "fits_80gb",
               "at_rest_bytes", "execution"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jmesh(name):
    sizes, names = MESHES[name]
    try:  # jax >= 0.5: AbstractMesh(axis_sizes, axis_names)
        return JAbstractMesh(sizes, names)
    except TypeError:  # jax 0.4.x: AbstractMesh(((name, size), ...))
        return JAbstractMesh(tuple(zip(names, sizes)))


@functools.lru_cache(maxsize=None)
def _pshapes(arch, variant):
    tcfg = dryrun._apply_variant(treg.get(arch), variant)
    jcfg = reference_variant(jreg.get(arch), tcfg)
    jp = jax.eval_shape(functools.partial(JM.init, jcfg),
                        jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, TM.init(tcfg, 0, "meta")


def _same_shards(port, ref, nstack=0, path=""):
    """The port's attached tree against the reference's: each port leaf's
    shape and dtype equal the reference leaf's shard shape, a list level
    of the port's layers being one (unsharded) stack dim of the
    reference's leaves.  Returns the number of port leaves compared."""
    if isinstance(port, dict):
        assert set(port) == set(ref), path
        return sum(_same_shards(port[k], ref[k], nstack, f"{path}/{k}")
                   for k in port)
    if isinstance(port, list):
        return sum(_same_shards(v, ref, nstack + 1, f"{path}/{i}")
                   for i, v in enumerate(port))
    assert port.device.type == "meta", path
    want = ref.sharding.shard_shape(ref.shape)
    if len(ref.shape) > nstack:
        assert want[:nstack] == ref.shape[:nstack], (path, want)
        want = want[nstack:]
    assert tuple(port.shape) == tuple(want), (path, port.shape, want)
    assert str(port.dtype).split(".")[-1] == str(ref.dtype), path
    return 1


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_attach_equals_reference_shard_shapes(arch, mesh):
    jm, tm = _jmesh(mesh), AbstractMesh(*MESHES[mesh])
    for variant in ("dense", "sparse", "perf"):
        jcfg, tcfg, jp, tp = _pshapes(arch, variant)
        jspec = jsh.param_specs(jcfg, jp, jm)
        tspec = sh.param_specs(tcfg, tp, tm)
        n = _same_shards(sh.attach(tp, tspec, tm),
                         jsh.attach(jp, jspec, jm))
        assert n == len(tree_leaves(tp))
        if variant != "perf":
            continue
        # Adam with fp32 masters, its specs as the reference's lower_cell
        jopt = jadam(jconstant(1e-4), master_copy=True)
        jo = jax.eval_shape(jopt.init, jp)
        jos = {k: jax.tree.map(lambda t, s: JP() if len(t.shape) == 0
                               else s, jo[k], jspec) for k in jo}
        tstate = adam(constant_schedule(1e-4), master_copy=True).init(tp)
        assert set(tstate) == set(jo) == {"m", "v", "master"}
        _same_shards(sh.attach(tstate, sh.state_specs(tstate, tspec), tm),
                     jsh.attach(jo, jos, jm))
    jcfg, tcfg, _, _ = _pshapes(arch, "dense")
    for shape in valid_cells(tcfg):
        js = jbase.SHAPES[shape.name]
        tb, jb = tspecs.batch_struct(tcfg, shape), jspecs.batch_struct(
            jcfg, js)
        tok, _ = tspecs.decode_inputs_struct(tcfg, shape)
        jtok, _ = jspecs.decode_inputs_struct(jcfg, js)
        for t, j in ((tb, jb), ({"tokens": tok}, {"tokens": jtok})):
            _same_shards(sh.attach(t, sh.batch_specs(tcfg, t, tm), tm),
                         jsh.attach(j, jsh.batch_specs(jcfg, j, jm), jm))
    tc = TM.make_cache(tcfg, 128, 32768, device="meta")
    jc = jax.eval_shape(lambda: JM.make_cache(jcfg, 128, 32768))
    _same_shards(sh.attach(tc, sh.cache_specs(tcfg, tc, tm), tm),
                 jsh.attach(jc, jsh.cache_specs(jcfg, jc, jm), jm))


def test_attach_raises_where_a_spec_does_not_divide():
    tm = AbstractMesh(*MESHES["multi"])
    t = {"w": torch.empty(64, 48, device="meta")}
    got = sh.attach(t, {"w": sh.P(("pod", "data"), "model")}, tm)
    assert tuple(got["w"].shape) == (64 // 32, 48 // 16)
    for bad in (sh.P("model", ("pod", "data")), sh.P(None, None, None)):
        with pytest.raises(ValueError):
            sh.attach(t, {"w": bad}, tm)


_REFERENCE_NAMES = """
import dataclasses, json
from repro.configs import registry
from repro.configs.base import SHAPES
from repro.launch import dryrun as D
V = {variants!r}
print(json.dumps({{
    "sweep": D.SWEEP_ORDER,
    "cells": [D.cell_id(a, s, m, v) for a in D.SWEEP_ORDER for s in SHAPES
              for m in ("single", "multi") for v in V],
    "variants": {{f"{{a}}/{{v}}": dataclasses.asdict(
        D._apply_variant(registry.get(a), v))
        for a in D.SWEEP_ORDER for v in V}}}}, default=str))
"""


def test_names_and_variants_equal_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c",
         _REFERENCE_NAMES.format(variants=dryrun.VARIANTS)],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300,
        check=True)
    ref = json.loads(out.stdout.strip().splitlines()[-1])
    assert dryrun.SWEEP_ORDER == ref["sweep"]
    assert sorted(dryrun.SWEEP_ORDER) == sorted(treg.ARCHS)
    assert [dryrun.cell_id(a, s, m, v) for a in dryrun.SWEEP_ORDER
            for s in SHAPES for m in ("single", "multi")
            for v in dryrun.VARIANTS] == ref["cells"]
    for key, want in ref["variants"].items():
        arch, variant = key.split("/")
        got = json.loads(json.dumps(dataclasses.asdict(
            dryrun._apply_variant(treg.get(arch), variant)), default=str))
        shared = set(got) & set(want)
        assert {"param_dtype", "loss_chunk", "ssm_scan_dtype", "dtype",
                "sparsity", "n_layers", "d_model"} <= shared
        assert {k: got[k] for k in shared} == {k: want[k] for k in shared}, \
            key
    with pytest.raises(ValueError):
        dryrun._apply_variant(treg.get("stablelm-3b"), "int8")


# ------------------------------------------- the mesh steps on 8 gloo ranks
@pytest.fixture(scope="module")
def mesh_counts(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun_mesh")
    run_ranks(dryrun_counts, 8, str(d))
    return d, [json.loads((d / f"counts_{r}.json").read_text())
               for r in range(8)]


@pytest.mark.parametrize("case", range(len(DRYRUN_CASES)),
                         ids=["-".join(map(str, c)) for c in DRYRUN_CASES])
def test_mesh_counts_equal_dryrun_reckoning(case, mesh_counts):
    _, ranks = mesh_counts
    cfg = dryrun_case(*DRYRUN_CASES[case])
    mesh = AbstractMesh((2, 4), ("data", "model"))

    @functools.lru_cache(maxsize=None)    # every rank reckons the same
    def reckon(B, kind):
        return dryrun.count_cell(cfg, ShapeSpec("mesh", DRYRUN_SEQ, B, kind),
                                 mesh)
    seen = 0
    for got in ranks:
        for g in got:
            if g["case"] != case:
                continue
            rl, held = reckon(g["B"], g["kind"])
            assert g["dot_flops"] == rl.dot_flops, g
            assert g["coll"] == {k: [v["bytes"], v["count"]]
                                 for k, v in rl.coll_detail.items()}, g
            assert g["held"] == held, g
            assert all(held[k] == v for k, v in g.get("after", {}).items())
            # decode's one token is never sequence-sharded
            kinds = {"train": {"all-gather", "reduce-scatter", "all-reduce"},
                     "prefill": {"all-gather", "reduce-scatter"},
                     "decode": {"all-gather", "all-reduce"}}
            assert set(g["coll"]) == kinds[g["kind"]], g
            seen += 1
    assert seen == 8 * (1 + 2 * len(DRYRUN_ROWS))


@pytest.mark.parametrize("case", range(len(DRYRUN_CASES)),
                         ids=["-".join(map(str, c)) for c in DRYRUN_CASES])
def test_mesh_prefill_and_decode_equal_one_rank(case, mesh_counts):
    d, _ = mesh_counts
    cfg = dryrun_case(*DRYRUN_CASES[case])
    out = np.load(d / f"out_{case}.npz")
    for B in DRYRUN_ROWS:
        params, batch, cache, token = dryrun_inputs(cfg, B)
        assert dryrun.execution(cfg) == "partitioned"
        lg, pc, npos = steps.make_prefill_step(cfg)(params, batch)
        assert npos == DRYRUN_SEQ
        dl, dc = steps.make_decode_step(cfg)(params, cache, token,
                                             DRYRUN_SEQ - 1)
        want = {"prefill_logits": lg, "decode_logits": dl,
                **{f"prefill_cache_{k}": v for k, v in pc.items()},
                **{f"decode_cache_{k}": v for k, v in dc.items()}}
        for name, t in want.items():
            *head, last = name.split("_")
            key = (f"{'_'.join(head)}_{B}_{last}" if "cache" in name
                   else f"{name}_{B}")
            got, t = out[key], t.float().numpy()
            np.testing.assert_allclose(got, t, err_msg=key,
                                       **TP_TOL[cfg.dtype])


_IMPORT_ONLY = """
import json, os, sys
before = dict(os.environ)
import repro_torch.launch.dryrun
import torch
import torch.distributed as dist
print(json.dumps({"environ": dict(os.environ) == before,
                  "group": dist.is_initialized(),
                  "cuda": torch.cuda.is_initialized(),
                  "jax": "jax" in sys.modules,
                  "reference": any(m == "repro" or m.startswith("repro.")
                                   for m in sys.modules)}))
"""


def test_import_has_no_side_effects():
    """Importing the dry run sets no environment variable, starts no
    process group, touches no card and loads neither JAX nor the
    reference (a fresh interpreter, so nothing else imported them)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ONLY],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=300, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {
        "environ": True, "group": False, "cuda": False, "jax": False,
        "reference": False}


# -------------------------------------------------------------- the peak
@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_peak_bytes_closed_form(device):
    M_, K, N = 48, 64, 80
    a = torch.ones(M_, K, device=device)
    b = torch.ones(K, N, device=device)

    def chain(a, b):
        c = a @ b                       # M N
        d = torch.relu(c)               # M N, c still live
        del c
        e = d * 2                       # M N, c gone
        del d
        return e.t()                    # a view: no storage

    with dispatch.DispatchCounter((a, b)) as cnt:
        out = chain(a, b)
    assert cnt.peak_bytes == 4 * (M_ * K + K * N + 2 * M_ * N)
    assert cnt.live_bytes == 4 * (M_ * K + K * N + M_ * N)
    rl = analysis.analyze(chain, a, b)
    assert rl.memory_stats["peak_bytes"] == cnt.peak_bytes
    assert rl.memory_stats["argument_bytes"] == 4 * (M_ * K + K * N)
    assert out.shape == (N, M_)


def test_hbm_capacity_is_the_cards():
    """What the fit test compares against: the H100 80GB HBM3's memory as
    CUDA reports it (chip_smoke.dryrun_phase holds it to the card)."""
    assert analysis.HBM_CAPACITY == 81079 * 2**20
    assert 0.98 < analysis.HBM_CAPACITY / (80 * 2**30) < 1.0


# --------------------------------------------------------------- the CLI
def _record(out, cid):
    return json.loads((out / f"{cid}.json").read_text())


def test_cli_records_skips_forces_and_fails(tmp_path, monkeypatch, capsys):
    argv = ["--arch", "whisper-base", "--shape", "decode_32k", "--mesh",
            "single", "--out", str(tmp_path)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                          *argv], capture_output=True, text=True, env=env,
                         cwd=ROOT, timeout=300)
    cid = "whisper-base__decode_32k__single"
    assert run.returncode == 0, run.stderr
    assert f"[dryrun] {cid}: ok count=" in run.stdout
    assert "[dryrun] done: 1 ok, 0 failed" in run.stdout
    rec = _record(tmp_path, cid)
    assert set(rec) == RECORD_KEYS and rec["ok"] is True
    assert rec["n_chips"] == 256 and rec["microbatches"] == 1
    assert list(tmp_path.iterdir()) == [tmp_path / f"{cid}.json"]
    # present: skipped (no count); --force: counted again
    with pytest.raises(SystemExit) as e:
        dryrun.main(argv)
    assert e.value.code == 0 and "ok count=" not in capsys.readouterr().out
    with pytest.raises(SystemExit) as e:
        dryrun.main(argv + ["--force"])
    assert e.value.code == 0 and "ok count=" in capsys.readouterr().out
    assert _record(tmp_path, cid)["roofline"] == rec["roofline"]

    def boom(*a, **k):
        raise RuntimeError("planted fault")

    monkeypatch.setattr(dryrun, "count_cell", boom)
    with pytest.raises(SystemExit) as e:
        dryrun.main(argv + ["--force"])
    assert e.value.code == 1
    assert "FAIL RuntimeError: planted fault" in capsys.readouterr().out
    rec = _record(tmp_path, cid)
    assert rec["ok"] is False and rec["error"] == \
        "RuntimeError: planted fault" and "boom" in rec["traceback"]


def test_microbatch_plan_keeps_the_first_that_fits(tmp_path, monkeypatch):
    """A reduced train cell: with room for none every attempt is recorded
    and the last kept; with room at 2 microbatches the plan stops there."""
    cfg = dataclasses.replace(treg.get("deepseek-7b").reduced(),
                              attn_chunk=1024)
    monkeypatch.setattr(treg, "get", lambda name: cfg)
    monkeypatch.setitem(SHAPES, "train_4k", ShapeSpec("train_4k", 1024, 256,
                                                      "train"))
    monkeypatch.setattr(analysis, "HBM_CAPACITY", 1)
    rec = dryrun.run_cell("deepseek-7b", "train_4k", "single", "dense",
                          tmp_path)
    gbs = [a["per_device_gb"] for a in rec["fit_attempts"]]
    assert [a["microbatches"] for a in rec["fit_attempts"]] == [1, 2, 4, 8]
    assert rec["microbatches"] == 8 and rec["fits_80gb"] is False
    assert gbs == sorted(gbs, reverse=True) and gbs[0] > gbs[-1]
    monkeypatch.setattr(analysis, "HBM_CAPACITY",
                        (gbs[1] + gbs[0]) / 2 * 2**30)
    rec = dryrun.run_cell("deepseek-7b", "train_4k", "single", "dense",
                          tmp_path, force=True)
    assert [a["microbatches"] for a in rec["fit_attempts"]] == [1, 2]
    assert rec["microbatches"] == 2 and rec["fits_80gb"] is True


# ------------------------------------------------------------ full size
class _OffMeta(dispatch.DispatchCounter):
    """Also records (in ``found``, over every instance) each op output
    that lies off ``meta``."""
    found: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        self.found += [str(func) for t in dispatch._tensors(out)
                       if t.device.type != "meta" and t.numel() > 1]
        return out


@pytest.mark.parametrize("arch,shape,mesh,variant", [
    ("stablelm-3b", "train_4k", "single", "perf-sparse"),
    ("stablelm-3b", "prefill_32k", "single", "dense"),
    ("qwen3-moe-30b-a3b", "decode_32k", "multi", "dense")])
def test_full_size_cell_record(arch, shape, mesh, variant, tmp_path,
                               monkeypatch):
    """One cell of each kind at full size.  The train cell counts its
    first attempt only (room for it is patched in: at 1, 2, 4 and 8
    microbatches it takes minutes here; the plan is tested above)."""
    monkeypatch.setattr(analysis, "HBM_CAPACITY", 2**50)
    monkeypatch.setattr(dispatch, "DispatchCounter", _OffMeta)
    monkeypatch.setattr(_OffMeta, "found", [])
    ops.reset_launch_counts()
    rec = dryrun.run_cell(arch, shape, mesh, variant, tmp_path)
    assert rec["ok"], rec.get("traceback")
    assert set(ops.launch_counts().values()) == {0}
    assert _OffMeta.found == []
    rl = rec["roofline"]
    at_rest = sum(rec["at_rest_bytes"].values())
    assert rec["per_device_gb"] == round(
        (at_rest + rl["memory_stats"]["peak_bytes"]) / 2**30, 3)
    assert rec["useful_fraction"] == rec["model_flops"] / (
        rl["dot_flops"] * rec["n_chips"])
    assert rec["n_chips"] == (512 if mesh == "multi" else 256)
    assert rl["dot_flops"] > 0 and rl["coll_detail"]["all-gather"]["count"]
    # the at-rest shards are a 1/256 or 1/512 share at most of the full
    # trees; partitioned, the step's arguments are the shards (what it
    # gathers, a layer at a time, tests/test_torch_partitioned.py and
    # tests/test_torch_partitioned_moe.py hold)
    cfg = dryrun._apply_variant(treg.get(arch), variant)
    assert rec["execution"] == dryrun.execution(cfg) == "partitioned"
    full = sum(t.numel() * t.element_size()
               for t in tree_leaves(TM.init(cfg, 0, "meta")))
    assert rec["at_rest_bytes"]["params"] <= full / 16
    assert rl["memory_stats"]["argument_bytes"] < full / 4
    print(f"[dryrun] {rec['cell']}: dot_flops {rl['dot_flops']:.4g}, "
          f"t_compute {rl['t_compute']:.4g} s, dominant {rl['dominant']}, "
          f"per_device_gb {rec['per_device_gb']}, useful_fraction "
          f"{rec['useful_fraction']:.4g}, count {rec['count_s']} s")


def _cut(cfg):
    """Two layers; the hybrid one super-block (its shared attention and
    ``hybrid_attn_every`` Mamba layers), a MoE with dense first layers
    one MoE layer past them."""
    n = 2
    if cfg.family == "hybrid":
        n = cfg.hybrid_attn_every
    elif cfg.family == "moe":
        n = cfg.moe.first_dense_layers + 1
    return dataclasses.replace(cfg, n_layers=n, enc_layers=min(
        cfg.enc_layers, 2))


@pytest.mark.parametrize("arch", dryrun.SWEEP_ORDER)
def test_every_arch_decode_counts_at_a_cut_depth(arch):
    cfg = _cut(treg.get(arch))
    shape = SHAPES["decode_32k"]
    for mesh in ("single", "multi"):
        rl, held = dryrun.count_cell(cfg, shape, dryrun.production_mesh(
            mesh))
        assert rl.dot_flops > 0 and rl.memory_stats["peak_bytes"] > 0
        assert set(held) == {"params", "cache", "logits"}
        assert rl.coll_detail["all-gather"]["count"] > 0


def test_a_config_the_route_refuses_has_no_count():
    """The dry run counts the partitioned route alone: a config that
    ``steps.partitioned`` refuses (a dense model on the "sp" strategy)
    raises in ``execution`` and ``count_cell`` alike."""
    cfg = dataclasses.replace(_cut(treg.get("stablelm-3b")), strategy="sp")
    assert not steps.partitioned(cfg, dryrun._train_opt(cfg))
    with pytest.raises(ValueError, match="gathered"):
        dryrun.execution(cfg)
    with pytest.raises(ValueError, match="gathered"):
        dryrun.count_cell(cfg, SHAPES["decode_32k"],
                          dryrun.production_mesh("single"))
