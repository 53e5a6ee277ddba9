"""Dry run: one rank of every (arch x shape x mesh x variant) cell,
counted on the ``meta`` device.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch stablelm-3b \
        --variant perf-sparse --mesh both

The port's counterpart of ``src/repro/launch/dryrun.py``.  The reference
lowers and compiles each cell for 256 or 512 forced host devices; the
port has no abstract sharded program, so it counts the ops one rank of
the production mesh would run.  It is the one entry point that runs on
``meta`` whatever the machine: no tensor is allocated, no kernel is
launched (every wrapper takes its plain version on ``meta``,
``device.plain_route``, so the bytes and the peak at a junction are the
plain version's, not the ``sm_90a`` kernel's), and there is no
``--device`` and no card or CPU path.  Importing this module sets no
environment variable, starts no process group and makes no CUDA call.

Per cell:
  * ``cfg`` from ``_apply_variant`` (the reference's five variants),
  * ``M.init(cfg, device="meta")``,
  * ``param_specs`` / ``batch_specs`` / ``cache_specs`` on
    ``AbstractMesh((16, 16), ("data", "model"))`` or ``((2, 16, 16),
    ("pod", "data", "model"))``, and ``sharding.attach`` for the shards
    each rank holds at rest,
  * the rank's step, counted by ``roofline.analysis.analyze``: train,
    ``adam(constant_schedule(1e-4), master_copy=(param_dtype !=
    "float32"))`` two-pass on the rank's rows; prefill on the rank's
    rows; decode on the rank's shard of the cache, ``pos = seq_len -
    1``.

Counted per rank as the port's mesh steps (``train/steps.make_mesh_*``)
do the work, on the partitioned route ``steps.partitioned`` gives every
architecture of the registry (the record's ``"execution"``: the dense
family, the vlm with its sliding window, the moe family with full
attention or MLA, the ssm family and the hybrid; the audio family on the
"sp" strategy, its sequence and frames over "model" and every weight
whole over it): the rank's step on its shards (``attach``, its junction
views from ``sharding.with_junction_views``) and rows, through the same
code the mesh runs (``steps.make_partitioned_train_step``,
``steps.partitioned_prefill`` / ``partitioned_decode``) under a
``partition.ReckonedComm``, which reckons each collective the real step
issues in the order and size it issues them: the per-layer all-gathers
over the dp axes, forward and backward (each layer recomputed), the
gradients' reduce-scatters and all-reduces (under "sp" each all-reduced
over "model" too), the sequence-parallel attention's k / v all-gathers
over "model" and its loss's all-reduce, tensor parallelism's
all-gathers, reduce-scatters and all-reduces of activations (a
replicated k / v, or MLA's latent, projected on the rank's positions and
all-gathered over "model"), the vocab-parallel cross entropy's and
decode's log-sum-exp all-reduces, a MoE's routing (its logits'
all-gather over "model", the all-gather of the top-k indices over the
row axes where a dispatch group crosses them, the all-reduces of the
load-balance means), a Mamba mixer's all-to-all that regroups the
columns its channels or heads read (``Partition.regroup``, forward and
backward) and Mamba-1's all-reduce of ``x_proj``'s partial products, the
clip norm's and the metrics'. The model axis divides the compute as the
specs say, and so does the memory: no leaf is gathered whole and the
cache stays sharded.  A config ``steps.partitioned`` refuses (none of
the registry's) raises: it has no count.  ``--fused`` counts the train
cells' fused BP+UP step instead (``fused_adam``, clip 1.0; records
``<cell>+fused``), for a variant whose params are in the compute dtype
(``perf-sparse``): its norm pre-pass, then each fused junction's update
over every row of the batch, x, the residual and dy all-gathered over
the row axes (``partition.HeldJunction``; a MoE's experts their every
row group's capacity slots, whisper's rows over "model" too where they
split over it), so its eager peak holds them.

Collectives follow ``roofline/dispatch.py``'s conventions (an
all-gather, a reduce-scatter and an all-to-all count their output bytes,
an all-reduce twice its bytes).  ``per_device_gb`` is the bytes the rank
holds at rest (``at_rest_bytes``: the shards of params, optimizer state,
cache and logits, from ``attach``) plus the step's eager peak
(``memory_stats["peak_bytes"]``: gathered leaves, activations,
gradients, the new state), in GiB.  Train cells try 1, 2, 4, 8
microbatches and keep the first whose ``per_device_gb`` is below the
card's memory (``analysis.HBM_CAPACITY``).

Records land in ``results/dryrun_torch/<cell>.json`` and are skipped
when present unless ``--force``; a cell that raises is recorded with
``ok: false`` and the sweep goes on (exit status 1).  The keys are the
reference's where the port has the quantity, with ``count_s`` for its
``lower_s`` / ``compile_s``, ``fits_80gb`` for ``fits_16gb``, and
``at_rest_bytes`` and ``execution`` added.  Left out:
``per_device_gb_corrected`` and ``fit_attempts[].corrected_gb``
(XLA-CPU's widening of bf16 loop state
has no counterpart) and ``roofline.raw_cost`` (no ``cost_analysis``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES, ArchConfig, ShapeSpec, \
    valid_cells
from repro_torch.core.sparsity import SparsityConfig
from repro_torch.launch import specs as specs_mod
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import model as M
from repro_torch.optim import adam, constant_schedule, fused_adam
from repro_torch.parallel import partition
from repro_torch.parallel import sharding as sh
from repro_torch.roofline import analysis as roofline
from repro_torch.train import steps
from repro_torch.tree import tree_leaves, tree_map

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"

# sweep order: small archs first so results accumulate fast
SWEEP_ORDER = [
    "whisper-base", "stablelm-3b", "zamba2-2.7b", "deepseek-7b",
    "llava-next-mistral-7b", "falcon-mamba-7b", "deepseek-v2-lite-16b",
    "qwen3-moe-30b-a3b", "qwen2-72b", "command-r-plus-104b",
]
VARIANTS = ("dense", "sparse", "sparse-all", "perf", "perf-sparse")


def cell_id(arch: str, shape: str, mesh_kind: str, variant: str,
            fused: bool = False) -> str:
    v = ("" if variant == "dense" else f"+{variant}") + (
        "+fused" if fused else "")
    return f"{arch}{v}__{shape}__{mesh_kind}"


def _apply_variant(cfg: ArchConfig, variant: str) -> ArchConfig:
    if variant == "dense":
        return cfg
    if variant == "sparse":   # the paper's technique on FFN projections
        return cfg.with_sparsity(SparsityConfig(density=0.125, block=128,
                                                where="ffn"))
    if variant == "sparse-all":
        return cfg.with_sparsity(SparsityConfig(density=0.125, block=128,
                                                where="ffn+attn"))
    if variant == "perf":     # bf16-resident params (fp32 masters in adam),
        # chunked CE, bf16 selective-scan elements
        return dataclasses.replace(cfg, param_dtype="bfloat16",
                                   loss_chunk=2048,
                                   ssm_scan_dtype="bfloat16")
    if variant == "perf-sparse":
        return dataclasses.replace(
            cfg.with_sparsity(SparsityConfig(density=0.125, block=128,
                                             where="ffn")),
            param_dtype="bfloat16", loss_chunk=2048,
            ssm_scan_dtype="bfloat16")
    raise ValueError(variant)


def production_mesh(mesh_kind: str) -> AbstractMesh:
    if mesh_kind == "multi":
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if torch.is_tensor(t))


def _meta_rows(tree, n: int):
    """Row group 0 of ``n`` of each leaf, along dim 0, on ``meta``."""
    return tree_map(lambda t: torch.empty(
        (t.shape[0] // n, *t.shape[1:]), dtype=t.dtype, device="meta"), tree)


def _train_opt(cfg: ArchConfig):
    return adam(constant_schedule(1e-4),
                master_copy=(cfg.param_dtype != "float32"))


def _fused_opt():
    """``--fused``'s optimizer: the dry run's Adam (clip 1.0) on the fused
    contract."""
    return fused_adam(constant_schedule(1e-4), grad_clip=1.0)


def execution(cfg: ArchConfig, optimizer=None) -> str:
    """The route the mesh steps run ``cfg`` on (its train step with
    ``optimizer``, by default the dry run's two-pass Adam):
    ``"partitioned"``, the only one the dry run counts (a config the
    route refuses raises)."""
    if not steps.partitioned(cfg, optimizer or _train_opt(cfg)):
        raise ValueError(f"{cfg.name}: the mesh steps run it gathered, "
                         "which the dry run does not count")
    return "partitioned"


def count_cell(cfg: ArchConfig, shape: ShapeSpec, mesh,
               microbatches: int = 1, optimizer=None, row_log=None):
    """One rank's count of a cell on the partitioned route (rank 0's
    shards): (its roofline, {tree: bytes the rank holds at rest}).
    ``mesh``: an ``AbstractMesh`` (or a ``DeviceMesh``, read for its axes
    only); ``optimizer``: the train step's, by default the dry run's
    two-pass Adam (a fused one counts the fused step); ``row_log``: a list
    that takes the bytes of each fused junction's update operands
    gathered over the row axes (``Partition.note_rows``)."""
    opt = optimizer or _train_opt(cfg)
    execution(cfg, opt)
    params = M.init(cfg, 0, "meta")
    pspecs = sh.param_specs(cfg, params, mesh)
    held = {"params": _nbytes(sh.attach(params, pspecs, mesh))}
    comm = partition.ReckonedComm(mesh)
    B = shape.global_batch
    if shape.kind == "decode":
        token, _ = specs_mod.decode_inputs_struct(cfg, shape)
        batch = {"tokens": token}
    else:
        batch = specs_mod.batch_struct(cfg, shape)
    axes, n = steps.dp_split(cfg, batch, mesh)
    rows = _meta_rows(batch, n)
    part = partition.Partition(cfg, comm, pspecs, axes if n > 1 else ())
    if row_log is not None:
        part.note_rows = lambda got: row_log.append(sum(
            t.numel() * t.element_size() for t in got if t is not None))
    local = sh.with_junction_views(sh.attach(params, pspecs, mesh), pspecs,
                                   mesh, 0)
    out = []
    if shape.kind == "train":
        state = opt.init(params)
        lstate = sh.attach(state, sh.state_specs(state, pspecs), mesh)
        held["opt_state"] = _nbytes(lstate)
        fn = steps.make_partitioned_train_step(cfg, opt, part, microbatches)
        rl = roofline.analyze(fn, local, lstate, rows, 0)
    elif shape.kind == "prefill":
        def fn(p, b):
            out.extend(steps.partitioned_prefill(cfg, part, p, b))
            return out
        rl = roofline.analyze(fn, local, rows)
        held["cache"] = _nbytes(out[1])
    else:
        cache = M.make_cache(cfg, B, shape.seq_len, "meta")
        cspecs = sh.cache_specs(cfg, cache, mesh)
        lcache = sh.attach(cache, cspecs, mesh)
        held["cache"] = _nbytes(lcache)
        part.cache_seq_split = steps.cache_seq_split(cspecs)

        def fn(p, c, tok):
            out.extend(steps.partitioned_decode(cfg, part, p, c, tok,
                                                shape.seq_len - 1))
            return out
        rl = roofline.analyze(fn, local, lcache, rows["tokens"])
    if shape.kind != "train":
        held["logits"] = _nbytes(out[0])
    rl = roofline.make_roofline(rl.dot_flops, rl.mem_bytes, comm.detail,
                                rl.memory_stats)
    return rl, held


def run_cell(arch: str, shape_name: str, mesh_kind: str, variant: str,
             out_dir: Path, force: bool = False, fused: bool = False) -> dict:
    """Count one cell and record it; ``fused``: a train cell's fused BP+UP
    step (``ArchConfig.fused_update``, ``_fused_opt``), whose whole
    batch runs at once (no microbatches)."""
    cid = cell_id(arch, shape_name, mesh_kind, variant, fused)
    out_path = Path(out_dir) / f"{cid}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())
    cfg = _apply_variant(registry.get(arch), variant)
    opt = None
    if fused:
        cfg, opt = dataclasses.replace(cfg, fused_update=True), _fused_opt()
    shape = SHAPES[shape_name]
    mesh = production_mesh(mesh_kind)
    n_chips = math.prod(mesh.shape)
    rec: dict = {"cell": cid, "arch": arch, "shape": shape_name,
                 "mesh": mesh_kind, "variant": variant, "n_chips": n_chips,
                 "params": cfg.param_count(),
                 "active_params": cfg.active_param_count()}
    cap_gb = roofline.HBM_CAPACITY / 2**30
    try:
        rec["execution"] = execution(cfg, opt)
        if fused:
            ok, why = steps.fused_update_eligible(cfg, opt)
            if not ok:
                raise ValueError(f"not fused: {why}")
            rec["update_path"] = "fused"
        # training cells auto-scale microbatches (gradient accumulation
        # over the rank's rows) until the per-device footprint fits
        mb_plan = [1, 2, 4, 8] if shape.kind == "train" and not fused \
            else [1]
        rows = shape.global_batch // steps.dp_split(
            cfg, specs_mod.batch_struct(cfg, shape), mesh)[1]
        attempts = []
        for mb in mb_plan:
            if mb > 1 and rows % mb:
                continue
            t0 = time.time()
            row_bytes: list = []
            rl, held = count_cell(cfg, shape, mesh, microbatches=mb,
                                  optimizer=opt, row_log=row_bytes)
            rec["count_s"] = round(time.time() - t0, 1)
            per_dev_gb = (sum(held.values())
                          + rl.memory_stats["peak_bytes"]) / 2**30
            attempts.append({"microbatches": mb,
                             "per_device_gb": round(per_dev_gb, 3)})
            rec["microbatches"] = mb
            if per_dev_gb < cap_gb or mb == mb_plan[-1]:
                break
        rec["fit_attempts"] = attempts
        rec["roofline"] = rl.to_json()
        rec["at_rest_bytes"] = held
        rec["model_flops"] = roofline.model_flops(cfg, shape)
        rec["useful_fraction"] = roofline.useful_fraction(
            cfg, shape, rl.dot_flops, n_chips)
        rec["per_device_gb"] = round(per_dev_gb, 3)
        if fused:   # one junction's x, dy and residual over every row
            rec["fused_rows_gb"] = round(max(row_bytes, default=0) / 2**30,
                                         3)
        rec["fits_80gb"] = per_dev_gb < cap_gb
        rec["ok"] = True
        rows_gb = (f" rows={rec['fused_rows_gb']}GiB at_rest="
                   f"{sum(held.values()) / 2**30:.2f}GiB" if fused else "")
        print(f"[dryrun] {cid}: ok count={rec['count_s']}s "
              f"perdev={per_dev_gb:.2f}GiB mb={rec['microbatches']} "
              f"dom={rl.dominant}{rows_gb}", flush=True)
    except Exception as e:  # record failure: these are faults to fix
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        print(f"[dryrun] {cid}: FAIL {rec['error'][:200]}", flush=True)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(rec, indent=1, default=float))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--variant", default="dense", choices=list(VARIANTS))
    ap.add_argument("--out", default=str(RESULTS))
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--fused", action="store_true",
                    help="count the train cells' fused BP+UP step (fused "
                    "Adam, clip 1.0; a variant with param_dtype == dtype, "
                    "e.g. perf-sparse)")
    args = ap.parse_args(argv)
    out_dir = Path(args.out)

    archs = [args.arch] if args.arch else SWEEP_ORDER
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    n_ok = n_fail = 0
    for arch in archs:
        cfg = registry.get(arch)
        cells = ([SHAPES[args.shape]] if args.shape
                 else list(valid_cells(cfg)))
        if args.fused:
            cells = [c for c in cells if c.kind == "train"]
        for shape in cells:
            for mk in meshes:
                rec = run_cell(arch, shape.name, mk, args.variant, out_dir,
                               force=args.force, fused=args.fused)
                n_ok += rec.get("ok", False)
                n_fail += not rec.get("ok", False)
    print(f"[dryrun] done: {n_ok} ok, {n_fail} failed", flush=True)
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
