"""Training launcher of the PyTorch port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b \
        --sparse --steps 100 --batch 8 --seq 256

runs on the card; ``--device cpu --reduce`` trains a tiny config on the
CPU.  ``--arch falcon-mamba-7b`` (ssm) and ``--arch zamba2-2.7b``
(hybrid) train too, with ``--seq`` a multiple of the scan chunk (128; 16
under ``--reduce``) or shorter than it; the hybrid's shared attention
block takes the two-pass update only.  ``--arch llava-next-mistral-7b``
(vlm) trains on batches of min(num_patches, seq // 2) random patch
embeddings ahead of the rest of ``--seq`` in tokens, the loss on the
text; ``--arch deepseek-v2-lite-16b`` runs MLA and its dense first
layer (``--layers`` counts it); ``--arch whisper-base`` (audio) trains
its encoder and decoder on batches of ``--seq`` tokens, each row with
its enc_frames random frame embeddings (``--layers`` sets the decoder's
depth).  ``--compress-grads`` wraps the optimizer in
``train/grad_compress.compressed`` (int8 gradients with error
feedback), which takes the two-pass update path: compression comes
first, then the optimizer (and its clipping) on the restored gradients.
Weights are random, made from seed 0; batches come from the synthetic
``LMTokenPipeline``.  The run auto-resumes from the newest
checkpoint under ``--ckpt`` (default: ``build/train_ckpt`` in the
checkout).  ``--obs PATH`` streams the flight recorder's events (a
record a step, guardian and checkpoint events) to a JSONL file that
``repro_torch.launch.obs_report`` renders; ``--profile DIR`` writes a
``torch.profiler`` Chrome trace of the run into DIR.

``--devices N`` trains on a (``--data``, ``--model``) device mesh of N
ranks, N = data x model (launch/mesh.py): params and optimizer state
are placed by ``parallel/sharding.param_specs``, each rank holding only
its shard at rest, and ``train/steps.make_mesh_train_step`` runs the
step: on the two-pass path the ranks divide the work as the specs
divide the leaves (tensor parallelism over "model", or whisper's
sequence over "model", each layer gathered over "data" only while it
runs, the gradients reduce-scattered back to the shards;
``steps.partitioned``), and so does the fused path (each fused
junction's update over every row of the batch, its weight and slots
gathered over "data" only while it runs; a MoE's experts over every
row group's capacity slots).
The two-pass step gives each
data-parallel rank its rows of the batch and averages the gradients
over the data axis.  On
the card N is 1 (a one-rank NCCL group; one card, one rank); with
``--device cpu`` N gloo ranks run as N processes on this host.  Rank 0
alone prints, records ``--obs`` / ``--profile`` and writes
checkpoints; a spawned run returns None.  ``--data`` / ``--model``
without ``--devices`` need a process group of that world size already
(else they raise); at data x model 1 without ``--devices`` the step runs
on plain tensors, as before.
"""
from __future__ import annotations

import argparse
import sys
from datetime import timedelta
from pathlib import Path

DEFAULT_CKPT = Path(__file__).resolve().parents[3] / "build" / "train_ckpt"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-3b")
    ap.add_argument("--reduce", action="store_true",
                    help="use the reduced (smoke-size) config")
    ap.add_argument("--width", type=int, default=0,
                    help="override d_model (d_ff = 3x, head_dim = width/heads)")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optim", choices=("sgd", "adam"), default="adam",
                    help="fused_sgd(momentum=0.9) or fused_adam(grad_clip=1)"
                         " (two-pass when the config is not eligible)")
    ap.add_argument("--sparse", action="store_true",
                    help="apply the paper's pre-defined FFN sparsity")
    ap.add_argument("--density", type=float, default=0.25)
    ap.add_argument("--ckpt", default=str(DEFAULT_CKPT))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--devices", type=int, default=0,
                    help="ranks of the device mesh (data x model): 1 on "
                         "the card, N gloo processes with --device cpu")
    ap.add_argument("--data", type=int, default=1, help="data-parallel size")
    ap.add_argument("--model", type=int, default=1,
                    help="model-parallel size")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true",
                    help="int8 gradients with error feedback "
                         "(train/grad_compress.py; two-pass update)")
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a crash at this step (restart test)")
    ap.add_argument("--obs", default=None, metavar="PATH",
                    help="flight-recorder JSONL sink (obs/telemetry.py): "
                         "per-step records + guardian/checkpoint events; "
                         "render with repro_torch.launch.obs_report")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler Chrome trace of the run "
                         "into DIR")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    argv = list(sys.argv[1:] if argv is None else argv)
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from repro_torch.device import resolve_device

    dev = resolve_device(args.device)
    world = args.data * args.model
    on_mesh = bool(args.devices) or world > 1
    if args.devices and args.devices != world:
        raise ValueError(f"--devices {args.devices} needs --data x --model "
                         f"= {args.devices}, have {args.data} x "
                         f"{args.model} = {world}")
    if on_mesh and dev.type == "cuda" and world > 1:
        raise RuntimeError(
            f"a mesh of {world} ranks on the card: this launcher drives one "
            f"card ({torch.cuda.get_device_name(dev)}) as one rank; use "
            "--devices 1, or --device cpu for gloo ranks")
    if args.devices > 1 and not dist.is_initialized():
        return _spawn(argv, world)
    return _train(args, dev, on_mesh)


def _spawn(argv, world: int) -> None:
    """``world`` gloo ranks, one process each, over a file store."""
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as d:
        mp.start_processes(_rank_main, args=(argv, world, f"{d}/store"),
                           nprocs=world, start_method="spawn")


def _rank_main(rank: int, argv, world: int, store: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)     # the ranks share this host's cores
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=timedelta(minutes=10))
    try:
        main(argv)
    finally:
        dist.destroy_process_group()


def _train(args, dev, on_mesh: bool):
    import contextlib
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.configs import registry
    from repro_torch.core.sparsity import SparsityConfig
    from repro_torch.data.pipeline import LMTokenPipeline
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import model as M
    from repro_torch.obs import Recorder, profile_ctx
    from repro_torch.optim import cosine_schedule, fused_adam, fused_sgd
    from repro_torch.parallel import hints
    from repro_torch.parallel import sharding as sh
    from repro_torch.train import grad_compress
    from repro_torch.train.steps import (fused_update_eligible,
                                         make_mesh_train_step,
                                         make_train_step)
    from repro_torch.train.train_loop import TrainLoopConfig, run

    own_group = on_mesh and not dist.is_initialized()
    mesh = make_local_mesh(args.data, args.model, dev) if on_mesh else None
    rank = dist.get_rank() if on_mesh else 0

    def say(*a, **k):
        if rank == 0:
            print(*a, **k)

    cfg = registry.get(args.arch)
    if args.reduce:
        cfg = cfg.reduced()
    if args.width:
        cfg = dataclasses.replace(cfg, d_model=args.width,
                                  d_ff=args.width * 3,
                                  head_dim=args.width // max(1, cfg.n_heads))
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    if args.sparse:
        block = 32 if args.reduce else 128
        cfg = cfg.with_sparsity(SparsityConfig(density=args.density,
                                               block=block, where="ffn"))

    sched = cosine_schedule(args.lr, warmup=20, total=args.steps)
    if args.optim == "sgd":
        opt = fused_sgd(sched, momentum=0.9)
    else:
        opt = fused_adam(sched, grad_clip=1.0)
    if args.compress_grads:
        opt = grad_compress.compressed(opt)
    ok, why = fused_update_eligible(cfg, opt, args.microbatches)
    say(f"[train] optim={args.optim} update path: "
        f"{'fused BP+UP' if ok else f'two-pass ({why})'}")

    params = M.init(cfg, 0, dev)
    opt_state = opt.init(params)
    if on_mesh:
        specs = sh.param_specs(cfg, params, mesh)
        params = sh.place(params, specs, mesh)
        opt_state = sh.place_state(opt_state, specs, mesh)
        train_step = make_mesh_train_step(cfg, opt, mesh, args.microbatches)
        held = {"params": sh.held_bytes(params),
                "optimizer state": sh.held_bytes(opt_state)}
        say(f"[train] mesh data={args.data} model={args.model} "
            f"({dist.get_backend()}, {dist.get_world_size()} ranks): bytes "
            "a rank holds at rest " + ", ".join(
                f"{k} {loc} of {full}" for k, (loc, full) in held.items()))
    else:
        train_step = make_train_step(cfg, opt, microbatches=args.microbatches)
    pipeline = LMTokenPipeline(cfg, args.batch, args.seq)
    loop_cfg = TrainLoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt,
                               ckpt_every=args.ckpt_every,
                               fail_at_step=args.fail_at)
    recorder = (Recorder(args.obs, meta={"launcher": "train",
                                         "arch": args.arch,
                                         "device": str(dev)})
                if args.obs and rank == 0 else None)
    try:
        with contextlib.ExitStack() as stack:
            if rank == 0:
                stack.enter_context(profile_ctx(args.profile))
            if on_mesh:
                stack.enter_context(hints.use_mesh_hints(mesh))
            result = run(loop_cfg, train_step, params, opt_state, pipeline,
                         log=say, recorder=recorder)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
    finally:
        if recorder is not None:
            recorder.close()
            say(f"[train] telemetry -> {args.obs} "
                f"({recorder.n_events} events)")
        if own_group:
            dist.destroy_process_group()
    say(f"[train] finished at step {result['step']} on {dev}; "
        f"stragglers={result['straggler_count']}")
    if result["history"]:
        say(f"[train] first loss {result['history'][0]['loss']:.4f} "
            f"-> last {result['history'][-1]['loss']:.4f}")
    return result


if __name__ == "__main__":
    main()
