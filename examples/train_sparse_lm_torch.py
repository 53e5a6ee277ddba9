"""Train a ~100M-parameter LM with the paper's pre-defined block
sparsity on its FFNs, on the PyTorch port, with checkpointing and
auto-resume.

    PYTHONPATH=src python examples/train_sparse_lm_torch.py --steps 300

runs on the card; ``--device cpu`` runs on the CPU, and ``--reduce``
trains the reduced stablelm-3b config instead (a CPU-sized smoke).  The
config is a scaled-down stablelm-family decoder (d_model 512, 8 layers,
vocab 50304); ``--dense`` trains the FC baseline the paper compares
against.  Checkpoints go to ``--ckpt`` (default: ``build/sparse_lm`` in
the checkout); a run resumes from the newest one there.
"""
import argparse
import dataclasses
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import registry
from repro_torch.core.sparsity import SparsityConfig
from repro_torch.data.pipeline import LMTokenPipeline
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.optim import adam, cosine_schedule
from repro_torch.train.steps import make_train_step
from repro_torch.train.train_loop import TrainLoopConfig, run
from repro_torch.tree import tree_leaves


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--dense", action="store_true", help="FC baseline")
    ap.add_argument("--density", type=float, default=0.25)
    ap.add_argument("--reduce", action="store_true",
                    help="the reduced stablelm-3b config (block 32)")
    ap.add_argument("--ckpt", default=str(ROOT / "build" / "sparse_lm"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if args.reduce:
        cfg, block = registry.get("stablelm-3b").reduced(), 32
    else:
        cfg, block = dataclasses.replace(
            registry.get("stablelm-3b"),
            n_layers=8, d_model=512, n_heads=8, kv_heads=8, head_dim=64,
            d_ff=1536, max_seq=2048, attn_chunk=128), 128
    if not args.dense:
        cfg = cfg.with_sparsity(SparsityConfig(
            density=args.density, block=block, where="ffn"))
    params = M.init(cfg, 0, dev)
    n_params = sum(p.numel() for p in tree_leaves(params)
                   if p.is_floating_point())
    print(f"{'dense' if args.dense else 'sparse'} model: "
          f"{n_params / 1e6:.1f}M trainable params on {dev}")

    opt = adam(cosine_schedule(3e-4, warmup=20, total=args.steps))
    opt_state = opt.init(params)
    ts = make_train_step(cfg, opt)
    pipe = LMTokenPipeline(cfg, args.batch, args.seq)
    t0 = time.time()
    res = run(TrainLoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt,
                              ckpt_every=100, log_every=20),
              ts, params, opt_state, pipe)
    h = res["history"]
    if h:
        print(f"done in {time.time() - t0:.0f}s: loss {h[0]['loss']:.3f} "
              f"-> {h[-1]['loss']:.3f} over {res['step']} steps")
    return res


if __name__ == "__main__":
    main()
