"""Batched serving on the PyTorch port: prefill a request batch, decode
step-locked, report the time a token and a step (the static engine,
``repro_torch.serve.engine.Engine``).

    PYTHONPATH=src python examples/serve_batched_torch.py --arch stablelm-3b

runs the reduced (CPU-sized) config on the card; ``--device cpu`` runs it
on the CPU.  The port serves the dense and moe families.
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np

from repro_torch.configs import registry
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.serve.engine import Engine, ServeConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-3b",
                    choices=list(registry.ARCHS))
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--temperature", type=float, default=0.7)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = registry.get(args.arch).reduced()   # CPU-sized
    params = M.init(cfg, 0, dev)
    eng = Engine(cfg, params, ServeConfig(max_new_tokens=args.max_new,
                                          temperature=args.temperature,
                                          seed=17), device=dev)
    rng = np.random.default_rng(0)
    V = cfg.raw_vocab or cfg.vocab
    prompts = rng.integers(0, V, size=(args.requests, args.prompt_len)
                           ).astype(np.int32)

    t0 = time.perf_counter()
    out = eng.generate(prompts)
    dt = time.perf_counter() - t0
    total = args.requests * args.max_new
    print(f"arch={args.arch} ({cfg.family}) on {dev} generated "
          f"{out.shape[0]}x{out.shape[1]} tokens in {dt:.2f}s -> "
          f"{total / dt:.1f} tok/s, {dt / args.max_new * 1e3:.1f} ms/step")
    print("sample:", out[0][:12].tolist())
    return out


if __name__ == "__main__":
    main()
