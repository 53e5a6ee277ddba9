"""Quickstart on the PyTorch port: train the paper's exact network
(Table I) on MNIST-class data in (12,3,8) fixed point with pre-defined
sparsity, then run the junction-pipelined schedule.

    PYTHONPATH=src python examples/quickstart_torch.py [--epochs 3] [--full]

runs on the card; ``--device cpu`` runs on the CPU.  The data is
``repro_torch.data.mnist.paper_dataset``: real MNIST where its idx files
lie on the machine, else the synthetic set.
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch

from repro_torch.core import fixed_point as fxp
from repro_torch.core import junction_pipeline as JP
from repro_torch.core import paper_net as PN
from repro_torch.data.mnist import PAPER_EPOCH, paper_dataset
from repro_torch.device import resolve_device


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--full", action="store_true",
                    help=f"full {PAPER_EPOCH}-sample epochs (paper scale)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    n = PAPER_EPOCH if args.full else 3072
    x, y, _ = paper_dataset(n)
    xs, ys = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)

    cfg = PN.PaperNetConfig(fmt=fxp.PAPER_FMT)
    print(f"network 1024-64-32, params={cfg.n_params()}, "
          f"overall density={cfg.overall_density():.4f}")
    print(f"block cycle = {JP.block_cycle_s(cfg) * 1e6:.2f} us "
          f"(paper: 2.27 us at 15 MHz)")
    print(f"arithmetic units: {JP.resources(cfg)}")

    # eta halving schedule (Sec. III-B), starting at 2^-3
    params = PN.init(cfg, device=dev)
    t0 = time.perf_counter()
    accs = []
    for e in range(args.epochs):
        halvings = 0 if e < 2 else 1 + (e - 2) // 4
        eta = 2.0 ** -min(3 + halvings, 7)
        params, losses, corr = PN.train_epoch(params, xs, ys, eta, cfg)
        acc = float(corr[-1000:].mean())
        accs.append(acc)
        print(f"epoch {e + 1}: eta=2^{-(3 + min(halvings, 4))} "
              f"acc(last1000)={acc:.4f}")
    _sync(dev)
    dt = time.perf_counter() - t0
    print(f"sequential training on {dev}: {dt:.1f}s "
          f"({dt / (args.epochs * n) * 1e6:.0f} us an input)")

    # the paper's junction-pipelined schedule (Fig. 1): FF/BP/UP overlapped
    params2 = PN.init(cfg, device=dev)
    for e in range(args.epochs):
        params2, corr2 = PN.train_epoch_pipelined(params2, xs, ys, 2.0 ** -3,
                                                  cfg)
    acc2 = float(corr2[-1000:].mean())
    print(f"junction-pipelined acc(last1000)={acc2:.4f} "
          f"(zero-bubble, {3 * cfg.n_junctions} ops in flight)")
    return accs, acc2


if __name__ == "__main__":
    main()
