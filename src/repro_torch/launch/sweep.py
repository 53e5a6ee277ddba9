"""Population sweep on MNIST-class data: a hyperparameter grid, end to end.

    PYTHONPATH=src python -m repro_torch.launch.sweep \
        --densities 0.25,0.5 --lrs 0.02,0.05,0.1 --rounds 3 \
        --steps-per-round 20 --out SWEEP_mnist.json

runs on the card; ``--device cpu`` runs on the CPU.  The default grid is
density x lr under SGD; ``--optim adam`` gives every member the in-kernel
Adam step and opens the ``--b1s`` / ``--wds`` axes (grid = density x lr
x b1 x wd, each member its own row of the [E, HYP_K] hyp table).  One
optimizer kind a sweep: the slot layout is structural.

It builds the candidate grid, buckets it into same-structure cohorts
(candidates whose densities give the same fan-ins train as one E-batched
population), runs successive halving (search/scheduler.py) and writes
the lineage ledger JSON: each member's config, loss curves, rounds
survived and the winner.  ``--tag`` stamps the ledger's meta.  The data
is ``data/mnist.paper_dataset`` (real MNIST where its idx files lie on
the machine, else the synthetic set).  ``--obs PATH`` streams the
scheduler's rank / prune / quarantine / winner events to a JSONL file
that ``repro_torch.launch.obs_report`` renders as the sweep table;
``--profile DIR`` writes a ``torch.profiler`` Chrome trace into DIR.
"""
from __future__ import annotations

import argparse


def _floats(s: str) -> list[float]:
    return [float(v) for v in s.split(",") if v]


def _parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--densities", default="0.25,0.5", metavar="D1,D2,...")
    ap.add_argument("--lrs", default="0.02,0.05,0.1", metavar="L1,L2,...")
    ap.add_argument("--momentum", type=float, default=0.0)
    ap.add_argument("--optim", choices=("sgd", "adam"), default="sgd",
                    help="per-member update rule (one kind a sweep: the "
                         "slot layout is structural)")
    ap.add_argument("--b1s", default="0.9", metavar="B1,B2,...",
                    help="Adam b1 sweep axis (--optim adam only)")
    ap.add_argument("--wds", default="0.0", metavar="W1,W2,...",
                    help="Adam weight-decay sweep axis (--optim adam only)")
    ap.add_argument("--hidden", type=int, default=512)
    ap.add_argument("--block", type=int, default=128)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--steps-per-round", type=int, default=20)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--samples", type=int, default=4096,
                    help="train samples drawn from the MNIST epoch")
    ap.add_argument("--eval-samples", type=int, default=512)
    ap.add_argument("--engine", default="auto",
                    help="pallas | jnp | auto (the fused update on the "
                         "junction kernels unless jnp)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tag", default="sweep",
                    help="artifact meta tag (ledger meta.tag)")
    ap.add_argument("--out", default="SWEEP_mnist.json")
    ap.add_argument("--obs", default=None, metavar="PATH",
                    help="flight-recorder JSONL sink: rank/prune/"
                         "quarantine round events; render with "
                         "repro_torch.launch.obs_report")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler Chrome trace of the sweep "
                         "into DIR")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    return ap.parse_args(argv)


def main(argv=None):
    args = _parse(argv)
    import math

    from repro_torch.configs.base import SweepConfig
    from repro_torch.data.mnist import paper_dataset
    from repro_torch.device import resolve_device
    from repro_torch.kernels.ops import resolve_engine
    from repro_torch.obs import Recorder, profile_ctx
    from repro_torch.search import CandidateSpec, bucket, run_sweep

    dev = resolve_device(args.device)
    # output width: the smallest block multiple holding the 32 padded classes
    out_w = -(-32 // args.block) * args.block
    layers = (1024, args.hidden, out_w)
    if args.optim == "adam":
        # density x lr x b1 x wd (the momentum field carries b1)
        grid = [(d, lr, b1, wd)
                for d in _floats(args.densities)
                for lr in _floats(args.lrs)
                for b1 in _floats(args.b1s)
                for wd in _floats(args.wds)]
        specs = [CandidateSpec(lr=lr, momentum=b1, opt="adam",
                               weight_decay=wd, density=d,
                               layers=layers, block=args.block,
                               init_seed=i)
                 for i, (d, lr, b1, wd) in enumerate(grid)]
    else:
        specs = [CandidateSpec(lr=lr, momentum=args.momentum, density=d,
                               layers=layers, block=args.block,
                               init_seed=i)
                 for i, (d, lr) in enumerate(
                     (d, lr) for d in _floats(args.densities)
                     for lr in _floats(args.lrs))]

    n = args.samples + args.eval_samples
    x, t, _ = paper_dataset(n=n, seed=args.seed)
    x_train, t_train = x[:args.samples], t[:args.samples]
    x_eval, t_eval = x[args.samples:], t[args.samples:]

    cfg = SweepConfig(rounds=args.rounds,
                      steps_per_round=args.steps_per_round,
                      batch_size=args.batch,
                      eval_samples=args.eval_samples,
                      seed=args.seed, engine=args.engine)
    n_cohorts = len(bucket(specs))
    eng = resolve_engine(cfg.engine)
    path = ("fused BP+UP" if cfg.fused and eng == "pallas"
            else "two-pass (materialized grads)")
    print(f"[sweep] {len(specs)} candidates in {n_cohorts} cohort(s), "
          f"{cfg.rounds} rounds x {cfg.steps_per_round} steps, "
          f"engine={eng}")
    print(f"[sweep] optim={args.optim} update path: {path}")
    recorder = (Recorder(args.obs, meta={"launcher": "sweep",
                                         "tag": args.tag,
                                         "device": str(dev)})
                if args.obs else None)
    try:
        with profile_ctx(args.profile):
            result = run_sweep(specs, x_train, t_train, x_eval, t_eval, cfg,
                               tag=args.tag, recorder=recorder, device=dev)
    finally:
        if recorder is not None:
            recorder.close()
            print(f"[sweep] telemetry -> {args.obs} "
                  f"({recorder.n_events} events)")
    led = result.ledger
    led.save(args.out)

    for m in sorted(led.members, key=lambda m: (m.pruned_at is None,
                                                m.rounds_survived)):
        ev = f"{m.eval_losses[-1]:.5f}" if m.eval_losses else "-"
        status = ("WINNER" if m.winner else
                  "live" if m.pruned_at is None else
                  f"quarantined@r{m.quarantined_at['round']}"
                  if m.quarantined_at is not None else
                  f"pruned@r{m.pruned_at}")
        hyps = f"density={m.config['density']} lr={m.config['lr']}"
        if m.config.get("opt") == "adam":
            hyps += (f" b1={m.config['momentum']} "
                     f"wd={m.config['weight_decay']}")
        print(f"[sweep]   member {m.member}: {hyps} eval={ev} {status}")
    w = led.winner()
    if w is None:
        survived = [m for m in led.members
                    if m.pruned_at is None and m.eval_losses]
        if survived and all(not math.isfinite(m.eval_losses[-1])
                            for m in survived):
            raise SystemExit("[sweep] no winner: every surviving candidate "
                             "diverged (non-finite eval loss); lower the "
                             "lr grid")
        raise SystemExit("[sweep] no winner: the sweep ran no rounds?")
    whyp = f"density={w.config['density']} lr={w.config['lr']}"
    if w.config.get("opt") == "adam":
        whyp += f" b1={w.config['momentum']} wd={w.config['weight_decay']}"
    print(f"[sweep] winner: {whyp} "
          f"eval_loss={w.eval_losses[-1]:.5f} -> {args.out}")
    return result


if __name__ == "__main__":
    main()
