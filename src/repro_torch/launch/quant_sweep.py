"""Post-training quantization sweep on the population kernels.

    PYTHONPATH=src python -m repro_torch.launch.quant_sweep \
        --bits 8,6,4 --granularities block,unit --fxp --out quant.json

Trains one fp32 paper MLP briefly on MNIST-class data (the population
step at E = 1, fused update), optionally calibrates static activation
scales on a calibration batch (absmax / 127), then evaluates every
quantization config as a member of a stacked quantized population: the
configs of one cohort (search/cohorts.bucket_quant: int8 widths and
granularities share a layout) run E at once through the int8 kernel,
and with ``--fxp`` each of the paper's fixed-point triplets (Table II)
is a cohort of its own through the fixed-point kernel.

It prints each config's eval loss and eval time per member, names the
winner (the lowest finite loss), and writes a JSON ledger with
``--out``.  Runs on the card unless ``--device`` names another device.
"""
from __future__ import annotations

import argparse
import json
import time


def _ints(s):
    return tuple(int(v) for v in s.split(",") if v)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--bits", default="8,6,4", help="int8-container code "
                    "widths to sweep (comma-separated, 2..8)")
    ap.add_argument("--granularities", default="block,unit")
    ap.add_argument("--fxp", action="store_true",
                    help="also sweep the paper's fixed-point triplets")
    ap.add_argument("--calibrate", action="store_true",
                    help="static per-unit activation scales from a "
                         "calibration batch (default: dynamic per-row)")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--lr", type=float, default=0.5)
    ap.add_argument("--density", type=float, default=0.25)
    ap.add_argument("--hidden", type=int, default=512)
    ap.add_argument("--block", type=int, default=128)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--samples", type=int, default=2048)
    ap.add_argument("--eval-samples", type=int, default=512)
    ap.add_argument("--calib-samples", type=int, default=256)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tag", default="quant")
    ap.add_argument("--out", default=None, help="JSON ledger path")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.core import quantize as qz
    from repro_torch.core import sparse_linear as sl
    from repro_torch.core.fixed_point import PAPER_TRIPLETS
    from repro_torch.data.mnist import paper_dataset
    from repro_torch.device import resolve_device
    from repro_torch.search.cohorts import bucket_quant
    from repro_torch.search.population import (
        CandidateSpec, hyp_table, init_population, init_slots,
        make_population_eval, make_population_step, member_slice)

    dev = resolve_device(args.device)
    act = "sigmoid"
    out_w = -(-32 // args.block) * args.block
    layers = (1024, args.hidden, out_w)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # ---------------------------------------------- 1. brief fp training
    spec = CandidateSpec(lr=args.lr, momentum=0.9, density=args.density,
                         layers=layers, block=args.block, act=act,
                         seed=args.seed)
    pop = init_population(args.seed, [spec], dev)
    slots = init_slots(pop, [spec])
    hyp = hyp_table([spec], dev)
    mask = torch.ones((1,), dtype=torch.float32, device=dev)
    n = args.samples + args.eval_samples + args.calib_samples
    x, t, _ = paper_dataset(n=n, seed=args.seed)
    if t.shape[1] < out_w:   # zero-pad the one-hot to the output width
        t = np.concatenate(
            [t, np.zeros((t.shape[0], out_w - t.shape[1]), t.dtype)], axis=1)
    x, t = torch.from_numpy(x).to(dev), torch.from_numpy(t).to(dev)
    s0, s1 = args.samples, args.samples + args.eval_samples
    xtr, ttr = x[:s0], t[:s0]
    xev, tev = x[s0:s1], t[s0:s1]
    xcal = x[s1:]
    step = make_population_step(act, fused=True)
    rng = np.random.default_rng(args.seed)
    print(f"[quant-sweep] fp pre-train: {args.steps} steps, "
          f"layers={layers}, device={dev}, update path: fused")
    for _ in range(args.steps):
        sel = torch.from_numpy(rng.integers(0, args.samples,
                                            size=args.batch)).to(dev)
        pop, slots, _ = step(pop, slots, hyp, mask, xtr[sel], ttr[sel])
    fp_layers = member_slice(pop, 0)

    evaluate = make_population_eval(act)
    fp_loss = float(evaluate(pop, xev, tev)[0])
    print(f"[quant-sweep] fp32 eval loss {fp_loss:.5f}")

    # ---------------------------------------------------- 2. calibration
    x_scales = (qz.calibrate_layer_scales(fp_layers, xcal, act=act)
                if args.calibrate else None)
    if x_scales is not None:
        print(f"[quant-sweep] calibrated x scales: "
              f"{[round(s, 5) for s in x_scales]}")

    # ------------------------------------------------ 3. the config grid
    configs = [qz.QuantConfig(mode="int8", bits=b, granularity=g)
               for b in _ints(args.bits)
               for g in args.granularities.split(",")]
    if args.fxp:
        configs += [qz.QuantConfig(mode="fxp", fmt=f, act=act)
                    for f in PAPER_TRIPLETS]
    cohorts = bucket_quant(configs)
    print(f"[quant-sweep] {len(configs)} configs in {len(cohorts)} "
          f"cohort(s); datapath: quantized junction kernels "
          f"({'static' if args.calibrate else 'dynamic'} activation "
          f"scales)")

    def quantize_member(q):
        return [qz.quantize_junction(
                    layer, q, x_scale=(x_scales[li] if q.mode == "int8"
                                       and x_scales is not None else None))
                for li, layer in enumerate(fp_layers)]

    def stack_members(members):
        """E per-config quantized layer lists -> one stacked population
        (codes, scales and bias a member; patterns and the fxp format
        shared)."""
        popq = []
        for li in range(len(members[0])):
            base = members[0][li]
            layer = {k: base[k] for k in sl.PATTERN_LEAVES}
            for k in ("qfmt", "qlut"):
                if k in base:
                    layer[k] = base[k]
            for k in ("wq", "w_scale", "b", "x_scale"):
                if k in base:
                    layer[k] = torch.stack([m[li][k] for m in members])
            popq.append(layer)
        return popq

    # ------------------------------------- 4. E-at-once eval per cohort
    records = []
    for co in cohorts:
        popq = stack_members([quantize_member(q) for q in co.configs])
        losses = evaluate(popq, xev, tev)
        sync()
        t0 = time.perf_counter()
        for _ in range(3):
            evaluate(popq, xev, tev)
        sync()
        us = (time.perf_counter() - t0) / 3 * 1e6 / co.size
        for slot, (q, cid) in enumerate(zip(co.configs, co.member_ids)):
            loss = float(losses[slot])
            records.append({"id": cid, "config": q.to_dict(),
                            "cohort": list(map(str, co.key)),
                            "eval_loss": loss,
                            "us_per_member_eval": us,
                            "delta_vs_fp32": loss - fp_loss})
            print(f"[quant-sweep] {q.to_dict()} loss={loss:.5f} "
                  f"({loss - fp_loss:+.5f} vs fp) {us:.0f}us/member")

    finite = [r for r in records if np.isfinite(r["eval_loss"])]
    winner = min(finite, key=lambda r: r["eval_loss"]) if finite else None
    if winner is not None:
        print(f"[quant-sweep] winner: {winner['config']} "
              f"loss={winner['eval_loss']:.5f}")
    else:
        print("[quant-sweep] winner: none (no finite member)")

    ledger = {"tag": args.tag, "device": str(dev), "layers": list(layers),
              "fp32_eval_loss": fp_loss, "calibrated": args.calibrate,
              "records": records, "winner": winner}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(ledger, f, indent=1)
        print(f"[quant-sweep] ledger -> {args.out}")
    return ledger


if __name__ == "__main__":
    main()
