"""Serving launcher of the PyTorch port.

Static batch (one prefill, lockstep decode):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-3b \
        --sparse --requests 8 --prompt-len 32 --max-new 16

Continuous batching (paged KV cache, admission loop, chunked prefill):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-3b \
        --sparse --continuous --slots 4 --page-size 16 --prefill-chunk 32 \
        --requests 8 --prompt-len 64 --max-new 16 --arrival-every 1

runs on the card; ``--device cpu --reduce`` runs a tiny config on the
CPU.  The ssm and hybrid families (``--arch falcon-mamba-7b``,
``--arch zamba2-2.7b``), the vlm with its sliding window (``--arch
llava-next-mistral-7b``: random patch embeddings, min(num_patches,
prompt_len // 2) a request, ahead of the prompt), MLA with a dense
first layer (``--arch deepseek-v2-lite-16b``) and the audio family
(``--arch whisper-base``: random fp32 frame embeddings, enc_frames a
request, drawn after the prompts; they feed the encoder, and decode
positions count from the prompt) serve on the static engine only: their
caches hold per-layer states, a ring, a latent or the encoder's cross
K / V that a paged pool does not, and ``--continuous`` refuses them.  Weights are random, made from ``--seed``, unless
``--ckpt DIR`` restores the params of the newest checkpoint that
``launch/train.py`` wrote there (``train/checkpoint.restore_latest``;
the same ``--arch``, ``--reduce``, ``--layers``, ``--sparse`` and
``--density`` as the training run, or the restore raises).
``--quantize int8`` serves the sparse FFN junctions from int8 codes
(quantized at load).  ``--obs
PATH`` streams the continuous engine's per-request spans, TTFT and
inter-token histograms and occupancy gauges to a JSONL file that
``repro_torch.launch.obs_report`` renders; ``--profile DIR`` writes a
``torch.profiler`` Chrome trace of the run into DIR.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-3b")
    ap.add_argument("--reduce", action="store_true")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: the "
                         "config's), as launch/train.py --layers")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and of sampling")
    ap.add_argument("--ckpt", default=None,
                    help="restore params from a training checkpoint dir")
    ap.add_argument("--sparse", action="store_true",
                    help="apply the paper's pre-defined FFN sparsity")
    ap.add_argument("--density", type=float, default=0.25)
    ap.add_argument("--quantize", default=None, choices=["int8"],
                    help="quantize sparse junction weights at load "
                         "(int8 codes + per-block scales)")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous-batching engine over the paged KV "
                         "cache (admission loop + chunked prefill)")
    ap.add_argument("--slots", type=int, default=4,
                    help="[continuous] decode batch width")
    ap.add_argument("--page-size", type=int, default=16,
                    help="[continuous] tokens per KV page")
    ap.add_argument("--num-pages", type=int, default=0,
                    help="[continuous] KV pool budget (0: full residency)")
    ap.add_argument("--prefill-chunk", type=int, default=32,
                    help="[continuous] prefill chunk width")
    ap.add_argument("--arrival-every", type=int, default=0,
                    help="[continuous] synthetic trace: one request every "
                         "N scheduler ticks (0: all arrive at tick 0)")
    ap.add_argument("--obs", default=None, metavar="PATH",
                    help="flight-recorder JSONL sink: per-request spans + "
                         "TTFT/ITL histograms + occupancy gauges "
                         "(continuous engine); render with "
                         "repro_torch.launch.obs_report")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler Chrome trace of the run "
                         "into DIR")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    import dataclasses
    import time

    import numpy as np
    import torch

    from repro_torch.configs import registry
    from repro_torch.core.sparsity import SparsityConfig
    from repro_torch.device import resolve_device
    from repro_torch.models import model as M
    from repro_torch.obs import Recorder, percentile, profile_ctx
    from repro_torch.serve.engine import (ContinuousEngine, Engine, Request,
                                          ServeConfig)
    from repro_torch.train import checkpoint as ckpt_mod

    dev = resolve_device(args.device)
    cfg = registry.get(args.arch)
    if args.reduce:
        cfg = cfg.reduced()
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    if args.sparse:
        block = 32 if args.reduce else 128
        cfg = cfg.with_sparsity(SparsityConfig(
            density=args.density, block=block, where="ffn"))
    if args.continuous:
        ok, reason = M.paged_supported(cfg)
        if not ok:
            raise SystemExit(f"[serve] --continuous unsupported: {reason}")
    params = M.init(cfg, args.seed, dev)
    if args.ckpt:
        step, tree, _ = ckpt_mod.restore_latest(args.ckpt,
                                                {"params": params})
        if tree is not None:
            params = tree["params"]
            print(f"[serve] restored params from step {step}")
    quant = args.quantize if (args.quantize and cfg.sparsity) else None
    why = ("int8 junction kernels (per-block scales)" if quant
           else "no sparse junctions to quantize" if args.quantize
           else "full precision")
    print(f"[serve] quantize={args.quantize or 'off'} datapath: {why}")

    rng = np.random.default_rng(0)
    V = cfg.raw_vocab or cfg.vocab
    prompts = rng.integers(0, V, size=(args.requests, args.prompt_len)
                           ).astype(np.int32)
    extra = {}
    if cfg.family == "vlm":
        extra["patches"] = rng.standard_normal(
            (args.requests, min(cfg.num_patches, args.prompt_len // 2),
             cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        extra["frames"] = rng.standard_normal(
            (args.requests, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    if args.continuous and extra:
        raise SystemExit("[serve] --continuous does not take encoder "
                         "side inputs (vlm/audio)")
    if not args.continuous:
        eng = Engine(cfg, params, ServeConfig(
            max_new_tokens=args.max_new, temperature=args.temperature,
            seed=args.seed, quantize=quant), device=dev)
        t0 = time.perf_counter()
        with profile_ctx(args.profile):
            out = eng.generate(prompts, extra)
        dt = time.perf_counter() - t0
        tps = args.requests * args.max_new / dt
        print(f"[serve] generated {out.shape} in {dt:.2f}s "
              f"({tps:.1f} tok/s)")
        print("[serve] first sequence:", out[0][:16].tolist())
        return out

    scfg = ServeConfig(
        max_new_tokens=args.max_new, temperature=args.temperature,
        seed=args.seed, slots=args.slots, page_size=args.page_size,
        num_pages=args.num_pages, prefill_chunk=args.prefill_chunk,
        max_seq=min(cfg.max_seq, args.prompt_len + args.max_new),
        quantize=quant)
    reqs = [Request(rid=i, prompt=prompts[i], max_new_tokens=args.max_new,
                    arrival=i * args.arrival_every)
            for i in range(args.requests)]
    recorder = (Recorder(args.obs, meta={"launcher": "serve",
                                         "arch": args.arch,
                                         "device": str(dev)})
                if args.obs else None)
    eng = ContinuousEngine(cfg, params, scfg, device=dev, recorder=recorder)
    t0 = time.perf_counter()
    try:
        with profile_ctx(args.profile):
            outs = eng.serve(reqs)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
    finally:
        if recorder is not None:
            recorder.close()
            print(f"[serve] telemetry -> {args.obs} "
                  f"({recorder.n_events} events)")
    dt = time.perf_counter() - t0
    st = eng.stats
    n_tok = sum(len(v) for v in outs.values())
    waits = [v["wall_s"] for v in st["latency"].values()]
    print(f"[serve] continuous on {dev}: {len(outs)}/{args.requests} "
          f"requests, {n_tok} tokens in {dt:.2f}s ({n_tok / dt:.1f} tok/s)")
    print(f"[serve] decode_ticks={st['decode_ticks']} "
          f"prefill_chunks={st['prefill_chunks']} "
          f"peak_pages={st['peak_pages']}/{st['num_pages']} "
          f"launches={st['launches']} "
          f"p50_lat={percentile(waits, 50) * 1e3:.1f}ms "
          f"p99_lat={percentile(waits, 99) * 1e3:.1f}ms")
    print("[serve] first sequence:", outs[0][:16].tolist())
    return outs


if __name__ == "__main__":
    main()
