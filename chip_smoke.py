#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and check it.

    python3 chip_smoke.py

from the root of a checkout, on a machine with a CUDA card, nvcc and
PyTorch built for CUDA.  It

1. prints the card's name and power limit (nvidia-smi);
2. builds the CUDA kernels from ``src/repro_torch/csrc`` (one nvcc per
   source, all started together) and prints the build time;
3. holds each kernel against its plain PyTorch version on the card at
   the serving path's shapes, with the tolerances stated below, and times
   kernel, plain version, the least time the card could take (bound) and,
   where one PyTorch call computes the same function, that call;
4. serves 8 greedy requests through ``ContinuousEngine`` on full-width
   sparse-FFN stablelm-3b (random weights from a seed), checks that every
   request completes, that the kernels' launch counts are exactly what
   the path implies, and that one prefill chunk and one decode tick give
   the same logits through the kernels as through the plain versions;
5. prints a ``kernels`` JSON line and, last, a JSON line with
   ``"ok": true`` and the device.

Any failed check raises and the exit code is not 0.  Without a card, or
without the port's sources beside it, it exits 1 and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12                      # H100 SXM data sheet
PEAK_OPS_PER_S = {torch.bfloat16: 989e12,      # dense tensor-core bf16
                  torch.float32: 67e12}        # fp32 outside the tensor cores
# kernel vs plain version: in fp32 the same sums (up to 1792 products)
# in another order; in bf16 both sides round fp32 values that differ only
# in summation order, so an output may move by one bf16 ulp
TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
       torch.bfloat16: dict(atol=1e-5, rtol=2.0 ** -7)}
# whole-model logits, kernels vs plain versions, relative to max |logit|:
# fp32 differs in summation order only; in bf16 one-ulp flips in the
# junction outputs propagate through 32 layers
LOGIT_REL_TOL = {torch.float32: 1e-3, torch.bfloat16: 0.1}


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Median CUDA-event time of one call, over ``reps`` calls, with the
    L2 cache flushed before each (the serving path meets these operands
    cold: a decode tick streams 6 GB of weights between two uses).  The
    card first spins for longer than the host needs to queue every call,
    so the events time the device work and not the host's enqueueing."""

    def __init__(self, reps: int = 25):
        self.reps = reps
        self.flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")

    def ms(self, fn) -> float:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            self.flush.zero_()
            fn()
        host_s = (time.perf_counter() - t0) / 3
        torch.cuda.synchronize()
        torch.cuda._sleep(int(2 * self.reps * host_s * 2e9) + 2_000_000)
        times = []
        for _ in range(self.reps):
            self.flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            times.append((a, b))
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in times)


def bound_ms(nbytes: float, nops: float, dtype) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def close(got, want, tol) -> bool:
    return bool(torch.allclose(got.float(), want.float(), **tol))


# ------------------------------------------------------------ junction_fwd
def junction_phase(P, timer, card):
    dev = "cuda"
    shapes = [("wg", 2560, 6912, "silu", 2), ("wi", 2560, 6912, "none", 0),
              ("wo", 6912, 2560, "none", 1)]
    cases = [(dt, s, M, s[3], False) for dt in (torch.bfloat16, torch.float32)
             for s in shapes for M in (4, 32)]
    cases += [(torch.bfloat16, shapes[0], 32, act, True)
              for act in P.bsm.ACTIVATIONS]
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    worst, decode = 0.0, {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "ops": 0}
    for dtype, (name, n_in, n_out, _, pseed), M, act, with_bias in cases:
        pat = P.make_block_pattern(n_in, n_out, 0.25, 128, seed=pseed)
        nob, kb, bs = pat.n_out_blocks, pat.fan_in_blocks, pat.block
        x = torch.randn((1, M, n_in), generator=gen, device=dev).to(dtype)
        w = (torch.randn((1, nob, kb, bs, bs), generator=gen, device=dev)
             / (kb * bs) ** 0.5).to(dtype)
        idx = torch.as_tensor(pat.idx, device=dev)
        b = (torch.randn((1, n_out), generator=gen, device=dev) if with_bias
             else torch.zeros((1, n_out), device=dev)).to(dtype)
        got = P.bsm.fwd(x, w, idx, b, act)
        want = P.bsm.fwd_ref(x, w, idx, b, act)
        torch.cuda.synchronize()
        err = max_err(got, want)
        ok = close(got, want, TOL[dtype])
        worst = max(worst, err)
        k_ms = timer.ms(lambda: P.bsm.fwd(x, w, idx, b, act))
        p_ms = timer.ms(lambda: P.bsm.fwd_ref(x, w, idx, b, act))
        isz = x.element_size()
        nbytes = (x.numel() + w.numel() + b.numel() + M * n_out) * isz \
            + idx.numel() * 4
        nops = 2 * M * nob * kb * bs * bs
        bnd, by = bound_ms(nbytes, nops, dtype)
        print(f"[kernel] junction_fwd {name} {n_in}->{n_out} kb={kb} M={M} "
              f"{str(dtype)[6:]} act={act} bias={with_bias}: "
              f"max_abs_err={err:.3g} (tol {TOL[dtype]}) "
              f"ms={k_ms:.4f} plain_ms={p_ms:.4f} bound_ms={bnd:.4f} "
              f"({by}) [{card}]")
        require(ok, f"junction_fwd disagrees with fwd_ref: {name} M={M} "
                    f"{dtype} act={act} err={err}")
        if dtype == torch.bfloat16 and M == 4 and not with_bias:
            decode["ms"] += k_ms
            decode["plain_ms"] += p_ms
            decode["bytes"] += nbytes
            decode["ops"] += nops
    bnd, by = bound_ms(decode["bytes"], decode["ops"], torch.bfloat16)
    print(f"[kernel] junction_fwd one layer's FFN at decode (wg+wi+wo, M=4, "
          f"bf16): ms={decode['ms']:.4f} plain_ms={decode['plain_ms']:.4f} "
          f"bound_ms={bnd:.4f} ({by}) [{card}]")
    return {"max_abs_err": worst, "ms": decode["ms"],
            "plain_ms": decode["plain_ms"], "bound_ms": bnd, "bound_by": by,
            "library_ms": None}


def weight_cast_phase(params, timer, card):
    """The per-call fp32 -> bf16 cast of the FFN junction weights, as
    ops.junction_matmul does it, for one layer and per decode tick."""
    mlp = params["layers"][0]["mlp"]
    ws = [mlp[k]["w"] for k in ("wg", "wi", "wo")]
    ms = timer.ms(lambda: [w.to(torch.bfloat16) for w in ws])
    n = len(params["layers"])
    print(f"[cast] fp32->bf16 FFN weight cast: {ms:.4f} ms per layer, "
          f"{ms * n:.3f} ms per tick ({n} layers) [{card}]")


# ------------------------------------------------------------ flash_decode
def decode_phase(P, timer, card):
    dev = "cuda"
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    lens = [0, 1, 17, 128]
    B, D, ps, maxp = 4, 80, 16, 8
    worst, main = 0.0, None
    for dtype, Hkv, rep in ((torch.bfloat16, 32, 1), (torch.float32, 32, 1),
                            (torch.bfloat16, 8, 4)):
        n_pages = 1 + B * maxp
        q, kp, vp = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                     for shape in ((B, Hkv, rep, D), (n_pages, ps, Hkv, D),
                                   (n_pages, ps, Hkv, D)))
        perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
        pt = torch.zeros((B, maxp), dtype=torch.int32, device=dev)
        for b, n in enumerate(lens):
            used = -(-n // ps)
            pt[b, :used] = perm[b * maxp:b * maxp + used].to(torch.int32)
        sl = torch.tensor(lens, dtype=torch.int32, device=dev)
        got = P.fa.flash_decode(q, kp, vp, pt, sl)
        want = P.fa.paged_decode_ref(q, kp, vp, pt, sl)
        torch.cuda.synchronize()
        err = max_err(got, want)
        worst = max(worst, err)
        zeros = bool((got[0] == 0).all())
        ok = close(got, want, TOL[dtype])
        k_ms = timer.ms(lambda: P.fa.flash_decode(q, kp, vp, pt, sl))
        p_ms = timer.ms(lambda: P.fa.paged_decode_ref(q, kp, vp, pt, sl))
        # yardstick: one SDPA call over the pages gathered beforehand
        K = maxp * ps
        kg = kp[pt.long()].reshape(B, K, Hkv, D).transpose(1, 2)
        vg = vp[pt.long()].reshape(B, K, Hkv, D).transpose(1, 2)
        kg = kg.repeat_interleave(rep, 1).contiguous()
        vg = vg.repeat_interleave(rep, 1).contiguous()
        qs = q.reshape(B, Hkv * rep, 1, D)
        mask = (torch.arange(K, device=dev)[None, :] < sl[:, None]
                )[:, None, None, :]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib_ms = timer.ms(lambda: sdpa(qs, kg, vg, attn_mask=mask))
        isz = q.element_size()
        tokens = sum(lens)
        nbytes = (2 * q.numel() + 2 * tokens * Hkv * D) * isz \
            + (pt.numel() + sl.numel()) * 4
        nops = 4 * D * tokens * Hkv * rep
        bnd, by = bound_ms(nbytes, nops, dtype)
        print(f"[kernel] flash_decode B={B} Hkv={Hkv} rep={rep} D={D} ps={ps} "
              f"maxp={maxp} lens={lens} {str(dtype)[6:]}: "
              f"max_abs_err={err:.3g} (tol {TOL[dtype]}) "
              f"zero_slot_exact={zeros} ms={k_ms:.4f} plain_ms={p_ms:.4f} "
              f"bound_ms={bnd:.5f} ({by}) library_ms={lib_ms:.4f} [{card}]")
        require(ok, f"flash_decode disagrees: {dtype} rep={rep} err={err}")
        require(zeros, "flash_decode: the zero-length slot is not exact zeros")
        if main is None:
            main = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bnd,
                    "bound_by": by, "library_ms": lib_ms}
    return {"max_abs_err": worst, **main}


# ------------------------------------------------------------ serve phase
def serve_phase(P, card):
    M, engine, ops = P.M, P.engine, P.ops
    dev = torch.device("cuda")
    cfg = P.registry.get("stablelm-3b").with_sparsity(
        P.SparsityConfig(density=0.25, block=128, where="ffn"))
    t0 = time.perf_counter()
    params = M.init(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params) if t.is_floating_point())
    print(f"[serve] {cfg.name} d_model={cfg.d_model} d_ff={cfg.d_ff} "
          f"layers={cfg.n_layers} heads={cfg.n_heads} vocab={cfg.vocab}, "
          f"sparse FFN {cfg.sparsity}: {n_params / 1e9:.3f} B params, "
          f"init {time.perf_counter() - t0:.1f} s")
    scfg = engine.ServeConfig(max_new_tokens=16, slots=4, page_size=16,
                              prefill_chunk=32, max_seq=128)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, size=(8, 64)).astype(np.int32)
    eng = engine.ContinuousEngine(cfg, params, scfg, device=dev)
    eng.serve([engine.Request(0, prompts[0][:8], 2)])          # warm-up
    reqs = [engine.Request(i, prompts[i], 16, arrival=i) for i in range(8)]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    outs = eng.serve(reqs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = ops.launch_counts()

    st = eng.stats
    n_tok = sum(len(v) for v in outs.values())
    lat = [v["wall_s"] for v in st["latency"].values()]
    p50, p99 = P.percentile(lat, 50), P.percentile(lat, 99)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[serve] {len(outs)}/8 requests, {n_tok} tokens in {dt:.3f} s: "
          f"{n_tok / dt:.1f} tok/s, decode_ticks={st['decode_ticks']} "
          f"prefill_chunks={st['prefill_chunks']} p50_latency={p50 * 1e3:.1f} ms "
          f"p99_latency={p99 * 1e3:.1f} ms peak_memory={peak:.2f} GiB "
          f"launches={counts} [{card}]")
    require(sorted(outs) == list(range(8)), f"requests missing: {sorted(outs)}")
    require(all(len(v) == 16 for v in outs.values()),
            f"token counts {[len(v) for v in outs.values()]}")
    require(eng.nonfinite_terminated == 0,
            f"{eng.nonfinite_terminated} slots hit non-finite logits")
    L = cfg.n_layers               # three FFN junctions and one attention a layer
    want_j = 3 * L * (st["decode_ticks"] + st["prefill_chunks"])
    want_d = L * st["decode_ticks"]
    require(counts["junction_fwd"] == want_j,
            f"junction_fwd launches {counts['junction_fwd']} != {want_j}")
    require(counts["flash_decode"] == want_d,
            f"flash_decode launches {counts['flash_decode']} != {want_d}")
    require(st["launches"] == counts, "engine stats disagree with counters")

    for dtype in (torch.bfloat16, torch.float32):
        compare_logits(P, cfg, params, prompts[0], dtype, card)
    tick_breakdown(M, cfg, params, card)
    return params, counts


def tick_breakdown(M, cfg, params, card):
    """One decode tick with 4 live slots of 80 cached tokens: its wall
    time and, from the profiler, the device time of its kernels by name
    (the share of the wall time the card is busy)."""
    dev = torch.device("cuda")
    B, maxp = 4, 8
    pool = M.make_paged_cache(cfg, 1 + B * maxp, 16, dev)
    pt = torch.arange(1, 1 + B * maxp, dtype=torch.int32,
                      device=dev).reshape(B, maxp)
    tok = torch.arange(1, 1 + B, dtype=torch.int32, device=dev)[:, None]
    pos = torch.full((B,), 80, dtype=torch.int32, device=dev)

    def step():
        return M.paged_decode_step(cfg, params, pool, tok, pos, pt)

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        step()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / 5 * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    print(f"[tick] decode tick, 4 live slots: wall {wall_ms:.2f} ms, kernels "
          f"{dev_ms:.2f} ms in {launches} launches, device busy "
          f"{dev_ms / wall_ms:.1%} of wall [{card}]")
    for e in kernels[:10]:
        print(f"[tick]   {e.self_device_time_total / 1e3:8.3f} ms "
              f"{e.count:5d}x  {e.key[:90]}")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _chunk_and_tick(M, cfg, params, prompt):
    dev = torch.device("cuda")
    maxp = 8
    pool = M.make_paged_cache(cfg, 1 + maxp, 16, dev)
    row = torch.arange(1, 1 + maxp, dtype=torch.int32, device=dev)
    tokens = torch.as_tensor(prompt[None, :32], device=dev)
    lp, pool = M.paged_prefill_chunk(cfg, params, pool, tokens, 0, row, 32)
    tok = torch.zeros((4, 1), dtype=torch.int32, device=dev)
    tok[0, 0] = int(prompt[32])     # the same input token on both paths
    positions = torch.tensor([32, 0, 0, 0], dtype=torch.int32, device=dev)
    pt = torch.zeros((4, maxp), dtype=torch.int32, device=dev)
    pt[0] = row
    ld, _ = M.paged_decode_step(cfg, params, pool, tok, positions, pt)
    return lp[0, -1].float(), ld[0, -1].float()


def compare_logits(P, cfg, params, prompt, dtype, card):
    """The first prefill chunk and one decode tick (slot 0 live, three
    free slots on the scratch page), once through the kernels and once
    through the plain versions, on the card."""
    M, ops, bsm, fa = P.M, P.ops, P.bsm, P.fa
    cfg = dataclasses.replace(cfg, dtype=str(dtype)[6:])
    ops.reset_launch_counts()
    k_pf, k_dec = _chunk_and_tick(M, cfg, params, prompt)
    kernel_counts = ops.launch_counts()
    with mock.patch.object(bsm, "fwd", bsm.fwd_ref), \
            mock.patch.object(fa, "flash_decode", fa.paged_decode_ref):
        p_pf, p_dec = _chunk_and_tick(M, cfg, params, prompt)
    torch.cuda.synchronize()
    L = cfg.n_layers
    require(kernel_counts == {"junction_fwd": 6 * L, "flash_decode": L}
            and ops.launch_counts() == kernel_counts,
            f"logit comparison did not take the intended paths: "
            f"{kernel_counts} then {ops.launch_counts()}")
    for what, a, b in (("prefill", k_pf, p_pf), ("decode", k_dec, p_dec)):
        require(bool(torch.isfinite(a).all() and torch.isfinite(b).all()),
                f"{what} logits not finite")
        rel = max_err(a, b) / float(b.abs().max())
        same = int(torch.argmax(a)) == int(torch.argmax(b))
        print(f"[logits] {what} {str(dtype)[6:]} kernels vs plain versions: "
              f"max_abs_err={max_err(a, b):.4g} max|logit|="
              f"{float(b.abs().max()):.4g} rel={rel:.3g} "
              f"(tol {LOGIT_REL_TOL[dtype]}) same_argmax={same} [{card}]")
        require(rel <= LOGIT_REL_TOL[dtype], f"{what} {dtype} logits differ")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not under {ROOT / 'src'}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False   # full fp32 references
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import registry
    from repro_torch.core.sparsity import SparsityConfig, make_block_pattern
    from repro_torch.kernels import block_sparse_matmul as bsm
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import percentile
    from repro_torch.models import model as M
    from repro_torch.serve import engine
    P = types.SimpleNamespace(
        registry=registry, SparsityConfig=SparsityConfig,
        make_block_pattern=make_block_pattern, bsm=bsm, fa=fa, ops=ops,
        M=M, engine=engine, percentile=percentile)

    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    secs = build.build_all()
    print(f"[build] {', '.join(f'{k} {v:.1f} s' for k, v in secs.items())}; "
          f"wall {time.perf_counter() - t0:.1f} s")
    for name in build.SOURCES:
        log = build.lib_path(name).with_suffix(".log")
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas] {name}: {line.strip()}")

    timer = Timer()
    junction = junction_phase(P, timer, card)
    decode = decode_phase(P, timer, card)
    params, counts = serve_phase(P, card)
    weight_cast_phase(params, timer, card)

    kernels = [
        {"name": "junction_fwd", "route": "cuda",
         "source": "src/repro_torch/csrc/junction_fwd.cu",
         "replaces": "src/repro/kernels/block_sparse_matmul.py:381",
         "launches": counts["junction_fwd"], **junction},
        {"name": "flash_decode", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_decode.cu",
         "replaces": "src/repro/kernels/flash_attention.py:206",
         "launches": counts["flash_decode"], **decode},
    ]
    print(card)                          # nvidia-smi's name, power.limit
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
