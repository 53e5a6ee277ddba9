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
   where one PyTorch call computes the same function, that call
   (flash_decode at stablelm-3b's heads and at qwen3-moe's, at the
   serving lengths and over a 4k-token cache); fwd, dx, dw, update_dw,
   gated_fwd and update_gated_dw have two entry points, SIMT and bf16
   tensor cores (``bsm.junction_variant`` routes), and both are held and
   timed wherever the route takes the tensor cores, and the route's
   crossover is timed from 1 row to 2048 (fwd), 1 to 160 (gated_fwd),
   at the training rows (dw, update_dw) and at 4 and 160 rows
   (update_gated_dw);
4. serves 8 greedy requests through ``ContinuousEngine`` on full-width
   sparse-FFN stablelm-3b (random weights from a seed), checks that every
   request completes, that the kernels' launch counts (and those of the
   tensor-core entry points) are exactly what the path implies, and that
   one prefill chunk and one decode tick give
   the same logits through the kernels as through the plain versions;
   a flight recorder (``repro_torch.obs.Recorder``, its sink under
   ``build/obs/``) rides that run under the same exact launch counts, and
   each request leaves one ``serve.span`` that ``obs_report.check_span``
   passes;
5. shows that the recorder adds no sync and no launch on the card: the
   synchronizing CUDA calls in a ``torch.profiler`` trace (stream and
   device synchronizations, device-to-host copies) and the launch counts
   of one prefill chunk and one decode tick on stablelm-3b, and of a
   3-step ``train_loop.run`` of stablelm-3b at full width and 1 layer
   (its exit checkpoint included), are equal without and with a
   recorder, and the train run leaves one ``train.step`` event a step;
6. holds the training kernels (fwd with its saved residual, dx, dw and
   the fused update_dw) against their plain versions at the training
   path's shapes (M = 2048), times them, and checks every activation,
   bias, E = 2, SGD / momentum / Adam, the health counts of poisoned
   tiles and the bit-for-bit freeze of a zero hyp row; the tensor-core
   fwd, dx and dw also at a ragged M, with and without bias (and
   save_pre), and at blocks 32 and 64, gated_fwd, update_dw and
   update_gated_dw (every optimizer, health, freeze) at a ragged M and
   blocks 32, 64 and 128, through both entry points; and the tensor-core
   dw equal bit for bit to the gradient the tensor-core update_dw steps;
7. trains the same model at full width: 3 two-pass Adam steps, 3 fused
   Adam steps and 3 fused SGD steps (batch 8 x 256), with finite losses,
   no non-finite update, exact launch counts (no dw launch on the
   unclipped fused path; every fwd, dx, dw and update_dw on the tensor
   cores), and one
   step at 2 layers through the kernels and through the plain versions
   within stated tolerances;
8. holds the gated kernels (gated_fwd, gated_dx, gated_dw and the fused
   update_gated_dw) against their plain versions at qwen3-moe's expert
   gate junction (128 experts, 2048 -> 768) and the plain kernels at its
   down junction, at the decode rows (M = 4) and the training rows
   (M = 160), bf16 and fp32, timed; SGD / momentum / Adam, tiles poisoned
   in one branch or both (each counted once) and the zero-hyp freeze;
9. serves the same 8 requests on full-size sparse qwen3-moe-30b-a3b (48
   layers, 128 experts, 9.6 B parameters) and trains it at full width
   and 6 layers as in 4. and 7. (every gated_fwd and update_gated_dw on
   the tensor cores);
10. holds the quantized kernels (fwd_int8, gated_fwd_int8, fwd_fxp)
   against their plain versions (bit for bit where the arithmetic allows)
   at stablelm-3b's FFN junctions, qwen3-moe's expert junctions and the
   PTQ sweep's MLP junctions (every paper triplet, and an int32 sum that
   wraps), timed; fwd_fxp also with weight codes beyond 16 bits, at a
   ragged M, with bf16 x and at blocks 32 and 64, and beside each time
   both of its bounds (``fxp_bounds``); the int8 kernels also under the
   other split of their
   slots than the plan's, at E 3 with blocks 32, 64 and 128 and rows 1,
   16 and 33 (both paths, split and unsplit), and twice back to back with
   equal bits (the split's tickets reset); serves both models again with
   ``quantize="int8"`` (on
   the same weights: exact int8 launch counts, no floating-point junction
   launch, logits kernels vs plain versions, greedy agreement with the fp
   run); and runs ``launch.quant_sweep --fxp`` dynamic and calibrated to
   a finite winner with exact launch counts;
11. drives the four standalone kernels through the reference's own
   entry points (``ops.fxp_qmatmul``, ``ops.sigmoid_lut``,
   ``selective_scan``, ``mha``) at full-width shapes: attention at
   stablelm-3b's, qwen3-moe's and llava-next-mistral-7b's heads (causal,
   sliding window, ragged, rows with no valid key), the scan at
   falcon-mamba-7b's d_inner (the batch-1 sequence split into chunks,
   batch 4 unsplit) and at shapes that reach every plan of
   ``selective_scan.scan_plan`` (a ragged last chunk, two lanes a
   channel with N not a multiple of two, rows staged by plain loads),
   its bound counting its exps (``scan_bounds``), the fixed-point matmul
   at every paper triplet (a wrapping int32 sum), at 4096^3, with codes
   beyond 16 bits,
   with K split over blocks for occupancy (16 x 65536 x 16) and by the
   8192 of K a block sums at most (1024 x 16384 x 1024, its int32
   accumulators at their worst case), the lookup on both
   tables with out-of-range codes; exact launch counts, each kernel
   against its plain version (bit for bit for the integer two), timed;
   beside the drive, attention at a head_dim that is not a multiple of 8;
12. runs the population sweep (``launch.sweep`` at its defaults: the MLP
   1024 -> 512 -> 128, two cohorts of three, 3 rounds of 20 fused fp32
   steps; then an Adam grid): finite winners, ledgers that round-trip,
   exact launch counts from the ledgers' live cohorts (no dw), one
   device-to-host copy a cohort step with and without ``--obs``, the
   time of a cohort step, the update kernels' health flags on a member
   with a NaN weight, the survivors of a quarantined lr=inf member
   bitwise equal to a cohort without it, one fused step against its
   plain version;
13. serves through the static engine (``launch/serve.py`` without
   ``--continuous``, 8 prompts of 32 tokens, 16 new) on full-size
   stablelm-3b and qwen3-moe-30b-a3b, each in bf16 and int8: 16 tokens a
   sequence, no non-finite row, exact launch counts, the prefill and one
   decode step against the plain versions, the bf16 tokens' agreement
   with the continuous engine; at full width and 2 layers in fp32 the
   static tokens equal the continuous engine's; then ``launch/train.py``
   writes a checkpoint of one SGD step of stablelm-3b at full width and
   CKPT_LAYERS layers and ``launch/serve.py --ckpt``
   (static and continuous) serves it: params equal bit for bit, tokens
   equal serving the trained params from memory; qwen3-moe's 8-row bf16
   prefill is traced block by block through the kernels and the plain
   versions (``moe_layer_gaps``: each block's output gap, the tokens whose
   top-k expert set differs, the logits of the plain path routed as the
   kernels routed, and the gap over rows with and without a flip);
14. serves full-size sparse falcon-mamba-7b (Mamba-1, 64 layers) on the
   static engine in bf16 and int8, and trains
   it at full width and 2 layers on the three update paths, with exact
   launch counts and one 2-layer step against the plain versions; serves
   full-size zamba2-2.7b (54 Mamba-2 layers in 9 super-blocks sharing one
   attention block) and trains it two-pass (one 4-layer step, two
   super-blocks, against the plain versions); serves qwen2-72b,
   deepseek-7b and command-r-plus-104b at full width and 2 layers, and
   holds and times ``fwd`` at every junction shape these configs bring
   (kb up to 66, zamba2's 41 output blocks), at 8 rows and 256, against
   the junction in fp64 within the rounding of one bf16 output and the
   probabilistic bound of an fp32 sum (``fwd_held``), beside a control
   that carries its sum in bf16 and must fail it; the two deep
   state-space models hold their bf16 prefill and decode step launch by
   launch and block by block (``ssm_layer_gaps``: every fwd launch
   against fp64 on its own operands at the main path's rows, 256 and 8;
   each block's mixer fed the kernel path's input, its output's gap over
   the block's own contribution within LOGIT_REL_TOL, a control that
   leaves a fan-in slot out beyond it; the decode step's logits from one
   cache within LOGIT_REL_TOL), and print the end-to-end bf16 gap (each
   path on its own prefill) beside the plain bf16 path's own distance
   from fp32, where a one-ulp rounding difference in one block reaches
   every block after it (fp32 and int8 stay held end to end); each
   phase prints its seconds;
15. serves full-size sparse llava-next-mistral-7b (a 4096-token sliding
   window, 16 stub patches ahead of each 32-token prompt) and
   deepseek-v2-lite-16b (MLA, a dense first layer, 64 experts top-6 and
   2 shared) on the static engine in bf16 and int8 with exact launch
   counts and the prefill and one decode step against the plain versions
   (deepseek's bf16 prefill also block by block, ``moe_layer_gaps``);
   drives llava's ring at full width (``ring_check``: 2 layers, 576
   patches and 4160 tokens into the 4096-slot ring, then decode; fp32
   logits against the forward recomputed over the whole sequence, bf16
   kernels against plain versions); trains llava at 8 layers and
   deepseek at 4 (its dense layer and 3 MoE layers) on the three update
   paths; and holds fwd and gated_fwd at every junction shape the two
   bring, 8 and 256 rows a unit (deepseek's experts at E 64), against the
   junction in fp64 (``fwd_held``, ``gated_held``) beside controls that
   must fail;
16. serves full-size sparse whisper-base (6 encoder and 6 decoder
   layers, 1500 stub frames a request feeding the encoder, learned
   decoder positions) on the static engine in bf16 and int8, with exact
   launch counts (the encoder in the prefill alone) and the prefill and
   one decode step against the plain versions; trains it at full size on
   the three update paths, one step at 2 + 2 layers against the plain
   versions; holds fwd at its two junctions (kb 1 with the gelu
   epilogue, kb 4) at 8, 256 and 8 x 1500 rows against the junction in
   fp64 beside controls that must fail; then runs ``launch/train.py
   --compress-grads`` (int8 gradients with error feedback, the two-pass
   step) for 3 Adam steps on stablelm-3b at full width and 2 layers and
   on whisper-base: finite losses and residuals, exact launch counts (no
   update_dw), the compression of one step's gradients on the card equal
   bit for bit to the CPU's, and the reference's property of compression
   (a 2 % restore, a residual that does not grow past 1.5 x);
17. trains the dry run's perf-sparse variant of stablelm-3b
   (FFN density 0.125 at block 128, bf16-resident params, the
   cross-entropy in chunks of 2048) at full width and 2 layers: 3
   two-pass steps of ``adam(master_copy=True)`` through the kernels
   (exact fwd / dx / dw launches, no update_dw) and through the plain
   versions (loss, fp32 masters and m within the bf16 step tolerance,
   params their masters rounded bit for bit), with the roofline of the
   same step counted on ``meta`` tensors (``roofline/analysis.py``:
   dot FLOPs, eager bytes, compute and memory terms) beside its
   measured wall and device time, and its peak memory beside fp32
   params with Adam alone; then runs three full-size cells of the dry
   run (``launch/dryrun.py``: counted on ``meta``, no card memory, no
   launch) and counts that perf step on a 1 x 1 abstract mesh: its
   predicted per-device memory and compute term beside the measured
   peak and step;
18. trains on a device mesh (``launch/mesh.py``, a one-rank NCCL
   group): ``launch/train.py --devices 1 --data 1 --model 1`` (params and
   Adam placed by ``parallel/sharding.param_specs``) for 3 two-pass steps
   of stablelm-3b at full width and 2 layers, and the fused SGD step
   under the same mesh (``make_mesh_train_step``, partitioned, and the
   gathered route) for every family but the hybrid (``MESH_FUSED``: the
   MoE's through the gated kernels), each against the same
   path without a mesh: losses and params bit for bit, exact launches,
   the bytes the rank holds at rest, each path's step time; then the
   partitioned route (``steps.partitioned``) under the same mesh for
   stablelm-3b, qwen3-moe-30b-a3b, deepseek-v2-lite-16b, falcon-mamba-7b
   (2 of its 64 layers), zamba2-2.7b (one super-block: 6 Mamba-2
   layers and the shared block), llava-next-mistral-7b (2 of its 32
   layers) and whisper-base (whole, on the "sp" strategy), sparse, bf16:
   train, prefill and greedy decode steps bit for bit against the plain
   steps, exact fwd / dx / dw
   launches on tensor cores, the step time partitioned / gathered /
   plain, the dry run's predicted peak beside the measured one;
19. runs the paper's junction pipeline at mesh scale
   (``parallel/pipeline.py``) over 4 stages, each a stablelm-3b layer's
   sparse MLP with its pre-norm and residual (bf16 compute, fp32
   weights), 8 microbatches of 256 rows: ``gpipe_forward`` equal to the
   stages in order bit for bit, a ``gpipe_step`` and two asynchronous
   epochs (FF, BP and UP overlapped) timed a tick with the device-busy
   share, the epochs against the same schedule on the plain versions,
   exact fwd / dx / dw launches; and the reference's tanh pipeline
   converging on the card as on the CPU;
20. trains the paper's own network (Table I, 1024 -> 64 -> 32 in (12,3,8)
   fixed point, ``core/paper_net.py``) on ``paper_dataset``, sequential and
   junction-pipelined: over the first 1024 inputs the card and the CPU give
   the same params, corrects and forward outputs bit for bit; one full
   12544-input epoch of each on the card is timed and must reach the
   reference's accuracy contracts (above 0.8 sequential, 0.75 pipelined);
   the FPGA model's block cycle and arithmetic units are printed;
21. prints a ``kernels`` JSON line and, last, a JSON line with
   ``"ok": true`` and the device.

Any failed check raises and the exit code is not 0.  Without a card, or
without the port's sources beside it, it exits 1 and prints no result.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import io
import json
import math
import shutil
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
                  torch.float32: 67e12,        # fp32 outside the tensor cores
                  torch.int8: 1979e12,         # dense tensor-core int8
                  # the data sheet gives no int32 rate: the fp32 rate of
                  # the CUDA cores stands in for their integer units
                  torch.int32: 67e12}
# the special-function units' exp2 (MUFU.EX2, one an expf): 16 results a
# clock an SM on compute capability 9.0 (CUDA C++ Programming Guide,
# arithmetic instruction throughput table), 132 SMs at the 1980 MHz boost
# clock of the H100 SXM: 4.18 T/s
SFU_EXP_PER_S = 16 * 132 * 1.98e9
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


def code_planes(codes) -> int:
    """The byte planes the fixed-point kernels give these int32 codes
    (csrc/fxp_tc.cuh): 1 within 8 bits, 2 within 16, else 4."""
    c = codes.long()
    mag = int((c ^ (c >> 63)).max())
    return 1 if mag < 1 << 7 else (2 if mag < 1 << 15 else 4)


def fxp_bounds(nbytes: float, n_mac: float, planes_a: int,
               planes_b: int) -> dict:
    """The two bounds of a fixed-point product of n_mac multiply-adds:
    int32 at the CUDA cores' stand-in rate (bound_int32_ms: printed beside
    bound_ms, kept out of the kernels JSON line), and split
    into byte planes on the int8 tensor cores (bound_ms: 2 n_mac
    operations a plane pair i + j <= 3 at 1,979 TOP/s; the kernels' own
    route); each against the bytes."""
    pairs = sum(1 for i in range(planes_a) for j in range(planes_b)
                if i + j <= 3)
    tc, tc_by = bound_ms(nbytes, 2 * n_mac * pairs, torch.int8)
    i32, i32_by = bound_ms(nbytes, 2 * n_mac, torch.int32)
    return {"bound_ms": tc, "bound_by": tc_by, "bound_int32_ms": i32,
            "bound_int32_by": i32_by, "plane_pairs": pairs}


def bounds_text(b: dict) -> str:
    return (f"bound_ms={b['bound_ms']:.5f} ({b['bound_by']}; byte planes "
            f"on int8 tensor cores, {b['plane_pairs']} plane pairs) "
            f"bound_int32_ms={b['bound_int32_ms']:.5f} "
            f"({b['bound_int32_by']}; int32 at the 67 T/s stand-in)")


def scan_bounds(nbytes: float, n_el: int) -> dict:
    """The selective scan's bound: the larger of its bytes, its n_el exps
    (one an element) at SFU_EXP_PER_S, and its 7 fp32 operations an
    element (dt * a, decay * h + inp, dt x * B, y += h * C) at the fp32
    rate."""
    parts = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "exps": n_el / SFU_EXP_PER_S * 1e3,
             "fp32": 7 * n_el / PEAK_OPS_PER_S[torch.float32] * 1e3}
    top = max(parts, key=parts.get)
    return {"bound_ms": parts[top],
            "bound_by": "bytes" if top == "bytes" else "operations",
            "text": f"bound_ms={parts[top]:.5f} ({top}; bytes "
                    f"{parts['bytes']:.5f}, exps {parts['exps']:.5f}, fp32 "
                    f"{parts['fp32']:.5f})"}


def max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def close(got, want, tol) -> bool:
    return bool(torch.allclose(got.float(), want.float(), **tol))


def forced(P, variant):
    """The junction wrappers launch ``variant`` ("simt" or "tc") whatever
    their route says (the plain and gated fwd, dx, dw and update): times
    and checks of the entry point the route does not take, on the same
    inputs."""
    return mock.patch.object(P.bsm, "junction_variant",
                             lambda *_: variant)


def forced_call(P, variant, fn):
    """``fn`` with the junction wrappers forced to ``variant``."""
    def call():
        with forced(P, variant):
            return fn()
    return call


def in_turns(timer, *fns):
    """The ms of each of ``fns``, timed in turns on the same inputs, last
    to first and then first to last (for a tensor-core and a SIMT entry
    point: SIMT, tensor cores, tensor cores, SIMT), each the mean of its
    two medians."""
    order = list(range(len(fns)))[::-1]
    ms = [0.0] * len(fns)
    for k in order + order[::-1]:
        ms[k] += timer.ms(fns[k]) / 2
    return ms


def with_tc(P, counts):
    """A path's launch counts with the launches of the tensor-core entry
    points beside them (``junction_*_tc``)."""
    return {**counts, **{f"{k}_tc": v
                         for k, v in P.ops.tc_launch_counts().items()}}


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
    worst = 0.0
    decode = {"ms": 0.0, "simt_ms": 0.0, "plain_ms": 0.0, "bytes": 0,
              "ops": 0}
    for dtype, (name, n_in, n_out, _, pseed), M, act, with_bias in cases:
        pat = P.make_block_pattern(n_in, n_out, 0.25, 128, seed=pseed)
        nob, kb, bs = pat.n_out_blocks, pat.fan_in_blocks, pat.block
        x = torch.randn((1, M, n_in), generator=gen, device=dev).to(dtype)
        w = (torch.randn((1, nob, kb, bs, bs), generator=gen, device=dev)
             / (kb * bs) ** 0.5).to(dtype)
        idx = torch.as_tensor(pat.idx, device=dev)
        b = (torch.randn((1, n_out), generator=gen, device=dev) if with_bias
             else torch.zeros((1, n_out), device=dev)).to(dtype)
        variant = P.bsm.junction_variant(dtype, M, bs)
        want = P.bsm.fwd_ref(x, w, idx, b, act)
        # the routed entry point, and the SIMT one beside the tensor cores
        variants = [variant] + (["simt"] if variant == "tc" else [])
        isz = x.element_size()
        nbytes = (x.numel() + w.numel() + b.numel() + M * n_out) * isz \
            + idx.numel() * 4
        nops = 2 * M * nob * kb * bs * bs
        bnd, by = bound_ms(nbytes, nops, dtype)
        p_ms = timer.ms(lambda: P.bsm.fwd_ref(x, w, idx, b, act))
        k_ms = {}
        for v in variants:
            with forced(P, v):
                got = P.bsm.fwd(x, w, idx, b, act)
                torch.cuda.synchronize()
                err = max_err(got, want)
                ok = close(got, want, TOL[dtype])
                k_ms[v] = timer.ms(lambda: P.bsm.fwd(x, w, idx, b, act))
            if v == variant:
                worst = max(worst, err)
            tag = "_tc" if v == "tc" else ""
            print(f"[kernel] junction_fwd{tag} {name} "
                  f"{n_in}->{n_out} kb={kb} M={M} {str(dtype)[6:]} "
                  f"act={act} bias={with_bias}: max_abs_err={err:.3g} "
                  f"(tol {TOL[dtype]}) ms={k_ms[v]:.4f} plain_ms={p_ms:.4f} "
                  f"bound_ms={bnd:.4f} ({by}) [{card}]")
            require(ok, f"junction_fwd ({v}) disagrees with fwd_ref: {name} "
                        f"M={M} {dtype} act={act} err={err}")
        if dtype == torch.bfloat16 and M == 4 and not with_bias:
            decode["ms"] += k_ms[variant]
            decode["simt_ms"] += k_ms["simt"]
            decode["plain_ms"] += p_ms
            decode["bytes"] += nbytes
            decode["ops"] += nops
    bnd, by = bound_ms(decode["bytes"], decode["ops"], torch.bfloat16)
    print(f"[kernel] junction_fwd one layer's FFN at decode (wg+wi+wo, M=4, "
          f"bf16): ms={decode['ms']:.4f} (SIMT {decode['simt_ms']:.4f}) "
          f"plain_ms={decode['plain_ms']:.4f} bound_ms={bnd:.4f} ({by}) "
          f"[{card}]")
    return {"max_abs_err": worst, "ms": decode["ms"],
            "simt_ms": decode["simt_ms"], "plain_ms": decode["plain_ms"],
            "bound_ms": bnd, "bound_by": by, "library_ms": None}


# (name, n_in, n_out, act, pattern seed, E, rows): stablelm-3b's three FFN
# junctions and qwen3-moe's expert down junction (E = 128), from one row
# (a lone decode slot) to the training rows
ROUTE_SHAPES = [("wg", 2560, 6912, "silu", 2, 1, (1, 4, 32, 64, 160, 2048)),
                ("wi", 2560, 6912, "none", 0, 1, (1, 4, 32, 64, 160, 2048)),
                ("wo", 6912, 2560, "none", 1, 1, (1, 4, 32, 64, 160, 2048)),
                ("moe wo", 768, 2048, "none", 1, 128, (1, 4, 32, 64, 160))]
# gated_fwd and gated_dx at qwen3-moe's expert gate junction (E = 128,
# 2048 -> 768): a lone decode slot, a tick's and a prefill chunk's
# capacity, an expert's training rows
GATED_ROUTE_ROWS = (1, 4, 32, 160)
# update_dw (Adam) at stablelm-3b's wg junction and qwen3-moe's down
# junction, at their training rows
UPDATE_ROUTE = [(("wg", 2560, 6912, "silu", 2), 1, 2048),
                (("moe wo", 768, 2048, "none", 1), 128, 160)]
# dw at stablelm-3b's three FFN junctions and qwen3-moe's down junction,
# at their training rows
DW_ROUTE = [(("wg", 2560, 6912, "silu", 2), 1, 2048),
            (("wi", 2560, 6912, "none", 0), 1, 2048),
            (("wo", 6912, 2560, "none", 1), 1, 2048),
            (("moe wo", 768, 2048, "none", 1), 128, 160)]
# update_gated_dw (Adam) and gated_dw at qwen3-moe's gate junction: a
# tick's capacity and an expert's training rows
GATED_UPDATE_ROUTE_ROWS = (4, 160)


def route_phase(P, timer, card):
    """The crossover of the route: bf16 ``fwd`` through both entry points
    on the same inputs (SIMT, tensor cores, tensor cores, SIMT), at every
    row count from one row to the training rows; ``gated_fwd`` likewise
    at qwen3-moe's gate junction, ``update_dw`` and ``dw`` at the
    training shapes, ``update_gated_dw``, ``gated_dx`` and ``gated_dw``
    at the gate junction, each entry point also held against its plain
    version.
    Reported beside ``bsm.TC_MIN_M``, the threshold the route uses; the
    times are not gated on."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    faster = {}
    for name, n_in, n_out, act, pseed, E, rows in ROUTE_SHAPES:
        pat = P.make_block_pattern(n_in, n_out, 0.25, BS, seed=pseed)
        nob, kb = pat.idx.shape
        idx = torch.as_tensor(pat.idx, device="cuda")
        w = (torch.randn((E, nob, kb, BS, BS), generator=gen, device="cuda")
             / (kb * BS) ** 0.5).to(torch.bfloat16)
        b = torch.zeros((E, n_out), dtype=torch.bfloat16, device="cuda")
        for M in rows:
            x = torch.randn((E, M, n_in), generator=gen,
                            device="cuda").to(torch.bfloat16)
            ms = []
            for v in ("simt", "tc", "tc", "simt"):
                with forced(P, v):
                    ms.append(timer.ms(
                        lambda: P.bsm.fwd(x, w, idx, b, act)))
            simt, tc = (ms[0] + ms[3]) / 2, (ms[1] + ms[2]) / 2
            faster[(name, M)] = tc < simt
            route = P.bsm.junction_variant(torch.bfloat16, M, BS)
            print(f"[route] junction_fwd {name} E={E} M={M} bf16: SIMT "
                  f"{ms[0]:.4f} / {ms[3]:.4f} ms, tensor cores "
                  f"{ms[1]:.4f} / {ms[2]:.4f} ms ({simt / tc:.2f}x); "
                  f"route: {route} [{card}]")
            del x
        del w
    # the fewest rows from which the tensor cores win at every shape
    lo = next((M for M in sorted({m for _, m in faster})
               if all(f for (_, m), f in faster.items() if m >= M)), None)
    print(f"[route] junction_fwd: tensor cores faster at every shape from "
          f"M={lo} on; the route's threshold TC_MIN_M={P.bsm.TC_MIN_M} "
          f"[{card}]")
    bsm, lim = P.bsm, REL_TOL["bf16_out"]
    faster = {}
    for M in GATED_ROUTE_ROWS:
        t, pt = _moe_inputs(P, gen, MOE_SHAPES[0], MOE_E, M, torch.bfloat16)
        args = (t["x"], t["w"], t["wi"], pt["idx"], True)
        want = bsm.gated_fwd_ref(*args)
        errs = {v: max(rel_err(a, b) for a, b in zip(
            forced_call(P, v, lambda: bsm.gated_fwd(*args))(), want))
            for v in ("simt", "tc")}
        tc, simt = in_turns(timer,
                            forced_call(P, "tc", lambda: bsm.gated_fwd(*args)),
                            forced_call(P, "simt",
                                        lambda: bsm.gated_fwd(*args)))
        faster[M] = tc < simt
        print(f"[route] junction_gated_fwd gate E={MOE_E} M={M} bf16 "
              f"save_res: SIMT {simt:.4f} ms, tensor cores {tc:.4f} ms "
              f"({simt / tc:.2f}x); rel_err SIMT {errs['simt']:.3g} tensor "
              f"cores {errs['tc']:.3g} (tol {lim:.3g}); route: "
              f"{bsm.junction_variant(torch.bfloat16, M, BS)} [{card}]")
        require(max(errs.values()) <= lim,
                f"gated_fwd at M={M} disagrees with its plain version: {errs}")
        del t, pt, want
    lo = next((M for M in sorted(faster)
               if all(f for m, f in faster.items() if m >= M)), None)
    print(f"[route] junction_gated_fwd: tensor cores faster from M={lo} on; "
          f"the route's threshold TC_MIN_M={P.bsm.TC_MIN_M} [{card}]")
    hyp = torch.tensor(ADAM_HYP, device="cuda")
    for shape, E, M in UPDATE_ROUTE:
        name, _, _, act, _ = shape
        t, pt = _train_inputs(P, gen, shape, E, torch.bfloat16, M=M)
        res = t["res"] if act != "none" else None
        mom, vel = _adam_slots(gen, t["w"].shape)
        init = (t["w"], mom, vel)
        sts = {v: [x.clone() for x in init] for v in ("plain", "simt", "tc")}

        def upd(st):
            return lambda: bsm.update_dw(
                t["x"], t["dy"], pt["idx"], res, st[0], None, st[1], None,
                hyp, vel=st[2], act=act, with_bias=False)
        bsm.update_dw_ref(t["x"], t["dy"], pt["idx"], res, sts["plain"][0],
                          None, sts["plain"][1], None, hyp,
                          vel=sts["plain"][2], act=act, with_bias=False)
        pw, pm, pv = sts["plain"]
        errs = {}
        for v in ("simt", "tc"):
            forced_call(P, v, upd(sts[v]))()
            kw, km, kv = sts[v]
            require(_adam_w_ok(kw, pw, t["w"], km, pm, kv, pv),
                    f"update_dw ({v}) {name} M={M}: weights differ "
                    f"({max_err(kw, pw):.3g})")
            errs[v] = max(rel_err(km, pm), rel_err(kv, pv))
        tc, simt = in_turns(timer, forced_call(P, "tc", upd(sts["tc"])),
                            forced_call(P, "simt", upd(sts["simt"])))
        print(f"[route] junction_update_dw {name} E={E} M={M} bf16 Adam: "
              f"SIMT {simt:.4f} ms, tensor cores {tc:.4f} ms "
              f"({simt / tc:.2f}x); slot rel_err SIMT {errs['simt']:.3g} "
              f"tensor cores {errs['tc']:.3g} (tol {REL_TOL['bf16_sum']:.3g})"
              f"; route: {bsm.junction_variant(torch.bfloat16, M, BS)} "
              f"[{card}]")
        require(max(errs.values()) <= REL_TOL["bf16_sum"],
                f"update_dw {name} M={M}: slots differ {errs}")
        del t, pt, sts
    for shape, E, M in DW_ROUTE:
        name, _, _, act, _ = shape
        t, pt = _train_inputs(P, gen, shape, E, torch.bfloat16, M=M)
        args = (t["x"], t["dy"], pt["idx"],
                t["res"] if act != "none" else None, act, False)
        want, _ = bsm.dw_ref(*args)
        errs = {v: rel_err(forced_call(P, v, lambda: bsm.dw(*args))()[0],
                           want) for v in ("simt", "tc")}
        tc, simt = in_turns(timer, forced_call(P, "tc", lambda: bsm.dw(*args)),
                            forced_call(P, "simt", lambda: bsm.dw(*args)))
        print(f"[route] junction_dw {name} E={E} M={M} bf16: SIMT "
              f"{simt:.4f} ms, tensor cores {tc:.4f} ms ({simt / tc:.2f}x); "
              f"rel_err SIMT {errs['simt']:.3g} tensor cores "
              f"{errs['tc']:.3g} (tol {REL_TOL['bf16_sum']:.3g}); route: "
              f"{bsm.junction_variant(torch.bfloat16, M, BS)} [{card}]")
        require(max(errs.values()) <= REL_TOL["bf16_sum"],
                f"dw {name} M={M} disagrees with its plain version: {errs}")
        del t, pt, want
    for M in GATED_UPDATE_ROUTE_ROWS:
        t, pt = _moe_inputs(P, gen, MOE_SHAPES[0], MOE_E, M, torch.bfloat16)
        mom, vel = _adam_slots(gen, t["w"].shape)
        init = (t["w"], t["wi"], mom, mom, vel, vel)
        sts = {v: [x.clone() for x in init] for v in ("plain", "simt", "tc")}
        dw_args = (t["x"], t["dy"], pt["idx"], t["g"], t["u"])

        def gupd(fn, st):
            return lambda: fn(*dw_args, st[0], st[1], st[2], st[3], hyp,
                              vg=st[4], vi=st[5])
        gupd(bsm.update_gated_dw_ref, sts["plain"])()
        pwg, pwi, *ps = sts["plain"]
        errs = {}
        for v in ("simt", "tc"):
            forced_call(P, v, gupd(bsm.update_gated_dw, sts[v]))()
            kwg, kwi, *ks = sts[v]
            require(_adam_w_ok(kwg, pwg, t["w"], ks[0], ps[0], ks[2], ps[2])
                    and _adam_w_ok(kwi, pwi, t["wi"], ks[1], ps[1], ks[3],
                                   ps[3]),
                    f"update_gated_dw ({v}) M={M}: weights differ "
                    f"({max_err(kwg, pwg):.3g}, {max_err(kwi, pwi):.3g})")
            errs[v] = max(rel_err(a, b) for a, b in zip(ks, ps))
        tc, simt = in_turns(
            timer, forced_call(P, "tc", gupd(bsm.update_gated_dw, sts["tc"])),
            forced_call(P, "simt", gupd(bsm.update_gated_dw, sts["simt"])))
        print(f"[route] junction_update_gated_dw gate E={MOE_E} M={M} bf16 "
              f"Adam: SIMT {simt:.4f} ms, tensor cores {tc:.4f} ms "
              f"({simt / tc:.2f}x); slot rel_err SIMT {errs['simt']:.3g} "
              f"tensor cores {errs['tc']:.3g} (tol {REL_TOL['bf16_sum']:.3g})"
              f"; route: {bsm.junction_variant(torch.bfloat16, M, BS)} "
              f"[{card}]")
        require(max(errs.values()) <= REL_TOL["bf16_sum"],
                f"update_gated_dw M={M}: slots differ {errs}")
        del t, pt, sts
    for M in GATED_ROUTE_ROWS:
        t, pt = _moe_inputs(P, gen, MOE_SHAPES[0], MOE_E, M, torch.bfloat16)
        cases = [("gated_dx", bsm.gated_dx, bsm.gated_dx_ref,
                  (t["dy"], t["w"], t["wi"], pt["rev_ob"], pt["rev_t"],
                   pt["rev_cnt"], t["g"], t["u"]), REL_TOL["bf16_out"])]
        if M in GATED_UPDATE_ROUTE_ROWS:
            cases.append(("gated_dw", bsm.gated_dw, bsm.gated_dw_ref,
                          (t["x"], t["dy"], pt["idx"], t["g"], t["u"]),
                          REL_TOL["bf16_sum"]))
        for kind, fn, ref, args, tol in cases:
            call = lambda: fn(*args)
            want = ref(*args)
            want = want if isinstance(want, tuple) else (want,)
            errs = {}
            for v in ("simt", "tc"):
                got = forced_call(P, v, call)()
                got = got if isinstance(got, tuple) else (got,)
                errs[v] = max(rel_err(a, b) for a, b in zip(got, want))
            del got, want
            tc, simt = in_turns(timer, forced_call(P, "tc", call),
                                forced_call(P, "simt", call))
            print(f"[route] junction_{kind} gate E={MOE_E} M={M} bf16: SIMT "
                  f"{simt:.4f} ms, tensor cores {tc:.4f} ms "
                  f"({simt / tc:.2f}x); rel_err SIMT {errs['simt']:.3g} "
                  f"tensor cores {errs['tc']:.3g} (tol {tol:.3g}); route: "
                  f"{bsm.junction_variant(torch.bfloat16, M, BS)} [{card}]")
            require(max(errs.values()) <= tol,
                    f"{kind} at M={M} disagrees with its plain version: "
                    f"{errs}")
        del t, pt, cases
    torch.cuda.empty_cache()


def weight_cast_phase(params, timer, card):
    """The per-call fp32 -> bf16 cast of the FFN junction weights, as
    ops.junction_matmul does it, for one layer and per decode tick."""
    lp = params["layers"][0]
    if "moe" in lp:
        ws = [lp["moe"][k] for k in ("wg", "wi", "wo")]
    else:
        ws = [lp["mlp"][k]["w"] for k in ("wg", "wi", "wo")]
    ms = timer.ms(lambda: [w.to(torch.bfloat16) for w in ws])
    n = len(params["layers"])
    gb = sum(w.numel() for w in ws) * 6 / 1e9        # 4 bytes read, 2 written
    print(f"[cast] fp32->bf16 FFN weight cast: {ms:.4f} ms per layer "
          f"({gb:.3f} GB moved), {ms * n:.3f} ms per tick ({n} layers) "
          f"[{card}]")


# ------------------------------------------------------------ flash_decode
# (what, dtype, Hkv, rep, D, lens, maxp): the serving path's lengths
# (4 slots, page 16, max_seq 128) at stablelm-3b's heads (bf16, fp32), a
# GQA rep 4 and qwen3-moe's heads (Hkv 4, rep 8, head_dim 128); then a
# 4k-token cache of the kind stablelm-3b is served with (maxp 256), at
# both models' heads
DECODE_CASES = [
    ("serve", torch.bfloat16, 32, 1, 80, [0, 1, 17, 128], 8),
    ("serve", torch.float32, 32, 1, 80, [0, 1, 17, 128], 8),
    ("serve", torch.bfloat16, 8, 4, 80, [0, 1, 17, 128], 8),
    ("serve", torch.bfloat16, 4, 8, 128, [0, 1, 17, 128], 8),
    ("long", torch.bfloat16, 32, 1, 80, [0, 17, 2048, 4096], 256),
    ("long", torch.bfloat16, 4, 8, 128, [0, 17, 2048, 4096], 256),
]
DECODE_B, DECODE_PS = 4, 16


def decode_inputs(gen, dtype, Hkv, rep, D, lens, maxp):
    """q, pools, page table (each slot's pages drawn at random from the
    pool, page 0 left as scratch) and seq_lens for one decode case."""
    dev, B, ps = "cuda", DECODE_B, DECODE_PS
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
    return q, kp, vp, pt, sl


def decode_sdpa(q, kp, vp, pt, sl):
    """The yardstick's inputs: one SDPA call over the pages gathered
    beforehand (kv heads repeated to the query heads), and its mask."""
    B, Hkv, rep, D = q.shape
    K = pt.shape[1] * kp.shape[1]
    kg = kp[pt.long()].reshape(B, K, Hkv, D).transpose(1, 2)
    vg = vp[pt.long()].reshape(B, K, Hkv, D).transpose(1, 2)
    kg = kg.repeat_interleave(rep, 1).contiguous()
    vg = vg.repeat_interleave(rep, 1).contiguous()
    qs = q.reshape(B, Hkv * rep, 1, D)
    mask = (torch.arange(K, device=q.device)[None, :] < sl[:, None]
            )[:, None, None, :]
    return qs, kg, vg, mask


def decode_phase(P, timer, card):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    worst, res = 0.0, {}
    for what, dtype, Hkv, rep, D, lens, maxp in DECODE_CASES:
        q, kp, vp, pt, sl = decode_inputs(gen, dtype, Hkv, rep, D, lens,
                                          maxp)
        got = P.fa.flash_decode(q, kp, vp, pt, sl)
        want = P.fa.paged_decode_ref(q, kp, vp, pt, sl)
        torch.cuda.synchronize()
        err = max_err(got, want)
        worst = max(worst, err)
        zeros = bool((got[0] == 0).all())
        ok = close(got, want, TOL[dtype])
        again = P.fa.flash_decode(q, kp, vp, pt, sl)
        repeats = bool(torch.equal(again, got))
        k_ms = timer.ms(lambda: P.fa.flash_decode(q, kp, vp, pt, sl))
        p_ms = timer.ms(lambda: P.fa.paged_decode_ref(q, kp, vp, pt, sl))
        args = decode_sdpa(q, kp, vp, pt, sl)
        lib_ms = timer.ms(lambda: sdpa(*args[:3], attn_mask=args[3]))
        del args
        isz = q.element_size()
        tokens = sum(lens)
        nbytes = (2 * q.numel() + 2 * tokens * Hkv * D) * isz \
            + (pt.numel() + sl.numel()) * 4
        nops = 4 * D * tokens * Hkv * rep
        bnd, by = bound_ms(nbytes, nops, dtype)
        nsplit, pps = P.fa.decode_splits(
            DECODE_B, Hkv, rep, DECODE_PS, maxp,
            torch.cuda.get_device_properties(0).multi_processor_count)
        print(f"[kernel] flash_decode {what} B={DECODE_B} Hkv={Hkv} rep={rep} "
              f"D={D} ps={DECODE_PS} maxp={maxp} lens={lens} "
              f"{str(dtype)[6:]} splits={nsplit}x{pps}: "
              f"max_abs_err={err:.3g} (tol {TOL[dtype]}) "
              f"zero_slot_exact={zeros} repeats_bit_for_bit={repeats} "
              f"ms={k_ms:.4f} plain_ms={p_ms:.4f} bound_ms={bnd:.5f} ({by}) "
              f"of_bound={bnd / k_ms:.3f} library_ms={lib_ms:.4f} [{card}]")
        require(ok, f"flash_decode disagrees: {what} {dtype} rep={rep} "
                    f"err={err}")
        require(zeros, "flash_decode: the zero-length slot is not exact zeros")
        require(repeats, "flash_decode: two calls differ")
        row = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bnd, "bound_by": by,
               "library_ms": lib_ms}
        prefix = ("moe_" if D == 128 else "") + \
            ("long_" if what == "long" else "")
        if prefix + "ms" not in res:         # the first case of each kind
            res.update({prefix + k: v for k, v in row.items()
                        if prefix == "" or k != "bound_by"})
    return {"max_abs_err": worst, **res}


# ------------------------------------------------------------ serve phase
# the fewest rows a serving junction call has: the 4 slots of a decode
# tick (a prefill chunk has 32); an expert's capacity is at least 4
# (models/moe.moe_dispatch_dims)
SERVE_MIN_ROWS = 4


def _ffn_tiles(cfg, d_ff) -> bool:
    """Whether an MLP of hidden width ``d_ff`` is sparse: both dims tile
    at the block (``core/sparse_linear.init_linear``; deepseek-v2's dense
    layer of 10944 does not at 128 and stays dense)."""
    bs = cfg.sparsity.block
    return cfg.d_model % bs == 0 and d_ff % bs == 0 and cfg.d_model >= 2 * bs


def junction_calls(cfg, quantized=False, encoder=True) -> dict:
    """The junction launches of one model call (a prefill, a decode step,
    a training forward) by kernel: a dense or vlm layer's three FFN
    junctions; a MoE layer's gate (one gated junction) and down junction,
    its shared experts' three, and a dense first layer's three where its
    width tiles; a Mamba-1 layer's in_proj and out_proj; a Mamba-2 layer's
    in_z, in_xbc and out_proj, and the hybrid's shared MLP (wg, wi, wo)
    once a super-block; a whisper decoder layer's two (wi with the gelu
    epilogue, wo) and, where the call runs the encoder (``encoder``: a
    prefill or a training forward, not a decode step), each encoder
    layer's two.  Quantized, each runs its int8 kernel but the
    shared experts: ``quantize_tree`` quantizes a MoE dict as one
    junction and leaves its "shared" MLP as it was (as the reference's
    does), so those stay on ``fwd``.  Attention's projections are dense
    under every phase's ``where="ffn"``; another ``where`` raises."""
    where = cfg.sparsity.where if cfg.sparsity else "ffn"
    require(where == "ffn", f"junction_calls counts FFN junctions only, "
            f"not where={where!r}")
    L = cfg.n_layers
    shared = 0
    if cfg.family == "moe":
        mo = cfg.moe
        nd = mo.first_dense_layers
        n = {"gated_fwd": L - nd, "fwd": L - nd}
        if mo.num_shared and _ffn_tiles(cfg, mo.d_shared):
            shared = 3 * (L - nd)
        if nd and _ffn_tiles(cfg, cfg.d_ff):
            n["fwd"] += 3 * nd
    else:
        n = {"dense": {"fwd": 3 * L}, "vlm": {"fwd": 3 * L},
             "ssm": {"fwd": 2 * L},
             "hybrid": {"fwd": 3 * L + shared_block_calls(cfg)},
             "audio": {"fwd": 2 * (L + (cfg.enc_layers if encoder else 0))}
             }[cfg.family]
    if not quantized:
        n["fwd"] += shared
        return {f"junction_{k}": v for k, v in n.items()}
    out = {f"junction_{k}_int8": v for k, v in n.items()}
    return {**out, "junction_fwd": shared} if shared else out


def shared_block_calls(cfg) -> int:
    """The junction launches of the hybrid's shared block in one model
    call: its MLP's (wi and wo, wg too where the activation gates) at
    each of its ``n_layers // hybrid_attn_every`` uses; 0 in another
    family."""
    if cfg.family != "hybrid":
        return 0
    return (3 if cfg.act == "silu" else 2) * (cfg.n_layers
                                              // cfg.hybrid_attn_every)


def serve_calls(cfg, quantized, n_decode) -> dict:
    """The junction launches of a static prefill and ``n_decode`` decode
    steps after it (``junction_calls``: whisper's encoder runs in the
    prefill only)."""
    out = collections.Counter(junction_calls(cfg, quantized))
    for k, n in junction_calls(cfg, quantized, encoder=False).items():
        out[k] += n_decode * n
    return dict(out)


def serve_phase(P, card, arch, params=None, quantize=None, fp_outs=None,
                obs_path=None):
    """8 requests through ContinuousEngine on full-size ``arch`` (random
    weights from seed 0, or ``params``), with ``quantize`` as the
    ServeConfig's; returns (params, launch counts, outputs).  Given the
    fp run's outputs, prints the greedy agreement with them.  Given
    ``obs_path``, a Recorder with its sink there rides the 8 requests
    (after the warm-up) under the same exact launch counts, and every
    request must leave one valid ``serve.span``."""
    M, engine, ops = P.M, P.engine, P.ops
    dev = torch.device("cuda")
    cfg = P.registry.get(arch).with_sparsity(
        P.SparsityConfig(density=0.25, block=128, where="ffn"))
    if params is None:
        t0 = time.perf_counter()
        params = M.init(cfg, seed=0, device=dev)
        torch.cuda.synchronize()
        n_params = sum(t.numel() for t in _leaves(params)
                       if t.is_floating_point())
        moe = (f" experts={cfg.moe.num_experts} top_k={cfg.moe.top_k} "
               f"d_expert={cfg.moe.d_expert}" if cfg.moe else "")
        print(f"[serve] {cfg.name} d_model={cfg.d_model} d_ff={cfg.d_ff} "
              f"layers={cfg.n_layers} heads={cfg.n_heads}/{cfg.kv_heads} "
              f"head_dim={cfg.head_dim} vocab={cfg.vocab}{moe}, "
              f"sparse FFN {cfg.sparsity}: {n_params / 1e9:.3f} B params, "
              f"init {time.perf_counter() - t0:.1f} s")
    scfg = engine.ServeConfig(max_new_tokens=16, slots=4, page_size=16,
                              prefill_chunk=32, max_seq=128,
                              quantize=quantize)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, size=(8, 64)).astype(np.int32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = engine.ContinuousEngine(cfg, params, scfg, device=dev)
    torch.cuda.synchronize()
    name = cfg.name + (f" {quantize}" if quantize else "")
    if quantize:
        codes = sum(t.numel() for t in _leaves(eng.params)
                    if t.dtype == torch.int8)
        print(f"[serve] {name}: quantized at load in "
              f"{time.perf_counter() - t0:.2f} s, {codes / 1e9:.3f} B int8 "
              f"weight codes, peak_memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB with "
              f"the caller's fp tree alive [{card}]")
    eng.serve([engine.Request(0, prompts[0][:8], 2)])          # warm-up
    reqs = [engine.Request(i, prompts[i], 16, arrival=i) for i in range(8)]
    if obs_path is not None:
        obs_path.parent.mkdir(parents=True, exist_ok=True)
        eng.rec = P.obs.Recorder(str(obs_path),
                                 meta={"launcher": "chip_smoke",
                                       "arch": arch, "card": card})

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    outs = eng.serve(reqs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = ops.launch_counts()
    path = with_tc(P, counts)

    st = eng.stats
    n_tok = sum(len(v) for v in outs.values())
    lat = [v["wall_s"] for v in st["latency"].values()]
    p50, p99 = P.percentile(lat, 50), P.percentile(lat, 99)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[serve] {name}: {len(outs)}/8 requests, {n_tok} tokens in "
          f"{dt:.3f} s: {n_tok / dt:.1f} tok/s, "
          f"decode_ticks={st['decode_ticks']} "
          f"prefill_chunks={st['prefill_chunks']} p50_latency={p50 * 1e3:.1f} ms "
          f"p99_latency={p99 * 1e3:.1f} ms peak_memory={peak:.2f} GiB "
          f"launches={path} [{card}]")
    require(sorted(outs) == list(range(8)), f"requests missing: {sorted(outs)}")
    require(all(len(v) == 16 for v in outs.values()),
            f"token counts {[len(v) for v in outs.values()]}")
    require(eng.nonfinite_terminated == 0,
            f"{eng.nonfinite_terminated} slots hit non-finite logits")
    L = cfg.n_layers
    steps = st["decode_ticks"] + st["prefill_chunks"]
    calls = junction_calls(cfg, bool(quantize))
    want = dict.fromkeys(counts, 0)
    want.update({k: n * steps for k, n in calls.items()})
    want["flash_decode"] = L * st["decode_ticks"]      # one attention a layer
    require(counts == want, f"{name} launches {counts} != {want}")
    require(st["launches"] == counts, "engine stats disagree with counters")
    if obs_path is not None:
        check_serve_spans(P, eng.rec, obs_path, 8, card)
    # every junction call of the path has at least SERVE_MIN_ROWS rows: on
    # the tensor cores when the route takes the compute dtype there
    tc = P.bsm.junction_variant(getattr(torch, cfg.dtype), SERVE_MIN_ROWS,
                                cfg.sparsity.block) == "tc"
    want_tc = {k: counts[k] if tc else 0 for k in P.ops.tc_launch_counts()}
    require(P.ops.tc_launch_counts() == want_tc,
            f"{name} tensor-core launches {P.ops.tc_launch_counts()} != "
            f"{want_tc}")
    if fp_outs is not None:
        # random weights give near ties: reported, not gated on
        same = [float(np.mean(outs[r] == fp_outs[r])) for r in sorted(outs)]
        print(f"[serve] {name}: greedy agreement with the fp engine on the "
              f"same weights {float(np.mean(same)):.3f} (per request "
              f"{[round(v, 3) for v in same]})")

    for dtype in (torch.bfloat16, torch.float32):
        compare_logits(P, cfg, eng.params, prompts[0], dtype, card,
                       LOGIT_REL_TOL[dtype], bool(quantize))
    tick_breakdown(M, cfg, eng.params, card)
    return params, path, outs


def step_breakdown(step, wall_s, what, card, top=8):
    """The device time of one more call of ``step`` by kernel name, from
    the profiler, and its share of ``wall_s`` (the unprofiled time).
    Returns the device time in ms."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"[profile] {what}: kernels {dev_ms:.1f} ms in "
          f"{sum(e.count for e in kernels)} launches, device busy "
          f"{dev_ms / (wall_s * 1e3):.1%} of the unprofiled "
          f"{wall_s * 1e3:.1f} ms [{card}]")
    for e in kernels[:top]:
        print(f"[profile]   {e.self_device_time_total / 1e3:9.2f} ms "
              f"{e.count:5d}x  {e.key[:90]}")
    return dev_ms


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
    for i, e in enumerate(kernels):
        if i < 10 or "decode_kernel" in e.key:   # and flash_decode's share
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


def compare_logits(P, cfg, params, prompt, dtype, card, tol,
                   quantized=False):
    """The first prefill chunk and one decode tick (slot 0 live, three
    free slots on the scratch page), once through the kernels and once
    through the plain versions, on the card, within ``tol`` of max
    |logit|.
    ``quantized`` swaps the int8 junctions alone and keeps flash_decode
    on both sides: its summation order would move an fp32 activation by
    an ulp, and at a rounding boundary its int8 code by a step, so the
    comparison would read the attention's noise and not the int8
    kernels' (flash_decode is held against its plain version at model
    level by the fp comparison)."""
    M, ops, bsm, fa = P.M, P.ops, P.bsm, P.fa
    cfg = dataclasses.replace(cfg, dtype=str(dtype)[6:])
    ops.reset_launch_counts()
    k_pf, k_dec = _chunk_and_tick(M, cfg, params, prompt)
    kernel_counts = ops.launch_counts()
    with contextlib.ExitStack() as stack:
        for name in (("fwd_int8", "gated_fwd_int8") if quantized
                     else ("fwd", "gated_fwd")):
            stack.enter_context(mock.patch.object(
                bsm, name, getattr(bsm, f"{name}_ref")))
        if not quantized:
            stack.enter_context(mock.patch.object(fa, "flash_decode",
                                                  fa.paged_decode_ref))
        p_pf, p_dec = _chunk_and_tick(M, cfg, params, prompt)
    torch.cuda.synchronize()
    L = cfg.n_layers
    want = dict.fromkeys(kernel_counts, 0)
    want.update({k: 2 * n for k, n in junction_calls(cfg, quantized).items()})
    want["flash_decode"] = L
    plain_want = dict(kernel_counts)
    if quantized:
        plain_want["flash_decode"] += L
    require(kernel_counts == want and ops.launch_counts() == plain_want,
            f"logit comparison did not take the intended paths: "
            f"{kernel_counts} then {ops.launch_counts()}")
    for what, a, b in (("prefill", k_pf, p_pf), ("decode", k_dec, p_dec)):
        require(bool(torch.isfinite(a).all() and torch.isfinite(b).all()),
                f"{what} logits not finite")
        rel = max_err(a, b) / float(b.abs().max())
        same = int(torch.argmax(a)) == int(torch.argmax(b))
        print(f"[logits] {cfg.name} {what} {str(dtype)[6:]} kernels vs plain "
              f"versions: "
              f"max_abs_err={max_err(a, b):.4g} max|logit|="
              f"{float(b.abs().max()):.4g} rel={rel:.3g} "
              f"(tol {tol}) same_argmax={same} [{card}]")
        require(rel <= tol, f"{what} {dtype} logits differ")


# ------------------------------------------------------------- telemetry
def check_serve_spans(P, rec, path, n, card):
    """Close ``rec`` and require one valid ``serve.span`` (launch/
    obs_report.check_span) for each of the ``n`` requests in its sink."""
    rec.close()
    _, events = P.obs.read_events(str(path))
    spans = [e for e in events if e["kind"] == "serve.span"]
    bad = [v for v in map(P.obs_report.check_span, spans) if v]
    h = rec.summary()["histograms"]
    ttft, itl = h["serve.ttft_s"], h["serve.itl_s"]
    print(f"[obs] {path.name}: {len(spans)} serve.span events "
          f"({len(events)} lines), outcomes {rec.counters}, ttft p50 "
          f"{ttft['p50'] * 1e3:.1f} ms p99 {ttft['p99'] * 1e3:.1f} ms, "
          f"inter-token p50 {itl['p50'] * 1e3:.2f} ms p99 "
          f"{itl['p99'] * 1e3:.2f} ms over {itl['count']} tokens [{card}]")
    require(sorted(e["rid"] for e in spans) == list(range(n)),
            f"spans for requests {sorted(e['rid'] for e in spans)}")
    require(not bad, f"span violations: {bad}")


SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize")


def host_syncs(fn):
    """fn() under torch.profiler: (its result, the synchronizing CUDA calls
    it made by name).  Counted: the runtime's ``cudaStreamSynchronize`` and
    ``cudaDeviceSynchronize`` calls, device-to-host copies (their memcpy
    activity, one per ``cudaMemcpy*`` call that reads the card) and, for
    the record, every ``cudaMemcpy*`` runtime call."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
    counts = collections.Counter()
    for e in prof.events():
        if e.name in SYNC_CALLS:
            counts[e.name] += 1
        elif e.name.startswith("cudaMemcpy"):
            counts["cudaMemcpy*"] += 1
        elif "DtoH" in e.name or "Device -> P" in e.name:
            counts["memcpy DtoH"] += 1
    return out, dict(counts)


def telemetry_phase(P, card, params):
    """The recorder adds no sync and no launch on the card: the
    synchronizing CUDA calls (``host_syncs``) and the kernels' launch
    counts of one serve run of one request (one prefill chunk, one decode
    tick) on full-size stablelm-3b (``params``), and of a 3-step
    ``train_loop.run`` (its exit checkpoint included) of stablelm-3b at
    full width cut to 1 layer (the loop writes a checkpoint on exit; the
    32-layer model's would be tens of GB), each without and with a
    Recorder, are equal; the train run with it leaves one ``train.step``
    a step."""
    dev = torch.device("cuda")
    cfg = P.registry.get("stablelm-3b").with_sparsity(
        P.SparsityConfig(density=0.25, block=128, where="ffn"))
    scfg = P.engine.ServeConfig(max_new_tokens=2, slots=4, page_size=16,
                                prefill_chunk=32, max_seq=128)
    prompt = np.random.default_rng(1).integers(0, cfg.vocab, 24).astype(
        np.int32)
    out_dir = ROOT / "build" / "obs"
    out_dir.mkdir(parents=True, exist_ok=True)
    serve, engines = {}, {}
    for name in ("off", "on"):
        rec = P.obs.Recorder() if name == "on" else None
        eng = engines[name] = P.engine.ContinuousEngine(
            cfg, params, scfg, device=dev, recorder=rec)
        eng.serve([P.engine.Request(0, prompt, 2)])             # warm-up
        P.ops.reset_launch_counts()
        outs, syncs = host_syncs(
            lambda: eng.serve([P.engine.Request(1, prompt, 2)]))
        st = eng.stats
        require(st["decode_ticks"] == 1 and st["prefill_chunks"] == 1,
                f"serve run of {st['decode_ticks']} ticks, "
                f"{st['prefill_chunks']} chunks")
        serve[name] = (syncs, P.ops.launch_counts(), outs[1].tolist())
    # the same run unprofiled, in turns (off, on, on, off, ...): wall time
    walls = {"off": [], "on": []}
    for name in ("off", "on", "on", "off") * 3:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engines[name].serve([P.engine.Request(2, prompt, 2)])
        torch.cuda.synchronize()
        walls[name].append((time.perf_counter() - t0) * 1e3)
    print(f"[obs] serve, one prefill chunk + one decode tick, stablelm-3b: "
          f"sync calls without recorder {serve['off'][0]}, with "
          f"{serve['on'][0]}; launches equal "
          f"{serve['off'][1] == serve['on'][1]}; wall median of 6 in turns "
          f"{statistics.median(walls['off']):.2f} ms without, "
          f"{statistics.median(walls['on']):.2f} ms with [{card}]")
    require(serve["off"][0].get("memcpy DtoH", 0) > 0,
            "the profiler saw no device-to-host copy in a serve run")
    require(serve["off"] == serve["on"],
            f"the recorder changed the serve run: {serve}")
    require(len(rec.events("serve.span")) == 8, "serve spans missing")

    tcfg = dataclasses.replace(cfg, n_layers=1, fused_update=True,
                               param_dtype="bfloat16")
    opt = P.optim.fused_sgd(P.optim.cosine_schedule(3e-4, 20, 100),
                            momentum=0.9)
    step_fn = P.steps.make_train_step(tcfg, opt)
    warm = P.M.init(tcfg, seed=0, device=dev)
    step_fn(warm, opt.init(warm), next(P.LMTokenPipeline(tcfg, TRAIN_B,
                                                         TRAIN_S)), 0)
    del warm
    train = {}
    sink = out_dir / "train_stablelm-3b_1layer.jsonl"
    for name in ("off", "on"):
        rec = (P.obs.Recorder(str(sink), meta={"launcher": "chip_smoke",
                                               "card": card})
               if name == "on" else None)
        ckpt = out_dir / f"ckpt_{name}"
        shutil.rmtree(ckpt, ignore_errors=True)
        params_t = P.M.init(tcfg, seed=0, device=dev)
        loop = P.train_loop.TrainLoopConfig(total_steps=3,
                                            ckpt_dir=str(ckpt),
                                            ckpt_every=1000, log_every=1000)
        P.ops.reset_launch_counts()
        t0 = time.perf_counter()
        res, syncs = host_syncs(lambda: P.train_loop.run(
            loop, step_fn, params_t, opt.init(params_t),
            P.LMTokenPipeline(tcfg, TRAIN_B, TRAIN_S), log=lambda s: None,
            recorder=rec))
        dt = time.perf_counter() - t0
        train[name] = (syncs, P.ops.launch_counts(), res["step"])
        shutil.rmtree(ckpt)
        del params_t, res
    rec.close()
    _, events = P.obs.read_events(str(sink))
    steps = [e for e in events if e["kind"] == "train.step"]
    rows = [(e["step"], round(e["loss"], 4), round(e["dt_s"] * 1e3, 1))
            for e in steps]
    print(f"[obs] train_loop.run, 3 fused SGD steps of stablelm-3b at 1 "
          f"layer (batch {TRAIN_B} x {TRAIN_S}) and its exit checkpoint, "
          f"{dt:.1f} s with the recorder: sync calls without recorder "
          f"{train['off'][0]}, with {train['on'][0]}; launches equal "
          f"{train['off'][1] == train['on'][1]}; train.step events "
          f"{rows} (step, loss, ms) [{card}]")
    require(train["off"] == train["on"],
            f"the recorder changed the train run: {train}")
    require([e["step"] for e in steps] == [0, 1, 2]
            and all(np.isfinite(e["loss"]) for e in steps),
            f"train.step events {steps}")
    torch.cuda.empty_cache()


# ------------------------------------------------------ the paper's network
PAPER_N = 12544          # inputs an epoch (Sec. III-B)
PAPER_PREFIX = 1024      # inputs held card against CPU bit for bit
PAPER_HELD = 256         # inputs whose forward outputs are compared
PAPER_ETA = 2.0 ** -3
# the reference's own accuracy contracts (tests/test_paper_net.py)
PAPER_MIN_ACC = {"sequential": 0.8, "pipelined": 0.75}


def _paper_to(params, device):
    return {"junctions": [{k: v.to(device) for k, v in jp.items()}
                          for jp in params["junctions"]]}


def _paper_epoch(P, cfg, kind, params, xs, ys):
    if kind == "sequential":
        p, _, corr = P.PN.train_epoch(params, xs, ys, PAPER_ETA, cfg)
    else:
        p, corr = P.PN.train_epoch_pipelined(params, xs, ys, PAPER_ETA, cfg)
    return p, corr


def _paper_same(a, b) -> bool:
    return all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(a, b))


def paper_phase(P, card):
    """The paper's Table I network in (12,3,8) fixed point, both schedules:
    over the first 1024 inputs of the epoch, the card and the CPU (the
    same port code, from the same weights) give the same params, corrects
    and forward outputs bit for bit; then one full 12544-input epoch of
    each on the card, timed, at the reference's accuracy contracts."""
    PN, JP, cfg = P.PN, P.JP, P.paper_mnist.CONFIG
    dev = torch.device("cuda")
    r = JP.resources(cfg)
    f = cfg.fmt
    print(f"[paper] Table I: layers {cfg.layers} d_out {cfg.d_out} z {cfg.z} "
          f"fmt ({f.bw},{f.bn},{f.bf}) {cfg.n_params()} params, density "
          f"{cfg.overall_density():.5f}; the FPGA model: block cycle "
          f"{JP.block_cycle_s(cfg) * 1e6:.4f} us at "
          f"{JP.CLOCK_HZ / 1e6:.0f} MHz = "
          f"{JP.throughput_inputs_per_s(cfg):.0f} inputs/s, "
          f"{JP.speedup_vs_sequential(cfg):.0f} ops in flight, {r}, "
          f"{r.total_multipliers} multipliers")
    x, y, _ = P.paper_dataset(PAPER_N)
    params0 = PN.init(cfg, device="cpu")
    held = torch.from_numpy(x[-PAPER_HELD:])
    xc, yc = torch.from_numpy(x[:PAPER_PREFIX]), torch.from_numpy(
        y[:PAPER_PREFIX])
    xs, ys = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
    res = {}
    for kind in ("sequential", "pipelined"):
        # the prefix on the CPU (one thread: the tensors are tiny) and on
        # the card, from the same weights
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        t0 = time.perf_counter()
        pc, cc = _paper_epoch(P, cfg, kind, params0, xc, yc)
        cpu_s = time.perf_counter() - t0
        ac, dc = PN.forward(pc, held, cfg)
        torch.set_num_threads(threads)
        pg0 = _paper_to(params0, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pg, cg = _paper_epoch(P, cfg, kind, pg0, xc.to(dev), yc.to(dev))
        torch.cuda.synchronize()
        gpu_s = time.perf_counter() - t0
        ag, dg = PN.forward(pg, held.to(dev), cfg)
        same_p = all(_paper_same(a.values(), b.values()) for a, b in
                     zip(pc["junctions"], pg["junctions"]))
        same_c = torch.equal(cc, cg.cpu())
        same_o = _paper_same(ac[1:] + dc[1:], ag[1:] + dg[1:])
        print(f"[paper] {kind}, first {PAPER_PREFIX} inputs: card vs CPU "
              f"params equal {same_p}, corrects equal {same_c} "
              f"(acc {float(cc.mean()):.4f}), outputs on {PAPER_HELD} "
              f"inputs equal {same_o}; card {gpu_s:.2f} s = "
              f"{gpu_s / PAPER_PREFIX * 1e6:.0f} us an input (first call "
              f"included), CPU (1 thread) {cpu_s:.2f} s = "
              f"{cpu_s / PAPER_PREFIX * 1e6:.0f} us an input [{card}]")
        require(same_p and same_c and same_o,
                f"{kind}: the card and the CPU differ on the prefix")
        # a full epoch on the card
        pf0 = _paper_to(params0, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pf, cf = _paper_epoch(P, cfg, kind, pf0, xs, ys)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        acc = float(cf[-1000:].mean())
        on_grid = all(bool(torch.equal(v * f.scale, torch.round(v * f.scale))
                           and v.abs().max() <= 2 ** f.bn)
                      for jp in pf["junctions"] for v in (jp["w"], jp["b"]))
        print(f"[paper] {kind}, one {PAPER_N}-input epoch on the card: "
              f"{dt:.2f} s = {dt / PAPER_N * 1e6:.1f} us an input, "
              f"accuracy over the last 1000 inputs {acc:.4f} (contract > "
              f"{PAPER_MIN_ACC[kind]}), params on the grid {on_grid}; CPU "
              f"prefix {cpu_s / PAPER_PREFIX * 1e6:.0f} us an input "
              f"[{card}]")
        require(acc > PAPER_MIN_ACC[kind] and on_grid,
                f"{kind}: accuracy {acc} or params off the grid")
        res[kind] = {"epoch_s": dt, "us_per_input": dt / PAPER_N * 1e6,
                     "cpu_us_per_input": cpu_s / PAPER_PREFIX * 1e6,
                     "acc": acc}
    return res


# ------------------------------------------------ backward kernels
TRAIN_SHAPES = [("wg", 2560, 6912, "silu", 2), ("wi", 2560, 6912, "none", 0),
                ("wo", 6912, 2560, "none", 1)]
TRAIN_B, TRAIN_S = 8, 256            # launch/train.py's defaults
TRAIN_M = TRAIN_B * TRAIN_S
BS = 128                             # the paper's block
# backward kernels vs plain versions, as max |got - want| / max |want|:
# fp32 sums in another order; a bf16 output may move by one ulp; an fp32
# sum of bf16 products (dw, db, the slots) also sees the dz elements whose
# fp32 value differs in its last bit between the two activation gradients
# (CUDA's expf / tanhf against PyTorch's) and rounds to the other bf16
# neighbour
REL_TOL = {"fp32": 1e-5, "bf16_out": 2.0 ** -7, "bf16_sum": 1e-3}
ADAM_HYP = (1e-3, 0.9, 0.95, 1e-8, 0.01, 3.0, 0.5)


def rel_err(got, want) -> float:
    d = (got.float() - want.float()).abs().max()
    return float(d / want.float().abs().max().clamp_min(1e-30))


def _train_inputs(P, gen, shape, E, dtype, M=TRAIN_M, bs=BS):
    name, n_in, n_out, act, pseed = shape
    pat = P.make_block_pattern(n_in, n_out, 0.25, bs, seed=pseed)
    nob, kb = pat.idx.shape
    r = lambda *sh: torch.randn(sh, generator=gen, device="cuda")
    s = r(E, M, n_out)
    t = {"x": r(E, M, n_in), "dy": r(E, M, n_out),
         "w": r(E, nob, kb, bs, bs) / (kb * bs) ** 0.5,
         "res": {"relu": s.clamp_min(0.0), "sigmoid": torch.sigmoid(s)
                 }.get(act, s), "b": r(E, n_out)}
    t = {k: v.to(dtype).contiguous() for k, v in t.items()}
    pt = {k: torch.as_tensor(getattr(pat, k), device="cuda")
          for k in ("idx", "rev_ob", "rev_t", "rev_cnt")}
    return t, pt


def _cost(kind, t, pt, act, n_slots=0):
    """(bytes, operations) the function needs: each operand read once,
    each output written once, and two operations per multiply-add over
    the edges this pattern holds."""
    isz = t["x"].element_size()
    E, M, n_in = t["x"].shape
    n_out, bs = t["dy"].shape[2], t["w"].shape[-1]
    xb, yb, wb = E * M * n_in * isz, E * M * n_out * isz, t["w"].numel()
    res = yb if act != "none" else 0
    ints = 4 * sum(v.numel() for v in pt.values())
    edges = int(pt["rev_cnt"].sum()) if kind == "dx" else pt["idx"].numel()
    nops = 2 * E * M * edges * bs * bs
    if kind == "fwd":               # x, w, bias in; y and the pre out
        pre = yb if act in ("silu", "gelu") else 0
        return xb + wb * isz + E * n_out * isz + yb + pre + ints, nops
    if kind == "dx":                # dy, res, w in; dx out
        return yb + res + wb * isz + xb + ints, nops
    if kind == "dw":                # x, dy, res in; dw in fp32 out
        return xb + yb + res + 4 * wb + ints, nops
    # update_dw: x, dy, res in; w and the fp32 slots read and written
    return xb + yb + res + 2 * wb * isz + 8 * n_slots * wb + ints, nops


def _report(kind, name, dtype, act, err, lim, k_ms, p_ms, nbytes, nops,
            card, extra="", M=TRAIN_M):
    bnd, by = bound_ms(nbytes, nops, dtype)
    print(f"[kernel] junction_{kind} {name} M={M} {str(dtype)[6:]} "
          f"act={act}{extra}: rel_err={err:.3g} (tol {lim:.3g}) "
          f"ms={k_ms:.4f} plain_ms={p_ms:.4f} bound_ms={bnd:.4f} ({by}) "
          f"[{card}]")
    require(err <= lim, f"junction_{kind} {name} {dtype} act={act}: "
                        f"rel_err {err} > {lim}")
    return bnd, by


def _adam_slots(gen, shape):
    """Slots for a kernel-vs-plain check of the update: v is kept away
    from 0, so that m / sqrt(v) does not magnify the summation-order
    difference of a near-zero gradient into a visible weight change."""
    mom = torch.randn(shape, generator=gen, device="cuda") * 0.01
    vel = 1.0 + torch.randn(shape, generator=gen, device="cuda").abs()
    return mom, vel


def train_kernel_phase(P, timer, card):
    """fwd (with its saved residual), dx, dw and the fused Adam update_dw
    at the three FFN junctions of the training path, M = 2048, bf16 and
    fp32, each against its plain version and timed (all four through
    both entry points in bf16, in turns); then every activation,
    bias, E = 2, SGD / momentum / Adam, the health counts of poisoned
    tiles and the zero-hyp freeze, checked."""
    bsm = P.bsm
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    out = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
               "bound_ms": 0.0, "bytes": 0, "ops": 0}
           for k in ("fwd", "dx", "dw", "update_dw")}
    for dtype in (torch.bfloat16, torch.float32):
        out_tol = REL_TOL["fp32" if dtype == torch.float32 else "bf16_out"]
        sum_tol = REL_TOL["fp32" if dtype == torch.float32 else "bf16_sum"]
        for shape in TRAIN_SHAPES:
            name, _, n_out, act, _ = shape
            t, pt = _train_inputs(P, gen, shape, 1, dtype)
            res = t["res"] if act != "none" else None
            zb = torch.zeros((1, n_out), dtype=dtype, device="cuda")
            rows = []
            # forward, with the pre-activation the backward needs
            pre = act in bsm.ACT_NEEDS_PRE
            got = bsm.fwd(t["x"], t["w"], pt["idx"], zb, act, save_pre=pre)
            want = bsm.fwd_ref(t["x"], t["w"], pt["idx"], zb, act,
                               save_pre=pre)
            got, want = (got, want) if pre else ((got,), (want,))
            err = max(rel_err(g, w) for g, w in zip(got, want))
            rows.append(("fwd", err, out_tol, max_err(got[0], want[0]),
                         lambda: bsm.fwd(t["x"], t["w"], pt["idx"], zb, act,
                                         save_pre=pre),
                         lambda: bsm.fwd_ref(t["x"], t["w"], pt["idx"], zb,
                                             act, save_pre=pre),
                         _cost("fwd", t, pt, act)))
            simt = {}
            if bsm.junction_variant(dtype, TRAIN_M, BS) == "tc":
                simt["fwd"] = _simt_row(P, rows[-1][4], want)
            rev = (pt["rev_ob"], pt["rev_t"], pt["rev_cnt"])
            got = bsm.dx(t["dy"], t["w"], *rev, res, act)
            want = bsm.dx_ref(t["dy"], t["w"], *rev, res, act)
            rows.append(("dx", rel_err(got, want), out_tol,
                         max_err(got, want),
                         lambda: bsm.dx(t["dy"], t["w"], *rev, res, act),
                         lambda: bsm.dx_ref(t["dy"], t["w"], *rev, res, act),
                         _cost("dx", t, pt, act)))
            if simt:
                simt["dx"] = _simt_row(P, rows[-1][4], (want,))
            got, _ = bsm.dw(t["x"], t["dy"], pt["idx"], res, act, False)
            want, _ = bsm.dw_ref(t["x"], t["dy"], pt["idx"], res, act, False)
            rows.append(("dw", rel_err(got, want), sum_tol,
                         max_err(got, want),
                         lambda: bsm.dw(t["x"], t["dy"], pt["idx"], res, act,
                                        False),
                         lambda: bsm.dw_ref(t["x"], t["dy"], pt["idx"], res,
                                            act, False),
                         _cost("dw", t, pt, act)))
            if simt:
                simt["dw"] = _simt_row(P, rows[-1][4], (want,))
            hyp = torch.tensor(ADAM_HYP, device="cuda")
            mom, vel = _adam_slots(gen, t["w"].shape)
            init = (t["w"], mom, vel)
            p_st = [v.clone() for v in init]

            def upd(fn, st):
                return lambda: fn(t["x"], t["dy"], pt["idx"], res, st[0], None,
                                  st[1], None, hyp, vel=st[2], act=act,
                                  with_bias=False)
            upd(bsm.update_dw_ref, p_st)()

            def held(variant):
                """One Adam step through the entry point ``variant`` from
                the same state as the plain version's: (its state, the
                slots' relative error)."""
                st = [v.clone() for v in init]
                forced_call(P, variant, upd(bsm.update_dw, st))()
                if dtype == torch.float32:
                    w_err = rel_err(st[0] - t["w"], p_st[0] - t["w"])
                    w_ok = w_err <= 1e-4
                elif variant == "tc":
                    # wgmma sums in another order than the plain version
                    # (slots some 5e-6 apart, relative, SIMT 1e-7): where
                    # w - lr * step cancels to ~1e-8, that difference is
                    # more than a bf16 ulp of the result; held as the
                    # MoE update is
                    w_err = max_err(st[0], p_st[0])
                    w_ok = _adam_w_ok(st[0], p_st[0], t["w"], st[1],
                                      p_st[1], st[2], p_st[2])
                else:
                    w_err = max_err(st[0], p_st[0])
                    w_ok = close(st[0], p_st[0],
                                 dict(atol=0.0, rtol=2.0 ** -7))
                require(w_ok, f"update_dw ({variant}) {name} {dtype}: w "
                              f"differs ({w_err})")
                return st, max(rel_err(st[1], p_st[1]),
                               rel_err(st[2], p_st[2]))
            k_st, err = held(bsm.junction_variant(dtype, TRAIN_M, BS))
            rows.append(("update_dw", err, sum_tol,
                         max_err(k_st[1], p_st[1]), upd(bsm.update_dw, k_st),
                         upd(bsm.update_dw_ref, p_st),
                         _cost("update_dw", t, pt, act, n_slots=2)))
            if simt:
                s_st, s_err = held("simt")
                simt["update_dw"] = (s_err, forced_call(
                    P, "simt", upd(bsm.update_dw, s_st)))
            torch.cuda.synchronize()
            for kind, err, lim, abs_err, kfn, pfn, (nb, no) in rows:
                p_ms = timer.ms(pfn)
                if kind in simt:
                    s_err, sfn = simt[kind]
                    k_ms, s_ms = in_turns(timer, kfn, sfn)
                else:
                    k_ms = timer.ms(kfn)
                bnd, _ = _report(kind, name, dtype, act, err, lim, k_ms,
                                 p_ms, nb, no, card)
                o = out[kind]
                o["max_abs_err"] = max(o["max_abs_err"], abs_err)
                if kind in simt:
                    _report_tc(kind, name, act, k_ms, s_err, lim, s_ms, bnd,
                               nb, no, card)
                    o["simt_ms"] = o.get("simt_ms", 0.0) + s_ms
                if dtype == torch.bfloat16:     # one layer's FFN, bf16
                    o["ms"] += k_ms
                    o["plain_ms"] += p_ms
                    o["bytes"] += nb
                    o["ops"] += no
                    o["bound_ms"] += bnd
            del t, pt, k_st, p_st, rows, simt
    coverage_checks(P, gen)
    tc_coverage_checks(P, gen)
    for kind, o in out.items():
        nb, no = o.pop("bytes"), o.pop("ops")
        _, o["bound_by"] = bound_ms(nb, no, torch.bfloat16)
        o["library_ms"] = None
        simt = (f" (SIMT {o['simt_ms']:.4f}; {no / o['ms'] * 1e-9:.1f} "
                f"TFLOP/s)" if "simt_ms" in o else "")
        print(f"[kernel] junction_{kind} one layer's FFN (wg+wi+wo, "
              f"M={TRAIN_M}, bf16): ms={o['ms']:.4f}{simt} "
              f"plain_ms={o['plain_ms']:.4f} bound_ms={o['bound_ms']:.4f} "
              f"({o['bound_by']}) [{card}]")
    torch.cuda.empty_cache()
    return out


def _simt_row(P, kfn, want):
    """The SIMT entry point of a junction kernel on the inputs of
    ``kfn``, where the route takes the tensor cores: (its relative error
    against the plain version's outputs ``want``, its call for the
    timer)."""
    call = forced_call(P, "simt", kfn)
    got = call()
    got = got if isinstance(got, tuple) else (got,)
    return max(rel_err(g, w) for g, w in zip(got, want)), call


def _report_tc(kind, name, act, tc_ms, simt_err, lim, simt_ms, bnd, nbytes,
               nops, card, M=TRAIN_M):
    """The tensor-core entry point's rate beside the SIMT one's time, from
    the same inputs; the SIMT entry point held to the same tolerance."""
    print(f"[kernel] junction_{kind}_tc {name} M={M} bf16 act={act}: "
          f"ms={tc_ms:.4f} ({nops / tc_ms * 1e-9:.1f} TFLOP/s, "
          f"{100 * nops / tc_ms * 1e-9 / 989:.1f} % of the bf16 rate, "
          f"{100 * bnd / tc_ms:.1f} % of bound_ms {bnd:.4f}; "
          f"{nbytes / tc_ms * 1e-9:.2f} TB/s of the function's bytes); "
          f"SIMT ms={simt_ms:.4f} ({simt_ms / tc_ms:.1f}x) "
          f"rel_err={simt_err:.3g} (tol {lim:.3g}) [{card}]")
    require(simt_err <= lim, f"junction_{kind} (SIMT) {name} act={act}: "
                             f"rel_err {simt_err} > {lim}")


def tc_coverage_checks(P, gen):
    """The tensor-core entry points beyond the timed shapes: a ragged M
    (2000 rows: the last 128-row tile holds 80) at E = 2 with every
    activation, with and without bias and save_pre (fwd), with its
    residual (dx), with and without db (dw, through both entry points);
    then block sizes 32 and 64, which the route sends there too;
    gated_fwd, update_dw, update_gated_dw, gated_dx and gated_dw at a
    ragged M and blocks 128, 64 and 32, gated_dx's exact zeros for an
    input block that feeds nothing; then the identity of the tensor-core
    dw and gated_dw with the gradients the tensor-core updates step."""
    bsm = P.bsm
    lim = REL_TOL["bf16_out"]
    M = 2000
    for act in bsm.ACTIVATIONS:
        shape = TRAIN_SHAPES[0][:3] + (act, TRAIN_SHAPES[0][4])
        t, pt = _train_inputs(P, gen, shape, 2, torch.bfloat16, M=M)
        require(bsm.junction_variant(torch.bfloat16, M, BS) == "tc",
                "the route does not take M=2000 to the tensor cores")
        errs = []
        for bias in (True, False):
            b = t["b"] if bias else torch.zeros_like(t["b"])
            for pre in (True, False):
                args = (t["x"], t["w"], pt["idx"], b, act)
                got, want = (bsm.fwd(*args, save_pre=pre),
                             bsm.fwd_ref(*args, save_pre=pre))
                got, want = (got, want) if pre else ((got,), (want,))
                errs += [rel_err(g, w) for g, w in zip(got, want)]
        res = t["res"] if act != "none" else None
        rev = (pt["rev_ob"], pt["rev_t"], pt["rev_cnt"])
        errs.append(rel_err(bsm.dx(t["dy"], t["w"], *rev, res, act),
                            bsm.dx_ref(t["dy"], t["w"], *rev, res, act)))
        sums = _dw_errs(P, t, pt, res, act)
        print(f"[check] tensor cores act={act} E=2 M={M} bf16, bias and "
              f"save_pre on and off: fwd/pre/dx rel_err {max(errs):.3g} "
              f"(tol {lim:.3g}); dw/db rel_err tensor cores {sums['tc']:.3g}"
              f", SIMT {sums['simt']:.3g} (tol {REL_TOL['bf16_sum']:.3g})")
        require(max(errs) <= lim, f"tensor-core fwd/dx act={act} at M={M} "
                                  f"E=2 disagrees: {max(errs)}")
        require(max(sums.values()) <= REL_TOL["bf16_sum"],
                f"dw act={act} at M={M} E=2 disagrees: {sums}")
        del t, pt
    for bs in (32, 64):
        t, pt = _train_inputs(P, gen, TRAIN_SHAPES[0], 1, torch.bfloat16,
                              M=M, bs=bs)
        require(bsm.junction_variant(torch.bfloat16, M, bs) == "tc",
                f"the route does not take block {bs} to the tensor cores")
        args = (t["x"], t["w"], pt["idx"], t["b"], "silu")
        errs = [rel_err(g, w) for g, w in zip(bsm.fwd(*args, save_pre=True),
                                              bsm.fwd_ref(*args,
                                                          save_pre=True))]
        rev = (pt["rev_ob"], pt["rev_t"], pt["rev_cnt"])
        errs.append(rel_err(bsm.dx(t["dy"], t["w"], *rev, t["res"], "silu"),
                            bsm.dx_ref(t["dy"], t["w"], *rev, t["res"],
                                       "silu")))
        sums = _dw_errs(P, t, pt, t["res"], "silu")
        print(f"[check] tensor cores block {bs} M={M} bf16 silu, bias, "
              f"save_pre: fwd/pre/dx rel_err {max(errs):.3g} "
              f"(tol {lim:.3g}); dw/db rel_err tensor cores {sums['tc']:.3g}"
              f", SIMT {sums['simt']:.3g} (tol {REL_TOL['bf16_sum']:.3g})")
        require(max(errs) <= lim, f"tensor-core fwd/dx at block {bs} "
                                  f"disagrees: {max(errs)}")
        require(max(sums.values()) <= REL_TOL["bf16_sum"],
                f"dw at block {bs} disagrees: {sums}")
        del t, pt
    # gated_fwd at a ragged M (157 rows: a 29-row second tile), E = 2,
    # blocks 128, 64 and 32, with and without the saved residuals, both
    # entry points
    for bs in (BS, 64, 32):
        t, pt = _moe_inputs(P, gen, MOE_SHAPES[0], 2, 157, torch.bfloat16,
                            bs=bs)
        require(bsm.junction_variant(torch.bfloat16, 157, bs) == "tc",
                f"the route does not take gated_fwd at block {bs} to the "
                f"tensor cores")
        errs = {}
        for save in (True, False):
            args = (t["x"], t["w"], t["wi"], pt["idx"], save)
            want = bsm.gated_fwd_ref(*args)
            want = want if save else (want,)
            for v in ("tc", "simt"):
                got = forced_call(P, v, lambda: bsm.gated_fwd(*args))()
                got = got if save else (got,)
                errs[v] = max([errs.get(v, 0.0)] + [
                    rel_err(a, b) for a, b in zip(got, want)])
        print(f"[check] gated_fwd block {bs} E=2 M=157 bf16, save_res on "
              f"and off: h/g/u rel_err tensor cores {errs['tc']:.3g}, SIMT "
              f"{errs['simt']:.3g} (tol {lim:.3g})")
        require(max(errs.values()) <= lim,
                f"gated_fwd at block {bs} M=157 disagrees: {errs}")
        del t, pt
    # update_dw at a ragged M (2000), E = 2 with a per-unit hyp row and
    # bias, blocks 128, 64 and 32: SGD / momentum / Adam, poisoned tiles,
    # the zero-hyp freeze, through both entry points
    for bs in (BS, 64, 32):
        t, pt = _train_inputs(P, gen, TRAIN_SHAPES[0], 2, torch.bfloat16,
                              M=M, bs=bs)
        for opt in ("sgd", "momentum", "adam"):
            for case in ("poison", "freeze"):
                _update_case(P, gen, t, pt, torch.bfloat16, opt, case)
        del t, pt
    # update_gated_dw at a ragged M (157: a half-filled last K step), E = 2
    # with a per-unit hyp row, blocks 128, 64 and 32, both entry points
    for bs in (BS, 64, 32):
        for opt in ("sgd", "momentum", "adam"):
            for case in ("poison", "freeze"):
                _gated_update_case(P, gen, torch.bfloat16, opt, case, M=157,
                                   bs=bs)
    # gated_dx and gated_dw at a ragged M (157: a 29-row second tile, a
    # half-filled last K step), E = 2, blocks 128, 64 and 32, both entry
    # points
    for bs in (BS, 64, 32):
        t, pt = _moe_inputs(P, gen, MOE_SHAPES[0], 2, 157, torch.bfloat16,
                            bs=bs)
        dx_args = (t["dy"], t["w"], t["wi"], pt["rev_ob"], pt["rev_t"],
                   pt["rev_cnt"], t["g"], t["u"])
        dw_args = (t["x"], t["dy"], pt["idx"], t["g"], t["u"])
        dx_want, dw_want = bsm.gated_dx_ref(*dx_args), bsm.gated_dw_ref(
            *dw_args)
        errs = {}
        for v in ("tc", "simt"):
            dxv = forced_call(P, v, lambda: bsm.gated_dx(*dx_args))()
            dwv = forced_call(P, v, lambda: bsm.gated_dw(*dw_args))()
            errs[v] = (rel_err(dxv, dx_want),
                       max(rel_err(a, b) for a, b in zip(dwv, dw_want)))
        print(f"[check] gated_dx / gated_dw block {bs} E=2 M=157 bf16: "
              f"rel_err tensor cores {errs['tc'][0]:.3g} / "
              f"{errs['tc'][1]:.3g}, SIMT {errs['simt'][0]:.3g} / "
              f"{errs['simt'][1]:.3g} (tol {lim:.3g} / "
              f"{REL_TOL['bf16_sum']:.3g})")
        require(all(e[0] <= lim and e[1] <= REL_TOL["bf16_sum"]
                    for e in errs.values()),
                f"gated_dx / gated_dw at block {bs} M=157 disagree: {errs}")
        del t, pt, dx_want, dw_want, dxv, dwv
    # input blocks 1 and 2 feed no output block (both outputs read block
    # 0) and dh is inf everywhere: their dx is exact zeros, block 0's is
    # not finite, through both entry points
    idx = np.zeros((2, 1), np.int32)
    rev = P.reverse_block_pattern(idx, 3)
    require(list(rev[2]) == [2, 0, 0], f"reverse pattern {rev}")
    rev = [torch.as_tensor(v, device="cuda") for v in rev]
    r = lambda *sh: torch.randn(sh, generator=gen, device="cuda").to(
        torch.bfloat16)
    dh = torch.full((2, 157, 2 * BS), float("inf"), device="cuda").to(
        torch.bfloat16)
    args = (dh, r(2, 2, 1, BS, BS), r(2, 2, 1, BS, BS), *rev,
            r(2, 157, 2 * BS), r(2, 157, 2 * BS))
    for v in ("tc", "simt"):
        got = forced_call(P, v, lambda: bsm.gated_dx(*args))().float()
        zeros = bool((got[..., BS:] == 0).all()) and not bool(
            torch.signbit(got[..., BS:]).any())
        fed = not bool(torch.isfinite(got[..., :BS]).any())
        print(f"[check] gated_dx ({v}) input blocks that feed nothing, dh "
              f"inf: exact zeros {zeros}, the fed block non-finite {fed}")
        require(zeros and fed, f"gated_dx ({v}): padded reverse slots read")
    gradient_identity_check(P, gen)


def _dw_errs(P, t, pt, res, act):
    """dw and db through each entry point at E = 2 with and without the
    bias, against the plain version: the worst relative error of each."""
    bsm = P.bsm
    errs = {}
    for bias in (True, False):
        args = (t["x"], t["dy"], pt["idx"], res, act, bias)
        want = bsm.dw_ref(*args)
        for v in ("tc", "simt"):
            got = forced_call(P, v, lambda: bsm.dw(*args))()
            errs[v] = max([errs.get(v, 0.0)] + [
                rel_err(a, b) for a, b in zip(got, want) if b is not None])
    return errs


def gradient_identity_check(P, gen):
    """The tensor-core dw against the gradient the tensor-core update_dw
    steps: with an SGD + momentum hyp row of lr 0, b1 0, gs 1, wd 0 and
    zero slots, the update leaves mom = b1 * 0 + gs * acc, the fp32
    gradient itself, and w and b as they were.  mom must equal dw, and
    mom_b db, bit for bit, at the wg junction (silu) and qwen3-moe's down
    junction: the clip pre-pass's norm is then the norm of the gradient
    the fused update applies.  Likewise the tensor-core gated_dw's dwg
    and dwi against the mg and mi of the tensor-core update_gated_dw at
    qwen3-moe's gate junction."""
    bsm = P.bsm
    hyp = torch.tensor([0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0], device="cuda")
    for shape, E, M in ((TRAIN_SHAPES[0], 1, TRAIN_M),
                        (("moe wo", 768, 2048, "none", 1), MOE_E,
                         MOE_M["train"])):
        name, _, _, act, _ = shape
        t, pt = _train_inputs(P, gen, shape, E, torch.bfloat16, M=M)
        require(bsm.junction_variant(torch.bfloat16, M, BS) == "tc",
                f"the route does not take {name} M={M} to the tensor cores")
        res = t["res"] if act != "none" else None
        tc0 = P.ops.tc_launch_counts()
        dwv, db = bsm.dw(t["x"], t["dy"], pt["idx"], res, act, True)
        w, b = t["w"].clone(), t["b"].clone()
        mom = torch.zeros(w.shape, device="cuda")
        mom_b = torch.zeros(b.shape, device="cuda")
        bsm.update_dw(t["x"], t["dy"], pt["idx"], res, w, b, mom, mom_b, hyp,
                      act=act, with_bias=True)
        torch.cuda.synchronize()
        tc1 = P.ops.tc_launch_counts()
        on_tc = all(tc1[k] == tc0[k] + 1
                    for k in ("junction_dw", "junction_update_dw"))
        same = torch.equal(mom, dwv) and torch.equal(mom_b, db)
        kept = torch.equal(w, t["w"]) and torch.equal(b, t["b"])
        print(f"[check] dw_tc vs update_dw_tc's gradient {name} E={E} M={M} "
              f"act={act}: dw and db bit for bit {same}, w and b kept "
              f"{kept}, both on tensor cores {on_tc}")
        require(same and kept and on_tc,
                f"dw_tc and update_dw_tc's gradient differ at {name}")
        del t, pt, dwv, db, w, b, mom, mom_b
    M = MOE_M["train"]
    t, pt = _moe_inputs(P, gen, MOE_SHAPES[0], MOE_E, M, torch.bfloat16)
    args = (t["x"], t["dy"], pt["idx"], t["g"], t["u"])
    tc0 = P.ops.tc_launch_counts()
    dwg, dwi = bsm.gated_dw(*args)
    wg, wi = t["w"].clone(), t["wi"].clone()
    mg, mi = torch.zeros(wg.shape, device="cuda"), torch.zeros(
        wi.shape, device="cuda")
    bsm.update_gated_dw(*args, wg, wi, mg, mi, hyp)
    torch.cuda.synchronize()
    tc1 = P.ops.tc_launch_counts()
    on_tc = all(tc1[k] == tc0[k] + 1
                for k in ("junction_gated_dw", "junction_update_gated_dw"))
    same = torch.equal(mg, dwg) and torch.equal(mi, dwi)
    kept = torch.equal(wg, t["w"]) and torch.equal(wi, t["wi"])
    print(f"[check] gated_dw_tc vs update_gated_dw_tc's gradients gate "
          f"E={MOE_E} M={M}: dwg and dwi bit for bit {same}, wg and wi kept "
          f"{kept}, both on tensor cores {on_tc}")
    require(same and kept and on_tc,
            "gated_dw_tc and update_gated_dw_tc's gradients differ")
    del t, pt, dwg, dwi, wg, wi, mg, mi


def coverage_checks(P, gen):
    """Every activation with bias at E = 2 (fwd with its residual, dx,
    dw and db), then update_dw under SGD, SGD+momentum and Adam with a
    per-unit hyp table: kernel against plain version, the health counts
    of two poisoned tiles of unit 1, and the bit-for-bit freeze of a unit
    whose hyp row is zero."""
    bsm = P.bsm
    for act in bsm.ACTIVATIONS:
        shape = TRAIN_SHAPES[0][:3] + (act, TRAIN_SHAPES[0][4])
        t, pt = _train_inputs(P, gen, shape, 2, torch.bfloat16)
        res = t["res"] if act != "none" else None
        pre = act in bsm.ACT_NEEDS_PRE
        got = bsm.fwd(t["x"], t["w"], pt["idx"], t["b"], act, save_pre=pre)
        want = bsm.fwd_ref(t["x"], t["w"], pt["idx"], t["b"], act,
                           save_pre=pre)
        got, want = (got, want) if pre else ((got,), (want,))
        errs = [rel_err(g, w) for g, w in zip(got, want)]
        rev = (pt["rev_ob"], pt["rev_t"], pt["rev_cnt"])
        errs.append(rel_err(bsm.dx(t["dy"], t["w"], *rev, res, act),
                            bsm.dx_ref(t["dy"], t["w"], *rev, res, act)))
        kdw, kdb = bsm.dw(t["x"], t["dy"], pt["idx"], res, act, True)
        pdw, pdb = bsm.dw_ref(t["x"], t["dy"], pt["idx"], res, act, True)
        sums = [rel_err(kdw, pdw), rel_err(kdb, pdb)]
        print(f"[check] act={act} E=2 bf16 bias: fwd/dx rel_err "
              f"{max(errs):.3g}, dw/db rel_err {max(sums):.3g}")
        require(max(errs) <= REL_TOL["bf16_out"]
                and max(sums) <= REL_TOL["bf16_sum"],
                f"activation {act} with bias at E=2 disagrees")
    shape = TRAIN_SHAPES[0]
    for dtype in (torch.bfloat16, torch.float32):
        t, pt = _train_inputs(P, gen, shape, 2, dtype)
        for opt in ("sgd", "momentum", "adam"):
            for case in ("poison", "freeze"):
                _update_case(P, gen, t, pt, dtype, opt, case)


def _update_case(P, gen, t, pt, dtype, opt, case):
    """update_dw at E = 2 with a per-unit hyp table (silu, bias), through
    the routed entry point and, where that is the tensor cores, the SIMT
    one too, each against the plain version.  "poison": two tiles of unit
    1 get an inf gradient and are counted; "freeze": unit 1's hyp row is
    zero and its weights stay as they were, bit for bit."""
    bsm = P.bsm
    M, bs = t["x"].shape[1], t["w"].shape[-1]
    hyp = torch.tensor([ADAM_HYP, ADAM_HYP], device="cuda")
    hyp[1, 0] = 2e-3                                     # unit 1's own lr
    if opt != "adam":
        hyp[:, 2:6] = 0.0
        hyp[:, 6] = 1.0
        if opt == "sgd":
            hyp[:, 1] = 0.0
    dy = t["dy"].clone()
    if case == "poison":
        dy[1, 0, 3 * BS] = float("inf")
        dy[1, 5, 7 * BS + 3] = float("inf")
    else:
        hyp[1] = 0.0
    w0, b0 = t["w"], t["b"]
    (mom, vel), (mom_b, vel_b) = (_adam_slots(gen, w0.shape),
                                  _adam_slots(gen, b0.shape))
    slots = [mom, mom_b, vel, vel_b]
    use = {"sgd": (False, False), "momentum": (True, False),
           "adam": (True, True)}[opt]
    route = bsm.junction_variant(dtype, M, bs)
    runs = {}
    for v in [route] + (["simt"] if route == "tc" else []) + ["plain"]:
        w, b = w0.clone(), b0.clone()
        m, mb, vl, vb = (x.clone() for x in slots)

        def run(fn):
            return fn(t["x"], dy, pt["idx"], t["res"], w, b,
                      m if use[0] else None, mb if use[0] else None, hyp,
                      vel=vl if use[1] else None,
                      vel_b=vb if use[1] else None, act="silu",
                      with_bias=True, with_health=True)
        h = (run(bsm.update_dw_ref) if v == "plain"
             else forced_call(P, v, lambda: run(bsm.update_dw))())
        runs[v] = (w, b, m, vl, h)
    torch.cuda.synchronize()
    pw, pb, pm, pv, ph = runs.pop("plain")
    lim = REL_TOL["fp32" if dtype == torch.float32 else "bf16_sum"]
    for v, (kw, kb, km, kv, kh) in runs.items():
        err = rel_err(km[0], pm[0]) if use[0] else 0.0
        w_ok = close(kw[0], pw[0], dict(atol=1e-6, rtol=2.0 ** -7))
        line = (f"[check] update_dw ({v}) {opt} {case} E=2 M={M} block {bs} "
                f"{str(dtype)[6:]} bias: health kernel {kh.tolist()} plain "
                f"{ph.tolist()}, unit-0 slot rel_err {err:.3g}")
        if case == "poison":
            require(kh.tolist() == ph.tolist() == [0, 2],
                    f"health counts wrong: {line}")
        else:
            frozen = (torch.equal(kw[1], w0[1]) and torch.equal(kb[1], b0[1])
                      and not torch.equal(kw[0], w0[0]))
            line += f", unit 1 frozen bit for bit: {frozen}"
            require(frozen, f"zero hyp row did not freeze unit 1: {line}")
            require(kh.tolist() == [0, 0], f"health counts wrong: {line}")
        print(line)
        require(w_ok and err <= lim, f"update_dw disagrees: {line}")


# ------------------------------------------------------ MoE expert kernels
# the expert junctions of qwen3-moe-30b-a3b (d_model 2048, d_expert 768)
# at density 0.25, block 128, with moe_init's pattern seeds; 128 experts
MOE_SHAPES = [("in", 2048, 768, 0), ("out", 768, 2048, 1)]
MOE_E = 128
# rows an expert: the capacity C of a decode tick or a prefill chunk, and
# of a training batch of 2048 tokens (models/moe.moe_dispatch_dims)
MOE_M = {"decode": 4, "train": 160}
# training depth: Adam's two-pass state for all 48 layers (9.59 B
# parameters) would need some 154 GB; 6 layers (1.74 B) fit one card
MOE_TRAIN_LAYERS = 6


def _moe_inputs(P, gen, shape, E, M, dtype, bs=BS):
    """Operands of both junction forms at one expert-junction shape: x,
    dy (dh), w and wi (the gate's two streams), and the gate residuals g
    and u as the forward leaves them."""
    _, n_in, n_out, pseed = shape
    pat = P.make_block_pattern(n_in, n_out, 0.25, bs, seed=pseed)
    nob, kb = pat.idx.shape
    r = lambda *sh: torch.randn(sh, generator=gen, device="cuda")
    t = {"x": r(E, M, n_in), "dy": r(E, M, n_out),
         "w": r(E, nob, kb, bs, bs) / (kb * bs) ** 0.5,
         "wi": r(E, nob, kb, bs, bs) / (kb * bs) ** 0.5,
         "g": r(E, M, n_out), "u": r(E, M, n_out)}
    t = {k: v.to(dtype).contiguous() for k, v in t.items()}
    pt = {k: torch.as_tensor(getattr(pat, k), device="cuda")
          for k in ("idx", "rev_ob", "rev_t", "rev_cnt")}
    return t, pt


def _gated_cost(kind, t, pt, n_slots=0, save_res=False):
    """(bytes, operations) of a gated kernel: each operand read once, each
    output written once; two streams of 2 operations per multiply-add over
    the edges of the pattern."""
    isz = t["x"].element_size()
    E, M, n_in = t["x"].shape
    n_out = t["dy"].shape[2]
    xb, yb, wb = E * M * n_in * isz, E * M * n_out * isz, t["w"].numel()
    ints = 4 * sum(v.numel() for v in pt.values())
    edges = (int(pt["rev_cnt"].sum()) if kind == "gated_dx"
             else pt["idx"].numel())
    nops = 2 * 2 * E * M * edges * BS * BS
    if kind == "gated_fwd":         # x, wg, wi in; h (and g, u) out
        return xb + 2 * wb * isz + yb * (3 if save_res else 1) + ints, nops
    if kind == "gated_dx":          # dh, g, u, wg, wi in; dx out
        return 3 * yb + 2 * wb * isz + xb + ints, nops
    if kind == "gated_dw":          # x, dh, g, u in; dwg, dwi fp32 out
        return xb + 3 * yb + 2 * 4 * wb + ints, nops
    # update_gated_dw: x, dh, g, u in; both streams and slots read, written
    return (xb + 3 * yb + 2 * (2 * wb * isz + 8 * n_slots * wb) + ints,
            nops)


def _adam_w_ok(kw, pw, w0, km, pm, kv, pv) -> bool:
    """Weights after one ADAM_HYP step through the kernel (kw, with its
    slots km, kv) and through the plain version (pw, pm, pv).  fp32: the
    two weight changes within 1e-4 of each other, relative.  bf16: each
    weight within one bf16 rounding of the plain one, plus the step
    difference its two sets of slots imply (the slots differ by summation
    order; near zero that difference is more than a bf16 ulp), plus two
    fp32 roundings of w (the kernel fuses w - lr * step into one FMA: where
    the step cancels w almost exactly, that rounding is all that is
    left)."""
    if kw.dtype == torch.float32:
        return rel_err(kw - w0, pw - w0) <= 1e-4
    lr, b1, b2, eps, _, t, _ = ADAM_HYP
    c1, c2 = 1.0 - b1 ** t, 1.0 - b2 ** t

    def step(m, v):
        return (m / c1) / (torch.sqrt(v / c2) + eps)

    slack = lr * (step(km, kv) - step(pm, pv)).abs() * (1 + 1e-3) \
        + 2.0 ** -22 * w0.float().abs()
    diff = (kw.float() - pw.float()).abs()
    return bool((diff <= 2.0 ** -7 * pw.float().abs() + slack).all())


def _sgd_w_ok(kw, pw, w0) -> bool:
    """bf16 weights after one SGD (+ momentum) step through a gated
    kernel (kw) and through the plain version (pw): each weight within
    one bf16 rounding of the plain one, plus the difference in the step
    that the gradient's own tolerance allows (``bf16_sum`` of the largest
    weight change: a dz element whose fp32 value differs in its last bit
    (the kernels' one FMA of 1 + g (1 - s) against the plain version's two
    roundings) and rounds to the other bf16 neighbour moves a whole
    column of the gradient by up to a bf16 ulp of dz), plus
    two fp32 roundings of w.  The step difference matters only where
    w - lr * g cancels w almost exactly."""
    change = (pw.float() - w0.float()).abs().max()
    slack = REL_TOL["bf16_sum"] * change + 2.0 ** -22 * w0.float().abs()
    diff = (kw.float() - pw.float()).abs()
    return bool((diff <= 2.0 ** -7 * pw.float().abs() + slack).all())


def moe_kernel_phase(P, timer, card):
    """The four gated kernels at the gate junction of qwen3-moe's experts
    (E = 128, 2048 -> 768) and the plain kernels at its down junction
    (768 -> 2048), at the decode rows (M = 4) and the training rows
    (M = 160), bf16 and fp32: each against its plain version and timed,
    all eight through both entry points in bf16.
    Then SGD / momentum / Adam, the health counts of tiles poisoned in one
    branch or both, and the zero-hyp freeze of the gated update."""
    bsm = P.bsm
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    out = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
               "bound_ms": 0.0, "bound_by": "", "library_ms": None}
           for k in ("gated_fwd", "gated_dx", "gated_dw", "update_gated_dw")}
    plain = {k: {} for k in ("fwd", "dx", "dw", "update_dw")}
    hyp = torch.tensor(ADAM_HYP, device="cuda")
    for dtype in (torch.bfloat16, torch.float32):
        out_tol = REL_TOL["fp32" if dtype == torch.float32 else "bf16_out"]
        sum_tol = REL_TOL["fp32" if dtype == torch.float32 else "bf16_sum"]
        for where, M in MOE_M.items():
            # the gate junction through the gated kernels
            t, pt = _moe_inputs(P, gen, MOE_SHAPES[0], MOE_E, M, dtype)
            rev = (pt["rev_ob"], pt["rev_t"], pt["rev_cnt"])
            save = where == "train"
            fwd_args = (t["x"], t["w"], t["wi"], pt["idx"], save)
            got = bsm.gated_fwd(*fwd_args)
            want = bsm.gated_fwd_ref(*fwd_args)
            got, want = (got, want) if save else ((got,), (want,))
            rows = [("gated_fwd", max(rel_err(a, b) for a, b in
                                      zip(got, want)), out_tol,
                     max_err(got[0], want[0]),
                     lambda: bsm.gated_fwd(*fwd_args),
                     lambda: bsm.gated_fwd_ref(*fwd_args),
                     _gated_cost("gated_fwd", t, pt, save_res=save))]
            simt = ({"gated_fwd": _simt_row(P, rows[0][4], want)}
                    if bsm.junction_variant(dtype, M, BS) == "tc" else {})
            dx_args = (t["dy"], t["w"], t["wi"], *rev, t["g"], t["u"])
            got, want = bsm.gated_dx(*dx_args), bsm.gated_dx_ref(*dx_args)
            rows.append(("gated_dx", rel_err(got, want), out_tol,
                         max_err(got, want), lambda: bsm.gated_dx(*dx_args),
                         lambda: bsm.gated_dx_ref(*dx_args),
                         _gated_cost("gated_dx", t, pt)))
            if simt:
                simt["gated_dx"] = _simt_row(P, rows[-1][4], (want,))
            dw_args = (t["x"], t["dy"], pt["idx"], t["g"], t["u"])
            got, want = bsm.gated_dw(*dw_args), bsm.gated_dw_ref(*dw_args)
            rows.append(("gated_dw", max(rel_err(a, b) for a, b in
                                         zip(got, want)), sum_tol,
                         max(max_err(a, b) for a, b in zip(got, want)),
                         lambda: bsm.gated_dw(*dw_args),
                         lambda: bsm.gated_dw_ref(*dw_args),
                         _gated_cost("gated_dw", t, pt)))
            if simt:
                simt["gated_dw"] = _simt_row(P, rows[-1][4], want)
            del got, want
            mom, vel = _adam_slots(gen, t["w"].shape)
            # the routed entry point, the plain version, the SIMT one
            states = [[t["w"].clone(), t["wi"].clone(), mom.clone(),
                       mom.clone(), vel.clone(), vel.clone()]
                      for _ in range(3)]

            def upd(fn, st):
                return lambda: fn(*dw_args, st[0], st[1], st[2], st[3], hyp,
                                  vg=st[4], vi=st[5])
            upd(bsm.update_gated_dw_ref, states[1])()
            pw, pwi, *ps = states[1]
            errs = {}
            for i, v in ((0, None), (2, "simt")):
                if v is not None and not simt:
                    continue
                fn = upd(bsm.update_gated_dw, states[i])
                (forced_call(P, v, fn) if v else fn)()
                kw, kwi, *ks = states[i]
                w_ok = (_adam_w_ok(kw, pw, t["w"], ks[0], ps[0], ks[2],
                                   ps[2])
                        and _adam_w_ok(kwi, pwi, t["wi"], ks[1], ps[1],
                                       ks[3], ps[3]))
                require(w_ok, f"update_gated_dw ({v or 'routed'}) {where} "
                              f"{dtype}: weights differ (max_abs_err "
                              f"{max_err(kw, pw):.3g}, "
                              f"{max_err(kwi, pwi):.3g})")
                errs[v] = (max(rel_err(a, b) for a, b in zip(ks, ps)),
                           max(max_err(a, b) for a, b in zip(ks, ps)))
            rows.append(("update_gated_dw", errs[None][0], sum_tol,
                         errs[None][1],
                         upd(bsm.update_gated_dw, states[0]),
                         upd(bsm.update_gated_dw_ref, states[1]),
                         _gated_cost("update_gated_dw", t, pt, n_slots=2)))
            if simt:
                simt["update_gated_dw"] = (errs["simt"][0], forced_call(
                    P, "simt", upd(bsm.update_gated_dw, states[2])))
            torch.cuda.synchronize()
            for kind, err, lim, abs_err, kfn, pfn, cost in rows:
                p_ms = timer.ms(pfn)
                if kind in simt:
                    s_err, sfn = simt[kind]
                    k_ms, s_ms = in_turns(timer, kfn, sfn)
                else:
                    k_ms = timer.ms(kfn)
                bnd, by = _report(kind, f"in E={MOE_E}", dtype, "silu-gate",
                                  err, lim, k_ms, p_ms, *cost, card, M=M)
                if kind in simt:
                    _report_tc(kind, f"in E={MOE_E}", "silu-gate", k_ms,
                               s_err, lim, s_ms, bnd, *cost, card, M=M)
                o = out[kind]
                o["max_abs_err"] = max(o["max_abs_err"], abs_err)
                # the JSON line: the serving shape for the forward, the
                # training shape for the backward kernels; bf16
                if dtype == torch.bfloat16 and (
                        (kind == "gated_fwd") == (where == "decode")):
                    o.update(ms=k_ms, plain_ms=p_ms, bound_ms=bnd,
                             bound_by=by)
                    if kind in simt:
                        o["simt_ms"] = s_ms
                if kind == "gated_fwd" and dtype == torch.bfloat16 \
                        and where == "train":
                    o.update(train_ms=k_ms, train_plain_ms=p_ms,
                             train_bound_ms=bnd)
                    if kind in simt:
                        o["train_simt_ms"] = s_ms
            del t, pt, states, rows, simt
            # the down junction through the plain kernels at E = 128
            t, pt = _moe_inputs(P, gen, MOE_SHAPES[1], MOE_E, M, dtype)
            zb = torch.zeros((MOE_E, t["dy"].shape[2]), dtype=dtype,
                             device="cuda")
            rev = (pt["rev_ob"], pt["rev_t"], pt["rev_cnt"])
            checks = {
                "fwd": (lambda: bsm.fwd(t["x"], t["w"], pt["idx"], zb),
                        lambda: bsm.fwd_ref(t["x"], t["w"], pt["idx"], zb),
                        out_tol),
                "dx": (lambda: bsm.dx(t["dy"], t["w"], *rev),
                       lambda: bsm.dx_ref(t["dy"], t["w"], *rev), out_tol),
                "dw": (lambda: bsm.dw(t["x"], t["dy"], pt["idx"],
                                      with_bias=False)[0],
                       lambda: bsm.dw_ref(t["x"], t["dy"], pt["idx"],
                                          with_bias=False)[0], sum_tol)}
            for kind, (kfn, pfn, lim) in checks.items():
                if kind != "fwd" and where == "decode":
                    continue        # the backward runs at training rows only
                want = pfn()
                err = rel_err(kfn(), want)
                k_ms, p_ms = timer.ms(kfn), timer.ms(pfn)
                cost = _cost(kind, t, pt, "none")
                bnd, _ = _report(kind, f"wo E={MOE_E}", dtype, "none", err,
                                 lim, k_ms, p_ms, *cost, card, M=M)
                row = (k_ms, p_ms, bnd)
                if kind in ("fwd", "dx", "dw") and \
                        bsm.junction_variant(dtype, M, BS) == "tc":
                    s_err, sfn = _simt_row(P, kfn, (want,))
                    s_ms = timer.ms(sfn)
                    _report_tc(kind, f"wo E={MOE_E}", "none", k_ms, s_err,
                               lim, s_ms, bnd, *cost, card, M=M)
                    row += (s_ms,)
                if dtype == torch.bfloat16:
                    plain[kind][where] = row
            if where == "train":
                mom, vel = _adam_slots(gen, t["w"].shape)
                init = (t["w"], mom, vel)
                p_st = [v.clone() for v in init]

                def upd1(fn, st):
                    return lambda: fn(t["x"], t["dy"], pt["idx"], None, st[0],
                                      None, st[1], None, hyp, vel=st[2],
                                      with_bias=False)
                upd1(bsm.update_dw_ref, p_st)()
                route = bsm.junction_variant(dtype, M, BS)
                sts, errs = {}, {}
                for v in [route] + (["simt"] if route == "tc" else []):
                    sts[v] = st = [x.clone() for x in init]
                    forced_call(P, v, upd1(bsm.update_dw, st))()
                    require(_adam_w_ok(st[0], p_st[0], t["w"], st[1],
                                       p_st[1], st[2], p_st[2]),
                            f"update_dw ({v}) wo E={MOE_E} {dtype}: weights "
                            f"differ ({max_err(st[0], p_st[0]):.3g})")
                    errs[v] = max(rel_err(st[1], p_st[1]),
                                  rel_err(st[2], p_st[2]))
                kfn = upd1(bsm.update_dw, sts[route])
                p_ms = timer.ms(upd1(bsm.update_dw_ref, p_st))
                cost = _cost("update_dw", t, pt, "none", n_slots=2)
                if route == "tc":
                    k_ms, s_ms = in_turns(timer, kfn, forced_call(
                        P, "simt", upd1(bsm.update_dw, sts["simt"])))
                else:
                    k_ms = timer.ms(kfn)
                bnd, _ = _report("update_dw", f"wo E={MOE_E}", dtype, "none",
                                 errs[route], sum_tol, k_ms, p_ms, *cost,
                                 card, M=M)
                row = (k_ms, p_ms, bnd)
                if route == "tc":
                    _report_tc("update_dw", f"wo E={MOE_E}", "none", k_ms,
                               errs["simt"], sum_tol, s_ms, bnd, *cost, card,
                               M=M)
                    row += (s_ms,)
                if dtype == torch.bfloat16:
                    plain["update_dw"][where] = row
                del sts
            del t, pt
    for dtype in (torch.bfloat16, torch.float32):
        for opt in ("sgd", "momentum", "adam"):
            for case in ("poison", "freeze"):
                _gated_update_case(P, gen, dtype, opt, case)
    torch.cuda.empty_cache()
    return out, plain


def _gated_update_case(P, gen, dtype, opt, case, M=MOE_M["train"], bs=BS):
    """update_gated_dw at E = 2 with a per-unit hyp table, through the
    routed entry point and, where that is the tensor cores, the SIMT one
    too, each against the plain version.  "poison": unit 1 gets a
    non-finite gradient in the wg branch only (u = inf) of output block
    1, in the wi branch only (silu(g) * dh overflows) of block 3 and in
    both of block 5: three tiles, each counted once.  "freeze": unit 1's
    hyp row is zero and its weights stay as they were, bit for bit."""
    bsm = P.bsm
    t, pt = _moe_inputs(P, gen, MOE_SHAPES[0], 2, M, dtype, bs=bs)
    hyp = torch.tensor([ADAM_HYP, ADAM_HYP], device="cuda")
    hyp[1, 0] = 2e-3                                     # unit 1's own lr
    if opt != "adam":
        hyp[:, 2:6] = 0.0
        hyp[:, 6] = 1.0
        if opt == "sgd":
            hyp[:, 1] = 0.0
    dh, g, u = t["dy"].clone(), t["g"].clone(), t["u"].clone()
    if case == "poison":
        for o, wg_br, wi_br in ((1, True, False), (3, False, True),
                                (5, True, True)):
            col = o * bs + 7
            dh[1, 2, col] = 4.0
            if wg_br:
                u[1, 2, col] = float("inf")
            if wi_br:
                g[1, 2, col] = 3e38
    else:
        hyp[1] = 0.0
    use = {"sgd": (False, False), "momentum": (True, False),
           "adam": (True, True)}[opt]
    mom, vel = _adam_slots(gen, t["w"].shape)
    route = bsm.junction_variant(dtype, M, bs)
    runs = {}
    for v in [route] + (["simt"] if route == "tc" else []) + ["plain"]:
        wg, wi = t["w"].clone(), t["wi"].clone()
        mg, mi, vg, vi = mom.clone(), mom.clone(), vel.clone(), vel.clone()

        def run(fn):
            return fn(t["x"], dh, pt["idx"], g, u, wg, wi,
                      mg if use[0] else None, mi if use[0] else None, hyp,
                      vg=vg if use[1] else None, vi=vi if use[1] else None,
                      with_health=True)
        h = (run(bsm.update_gated_dw_ref) if v == "plain"
             else forced_call(P, v, lambda: run(bsm.update_gated_dw))())
        runs[v] = (wg, wi, mg, mi, vg, vi, h)
    torch.cuda.synchronize()
    pwg, pwi, pmg, pmi, pvg, pvi, ph = runs.pop("plain")
    lim = REL_TOL["fp32" if dtype == torch.float32 else "bf16_sum"]
    for v, (kwg, kwi, kmg, kmi, kvg, kvi, kh) in runs.items():
        err = max(rel_err(kmg[0], pmg[0]), rel_err(kmi[0], pmi[0])) \
            if use[0] else 0.0
        if dtype == torch.float32:
            w_ok = all(close(a[0], b[0], dict(atol=1e-6, rtol=2.0 ** -7))
                       for a, b in ((kwg, pwg), (kwi, pwi)))
        elif use[1]:
            # unit 0 steps at ADAM_HYP: held as the update_dw is where
            # w - lr * step cancels to the summation-order noise
            w_ok = (_adam_w_ok(kwg[0], pwg[0], t["w"][0], kmg[0], pmg[0],
                               kvg[0], pvg[0])
                    and _adam_w_ok(kwi[0], pwi[0], t["wi"][0], kmi[0],
                                   pmi[0], kvi[0], pvi[0]))
        else:
            w_ok = (_sgd_w_ok(kwg[0], pwg[0], t["w"][0])
                    and _sgd_w_ok(kwi[0], pwi[0], t["wi"][0]))
        line = (f"[check] update_gated_dw ({v}) {opt} {case} E=2 M={M} "
                f"block {bs} {str(dtype)[6:]}: health kernel {kh.tolist()} "
                f"plain {ph.tolist()}, unit-0 slot rel_err {err:.3g}")
        if case == "poison":
            require(kh.tolist() == ph.tolist() == [0, 3],
                    f"health counts wrong: {line}")
        else:
            frozen = (torch.equal(kwg[1], t["w"][1])
                      and torch.equal(kwi[1], t["wi"][1])
                      and not torch.equal(kwg[0], t["w"][0]))
            line += f", unit 1 frozen bit for bit: {frozen}"
            require(frozen, f"zero hyp row did not freeze unit 1: {line}")
            require(kh.tolist() == [0, 0], f"health counts wrong: {line}")
        print(line)
        require(w_ok and err <= lim, f"update_gated_dw disagrees: {line}")


# ------------------------------------------------------------ train phase
def _expected_launches(P, cfg, n_steps, kind):
    """Junction launches a step implies: a forward's junctions
    (``junction_calls``), run again by the per-layer recompute but the
    hybrid's shared block's (``shared_block_calls``), which the reference
    and the port never recompute; the norm pre-pass of a clipped fused
    step a plain forward and backward of its own."""
    r = 2 if cfg.remat else 1
    kept = shared_block_calls(cfg)
    want = dict.fromkeys(P.ops.launch_counts(), 0)
    for name, J in junction_calls(cfg).items():
        g = "gated_" if "gated" in name else ""
        fwd, dx, dw = (f"junction_{g}{k}" for k in ("fwd", "dx", "dw"))
        upd = f"junction_update_{g}dw"
        F = r * J - (r - 1) * (kept if name == "junction_fwd" else 0)
        per = {"two_pass": {fwd: F, dx: J, dw: J},
               "fused_clip": {fwd: 2 * F, dx: 2 * J, dw: J, upd: J},
               "fused": {fwd: F, dx: J, upd: J}}[kind]
        for k, v in per.items():
            want[k] += v * n_steps
    return want


def _expected_tc(P, cfg, want):
    """Of the expected launches, those of the tensor-core entry points:
    every junction launch (plain and gated fwd, dx, dw and update) of the
    path where the route takes its compute dtype at its junctions' rows
    (M = 2048 a dense, ssm or hybrid junction, the capacity C = 160 an
    expert) to the tensor cores, else none."""
    rows = MOE_M["train"] if cfg.family == "moe" else TRAIN_M
    tc = P.bsm.junction_variant(getattr(torch, cfg.dtype), rows, BS) == "tc"
    return {k: want[k] if tc else 0 for k in P.ops.tc_launch_counts()}


def train_run(P, cfg, opt, kind, card, n_steps=3):
    """n_steps (2 or more) of make_train_step on ``cfg`` (random weights
    from seed 0, LMTokenPipeline batch 8 x 256): finite losses, no
    non-finite update, memory held flat, exact launch counts.  Returns
    (the path's launch counts, {"step_s": the median of the steps after
    the first, which warms up; "device_ms": the kernels' time of one
    more step; "peak_gib": the peak allocated over the steps})."""
    ok, why = P.steps.fused_update_eligible(cfg, opt)
    require(ok == (kind != "two_pass"), f"{kind}: eligibility {ok} ({why})")
    params = P.M.init(cfg, seed=0, device="cuda")
    opt_state = opt.init(params)
    step_fn = P.steps.make_train_step(cfg, opt)
    pipe = P.LMTokenPipeline(cfg, TRAIN_B, TRAIN_S)
    batches = [next(pipe) for _ in range(n_steps)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    P.ops.reset_launch_counts()
    times, losses, nonfinite, held = [], [], [], []
    for i, batch in enumerate(batches):
        t0 = time.perf_counter()
        params, opt_state, m = step_fn(params, opt_state, batch, i)
        losses.append(float(m["loss"]))
        nonfinite.append(float(m["nonfinite"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        del m
        held.append(torch.cuda.memory_allocated() / 2 ** 30)
    counts, tc = P.ops.launch_counts(), P.ops.tc_launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    tok = TRAIN_M
    med = statistics.median(times[1:])
    print(f"[train] {kind} ({why}) {cfg.name} layers={cfg.n_layers} "
          f"param_dtype={cfg.param_dtype}: "
          f"losses {[round(v, 4) for v in losses]} nonfinite {nonfinite} "
          f"step_ms {[round(v * 1e3, 1) for v in times]} median after the "
          f"first {med * 1e3:.1f} ms = {tok / med:.0f} tokens/s, peak_memory "
          f"{peak:.2f} GiB, held after each step "
          f"{[round(v, 2) for v in held]} GiB, launches={counts}, of them "
          f"on tensor cores {tc} [{card}]")
    require(held[-1] <= held[1] * 1.01 + 0.01,
            f"{kind}: memory held grows from step to step: {held}")
    require(all(np.isfinite(losses)), f"{kind}: non-finite loss {losses}")
    require(nonfinite == [0.0] * n_steps, f"{kind}: nonfinite {nonfinite}")
    want = _expected_launches(P, cfg, n_steps, kind)
    require(counts == want, f"{kind}: launches {counts} != {want}")
    want_tc = _expected_tc(P, cfg, want)
    require(tc == want_tc,
            f"{kind}: tensor-core launches {tc} != {want_tc}")
    batch = next(pipe)
    dev_ms = step_breakdown(lambda: step_fn(params, opt_state, batch,
                                            n_steps), med, f"{kind} step",
                            card)
    del params, opt_state
    torch.cuda.empty_cache()
    return ({**counts, **{f"{k}_tc": v for k, v in tc.items()}},
            {"step_s": med, "device_ms": dev_ms, "peak_gib": peak})


def adam_reach(n_steps, b1=0.9, b2=0.95) -> float:
    """The farthest n_steps of Adam can move a weight, in units of lr:
    the sum over steps t of the largest |m_t / sqrt(v_t)| after bias
    correction, which by Cauchy-Schwarz is sqrt(sum a_i^2 / c_i) with
    a_i, c_i the weights of gradient i in m_t and v_t (1 at t = 1,
    1.00037 at t = 2, 1.00098 at t = 3)."""
    reach = 0.0
    for t in range(1, n_steps + 1):
        r = sum(((1 - b1) * b1 ** (t - i)) ** 2 / ((1 - b2) * b2 ** (t - i))
                for i in range(1, t + 1))
        reach += math.sqrt(r * (1 - b2 ** t)) / (1 - b1 ** t)
    return reach


def compare_train_step(P, cfg, dtype, fused, card, depth=None, opt=None,
                       lr=1e-3, n_steps=1):
    """n_steps at full width and 2 layers (or the ``depth`` fields given),
    once through the kernels and once through their plain versions, from
    the same weights and batches: losses and, per leaf, the updated
    params and Adam's m.  ``opt`` (whose rate is ``lr``) runs on the
    config's own param dtype; by default a clipped fused Adam runs, on
    fp32 params for the two-pass path.  Where the state holds fp32
    masters, each side's params are its masters rounded, bit for bit,
    and the masters' displacements agree per leaf by norm."""
    bsm = P.bsm
    cfg = dataclasses.replace(
        cfg, **(depth or {"n_layers": 2}), dtype=dtype, fused_update=fused)
    if opt is None:
        cfg = dataclasses.replace(
            cfg, param_dtype=dtype if fused else "float32")
        opt = P.optim.fused_adam(P.optim.constant_schedule(lr),
                                 grad_clip=1.0)
    pipe = P.LMTokenPipeline(cfg, TRAIN_B, TRAIN_S)
    batches = [next(pipe) for _ in range(n_steps)]
    step_fn = P.steps.make_train_step(cfg, opt)

    def run():
        params = P.M.init(cfg, seed=0, device="cuda")
        state, losses = opt.init(params), []
        for i, batch in enumerate(batches):
            params, state, m = step_fn(params, state, batch, i)
            losses.append(float(m["loss"]))
        return params, state, losses

    P.ops.reset_launch_counts()
    kp, ks, kl = run()
    kc = P.ops.launch_counts()
    with contextlib.ExitStack() as stack:
        for name in ("fwd", "dx", "dw", "update_dw", "gated_fwd", "gated_dx",
                     "gated_dw", "update_gated_dw"):
            stack.enter_context(mock.patch.object(
                bsm, name, getattr(bsm, f"{name}_ref")))
        pp, ps, pl = run()
    torch.cuda.synchronize()
    kind = "fused_clip" if fused else "two_pass"
    require(kc == _expected_launches(P, cfg, n_steps, kind)
            and P.ops.launch_counts() == kc,
            f"comparison did not take the intended paths: {kc}")
    # MoE in bf16: a router score that ties another to within a bf16
    # rounding sends a token to another expert through the kernels than
    # through the plain versions, so single elements of Adam's m differ by
    # their whole value; m is held in fp32 only, and a weight may be
    # rounded on both sides
    moe_bf16 = cfg.family == "moe" and dtype == "bfloat16"
    tol = dict(STEP_TOL[dtype], **({"m": None} if moe_bf16 else {}))
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(kl, pl))
    m_err = max(rel_err(a, b) for (_, a), (_, b) in
                zip(P.tree_items(ks["m"]), P.tree_items(ps["m"]))
                if a.is_floating_point() and a.dim())
    pairs = [(a, b) for (_, a), (_, b) in
             zip(P.tree_items(kp), P.tree_items(pp)) if a.is_floating_point()]
    p_err = max(max_err(a, b) for a, b in pairs)
    # +-lr a step each way (2 lr, with room for lr's own fp32 rounding),
    # plus one ulp of the stored weight (of both, for MoE in bf16)
    reach = 2 * lr * adam_reach(n_steps) * (1 + 1e-5)
    p_ok = all(bool(((a.float() - b.float()).abs()
                     <= reach + ULP[a.dtype] * (
                         b.float().abs() + (a.float().abs() if moe_bf16
                                            else 0.0))).all())
               for a, b in pairs)
    masters = ""
    moved_ok = True
    if "master" in ks:
        for p, s in ((kp, ks), (pp, ps)):
            for (k, t), (_, w) in zip(P.tree_items(p),
                                      P.tree_items(s["master"])):
                require(not t.is_floating_point() or (
                    t.dtype == getattr(torch, cfg.param_dtype)
                    and w.dtype == torch.float32
                    and bits_equal(t, w.to(t.dtype))),
                    f"{kind}: {k} is not its fp32 master rounded")
        start = P.M.init(cfg, seed=0, device="cuda")
        moved = max(moved_rel(a, b, w0) for (_, a), (_, b), (_, w0) in zip(
            P.tree_items(ks["master"]), P.tree_items(ps["master"]),
            P.tree_items(start)) if a.dim())
        moved_ok = moved <= tol["moved"]
        masters = (f", masters' displacement rel {moved:.3g} (tol "
                   f"{tol['moved']}); params = masters rounded")
    print(f"[step] {cfg.name} {kind} {cfg.n_layers} layers {dtype} "
          f"param_dtype={cfg.param_dtype} {n_steps} step(s) kernels vs "
          f"plain versions: losses {[round(v, 6) for v in kl]} vs "
          f"{[round(v, 6) for v in pl]} (rel {loss_rel:.3g}, tol "
          f"{tol['loss']}), Adam m rel_err {m_err:.3g} (tol {tol['m']}), "
          f"params max_abs_err {p_err:.3g} (tol 2 lr a step = {reach:.3g} "
          f"plus one ulp: {p_ok}){masters} [{card}]")
    require(loss_rel <= tol["loss"] and p_ok and moved_ok
            and (tol["m"] is None or m_err <= tol["m"]),
            f"{kind} {dtype} step differs")


def moved_rel(got, want, start) -> float:
    """||(got - start) - (want - start)|| / ||want - start||: how far two
    runs' displacements of one leaf from its common start part, by
    norm."""
    d = want.float() - start.float()
    num = torch.linalg.vector_norm(got.float() - want.float())
    return float(num / torch.linalg.vector_norm(d).clamp_min(1e-30))


# one train step, kernels vs plain versions: fp32 differs in summation
# order only; in bf16 one-ulp flips in the junction outputs propagate
# through the model into every gradient.  Params: Adam's first step
# moves each weight by lr * m / sqrt(v) = +-lr, so a gradient near 0
# whose sign differs moves it by 2 lr at most, and the stored weight may
# round to the neighbouring value of its type.
# With fp32 masters (the perf variant) each master's displacement from
# its start is held per leaf by norm, kernels against plain versions:
# Adam's early steps move a weight by about lr times its gradient's sign,
# so weights whose gradients sit at the bf16 noise floor part.  The perf
# step read 0.108 (3 steps, H100 80GB HBM3, 700 W); with the plain dx
# halved 0.97, with the plain dw halved m's rel_err 0.975 (Adam's step
# does not see a gradient's scale, m does).
TRAIN_KINDS = ("two_pass", "fused_clip", "fused")
MOVED_TOL = 0.3
STEP_TOL = {"float32": {"loss": 1e-5, "m": 1e-3},
            "bfloat16": {"loss": 1e-2, "m": 5e-2, "moved": MOVED_TOL}}
ULP = {torch.float32: 2.0 ** -23, torch.bfloat16: 2.0 ** -7}


def train_phase(P, card, arch, n_layers=0, kinds=TRAIN_KINDS, depth=None):
    """Full-width sparse-FFN training of ``arch`` (depth cut to
    ``n_layers`` when given): 3 steps each of ``kinds``, two-pass Adam
    (fp32 masters, bf16 compute), fused Adam and fused SGD (bf16 params,
    fp32 slots), then one step at 2 layers (or ``depth``) through the
    kernels and through their plain versions on each kind's update
    path."""
    cfg = P.registry.get(arch).with_sparsity(
        P.SparsityConfig(density=0.25, block=BS, where="ffn"))
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    sched = P.optim.cosine_schedule(3e-4, 20, 100)
    adam = P.optim.fused_adam(sched, grad_clip=1.0)
    fused_cfg = dataclasses.replace(cfg, fused_update=True,
                                    param_dtype="bfloat16")
    runs = {
        "two_pass": lambda: train_run(P, cfg, adam, "two_pass", card),
        "fused_clip": lambda: train_run(P, fused_cfg, adam, "fused_clip",
                                        card),
        "fused": lambda: train_run(P, fused_cfg,
                                   P.optim.fused_sgd(sched, momentum=0.9),
                                   "fused", card)}
    runs = {k: runs[k]()[0] for k in kinds}
    if "fused" in runs:
        require(runs["fused"]["junction_dw"] == 0
                and runs["fused"]["junction_gated_dw"] == 0,
                "the unclipped fused path launched a dw kernel")
    for dtype in ("bfloat16", "float32"):
        for fused in (False, True)[:1 + ("fused_clip" in kinds)]:
            compare_train_step(P, cfg, dtype, fused, card, depth)
    first = next(iter(runs.values()))
    return {k: sum(r[k] for r in runs.values()) for k in first}


# --------------------------------------------------- quantized kernels
# stablelm-3b's FFN junctions at decode and prefill, qwen3-moe's expert
# junctions at E = 128, and the sweep's MLP junctions (1024 -> 512 at
# kb 2, 512 -> 128 at kb 1; eval rows 512; the int8 cohort is E = 6)
SWEEP_SHAPES = [("l1", 1024, 512, 0), ("l2", 512, 128, 0)]
SWEEP_M, SWEEP_E = 512, 6
# kernel vs plain version, int8: with act "none" the same integer dots,
# the same two fp32 products and the same sums in slot order, so equal
# bit for bit; with an activation CUDA's expf / tanhf against PyTorch's
# may move an fp32 value by an ulp or two and its rounding to bf16 by one
# bf16 ulp.  fxp: integer arithmetic and a table, equal bit for bit.
QUANT_TOL = {torch.float32: dict(atol=1e-6, rtol=1e-5),
             torch.bfloat16: dict(atol=1e-5, rtol=2.0 ** -7)}


def _int8_cost(x, codes, M, n_out, E, with_bias=True):
    """(bytes, operations) of an int8 forward: x, the codes (and their
    fp32 scales), the fp32 bias (``fwd_int8``'s; the gate takes none) and
    the output once each; two integer operations per multiply-add over
    the pattern's edges."""
    isz = x.element_size()
    nbytes = x.numel() * isz + sum(c.numel() * (1 + 4 / (BS * BS))
                                   for c in codes) \
        + (4 * E * n_out if with_bias else 0) + E * M * n_out * isz
    nops = 2 * M * sum(c.numel() for c in codes)
    return nbytes, nops


def _quant_case(P, gen, shape, E, M, dtype, bits=8, granularity="block",
                n_codes=1):
    _, n_in, n_out, pseed = shape
    pat = P.make_block_pattern(n_in, n_out, 0.25, BS, seed=pseed)
    nob, kb = pat.idx.shape
    r = lambda *sh: torch.randn(sh, generator=gen, device="cuda")
    x = r(E, M, n_in).to(dtype)
    codes = [P.qz.quantize_weights(r(E, nob, kb, BS, BS) / (kb * BS) ** 0.5,
                                   bits=bits, granularity=granularity)
             for _ in range(n_codes)]
    return pat, torch.as_tensor(pat.idx, device="cuda"), x, codes, r(E, n_out)


def int8_split_rule(P, blocks):
    """The int8 wrappers' split aims at ``blocks`` blocks a launch
    (``bsm._INT8_BLOCKS``): 1 leaves each output block to one block, a
    large number splits it to one slot a block."""
    return mock.patch.object(P.bsm, "_INT8_BLOCKS", blocks)


UNSPLIT, ONE_SLOT = 1, 1 << 30
# the redesign's coverage: E 3 at blocks 32, 64 and 128 (1024 -> 512 at
# density 0.25: kb 8, 4, 2), rows 1 and 16 (dp4a: one row chunk, two) and
# 33 (the mma path at block 128 in three row chunks, dp4a in five at
# blocks 32 and 64), unsplit and one slot a block
INT8_COVER = dict(E=3, n_in=1024, n_out=512, blocks=(32, 64, 128),
                  rows=(1, 16, 33))


def int8_coverage_checks(P, gen, card):
    """fwd_int8 (act none: bit for bit) and gated_fwd_int8 (QUANT_TOL)
    against their plain versions at INT8_COVER, bf16 and fp32, dynamic
    scales (static at fp32, M 33), each plan unsplit and split; then two
    back-to-back split calls that must give the same bits (the tickets
    reset)."""
    bsm = P.bsm
    c = INT8_COVER
    E = c["E"]
    r = lambda *sh: torch.randn(sh, generator=gen, device="cuda")
    for bs in c["blocks"]:
        pat = P.make_block_pattern(c["n_in"], c["n_out"], 0.25, bs, seed=3)
        idx = torch.as_tensor(pat.idx, device="cuda")
        nob, kb = pat.idx.shape
        (wq, sc), (wi, si) = (
            P.qz.quantize_weights(r(E, nob, kb, bs, bs) / (kb * bs) ** 0.5)
            for _ in range(2))
        b = r(E, c["n_out"])
        for dtype in (torch.bfloat16, torch.float32):
            for M in c["rows"]:
                x = r(E, M, c["n_in"]).to(dtype)
                xs = ((x.float().abs().amax(dim=(1, 2)) / 127.0).contiguous()
                      if dtype == torch.float32 and M == 33 else None)
                want_y = bsm.fwd_int8_ref(x, wq, idx, sc, b, "none", xs)
                want_h = bsm.gated_fwd_int8_ref(x, wq, wi, idx, sc, si, xs)
                for blocks in (UNSPLIT, ONE_SLOT):
                    with int8_split_rule(P, blocks):
                        plan = bsm.int8_plan(E, M, nob, kb, bs)
                        y = bsm.fwd_int8(x, wq, idx, sc, b, "none", xs)
                        h = bsm.gated_fwd_int8(x, wq, wi, idx, sc, si, xs)
                        torch.cuda.synchronize()
                        if blocks == ONE_SLOT:
                            again = (bsm.fwd_int8(x, wq, idx, sc, b, "none",
                                                  xs),
                                     bsm.gated_fwd_int8(x, wq, wi, idx, sc,
                                                        si, xs))
                            torch.cuda.synchronize()
                            require(bits_equal(again[0], y)
                                    and bits_equal(again[1], h),
                                    f"int8 bs={bs} M={M} {plan}: a second "
                                    f"call gave other bits")
                    err_h = max_err(h, want_h)
                    print(f"[kernel] int8 coverage E={E} bs={bs} M={M} "
                          f"{str(dtype)[6:]} static_x={xs is not None} plan="
                          f"{plan}: fwd_int8 bit_equal="
                          f"{torch.equal(y, want_y)}, gated max_abs_err="
                          f"{err_h:.3g} ({QUANT_TOL[dtype]}) [{card}]")
                    require(torch.equal(y, want_y),
                            f"fwd_int8 bs={bs} M={M} {dtype} {plan} "
                            f"disagrees with its plain version")
                    require(close(h, want_h, QUANT_TOL[dtype]),
                            f"gated_fwd_int8 bs={bs} M={M} {dtype} {plan} "
                            f"disagrees with its plain version: {err_h}")


def quant_kernel_phase(P, timer, card):
    """fwd_int8 at stablelm-3b's FFN junctions (decode M = 4, prefill
    M = 32; bf16 and fp32; dynamic and static activation scales, block
    and unit scales, 4-bit codes, bias, ragged M), at qwen3-moe's down
    junction (E = 128) and at the sweep's int8 cohort; gated_fwd_int8 at
    qwen3-moe's gate junction (E = 128, M = 4); fwd_fxp at the sweep's
    junctions (both timed) for every paper triplet, for a sum that wraps
    int32 and for weight codes beyond 16 bits, then
    ``fxp_coverage_checks``.
    Each against its plain version, timed; each int8 path shape again
    under the other split (``int8_split_rule``), untimed; then
    ``int8_coverage_checks``."""
    bsm = P.bsm
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    fgen = torch.Generator(device="cuda")   # fwd_fxp's later cases
    fgen.manual_seed(22)
    out = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
               "bound_ms": 0.0, "bound_by": "", "library_ms": None}
           for k in ("fwd_int8", "gated_fwd_int8", "fwd_fxp")}
    layer = {M: {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "ops": 0}
             for M in (4, 32)}

    def other_split(kind, what, fn, ref, exact, dtype, shape_args):
        """The same call under the other split than its plan's."""
        plan = P.bsm.int8_plan(*shape_args)
        with int8_split_rule(P, UNSPLIT if plan[3] > 1 else ONE_SLOT):
            other = P.bsm.int8_plan(*shape_args)
            check(kind, f"{what}, again under plan={other}", fn, ref,
                  exact, dtype, (0, 0), time_it=False)

    def check(kind, what, fn, ref, exact, dtype, cost, time_it=True):
        """cost: (bytes, operations), or fwd_fxp's fxp_bounds."""
        got, want = fn(), ref()
        torch.cuda.synchronize()
        err = max_err(got, want)
        same = torch.equal(got, want)
        ok = same if exact else close(got, want, QUANT_TOL[dtype])
        o = out[kind]
        o["max_abs_err"] = max(o["max_abs_err"], err)
        k_ms = timer.ms(fn) if time_it else float("nan")
        p_ms = timer.ms(ref) if time_it else float("nan")
        if isinstance(cost, dict):
            bnd, by, text = cost["bound_ms"], cost["bound_by"], \
                bounds_text(cost)
        else:
            bnd, by = bound_ms(*cost, torch.int8)
            text = f"bound_ms={bnd:.5f} ({by})"
        print(f"[kernel] junction_{kind} {what} {str(dtype)[6:]}: "
              f"max_abs_err={err:.3g} bit_equal={same} "
              f"({'exact' if exact else QUANT_TOL[dtype]}) ms={k_ms:.4f} "
              f"plain_ms={p_ms:.4f} {text} [{card}]")
        require(ok, f"junction_{kind} {what} {dtype} disagrees with its "
                    f"plain version: err {err}")
        return k_ms, p_ms, bnd, by

    # fwd_int8 at stablelm-3b's three FFN junctions
    for dtype in (torch.bfloat16, torch.float32):
        for M in (4, 32):
            for shape in TRAIN_SHAPES:
                name, n_in, n_out, act, pseed = shape
                _, idx, x, ((wq, sc),), _ = _quant_case(
                    P, gen, (name, n_in, n_out, pseed), 1, M, dtype)
                b = torch.zeros((1, n_out), device="cuda")
                fn = lambda: bsm.fwd_int8(x, wq, idx, sc, b, act)
                ref = lambda: bsm.fwd_int8_ref(x, wq, idx, sc, b, act)
                cost = _int8_cost(x, [wq], M, n_out, 1)
                what = (f"{name} {n_in}->{n_out} M={M} act={act} plan="
                        f"{bsm.int8_plan(1, M, *wq.shape[1:4])}")
                res = check("fwd_int8", what, fn, ref, act == "none", dtype,
                            cost)
                other_split("fwd_int8", what, fn, ref, act == "none", dtype,
                            (1, M, *wq.shape[1:4]))
                if dtype == torch.bfloat16:
                    lay = layer[M]
                    lay["ms"] += res[0]
                    lay["plain_ms"] += res[1]
                    lay["bytes"] += cost[0]
                    lay["ops"] += cost[1]
    for M, where in ((4, "decode"), (32, "prefill")):
        lay = layer[M]
        bnd, by = bound_ms(lay["bytes"], lay["ops"], torch.int8)
        print(f"[kernel] junction_fwd_int8 one layer's FFN at {where} "
              f"(wg+wi+wo, M={M}, bf16): ms={lay['ms']:.4f} plain_ms="
              f"{lay['plain_ms']:.4f} bound_ms={bnd:.4f} ({by}) [{card}]")
        if M == 4:
            out["fwd_int8"].update(ms=lay["ms"], plain_ms=lay["plain_ms"],
                                   bound_ms=bnd, bound_by=by)
        else:
            out["fwd_int8"].update(prefill_ms=lay["ms"],
                                   prefill_plain_ms=lay["plain_ms"],
                                   prefill_bound_ms=bnd)

    # the options: static scales, unit scales, 4-bit codes, bias, ragged M
    name, n_in, n_out, _, pseed = TRAIN_SHAPES[0]
    for dtype, M, act, static, gran, bits in (
            (torch.bfloat16, 5, "silu", True, "block", 8),
            (torch.float32, 5, "none", True, "unit", 4),
            (torch.float32, 13, "gelu", False, "unit", 8),
            (torch.bfloat16, 32, "relu", False, "block", 4),
            (torch.float32, 32, "sigmoid", True, "block", 8)):
        _, idx, x, ((wq, sc),), b = _quant_case(
            P, gen, (name, n_in, n_out, pseed), 1, M, dtype, bits, gran)
        xs = (x.float().abs().amax(dim=(1, 2)) / 127.0).contiguous() \
            if static else None
        fn = lambda: bsm.fwd_int8(x, wq, idx, sc, b, act, xs)
        ref = lambda: bsm.fwd_int8_ref(x, wq, idx, sc, b, act, xs)
        check("fwd_int8", f"{name} M={M} act={act} bias static_x={static} "
              f"{gran} bits={bits}", fn, ref, act == "none", dtype,
              _int8_cost(x, [wq], M, n_out, 1), time_it=False)

    # qwen3-moe at E = 128: the gate through gated_fwd_int8, the down
    # junction through fwd_int8
    for dtype in (torch.bfloat16, torch.float32):
        for static in (False, True):
            _, n_in, n_out, _ = MOE_SHAPES[0]
            _, idx, x, ((wg, sg), (wi, si)), _ = _quant_case(
                P, gen, MOE_SHAPES[0], MOE_E, MOE_M["decode"], dtype,
                n_codes=2)
            xs = (x.float().abs().amax(dim=(1, 2)) / 127.0).contiguous() \
                if static else None
            fn = lambda: bsm.gated_fwd_int8(x, wg, wi, idx, sg, si, xs)
            ref = lambda: bsm.gated_fwd_int8_ref(x, wg, wi, idx, sg, si, xs)
            what = f"gate E={MOE_E} {n_in}->{n_out} M=4 static_x={static}"
            res = check("gated_fwd_int8", what, fn, ref, False, dtype,
                        _int8_cost(x, [wg, wi], 4, n_out, MOE_E,
                                   with_bias=False),
                        time_it=not static)
            other_split("gated_fwd_int8", what, fn, ref, False, dtype,
                        (MOE_E, 4, *wg.shape[1:4]))
            if dtype == torch.bfloat16 and not static:
                out["gated_fwd_int8"].update(
                    ms=res[0], plain_ms=res[1], bound_ms=res[2],
                    bound_by=res[3])
        _, n_in, n_out, _ = MOE_SHAPES[1]
        _, idx, x, ((wq, sc),), _ = _quant_case(
            P, gen, MOE_SHAPES[1], MOE_E, MOE_M["decode"], dtype)
        b = torch.zeros((MOE_E, n_out), device="cuda")
        fn = lambda: bsm.fwd_int8(x, wq, idx, sc, b)
        ref = lambda: bsm.fwd_int8_ref(x, wq, idx, sc, b)
        what = f"down E={MOE_E} {n_in}->{n_out} M=4"
        res = check("fwd_int8", what, fn, ref, True, dtype,
                    _int8_cost(x, [wq], 4, n_out, MOE_E))
        other_split("fwd_int8", what, fn, ref, True, dtype,
                    (MOE_E, 4, *wq.shape[1:4]))
        if dtype == torch.bfloat16:
            out["fwd_int8"].update(moe_down_ms=res[0], moe_down_plain_ms=res[1],
                                   moe_down_bound_ms=res[2])

    # the sweep's junctions: the int8 cohort (E = 6, bits 8/6/4 x block /
    # unit) and each fxp cohort (E = 1)
    for shape in SWEEP_SHAPES:
        name, n_in, n_out, _ = shape
        _, idx, x, _, b = _quant_case(P, gen, shape, SWEEP_E, SWEEP_M,
                                      torch.float32, n_codes=0)
        pat = P.make_block_pattern(n_in, n_out, 0.25, BS, seed=0)
        w = torch.randn((SWEEP_E, *pat.idx.shape, BS, BS), generator=gen,
                        device="cuda") * 0.05
        qs = [P.qz.quantize_weights(w[e], bits=bits, granularity=g)
              for e, (bits, g) in enumerate(
                  [(bt, g) for bt in (8, 6, 4) for g in ("block", "unit")])]
        wq = torch.stack([q for q, _ in qs])
        sc = torch.stack([s for _, s in qs])
        fn = lambda: bsm.fwd_int8(x, wq, idx, sc, b, "sigmoid")
        ref = lambda: bsm.fwd_int8_ref(x, wq, idx, sc, b, "sigmoid")
        what = (f"sweep {name} {n_in}->{n_out} E={SWEEP_E} M={SWEEP_M} "
                f"act=sigmoid")
        res = check("fwd_int8", what, fn, ref, False, torch.float32,
                    _int8_cost(x, [wq], SWEEP_M, n_out, SWEEP_E))
        other_split("fwd_int8", what, fn, ref, False, torch.float32,
                    (SWEEP_E, SWEEP_M, *wq.shape[1:4]))
        out["fwd_int8"][f"sweep_{name}_ms"] = res[0]
        for fmt in P.fxp.PAPER_TRIPLETS + ["wraps", "wide"]:
            kind = fmt if isinstance(fmt, str) else "spread"
            fmt = P.fxp.PAPER_TRIPLETS[-1] if kind != "spread" else fmt
            xf, wq, qf, lut, bf = _fxp_operands(
                P, gen if kind != "wide" else fgen, w[:1], b[:1], fmt, kind,
                SWEEP_M, n_in)
            fn = lambda: bsm.fwd_fxp(xf, wq, idx, qf, lut, bf)
            ref = lambda: bsm.fwd_fxp_ref(xf, wq, idx, qf, lut, bf)
            bounds = _fxp_cost(P, xf, wq, lut, fmt)
            if kind == "wraps":
                s = torch.einsum("mi,ic->mc",
                                 torch.round(xf[0, :, :BS].double()
                                             * fmt.scale),
                                 wq[0, 0, 0].double())
                require(float(s.abs().max()) > 2 ** 31,
                        "the wrap case does not wrap")
            tag = {"spread": "", "wraps": " int32 sum wraps",
                   "wide": " codes beyond 16 bits"}[kind]
            res = check("fwd_fxp", f"sweep {name} {n_in}->{n_out} M={SWEEP_M} "
                        f"fmt=({fmt.bw},{fmt.bn},{fmt.bf}){tag}", fn, ref,
                        True, torch.float32, bounds,
                        time_it=kind == "spread")
            if fmt == P.fxp.PAPER_FMT:
                pre = "" if name == "l1" else f"{name}_"
                out["fwd_fxp"].update({
                    f"{pre}ms": res[0], f"{pre}plain_ms": res[1],
                    f"{pre}bound_ms": bounds["bound_ms"],
                    f"{pre}bound_by": bounds["bound_by"]})
    fxp_coverage_checks(P, fgen, check)
    int8_coverage_checks(P, gen, card)
    return out


def _fxp_operands(P, gen, w, b, fmt, kind, M, n_in):
    """x [E, M, n_in] (pixels in [0, 1), or at the clip), the weight codes
    of w * 8 (or at the top of the range: the sum wraps; or drawn beyond
    16 bits), the format, the table and the bias on the grid."""
    E = w.shape[0]
    if kind == "wraps":
        xf = torch.full((E, M, n_in), fmt.max_val, device="cuda")
        xf[:, 1::2] = fmt.min_val
        wf = torch.full_like(w, fmt.max_val)
    else:
        xf = torch.rand((E, M, n_in), generator=gen, device="cuda")
        wf = w * 8.0
    wq = P.qz.fxp_encode_weights(wf, fmt)
    if kind == "wide":
        xf = torch.full((E, M, n_in), fmt.max_val, device="cuda")
        wq = torch.randint(2 ** 30, 2 ** 31 - 1, tuple(w.shape),
                           generator=gen, device="cuda", dtype=torch.int64
                           ).to(torch.int32)
    lut = P.qz.act_lut(fmt, "sigmoid", "cuda")
    qf = torch.tensor([fmt.bf, fmt.bn], dtype=torch.int32, device="cuda")
    return xf, wq, qf, lut, P.fxp.quantize(b, fmt)


def _fxp_cost(P, xf, wq, lut, fmt):
    """fwd_fxp's fxp_bounds: x, the codes, the table, the bias and the
    output once each; the planes of this run's x codes and weight codes."""
    E, M, _ = xf.shape
    n_out = wq.shape[1] * wq.shape[3]
    isz = xf.element_size()
    lim = lut.shape[0] // 2
    xq = torch.clamp(torch.round(xf.float() * fmt.scale), -lim, lim - 1)
    return fxp_bounds(xf.numel() * isz + wq.numel() * 4 + lut.numel() * 4
                      + 4 * E * n_out + E * M * n_out * isz,
                      M * wq.numel(), code_planes(xq), code_planes(wq))


def fxp_coverage_checks(P, gen, check):
    """fwd_fxp bit for bit, untimed: a ragged M (33) in fp32 and bf16,
    bf16 x at the sweep's rows, and blocks 32 and 64 (E 2, M 33, bf16),
    each with codes spread over the paper triplet's range and with weight
    codes beyond 16 bits."""
    fmt = P.fxp.PAPER_FMT
    _, n_in, n_out, pseed = SWEEP_SHAPES[0]
    for bs, E, M, dtype in ((BS, 1, 33, torch.float32),
                            (BS, 1, 33, torch.bfloat16),
                            (BS, 1, SWEEP_M, torch.bfloat16),
                            (64, 2, 33, torch.bfloat16),
                            (32, 2, 33, torch.bfloat16)):
        pat = P.make_block_pattern(n_in, n_out, 0.25, bs, seed=pseed)
        idx = torch.from_numpy(pat.idx).to("cuda")
        w = torch.randn((E, *pat.idx.shape, bs, bs), generator=gen,
                        device="cuda") * 0.05
        b = torch.randn((E, n_out), generator=gen, device="cuda")
        for kind in ("spread", "wide"):
            xf, wq, qf, lut, bq = _fxp_operands(P, gen, w, b, fmt, kind, M,
                                                n_in)
            xf = xf.to(dtype)
            check("fwd_fxp", f"bs={bs} E={E} M={M} {kind} plan="
                  f"{P.bsm.fxp_plan(E, M, *wq.shape[1:4])}",
                  lambda: P.bsm.fwd_fxp(xf, wq, idx, qf, lut, bq),
                  lambda: P.bsm.fwd_fxp_ref(xf, wq, idx, qf, lut, bq), True,
                  dtype, _fxp_cost(P, xf, wq, lut, fmt), time_it=False)



def sweep_phase(P, card):
    """launch.quant_sweep on the card with the paper triplets, once with
    dynamic activation scales and once calibrated: a finite winner, and
    exact launch counts (30 fused pre-training steps of the 2-layer MLP,
    the fp eval, the calibration pass, and 4 evals of each cohort)."""
    counts = {}
    for extra in ([], ["--calibrate"]):
        out = ROOT / "build" / f"QUANT_sweep{''.join(extra)}.json"
        P.ops.reset_launch_counts()
        t0 = time.perf_counter()
        ledger = P.quant_sweep.main(["--fxp", "--out", str(out), *extra])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        c = P.ops.launch_counts()
        want = dict.fromkeys(c, 0)
        want.update(junction_fwd=2 * 30 + 2 + (2 if extra else 0),
                    junction_dx=2 * 30, junction_update_dw=2 * 30,
                    junction_fwd_int8=2 * 4, junction_fwd_fxp=2 * 4 * 5)
        w = ledger["winner"]
        evals = {json.dumps(r["config"]): round(r["us_per_member_eval"], 1)
                 for r in ledger["records"]}
        print(f"[sweep] quant_sweep --fxp {' '.join(extra)}: {dt:.1f} s, "
              f"fp32 eval loss {ledger['fp32_eval_loss']:.5f}, winner "
              f"{w and w['config']} loss {w and w['eval_loss']}, "
              f"launches={c} [{card}]")
        print(f"[sweep] us per member eval: {evals} [{card}]")
        require(w is not None and np.isfinite(w["eval_loss"]),
                "the sweep named no finite winner")
        require(c == want, f"sweep launches {c} != {want}")
        for k, v in with_tc(P, c).items():
            counts[k] = counts.get(k, 0) + v
    return counts


# ------------------------------------------------------- population search
# launch.sweep's defaults: the MLP 1024 -> 512 -> 128 at block 128,
# densities 0.25 and 0.5 (fan-in 2 and 4: two cohorts) x lrs 0.02, 0.05
# and 0.1 under SGD, 3 rounds x 20 steps at batch 128, 4096 train and 512
# eval samples of paper_dataset; then Adam over lr x b1.  fp32, so every
# junction launch is a SIMT one (bsm.junction_variant).
SWEEP_ARGS = {"sgd": [], "adam": ["--optim", "adam", "--lrs", "0.001,0.005",
                                  "--b1s", "0.8,0.9"]}
SWEEP_LAYERS, SWEEP_BLOCK = (1024, 512, 128), 128
# one fused population step, kernels vs plain versions (fp32 sums of up to
# 512 products in another order; tests/test_torch_quant_sweep.py's bound)
POP_TOL = dict(rtol=1e-5, atol=1e-6)


def _sweep_work(ledger) -> tuple[int, int]:
    """(cohort steps, cohort evals) the sweep ran, from its ledger: a
    cohort steps while any member is live (a member records a loss each
    step it is live, from step 0 on) and evaluates each round any member
    is live at its end (an eval loss each)."""
    by = collections.defaultdict(list)
    for m in ledger.members:
        by[m.cohort].append(m)
    return (sum(max(len(m.loss_curve) for m in ms) for ms in by.values()),
            sum(max(len(m.eval_losses) for m in ms) for ms in by.values()))


def _sweep_launches(P, ledger) -> dict:
    """The launches a sweep of the 2-junction MLP implies: a cohort step
    2 fwd, 2 dx (the first junction's too: the fused step's input takes
    part in autograd) and 2 update_dw; a cohort eval 2 fwd; no dw (the
    weight gradient never leaves update_dw)."""
    steps, evals = _sweep_work(ledger)
    want = dict.fromkeys(P.ops.launch_counts(), 0)
    want.update(junction_fwd=2 * (steps + evals), junction_dx=2 * steps,
                junction_update_dw=2 * steps)
    return want


def _sweep_cli(P, argv):
    """launch.sweep.main(argv): (result, seconds, launch counts)."""
    P.ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = P.sweep.main(argv)
    torch.cuda.synchronize()
    return result, time.perf_counter() - t0, P.ops.launch_counts()


def _pop_specs(P, lrs, density=0.25):
    return [P.search.CandidateSpec(lr=lr, density=density,
                                   layers=SWEEP_LAYERS, block=SWEEP_BLOCK,
                                   init_seed=i)
            for i, lr in enumerate(lrs)]


def _pop_batch(P, n=128, seed=5):
    x, t, _ = P.paper_dataset(n=n, seed=seed)
    tp = np.zeros((n, SWEEP_LAYERS[-1]), np.float32)
    tp[:, :t.shape[1]] = t
    dev = torch.device("cuda")
    return torch.from_numpy(x).to(dev), torch.from_numpy(tp).to(dev)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def search_phase(P, card):
    """The population sweep on the card: launch.sweep at its defaults and
    an Adam grid (finite winners, ledgers that round-trip, exact launch
    counts from the ledgers' live cohorts, no dw), the host reads of a
    step with and without --obs, the time of a cohort step, the kernels'
    health flags on a poisoned member, quarantined survivors bitwise equal
    to a cohort without the bad member, and one fused step against its
    plain version."""
    dev = torch.device("cuda")
    counts = collections.Counter()
    out_dir = ROOT / "build"
    out_dir.mkdir(parents=True, exist_ok=True)
    for name, extra in SWEEP_ARGS.items():
        out = out_dir / ("SWEEP_mnist.json" if name == "sgd"
                         else f"SWEEP_mnist_{name}.json")
        res, dt, c = _sweep_cli(P, ["--out", str(out), *extra])
        led = res.ledger
        steps, evals = _sweep_work(led)
        w = led.winner()
        print(f"[search] sweep {name}: {len(led.members)} candidates, "
              f"{dt:.3f} s, {steps} cohort steps + {evals} cohort evals = "
              f"{dt / steps * 1e6:.0f} us a cohort step (evals, set-up and "
              f"data included), winner member {w and w.member} "
              f"{w and w.config['density']}/{w and w.config['lr']} eval "
              f"{w and w.eval_losses[-1]:.5f}, quarantined "
              f"{led.meta['quarantined']}, launches={with_tc(P, c)} "
              f"[{card}]")
        require(w is not None and np.isfinite(w.eval_losses[-1]),
                f"sweep {name}: no finite winner")
        again = P.search.Ledger.load(str(out))
        require(json.dumps(again.to_dict(), sort_keys=True)
                == json.dumps(led.to_dict(), sort_keys=True),
                f"sweep {name}: the ledger does not round-trip")
        want = _sweep_launches(P, led)
        require(c == want, f"sweep {name}: launches {c} != {want}")
        require(not any(P.ops.tc_launch_counts().values()),
                f"sweep {name}: fp32 took a tensor-core entry point")
        counts.update(with_tc(P, c))

    # host reads: the losses and health of a step in one copy, the eval
    # losses of a cohort in one copy a round; the recorder adds none
    short = ["--rounds", "2", "--steps-per-round", "3",
             "--out", str(out_dir / "SWEEP_syncs.json")]
    syncs = {}
    for name, extra in (("off", []),
                        ("on", ["--obs", str(out_dir / "obs" /
                                             "sweep.jsonl")])):
        res, s = host_syncs(lambda: P.sweep.main(short + extra))
        steps, evals = _sweep_work(res.ledger)
        syncs[name] = s
        require(s.get("memcpy DtoH", 0) == steps + evals,
                f"sweep --obs {name}: {s} for {steps} cohort steps and "
                f"{evals} cohort evals")
    require(syncs["off"] == syncs["on"],
            f"the recorder changed the sweep's syncs: {syncs}")
    _, events = P.obs.read_events(str(out_dir / "obs" / "sweep.jsonl"))
    table = P.obs_report.build_report(events).get("sweep", [])
    print(f"[search] host reads of a {steps}-step, {evals}-eval sweep: "
          f"{syncs['off']} without --obs, {syncs['on']} with: "
          f"{(syncs['off']['memcpy DtoH'] - evals) / steps:.0f} "
          f"device-to-host copy a cohort step; {len(table)} sweep.round "
          f"rows rendered [{card}]")
    require(any(r["action"] == "winner" for r in table),
            "obs_report rendered no winner row")

    # the time of one cohort step as the scheduler runs it (the step and
    # its one host read), E = 3
    specs = _pop_specs(P, (0.02, 0.05, 0.1))
    x, t = _pop_batch(P)
    step = P.search.make_population_step(with_health=True)
    params = P.search.init_population(0, specs, device=dev)
    hyp = P.search.hyp_table(specs, device=dev)
    mask = torch.ones(3, device=dev)

    def one():
        _, _, losses, health = step(params, None, hyp, mask, x, t)
        return torch.stack([losses, health]).cpu()

    for _ in range(3):
        one()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        one()
    us = (time.perf_counter() - t0) / 20 * 1e6
    print(f"[search] fused population step, E=3, batch 128, layers "
          f"{SWEEP_LAYERS} at density 0.25, with its one host read: "
          f"{us:.0f} us a cohort step, {us / 3:.0f} us a member step "
          f"(mean of 20) [{card}]")
    step_breakdown(one, us / 1e6, "fused population step", card)

    # the kernels' health flags isolate a poisoned member
    for poison in (False, True):
        params = P.search.init_population(0, specs, device=dev)
        if poison:
            params[0]["w"][1, 0, 0, 0, 0] = float("nan")
        _, _, _, health = step(params, None, hyp, mask, x, t)
        h = health.cpu().tolist()
        require(h == [0.0, 0.0, 0.0] if not poison
                else h[0] == 0 and h[2] == 0 and h[1] > 0,
                f"health {h} (poisoned member 1: {poison})")
        fin = all(bool(torch.isfinite(layer["w"]).all())
                  for e in (0, 2)
                  for layer in P.search.member_slice(params, e))
        require(fin, "a clean member's update went non-finite")
    print(f"[search] health flags: clean [0, 0, 0], NaN in member 1's "
          f"weight {h} (non-finite update tiles, summed over the layers) "
          f"[{card}]")

    # one fused step through the kernels and through the plain versions
    res = {}
    for side in ("kernel", "plain"):
        params = P.search.init_population(0, specs, device=dev)
        P.ops.reset_launch_counts()
        with contextlib.ExitStack() as stack:
            if side == "plain":
                for name in ("fwd", "dx", "update_dw"):
                    stack.enter_context(mock.patch.object(
                        P.bsm, name, getattr(P.bsm, f"{name}_ref")))
            _, _, losses, health = step(params, None, hyp, mask, x, t)
            torch.cuda.synchronize()
        res[side] = (params, losses, P.ops.launch_counts())
    kc, pc = res["kernel"][2], res["plain"][2]
    require(kc["junction_fwd"] == kc["junction_dx"]
            == kc["junction_update_dw"] == 2 and not any(pc.values()),
            f"the step comparison took other paths: {kc} then {pc}")
    errs = [max_err(res["kernel"][1], res["plain"][1])]
    for a, b in zip(res["kernel"][0], res["plain"][0]):
        for k in ("w", "b"):
            require(close(a[k], b[k], POP_TOL), f"step {k} differs")
            errs.append(max_err(a[k], b[k]))
    require(close(res["kernel"][1], res["plain"][1], POP_TOL),
            "step losses differ")
    print(f"[search] one fused step, kernels vs plain versions: max abs "
          f"err {max(errs):.3g} (losses, w, b; tol {POP_TOL}) [{card}]")

    # quarantine: an lr=inf member against the same cohort without it
    xq, tq, _ = P.paper_dataset(n=512 + 64, seed=7)
    cfg = P.SweepConfig(rounds=2, steps_per_round=4, batch_size=128,
                               eval_samples=64, keep_fraction=1.0)
    good = _pop_specs(P, (0.05, 0.1), density=0.5)
    bad = _pop_specs(P, (0.05, 0.1, float("inf")), density=0.5)[2:]
    args = (xq[:512], tq[:512], xq[512:], tq[512:], cfg)
    r_with = P.search.run_sweep(good + bad, *args, device=dev)
    r_without = P.search.run_sweep(good, *args, device=dev)
    q = r_with.ledger.members[2]
    require(q.quarantined_at is not None and q.pruned_at == 0
            and r_with.ledger.meta["quarantined"] == 1,
            f"the lr=inf member was not quarantined: {q}")
    for e in range(2):
        for lw, lo in zip(
                P.search.member_slice(r_with.states[0].params, e),
                P.search.member_slice(r_without.states[0].params, e)):
            for k in ("w", "b"):
                require(torch.equal(_bits(lw[k]), _bits(lo[k])),
                        f"survivor {e} {k} not bitwise equal")
    w1, w2 = r_with.ledger.winner(), r_without.ledger.winner()
    require(w1 is not None and w1.member == w2.member
            and np.isfinite(w1.eval_losses[-1]), "quarantine winners")
    print(f"[search] quarantine at {SWEEP_LAYERS}: lr=inf member "
          f"quarantined at {q.quarantined_at}, survivors bitwise equal to "
          f"the cohort without it, winner member {w1.member} both ways "
          f"[{card}]")
    torch.cuda.empty_cache()
    return dict(counts)


# ------------------------------------------------------ static serving
# launch/serve.py without --continuous: 8 prompts of 32 tokens, 16 new
# tokens, greedy, random weights from seed 0: one prefill and 15 decode
# steps, each a call of every layer's junctions
STATIC_ARGS = ["--sparse", "--requests", "8", "--prompt-len", "32",
               "--max-new", "16"]
STATIC_STEPS = 16


def _launcher_inputs(cfg, n=8, length=32):
    """The prompts launch/serve.py makes (seed 0) and its side inputs from
    the same rng after the prompts: a vlm's patches, min(num_patches,
    length // 2) a request; whisper's enc_frames frames a request."""
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.raw_vocab or cfg.vocab,
                           size=(n, length)).astype(np.int32)
    extra = {}
    if cfg.family == "vlm":
        extra["patches"] = rng.standard_normal(
            (n, min(cfg.num_patches, length // 2), cfg.d_model)
        ).astype(np.float32)
    if cfg.family == "audio":
        extra["frames"] = rng.standard_normal(
            (n, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    return prompts, extra


def _prefill_batch(prompts, extra):
    """The static prefill's batch on the card (with a vlm's patches)."""
    batch = {"tokens": torch.as_tensor(prompts, device="cuda")}
    batch.update({k: torch.as_tensor(v, device="cuda")
                  for k, v in extra.items()})
    return batch


def _served(P, fn):
    """fn() with the engines the serve launcher builds recorded: (its
    result, [(engine class, engine)])."""
    made = []
    real = {n: getattr(P.engine, n) for n in ("Engine", "ContinuousEngine")}

    def spy(name):
        def build(*a, **kw):
            made.append((name, real[name](*a, **kw)))
            return made[-1][1]
        return build

    with contextlib.ExitStack() as stack:
        for n in real:
            stack.enter_context(mock.patch.object(P.engine, n, spy(n)))
        out = fn()
    return out, made


def _static_steps(P, cfg, params, prompts, extra):
    """The static prefill of ``prompts`` (and ``extra``) and one decode
    step after it (the prompts' first tokens as the input token, the same
    on both paths), through the static engine's step functions: their
    logits, fp32."""
    eng = P.engine.Engine(cfg, params, device="cuda")
    B = prompts.shape[0]
    lp, cache, S = eng._prefill(eng.params, _prefill_batch(prompts, extra))
    full = eng._grow_cache(cache, B, S + 1, S)
    tok = torch.as_tensor(prompts[:, :1], device="cuda")
    ld, _ = eng._decode(eng.params, full, tok, S)
    return lp[:, -1].float(), ld[:, -1].float()


def static_step_breakdown(P, eng, prompts, extra, name, card):
    """One static decode step of the 8 rows after their prefill: its wall
    time (mean of 5, synchronized) and its kernels by name."""
    B = prompts.shape[0]
    _, cache, S = eng._prefill(eng.params, _prefill_batch(prompts, extra))
    cache = eng._grow_cache(cache, B, S + 1, S)
    tok = torch.as_tensor(prompts[:, :1], device="cuda")

    def step():
        return eng._decode(eng.params, cache, tok, S)

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        step()
        torch.cuda.synchronize()
    step_breakdown(step, (time.perf_counter() - t0) / 5,
                   f"static {name} decode step, 8 rows", card)


def compare_static_logits(P, cfg, params, prompts, extra, quantized, card,
                          gate_bf16=True, gate_fp32=True):
    """The static prefill and one decode step through the kernels and
    through their plain versions on the card, in bf16 and fp32, within
    LOGIT_REL_TOL of max |logit| (attention is plain PyTorch on both).
    Without ``gate_bf16`` the bf16 gaps are printed and not gated: the
    caller holds every bf16 kernel launch and every block on the same
    inputs instead (``ssm_layer_gaps``); without ``gate_fp32`` the fp32
    gaps likewise: the caller holds every int8 launch on its own inputs
    and the logits with the kernels' activation codes fed
    (``int8_code_gaps``).  Beside them, how far each bf16
    path lies from the plain fp32 one: where the plain bf16 path lies as
    far, the gap is bf16's own rounding grown with depth."""
    # quantized, the floating-point junctions left (deepseek-v2's shared
    # experts) run their kernels on both paths, so that the int8 kernels
    # meet the same inputs as their plain versions
    names = (("fwd_int8", "gated_fwd_int8") if quantized
             else ("fwd", "gated_fwd"))
    plain = {f"junction_{n}" for n in names}
    got = {}
    for dtype in (torch.bfloat16, torch.float32):
        c = dataclasses.replace(cfg, dtype=str(dtype)[6:])
        P.ops.reset_launch_counts()
        k_pf, k_dec = _static_steps(P, c, params, prompts, extra)
        kc = P.ops.launch_counts()
        with contextlib.ExitStack() as stack:
            for name in names:
                stack.enter_context(mock.patch.object(
                    P.bsm, name, getattr(P.bsm, f"{name}_ref")))
            p_pf, p_dec = _static_steps(P, c, params, prompts, extra)
        torch.cuda.synchronize()
        want = dict.fromkeys(kc, 0)
        want.update(serve_calls(c, quantized, 1))
        again = {k: n if k in plain else 2 * n for k, n in kc.items()}
        require(kc == want and P.ops.launch_counts() == again,
                f"static logit comparison took other paths: {kc} then "
                f"{P.ops.launch_counts()}")
        for what, a, b in (("prefill", k_pf, p_pf), ("decode", k_dec,
                                                     p_dec)):
            got[what, dtype] = a, b
            require(bool(torch.isfinite(a).all() and torch.isfinite(b).all()),
                    f"static {what} logits not finite")
            rel = max_err(a, b) / float(b.abs().max())
            gated = gate_bf16 if dtype == torch.bfloat16 else gate_fp32
            held = ("every launch and block held on the same inputs, "
                    "[held] and [gap] lines" if dtype == torch.bfloat16
                    else "every int8 launch held on its own inputs, the "
                    "logits with the kernels' codes fed, [codes] lines")
            print(f"[logits] {cfg.name} static {what} "
                  f"{'int8 ' if quantized else ''}{str(dtype)[6:]} kernels "
                  f"vs plain versions: max_abs_err={max_err(a, b):.4g} "
                  f"max|logit|={float(b.abs().max()):.4g} rel={rel:.3g} "
                  + (f"(tol {LOGIT_REL_TOL[dtype]})" if gated else
                     f"(printed; {held})")
                  + f" [{card}]")
            require(not gated or rel <= LOGIT_REL_TOL[dtype],
                    f"static {what} {dtype} logits differ")
    for what in ("prefill", "decode"):
        (kb, pb), (_, pf) = got[what, torch.bfloat16], got[what, torch.float32]
        print(f"[logits] {cfg.name} static {what} "
              f"{'int8 ' if quantized else ''}bf16 against the plain fp32 "
              f"path: plain bf16 rel={_rel(pb, pf):.3g}, kernels bf16 "
              f"rel={_rel(kb, pf):.3g} [{card}]")


def _int8_codes(P, x):
    """The activation codes the int8 junction makes of ``x`` [E, M, n_in]
    (per row and input block, dynamic scale; ``bsm.int8_sums``)."""
    xb = x.float().reshape(*x.shape[:-1], -1, BS)
    sx = P.bsm._slot_scale(xb, None)
    return torch.clamp(torch.round(xb / sx), -127, 127)


def int8_code_gaps(P, cfg, params, prompts, extra, card):
    """The fp32 int8 static prefill and one decode step through the
    kernels and through their plain versions, launch by launch: every
    ``fwd_int8`` launch against its plain version on the launch's own
    inputs within QUANT_TOL; the activation codes of each launch's input
    on the two paths, counted where they differ (an fp32 ulp of one
    junction's output moves a later activation across a rounding
    boundary of its code); then the plain path again with each int8
    junction fed the kernel path's input: its logits within
    LOGIT_REL_TOL of the kernels' (the codes fed, only the arithmetic of
    the launches and the ops between them differs)."""
    c = dataclasses.replace(cfg, dtype="float32")
    real, ref = P.bsm.fwd_int8, P.bsm.fwd_int8_ref

    def trace(fn, feed=None):
        seen = []

        def call(x, *a, **kw):
            if feed is not None:
                x = feed[len(seen)]
            out = fn(x, *a, **kw)
            seen.append((x.detach().clone(), a, kw, out.detach()))
            return out

        call.launches = real.launches
        with mock.patch.object(P.bsm, "fwd_int8", call):
            logits = _static_steps(P, c, params, prompts, extra)
        real.launches = call.launches
        return torch.stack(logits, 1), seen

    kl, ks = trace(real)
    pl, ps = trace(ref)
    rl, _ = trace(ref, [x for x, _, _, _ in ks])
    require(len(ks) == len(ps), "the int8 paths ran other launches")
    worst, gap, n_exact, n_codes, n_flips, flipped = (-1.0, 0.0, 0, 0, 0,
                                                      0)
    tol = QUANT_TOL[torch.float32]
    for (x, a, kw, out), (px, _, _, _) in zip(ks, ps):
        want = ref(x, *a, **kw)
        err = (out - want).abs() - tol["atol"] - tol["rtol"] * want.abs()
        worst = max(worst, float(err.max()))
        gap = max(gap, max_err(out, want))
        n_exact += bits_equal(out, want)
        flips = int((_int8_codes(P, x) != _int8_codes(P, px)).sum())
        n_codes += x.numel()
        n_flips += flips
        flipped += flips > 0
    print(f"[codes] {cfg.name} int8 fp32 prefill and decode step: "
          f"{len(ks)} fwd_int8 launches, each against its plain version on "
          f"its own inputs: max_abs_err {gap:.3g}, {n_exact} bit for bit, "
          f"largest excess over QUANT_TOL {worst:.3g} (<= 0); activation "
          f"codes that differ between the two paths "
          f"{n_flips} of {n_codes} in {flipped} launches; logits kernels vs "
          f"plain rel {_rel(kl, pl):.4g}, vs plain fed the kernels' "
          f"junction inputs rel {_rel(kl, rl):.4g} (tol "
          f"{LOGIT_REL_TOL[torch.float32]}) [{card}]")
    require(worst <= 0.0, f"{cfg.name}: an fwd_int8 launch differs from its "
            "plain version on its own inputs")
    require(_rel(kl, rl) <= LOGIT_REL_TOL[torch.float32],
            f"{cfg.name}: int8 fp32 logits differ with the codes fed")


def _continuous(P, cfg, params, prompts, new=16):
    """The same uniform prompts through ContinuousEngine: [B, new]."""
    B, S = prompts.shape
    eng = P.engine.ContinuousEngine(cfg, params, P.engine.ServeConfig(
        max_new_tokens=new, slots=4, page_size=16, prefill_chunk=32,
        max_seq=S + new), device="cuda")
    outs = eng.serve([P.engine.Request(i, prompts[i], new)
                      for i in range(B)])
    return np.stack([outs[i] for i in range(B)])


def static_parity_check(P, card):
    """The reference's contract (tests/test_serve_continuous.py): at full
    width, 2 layers, fp32, the static engine's greedy tokens equal the
    continuous engine's on the same uniform prompts.  Where they differ,
    the top-2 gap of the static logits there is printed, and it fails."""
    cfg = dataclasses.replace(
        P.registry.get("stablelm-3b").with_sparsity(P.SparsityConfig(
            density=0.25, block=128, where="ffn")),
        n_layers=2, dtype="float32")
    params = P.M.init(cfg, seed=0, device="cuda")
    prompts, _ = _launcher_inputs(cfg)
    static = P.engine.Engine(cfg, params, P.engine.ServeConfig(
        max_new_tokens=16), device="cuda").generate(prompts)
    cont = _continuous(P, cfg, params, prompts)
    diff = np.argwhere(static != cont)
    if len(diff):
        i, j = diff[0]
        seq = np.concatenate([prompts[i], static[i, :j]])[None]
        logits, _, _ = P.M.forward(cfg, params, {"tokens": seq})
        top2 = torch.topk(logits[0, -1].float(), 2).values
        print(f"[serve] static vs continuous differ first at request {i} "
              f"token {j}: top-2 logit gap {float(top2[0] - top2[1]):.4g} "
              f"[{card}]")
    print(f"[serve] stablelm-3b 2 layers fp32: static = continuous on "
          f"{float(np.mean(static == cont)):.3f} of tokens [{card}]")
    require(not len(diff), "static and continuous greedy tokens differ")
    del params
    torch.cuda.empty_cache()


def static_serve_run(P, card, arch, quant=None, layers=0, gaps=False):
    """The static engine on sparse ``arch``: at full size through
    launch/serve.py without --continuous, or, ``layers`` deep, built here
    as the launcher builds it; bf16 or ``quant``: 16 tokens a sequence, no
    non-finite row, exact launch counts, a second generate, one decode
    step profiled, the prefill and one decode step against the plain
    versions (layer by layer: with ``gaps`` on MoE, always on bf16
    state-space models).  Returns its launch counts."""
    P.ops.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if layers:
        cfg = dataclasses.replace(P.registry.get(arch), n_layers=layers
                                  ).with_sparsity(P.SparsityConfig(
                                      density=0.25, block=BS, where="ffn"))
        scfg = P.engine.ServeConfig(max_new_tokens=STATIC_STEPS,
                                    quantize=quant)
        eng = P.engine.Engine(cfg, P.M.init(cfg, 0, "cuda"), scfg,
                              device="cuda")
        out = eng.generate(*_launcher_inputs(cfg))
    else:
        argv = ["--arch", arch, *STATIC_ARGS] + (
            ["--quantize", quant] if quant else [])
        out, made = _served(P, lambda: P.serve.main(argv))
        ((_, eng),) = made
        del made
    dt = time.perf_counter() - t0
    counts = P.ops.launch_counts()
    path = with_tc(P, counts)
    cfg = eng.cfg
    name = f"{arch}{' ' + quant if quant else ''}" + (
        f" {layers} layers" if layers else "")
    require(out.shape == (8, STATIC_STEPS), f"{name}: tokens {out.shape}")
    require(eng.nonfinite_terminated == 0,
            f"{name}: {eng.nonfinite_terminated} rows non-finite")
    want = dict.fromkeys(counts, 0)
    want.update(serve_calls(cfg, bool(quant), STATIC_STEPS - 1))
    require(counts == want, f"{name} static launches {counts} != {want}")
    # every junction call has at least 8 rows: bf16 on tensor cores (the
    # int8 kernels have no tensor-core count)
    tc = {k: counts[k] for k in P.ops.tc_launch_counts()}
    require(P.ops.tc_launch_counts() == tc,
            f"{name} tensor-core launches {P.ops.tc_launch_counts()}")
    n_params = sum(t.numel() for t in _leaves(eng.params)
                   if t.is_floating_point() or t.dtype == torch.int8)
    prompts, extra = _launcher_inputs(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = eng.generate(prompts, extra)
    warm = time.perf_counter() - t0
    require(np.array_equal(again, out), f"{name}: a second generate "
            "of the same prompts gave other tokens")
    print(f"[serve] static {name}: {cfg.family}, {cfg.n_layers} layers, "
          f"{n_params / 1e9:.3f} B params and codes held (param_count "
          f"{cfg.param_count() / 1e9:.3f} B dense); "
          f"{'init' if layers else 'launcher'} {dt:.2f} s "
          f"(init, load and generate); generate again {warm:.3f} s = "
          f"{8 * STATIC_STEPS / warm:.1f} tok/s (8 x {STATIC_STEPS} "
          f"tokens, {STATIC_STEPS} model calls); peak_memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
          f"launches={path} [{card}]")
    static_step_breakdown(P, eng, prompts, extra, name, card)
    if arch == "stablelm-3b" and not quant:
        cont = _continuous(P, cfg, eng.params, prompts)
        print(f"[serve] static {name} bf16: greedy agreement with the "
              f"continuous engine {float(np.mean(cont == out)):.3f} "
              f"(per request "
              f"{[round(float(v), 3) for v in (cont == out).mean(1)]}) "
              f"[{card}]")
    # a deep ssm or hybrid model in bf16: each kernel launch and each
    # block is held on the same inputs (ssm_layer_gaps), the end-to-end
    # gap printed beside the plain bf16 path's own distance from fp32
    by_block = cfg.family in ("ssm", "hybrid") and not quant
    # whisper in int8: its encoder's 8 x 1500 rows put millions of
    # activations through the dynamic int8 codes, where the two paths'
    # fp32 ulps move some to the neighbouring code (int8_code_gaps)
    by_codes = cfg.family == "audio" and bool(quant)
    if by_block:
        ssm_layer_gaps(P, cfg, eng.params, prompts, card)
    elif gaps:
        moe_layer_gaps(P, cfg, eng.params, prompts, card)
    if by_codes:
        int8_code_gaps(P, cfg, eng.params, prompts, extra, card)
    compare_static_logits(P, cfg, eng.params, prompts, extra, bool(quant),
                          card, gate_bf16=not by_block,
                          gate_fp32=not by_codes)
    del eng
    torch.cuda.empty_cache()
    return path


def static_serve_phase(P, card):
    """launch/serve.py without --continuous on full-size stablelm-3b and
    qwen3-moe-30b-a3b (bf16, then --quantize int8), ``static_serve_run``;
    qwen3-moe's bf16 prefill layer by layer (``moe_layer_gaps``); the bf16
    tokens' agreement with the continuous engine; the 2-layer fp32
    parity; then --ckpt."""
    paths = collections.Counter()
    for arch, quant in (("stablelm-3b", None), ("stablelm-3b", "int8"),
                        ("qwen3-moe-30b-a3b", None),
                        ("qwen3-moe-30b-a3b", "int8")):
        paths.update(static_serve_run(
            P, card, arch, quant,
            gaps=arch == "qwen3-moe-30b-a3b" and not quant))
    static_parity_check(P, card)
    ckpt_check(P, card)
    return dict(paths)


# ------------------------------------------------- bf16 layer by layer
def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _drop_last_slot(P, x, w, idx, bias, *a, **kw):
    """The control of the block-by-block check: fwd's plain version with
    each output block's last fan-in slot left out (a kernel whose loop
    over the slots stops one short)."""
    w = w.clone()
    w[:, :, -1] = 0
    return P.bsm.fwd_ref(x, w, idx, bias, *a, **kw)


def _trace(P, cfg, params, run, plain, replay=None, feed=None, fault=False,
           held=None):
    """``run(cfg)`` -> (logits, cache), a static prefill or decode step in
    bf16, through the kernels or (``plain``) their plain versions
    (``fault``: the plain fwd that leaves out a slot).  Returns (its last
    logits fp32, its cache, each block's output in call order, each MoE
    layer's expert choices [G, g, K], each block's mixer as (input,
    output fp32): the Mamba mixer of a state-space block, the FFN of an
    attention block).  ``replay`` (a list of expert choices) routes each
    MoE layer as given, with this path's own probabilities; ``feed`` (a
    list of mixer inputs) gives each mixer that input in place of its
    own; ``held`` (a list) gets ``fwd_held`` of each fwd launch."""
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    outs, experts, mix = [], [], []
    real_top_k, real_fwd = P.moe._top_k, P.bsm.fwd

    def block(fn):
        def call(lp, x, *a, **kw):
            res = fn(lp, x, *a, **kw)
            outs.append(res[0].detach().float())
            return res
        return call

    def mixer(fn):
        def call(lp, h, *a, **kw):
            if feed is not None:
                h = feed[len(mix)]
            res = fn(lp, h, *a, **kw)
            mix.append((h.detach(), res[0].detach().float()))
            return res
        return call

    def top_k(probs, k):
        if replay is None:
            vals, idx = real_top_k(probs, k)
        else:
            idx = replay[len(experts)]
            vals = torch.gather(probs, -1, idx)
        experts.append(idx)
        return vals, idx

    def fwd(x, w, idx, bias, act="none", save_pre=False):
        out = real_fwd(x, w, idx, bias, act, save_pre)
        held.append(fwd_held(P, x, w, idx, bias, act,
                             out[0] if save_pre else out))
        return out

    # the kernel's wrapper counts its launches on the module's ``fwd``
    fwd.launches, fwd.tc_launches = real_fwd.launches, real_fwd.tc_launches

    with contextlib.ExitStack() as stack:
        for n in ("_attn_mlp_block", "_ssm_block"):
            stack.enter_context(mock.patch.object(P.M, n,
                                                  block(getattr(P.M, n))))
        for n in ("_ffn", "mamba1_apply", "mamba2_apply"):
            stack.enter_context(mock.patch.object(P.M, n,
                                                  mixer(getattr(P.M, n))))
        stack.enter_context(mock.patch.object(P.moe, "_top_k", top_k))
        if plain:
            stack.enter_context(mock.patch.object(P.bsm, "gated_fwd",
                                                  P.bsm.gated_fwd_ref))
            stack.enter_context(mock.patch.object(
                P.bsm, "fwd", functools.partial(_drop_last_slot, P)
                if fault else P.bsm.fwd_ref))
        elif held is not None:
            stack.enter_context(mock.patch.object(P.bsm, "fwd", fwd))
        logits, cache = run(cfg)
    real_fwd.launches, real_fwd.tc_launches = fwd.launches, fwd.tc_launches
    return logits[:, -1].float(), cache, outs, experts, mix


def _rel(a, b) -> float:
    return max_err(a, b) / float(b.abs().max())


def _prefill_run(P, params, prompts):
    tokens = torch.as_tensor(prompts, device="cuda")
    return lambda c: P.steps.make_prefill_step(c)(params,
                                                  {"tokens": tokens})[:2]


def moe_layer_gaps(P, cfg, params, prompts, card):
    """The bf16 static prefill of a MoE model through the kernels and
    through their plain versions, block by block: each block's output gap
    (max |diff| over max |plain|, as the logits are held), each path
    running on its own outputs, and the tokens whose top-k expert set
    differs; then the plain path again routed as the kernels routed: if
    the gap of its logits falls to the level of the other bf16 cells, the
    routing flips account for the gap; and the gap over the rows with and
    without a flipped token in any layer."""
    B, S = prompts.shape
    nd = cfg.moe.first_dense_layers     # blocks with no expert choices
    run = _prefill_run(P, params, prompts)
    kl, _, ko, ke, _ = _trace(P, cfg, params, run, plain=False)
    pl, _, po, pe, _ = _trace(P, cfg, params, run, plain=True)
    require(len(ko) == len(po) and len(ke) == len(pe) == len(ko) - nd,
            "the two prefills ran other blocks")
    flipped = torch.zeros((B, S), dtype=torch.bool, device="cuda")
    for i, (a, b) in enumerate(zip(ko, po)):
        diff = torch.zeros_like(flipped) if i < nd else (
            torch.sort(ke[i - nd], -1).values
            != torch.sort(pe[i - nd], -1).values).any(-1).reshape(B, S)
        flipped |= diff
        print(f"[gap] {cfg.name} bf16 prefill block {i}: rel "
              f"{_rel(a, b):.4g}, tokens whose expert set differs "
              f"{int(diff.sum())} [{card}]")
    rl, _, _, _, _ = _trace(P, cfg, params, run, plain=True, replay=ke)
    rows = flipped.any(-1)
    line = (f"[gap] {cfg.name} bf16 prefill logits: rel {_rel(kl, pl):.4g}"
            f" (each path on its own outputs); plain routed as the kernels "
            f"routed: rel {_rel(kl, rl):.4g}; {int(flipped.sum())} of "
            f"{B * S} tokens flipped in some layer, {int(rows.sum())} of "
            f"{B} rows hold one")
    for what, m in (("rows with a flip", rows), ("rows without", ~rows)):
        if bool(m.any()):
            line += f"; {what}: rel {_rel(kl[m], pl[m]):.4g}"
    print(line + f" [{card}]")


def ssm_layer_gaps(P, cfg, params, prompts, card):
    """A deep state-space model's bf16 static prefill and the decode step
    after it (from the kernel path's prefill cache), through the kernels
    and through their plain versions.  Every fwd launch of the kernel path
    is held against the junction in fp64 on the same operands
    (``fwd_held``, at the main path's own shapes: 256 rows in the prefill,
    8 in the decode step).  Every block's mixer is held on the same
    input: the plain mixer is fed the kernel path's mixer input, and the
    gap of the mixer's output (max |diff| over max |plain output|, the
    block's own contribution, not the residual stream it is added to)
    must stay within LOGIT_REL_TOL, which a control (the plain fwd
    leaving out each output block's last fan-in slot) must exceed; so
    must the decode step's logits, both paths starting from one cache.
    Each block's output gap with each path on its own outputs is printed
    beside: a one-ulp rounding difference in one block reaches every
    block after it."""
    B, S = prompts.shape
    tol = LOGIT_REL_TOL[torch.bfloat16]
    eng = P.engine.Engine(cfg, params, device="cuda")
    tok = torch.as_tensor(prompts[:, :1], device="cuda")
    pre = _prefill_run(P, params, prompts)
    for what, run in (("prefill", pre), ("decode", None)):
        if run is None:      # the decode step from the kernels' prefill
            full = eng._grow_cache(cache, B, S + 1, S)
            run = lambda c: P.steps.make_decode_step(c)(   # noqa: E731
                params, _clone(full), tok, S)
        held = []
        kl, kc, ko, _, kmix = _trace(P, cfg, params, run, plain=False,
                                     held=held)
        if what == "prefill":
            cache = kc
        pl, _, po, _, _ = _trace(P, cfg, params, run, plain=True)
        feed = [h for h, _ in kmix]
        _, _, _, _, fmix = _trace(P, cfg, params, run, plain=True,
                                  feed=feed)
        _, _, _, _, cmix = _trace(P, cfg, params, run, plain=True,
                                  feed=feed, fault=True)
        require(len(ko) == len(po) == len(kmix) == len(fmix) == len(cmix),
                f"{cfg.name} {what}: the paths ran other blocks")
        own, ctrl = [], []
        for i, (a, b) in enumerate(zip(ko, po)):
            yk, yf, yc = kmix[i][1], fmix[i][1], cmix[i][1]
            own.append(_rel(yk, yf))
            ctrl.append(_rel(yc, yf))
            print(f"[gap] {cfg.name} bf16 {what} block {i}: rel "
                  f"{_rel(a, b):.4g} (each path on its own outputs); its "
                  f"mixer on the same input {own[-1]:.4g}, control "
                  f"{ctrl[-1]:.4g} [{card}]")
        rows = sorted({(r["M"], r["kb"]) for r in held})
        worst = max(held, key=lambda r: r["ratio"])
        print(f"[held] {cfg.name} bf16 {what}: {len(held)} fwd launches "
              f"at (M, kb) {rows}, each against fp64 on its operands: "
              f"worst |err| over its bound {worst['ratio']:.4g} (M "
              f"{worst['M']}, kb {worst['kb']}) [{card}]")
        # the decode step starts both paths from one cache: its logits
        # are held end to end too
        print(f"[gap] {cfg.name} bf16 {what} logits: rel {_rel(kl, pl):.4g}"
              + (f" (from one cache, tol {tol})" if what == "decode" else
                 " (each path on its own outputs)")
              + f"; worst mixer on the same input {max(own):.4g} (tol "
              f"{tol}), least control {min(ctrl):.4g} [{card}]")
        require(what == "prefill" or _rel(kl, pl) <= tol,
                f"{cfg.name}: the decode step's logits differ")
        require(len(held) == junction_calls(cfg)["junction_fwd"],
                f"{cfg.name} {what}: {len(held)} fwd launches held")
        require(worst["ratio"] <= 1.0, f"{cfg.name} {what}: a fwd launch "
                f"lies beyond its bound: {worst}")
        require(max(own) <= tol < min(ctrl),
                f"{cfg.name} {what}: a mixer's kernels differ from its "
                "plain versions on the same input, or the control passed")
    del eng, cache, full
    torch.cuda.empty_cache()


# the checkpoint check's depth: full width, CKPT_LAYERS of stablelm-3b's
# 32 layers (at 32 its checkpoint was 11 GiB and the check 40-60 s)
CKPT_LAYERS = 2


def ckpt_check(P, card):
    """launch/train.py (one SGD step of sparse stablelm-3b at full width
    and CKPT_LAYERS layers, its exit checkpoint under build/) and
    launch/serve.py --ckpt at the same depth, static and --continuous:
    the params each launcher hands its engine equal the trained ones bit
    for bit, and the tokens equal serving the trained params held in
    memory through the same engine."""
    ck = ROOT / "build" / "ckpt_serve"
    shutil.rmtree(ck, ignore_errors=True)
    depth = ["--layers", str(CKPT_LAYERS)]
    t0 = time.perf_counter()
    res = P.train.main(["--arch", "stablelm-3b", "--sparse", "--optim",
                        "sgd", "--steps", "1", "--ckpt", str(ck), *depth])
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    size = sum(f.stat().st_size for f in ck.rglob("*") if f.is_file())
    trained = dict(P.tree_items(res["params"]))
    del res["opt_state"]
    torch.cuda.empty_cache()
    for mode in ("static", "continuous"):
        argv = ["--arch", "stablelm-3b", "--ckpt", str(ck), *depth,
                *STATIC_ARGS] + (["--continuous"] if mode == "continuous"
                                 else [])
        t0 = time.perf_counter()
        out, made = _served(P, lambda: P.serve.main(argv))
        dt = time.perf_counter() - t0
        ((name, eng),) = made
        got = dict(P.tree_items(eng.params))
        require(got.keys() == trained.keys(), f"{mode}: other leaves")
        for k, v in trained.items():
            require(got[k].dtype == v.dtype
                    and torch.equal(_bits(got[k]), _bits(v)),
                    f"{mode}: restored {k} differs from the trained one")
        prompts, _ = _launcher_inputs(eng.cfg)
        if mode == "static":
            want = P.engine.Engine(eng.cfg, res["params"], eng.scfg,
                                   device="cuda").generate(prompts)
            same = np.array_equal(out, want)
        else:
            ref = P.engine.ContinuousEngine(
                eng.cfg, res["params"], eng.scfg, device="cuda").serve(
                [P.engine.Request(i, prompts[i], 16) for i in range(8)])
            same = all(np.array_equal(out[i], ref[i]) for i in range(8))
        print(f"[serve] --ckpt {mode}: train {t_train:.1f} s, checkpoint "
              f"{size / 2 ** 30:.2f} GiB, serve launcher {dt:.1f} s; "
              f"restored params equal the trained ones bit for bit, tokens "
              f"equal serving them from memory: {same} [{card}]")
        require(same, f"--ckpt {mode}: tokens differ from the in-memory "
                "params'")
        del eng, made, got
        torch.cuda.empty_cache()
    shutil.rmtree(ck, ignore_errors=True)
    del res, trained
    torch.cuda.empty_cache()


# ------------------------------------------- ssm, hybrid, dense configs
# falcon-mamba-7b trains at full width and 2 of its 64 layers (8 before
# the mesh phase's state-space paths came; qwen3-moe trains 6 of 48): one
# layer holds 0.03 B junction and 0.05 B dense params, and the
# embeddings 0.53 B
SSM_TRAIN_LAYERS = 2
# the dense configs no other phase drives, at full width and 2 layers:
# command-r-plus-104b's tied 256000 x 12288 embedding alone is 12.6 GB in
# fp32
DENSE_CONFIGS = ("qwen2-72b", "deepseek-7b", "command-r-plus-104b")
DENSE_CONFIG_LAYERS = 2
# the junctions these configs bring to the kernels (kb up to 66, zamba2's
# in_xbc with 41 output blocks), timed at the static prefill's 256 rows
NEW_SHAPES = [("falcon-mamba-7b in_proj", 4096, 16384),
              ("falcon-mamba-7b out_proj", 8192, 4096),
              ("zamba2-2.7b in_z", 2560, 5120),
              ("zamba2-2.7b in_xbc", 2560, 5248),
              ("zamba2-2.7b out_proj", 5120, 2560),
              ("zamba2-2.7b wi", 2560, 10240),
              ("zamba2-2.7b wo", 10240, 2560),
              ("qwen2-72b wo", 29568, 8192),
              ("command-r-plus-104b wo", 33792, 12288)]


# fwd's bf16 output held against the junction computed in fp64 on the
# same operands.  The kernel sums K = kb * bs exact products in fp32, adds
# the bias, applies the activation (slope at most FWD_SLOPE) and rounds
# once to bf16, so |got - ref| <= (2^-8 + 2^-20) |ref| + (1 + 2^-8)
# FWD_SLOPE |v - ref|, v its fp32 sum (2^-20 for the bias add and the
# activation in fp32).  |v - ref|, the error of a sum of K terms in fp32
# in the kernel's order, is held to FWD_LAMBDA sqrt(K) 2^-23 S, S the sum
# of |x w| over the output's K terms: the probabilistic bound of an fp32
# sum (rounding errors of random sign, one ulp an add for tensor cores
# that truncate).  FWD_LAMBDA sits between what sound launches read and
# what the control (``_slotwise_bf16_fwd``) reads: on an H100, sound
# launches at most 0.025 of the bound at NEW_SHAPES and 0.054 on the
# state-space models' prefill and decode steps, the control at least 8.9.
FWD_SLOPE = 1.13
FWD_LAMBDA = 1.0


def fwd_held(P, x, w, idx, bias, act, got) -> dict:
    """fwd's output ``got`` against the junction in fp64: its rows, kb, the
    largest |got - ref| (``err``), and ``ratio``, the largest excess over
    the rounding term (|got - ref| - (2^-8 + 2^-20) |ref|) over its
    bound (1 + 2^-8) FWD_SLOPE FWD_LAMBDA sqrt(K) 2^-23 S: at most 1."""
    M = x.shape[1]
    _, _, kb, bs, _ = w.shape
    x64, w64 = x.double(), w.double()
    ref = P.bsm.fwd_ref(x64, w64, idx, bias.double(), act)
    S = P.bsm.fwd_ref(x64.abs(), w64.abs(), idx,
                      torch.zeros_like(bias, dtype=torch.float64))
    err = (got.double() - ref).abs()
    over = (err - (2.0 ** -8 + 2.0 ** -20) * ref.abs()).clamp_min(0)
    lim = ((1 + 2.0 ** -8) * FWD_SLOPE * FWD_LAMBDA * (kb * bs) ** 0.5
           * 2.0 ** -23 * S)
    return {"M": M, "kb": kb, "err": float(err.max()),
            "ratio": float((over / lim.clamp_min(1e-300)).max())}


def gated_held(P, x, wg, wi, idx, got) -> dict:
    """gated_fwd's output ``got`` (h = silu(g) u from the two fp32 sums,
    rounded once) against the junction in fp64, as ``fwd_held`` holds fwd:
    the excess over the rounding term (2^-8 + 2^-20) |h| (the silu and
    the product in fp32 included) over the sums' bound, where each sum's
    error e is held to FWD_LAMBDA sqrt(K) 2^-23 S of its own S and carries
    into h as FWD_SLOPE e_g (|u| + e_u) + |silu(g)| e_u."""
    M = x.shape[1]
    _, _, kb, bs, _ = wg.shape
    x64 = x.double()
    zero = torch.zeros((x.shape[0], wg.shape[1] * bs), dtype=torch.float64,
                       device=x.device)
    g = P.bsm.fwd_ref(x64, wg.double(), idx, zero)
    u = P.bsm.fwd_ref(x64, wi.double(), idx, zero)
    ref = P.bsm.act_fwd(g, "silu") * u
    unit = FWD_LAMBDA * (kb * bs) ** 0.5 * 2.0 ** -23
    e_g = unit * P.bsm.fwd_ref(x64.abs(), wg.double().abs(), idx, zero)
    e_u = unit * P.bsm.fwd_ref(x64.abs(), wi.double().abs(), idx, zero)
    err = (got.double() - ref).abs()
    over = (err - (2.0 ** -8 + 2.0 ** -20) * ref.abs()).clamp_min(0)
    lim = (1 + 2.0 ** -8) * (FWD_SLOPE * e_g * (u.abs() + e_u)
                             + P.bsm.act_fwd(g, "silu").abs() * e_u)
    return {"M": M, "kb": kb, "err": float(err.max()),
            "ratio": float((over / lim.clamp_min(1e-300)).max())}


def _slotwise_bf16_fwd(P, x, w, idx, bias, act="none", split=1):
    """The control of ``fwd_held``: the junction with each fan-in slot's
    partial sum (each of its ``split`` parts along K: at a fan-in of one
    slot the slot's sum is the output and rounds once either way) rounded
    to bf16 before the sum (a kernel that carries its sum in bf16)."""
    E, M, n_in = x.shape
    _, nob, kb, bs, _ = w.shape
    xb = x.reshape(E, M, n_in // bs, bs)
    c = bs // split
    acc = torch.zeros((E, M, nob, bs), dtype=torch.float32, device=x.device)
    for k in range(kb):
        xk = xb[:, :, idx[:, k].long()].float()
        for j in range(0, bs, c):
            acc += torch.einsum("emob,eobc->emoc", xk[..., j:j + c],
                                w[:, :, k, j:j + c].float()
                                ).to(x.dtype).float()
    s = acc.reshape(E, M, nob * bs) + bias.float()[:, None, :]
    return P.bsm.act_fwd(s, act).to(x.dtype)


def _slotwise_bf16_gated(P, x, wg, wi, idx):
    """The control of ``gated_held``: both branches' slot sums carried in
    bf16 (``_slotwise_bf16_fwd``), h = silu(g) u from them."""
    zero = torch.zeros((x.shape[0], wg.shape[1] * wg.shape[3]),
                       dtype=x.dtype, device=x.device)
    g = _slotwise_bf16_fwd(P, x, wg, idx, zero).float()
    u = _slotwise_bf16_fwd(P, x, wi, idx, zero).float()
    return (P.bsm.act_fwd(g, "silu") * u).to(x.dtype)


def held_shapes(P, timer, card, shapes, seed, rows=(8, 8 * 32)):
    """fwd (or, for a shape marked gated, gated_fwd) at each ``(name,
    n_in, n_out, E, gated)`` of ``shapes``, at each of ``rows`` (a unit's
    rows; by default the decode step's 8 and the prefill's 256), in bf16:
    held against the junction in fp64 (``fwd_held`` / ``gated_held``)
    beside a control that carries its slot sums in bf16 (at a fan-in of
    one slot, its four 32-term parts) and must fail it, and timed beside
    its plain version and its bound.  Returns {(name, M): (ms, plain_ms,
    bound_ms, ratio, control)}."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    out = {}
    for name, n_in, n_out, E, gated in shapes:
        pat = P.make_block_pattern(n_in, n_out, 0.25, BS, seed=1)
        nob, kb = pat.n_out_blocks, pat.fan_in_blocks
        idx = torch.as_tensor(pat.idx, device="cuda")
        ws = [(torch.randn((E, nob, kb, BS, BS), generator=gen,
                           device="cuda") / (kb * BS) ** 0.5
               ).to(torch.bfloat16) for _ in range(1 + gated)]
        b = torch.zeros((E, n_out), device="cuda", dtype=torch.bfloat16)
        split = 4 if kb == 1 else 1
        for M in rows:
            x = torch.randn((E, M, n_in), generator=gen,
                            device="cuda").to(torch.bfloat16)
            if gated:
                kern = functools.partial(P.bsm.gated_fwd, x, *ws, idx)
                plain = functools.partial(P.bsm.gated_fwd_ref, x, *ws, idx)
                held = gated_held(P, x, *ws, idx, kern())
                ctrl = gated_held(P, x, *ws, idx,
                                  _slotwise_bf16_gated(P, x, *ws, idx))
            else:
                kern = functools.partial(P.bsm.fwd, x, ws[0], idx, b)
                plain = functools.partial(P.bsm.fwd_ref, x, ws[0], idx, b)
                held = fwd_held(P, x, ws[0], idx, b, "none", kern())
                ctrl = fwd_held(P, x, ws[0], idx, b, "none",
                                _slotwise_bf16_fwd(P, x, ws[0], idx, b,
                                                   split=split))
            k_ms, p_ms = timer.ms(kern), timer.ms(plain)
            nbytes = (x.numel() + sum(w.numel() for w in ws)
                      + (0 if gated else b.numel()) + E * M * n_out) * 2 \
                + idx.numel() * 4
            bnd, by = bound_ms(nbytes, 2 * E * M * nob * kb * BS * BS
                               * len(ws), torch.bfloat16)
            kname = "junction_gated_fwd_tc" if gated else "junction_fwd_tc"
            print(f"[kernel] {kname} {name} {n_in}->{n_out} E={E} "
                  f"nob={nob} kb={kb} M={M} bf16: max_abs_err against fp64 "
                  f"{held['err']:.3g}, |err| over its bound "
                  f"{held['ratio']:.4g}; control ("
                  + ("slot" if split == 1 else f"1/{split}-slot")
                  + f" sums rounded to bf16) {ctrl['ratio']:.4g} "
                  f"ms={k_ms:.4f} "
                  f"plain_ms={p_ms:.4f} bound_ms={bnd:.4f} ({by}) [{card}]")
            require(held["ratio"] <= 1.0 < ctrl["ratio"],
                    f"{kname} at {name}, M {M}: {held}, control {ctrl}")
            out[name, M] = (k_ms, p_ms, bnd, held["ratio"], ctrl["ratio"])
    return out


def ssm_phase(P, card):
    """falcon-mamba-7b (Mamba-1, 64 layers, d_inner 8192, N 16): the static
    engine at full size in bf16 (held launch by launch and block by block)
    and int8, then training at full width and SSM_TRAIN_LAYERS layers on
    the three update paths."""
    paths = {"ssm_serve": static_serve_run(P, card, "falcon-mamba-7b"),
             "ssm_serve_int8": static_serve_run(P, card, "falcon-mamba-7b",
                                                "int8")}
    paths["ssm_train"] = train_phase(P, card, "falcon-mamba-7b",
                                     SSM_TRAIN_LAYERS)
    return paths


def hybrid_phase(P, card):
    """zamba2-2.7b (54 Mamba-2 layers in 9 super-blocks of 6 sharing one
    attention block) at full size: the static engine in bf16, two-pass
    Adam training (the fused update refuses the shared block), and one
    step against the plain versions at 4 layers (super-blocks of 2: the
    shared block's gradient sums over two uses)."""
    return {"hybrid_serve": static_serve_run(P, card, "zamba2-2.7b"),
            "hybrid_train": train_phase(
                P, card, "zamba2-2.7b", kinds=("two_pass",),
                depth={"n_layers": 4, "hybrid_attn_every": 2})}


def dense_configs_phase(P, timer, card):
    """qwen2-72b (QKV bias), deepseek-7b and command-r-plus-104b (tied
    embeddings) on the static engine at full width and 2 layers; then the
    fwd kernel at every junction shape the new configs bring, at the
    decode step's 8 rows and the prefill's 256, held against the
    junction in fp64 (``fwd_held``) beside a control that must fail it,
    and timed beside its bound."""
    paths = collections.Counter()
    for arch in DENSE_CONFIGS:
        paths.update(static_serve_run(P, card, arch,
                                      layers=DENSE_CONFIG_LAYERS))
    held_shapes(P, timer, card, [(n, i, o, 1, False)
                                 for n, i, o in NEW_SHAPES], seed=26)
    return dict(paths)


# ---------------------------------------------- vlm (sliding window), MLA
# llava-next-mistral-7b trains at full width and 8 of its 32 layers
# (0.95 B held: a layer holds 0.04 B attention and 0.04 B junction
# params, the embeddings 0.26 B); deepseek-v2-lite-16b at 4 of 27, the
# dense first layer and 3 MoE layers (0.98 B: a MoE layer's 64 sparse
# experts hold 0.14 B, the embeddings 0.42 B)
VLM, MLA = "llava-next-mistral-7b", "deepseek-v2-lite-16b"
VLM_TRAIN_LAYERS, MLA_TRAIN_LAYERS = 8, 4
# the ring at full width: 2 layers, 2 rows, a prompt of 4160 tokens after
# the 576 patches, L = 4736 positions: past the 4096-slot window and not
# a multiple of it, so the prefill wraps the ring and decode runs on
RING_LAYERS, RING_PROMPT, RING_NEW = 2, 4160, 4
# the junctions the two bring to the kernels: (name, n_in, n_out, E,
# gated); the experts' gate as one gated junction of 64 units
VLM_SHAPES = [("llava wi/wg", 4096, 14336, 1, False),
              ("llava wo", 14336, 4096, 1, False)]
MLA_SHAPES = [("deepseek experts wg+wi", 2048, 1408, 64, True),
              ("deepseek experts wo", 1408, 2048, 64, False),
              ("deepseek shared wi/wg", 2048, 2816, 1, False),
              ("deepseek shared wo", 2816, 2048, 1, False)]


def ring_check(P, card):
    """llava's sliding window at full width (RING_LAYERS layers, 2 rows):
    the static engine prefills RING_PROMPT tokens after the 576 patches
    (more positions than the 4096-slot ring holds, not a multiple of it)
    and decodes RING_NEW tokens, with exact launch counts.  In fp32 the
    prefill's last logits and each decode step's, fed the engine's own
    tokens, are held against the port's forward recomputed over the
    whole sequence (patches, prompt and the tokens before), within 2e-4
    of max |logit|; in bf16 the same steps through the kernels against
    their plain versions, within LOGIT_REL_TOL.  Returns the launch
    counts of the two generates."""
    cfg = dataclasses.replace(P.registry.get(VLM), n_layers=RING_LAYERS
                              ).with_sparsity(P.SparsityConfig(
                                  density=0.25, block=BS, where="ffn"))
    rng = np.random.default_rng(27)
    B = 2
    prompts = rng.integers(0, cfg.vocab, size=(B, RING_PROMPT)
                           ).astype(np.int32)
    extra = {"patches": rng.standard_normal(
        (B, cfg.num_patches, cfg.d_model)).astype(np.float32)}
    batch = _prefill_batch(prompts, extra)
    L = cfg.num_patches + RING_PROMPT
    require(L > cfg.window and L % cfg.window,
            f"the ring check's {L} positions do not wrap the ring")
    paths = collections.Counter()

    def steps(c, params, fed):
        """The engine's prefill, its cache grown, then a decode step a
        token of ``fed``: [B, 1 + len(fed), V] fp32 logits."""
        eng = P.engine.Engine(c, params, device="cuda")
        lp, cache, n = eng._prefill(eng.params, batch)
        require(n == L, f"the ring's prefill holds {n} positions, not {L}")
        cache = eng._grow_cache(cache, B, L + RING_NEW, L)
        out = [lp[:, -1].float()]
        for i in range(fed.shape[1]):
            ld, cache = eng._decode(eng.params, cache,
                                    torch.as_tensor(fed[:, i:i + 1],
                                                    device="cuda"), L + i)
            out.append(ld[:, -1].float())
        require(cache["k"].shape[2] == cfg.window,
                f"ring of {cache['k'].shape[2]} slots")
        return torch.stack(out, 1)

    toks = {}
    for dtype in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, dtype=dtype)
        params = P.M.init(c, seed=0, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        P.ops.reset_launch_counts()
        t0 = time.perf_counter()
        toks[dtype] = P.engine.Engine(c, params, P.engine.ServeConfig(
            max_new_tokens=RING_NEW), device="cuda").generate(prompts, extra)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = P.ops.launch_counts()
        want = dict.fromkeys(counts, 0)
        want.update({k: n * RING_NEW for k, n in junction_calls(c).items()})
        require(counts == want, f"ring {dtype} launches {counts} != {want}")
        paths.update(with_tc(P, counts))
        fed = toks[dtype][:, :-1]
        if dtype == "float32":
            got = steps(c, params, fed)
            seq = np.concatenate([prompts, fed], 1)
            full, _, (_, off) = P.M.forward(c, params, {
                "tokens": torch.as_tensor(seq, device="cuda"),
                "patches": batch["patches"]})
            want_l = full[:, L - 1:].float()
            del full
            rel = _rel(got, want_l)
            same = bool((got.argmax(-1)[:, :RING_NEW]
                         == torch.as_tensor(toks[dtype], device="cuda")
                         ).all())
            print(f"[ring] {VLM} {RING_LAYERS} layers fp32, {L} positions "
                  f"({cfg.num_patches} patches + {RING_PROMPT} tokens) into "
                  f"a {cfg.window}-slot ring, {RING_NEW} new: generate "
                  f"{dt:.2f} s, peak_memory "
                  f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
                  f"prefill and decode logits against the forward over the "
                  f"whole sequence rel {rel:.3g} (tol 2e-4), greedy tokens "
                  f"equal its argmax: {same}; launches={counts} [{card}]")
            require(off == cfg.num_patches and rel <= 2e-4 and same,
                    "the ring's decode differs from the forward")
        else:
            k_l = steps(c, params, fed)
            with contextlib.ExitStack() as stack:
                for name in ("fwd", "gated_fwd"):
                    stack.enter_context(mock.patch.object(
                        P.bsm, name, getattr(P.bsm, f"{name}_ref")))
                p_l = steps(c, params, fed)
            rel = _rel(k_l, p_l)
            print(f"[ring] {VLM} {RING_LAYERS} layers bf16: generate "
                  f"{dt:.2f} s; prefill and decode logits kernels vs plain "
                  f"versions rel {rel:.3g} (tol "
                  f"{LOGIT_REL_TOL[torch.bfloat16]}); greedy agreement with "
                  f"fp32 {float(np.mean(toks[dtype] == toks['float32'])):.3f}"
                  f" [{card}]")
            require(rel <= LOGIT_REL_TOL[torch.bfloat16],
                    "the ring's bf16 logits differ, kernels vs plain")
        del params
        torch.cuda.empty_cache()
    return dict(paths)


def vlm_phase(P, timer, card):
    """llava-next-mistral-7b (mistral backbone, a 4096-token sliding
    window, 576 stub patches): the static engine at full size in bf16
    and int8 (launch/serve.py, 16 patches ahead of each 32-token prompt),
    the ring at full width (``ring_check``), training at full width and
    VLM_TRAIN_LAYERS layers on the three update paths (128 patches and
    128 tokens a row), and fwd at its junctions (``held_shapes``)."""
    paths = {"vlm_serve": static_serve_run(P, card, VLM),
             "vlm_serve_int8": static_serve_run(P, card, VLM, "int8"),
             "vlm_ring": ring_check(P, card)}
    paths["vlm_train"] = train_phase(P, card, VLM, VLM_TRAIN_LAYERS)
    held_shapes(P, timer, card, VLM_SHAPES, seed=27)
    return paths


def mla_phase(P, timer, card):
    """deepseek-v2-lite-16b (MLA, a dense first layer, 64 routed experts
    top-6 and 2 shared): the static engine at full size in bf16 (its
    prefill block by block, ``moe_layer_gaps``) and int8, training at
    full width and MLA_TRAIN_LAYERS layers on the three update paths, and
    fwd / gated_fwd at its junctions (``held_shapes``)."""
    paths = {"mla_serve": static_serve_run(P, card, MLA, gaps=True),
             "mla_serve_int8": static_serve_run(P, card, MLA, "int8")}
    paths["mla_train"] = train_phase(P, card, MLA, MLA_TRAIN_LAYERS)
    held_shapes(P, timer, card, MLA_SHAPES, seed=28)
    return paths


# whisper-base at full size: its FFN junctions (512 -> 2048 at kb 1 with
# the gelu epilogue, 2048 -> 512 at kb 4) at the decode step's 8 rows, the
# decoder's prefill of 256 and the encoder's 8 x 1500 frames; one step
# against the plain versions at 2 encoder and 2 decoder layers
AUDIO = "whisper-base"
AUDIO_SHAPES = [("whisper wi", 512, 2048, 1, False),
                ("whisper wo", 2048, 512, 1, False)]
AUDIO_DEPTH = {"n_layers": 2, "enc_layers": 2}
# launch/train.py --compress-grads: 3 Adam steps on these, at full width
# (stablelm-3b cut to 2 layers, whisper-base whole)
COMPRESS_RUNS = (("stablelm-3b", 2), (AUDIO, 0))
COMPRESS_STEPS = 3


def audio_phase(P, timer, card):
    """whisper-base (6 encoder and 6 decoder layers, d_model 512, 1500 stub
    frames a request) at full size: the static engine in bf16 and int8
    (launch/serve.py: the encoder runs in the prefill alone, so a prefill
    makes 2 x (6 + 6) junction launches and a decode step 2 x 6), training
    on the three update paths (each row of 256 tokens with its 1500
    frames) with one step against the plain versions at AUDIO_DEPTH, and
    fwd at its junctions (``held_shapes``) at 8, 256 and the encoder's
    8 x 1500 rows."""
    enc_rows = 8 * P.registry.get(AUDIO).enc_frames
    paths = {"audio_serve": static_serve_run(P, card, AUDIO),
             "audio_serve_int8": static_serve_run(P, card, AUDIO, "int8")}
    paths["audio_train"] = train_phase(P, card, AUDIO, depth=AUDIO_DEPTH)
    held_shapes(P, timer, card, AUDIO_SHAPES, seed=29,
                rows=(8, 8 * 32, enc_rows))
    return paths


def _compress_property(P, card):
    """The reference's property of compression (tests/test_distributed.py)
    on the card: 1000 gradients of scale 0.01 restored within 2 %, and the
    residual of a second compression from the first's residual no larger
    than 1.5 x it."""
    gc = P.grad_compress
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    g = torch.randn(1000, generator=gen, device="cuda") * 0.01
    restored, err2 = gc.compress_decompress(g, torch.zeros_like(g))
    rel = float(torch.linalg.norm(restored - g) / torch.linalg.norm(g))
    _, err3 = gc.compress_decompress(g, err2)
    n2, n3 = float(torch.linalg.norm(err2)), float(torch.linalg.norm(err3))
    print(f"[compress] 1000 gradients of scale 0.01: restored rel err "
          f"{rel:.4g} (tol 0.02); residual {n2:.4g} then {n3:.4g} "
          f"(tol 1.5 x) [{card}]")
    require(rel < 0.02 and n3 <= 1.5 * n2 + 1e-6,
            "compression loses the reference's property")


def compress_run(P, card, arch, layers):
    """launch/train.py --compress-grads on sparse ``arch`` at full width
    (``layers`` deep, or whole): COMPRESS_STEPS two-pass Adam steps of
    batch 8 x 256 with finite losses and residuals, exact launch counts
    (fwd, dx and dw; no update_dw), and the compression of one more
    step's gradients (``grad_compress.compress_tree``, one scale a stack
    of layers) on the card bit for bit equal to the same function on the
    CPU.  Returns its launch counts."""
    gc = P.grad_compress
    ckpt = ROOT / "build" / f"compress_{arch}"
    sink = ckpt.with_suffix(".jsonl")
    shutil.rmtree(ckpt, ignore_errors=True)
    argv = ["--arch", arch, "--sparse", "--compress-grads", "--steps",
            str(COMPRESS_STEPS), "--batch", str(TRAIN_B), "--seq",
            str(TRAIN_S), "--ckpt", str(ckpt), "--obs", str(sink)] + (
                ["--layers", str(layers)] if layers else [])
    P.ops.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        res = P.train.main(argv)
    dt = time.perf_counter() - t0
    _, events = P.obs.read_events(str(sink))
    shutil.rmtree(ckpt, ignore_errors=True)
    sink.unlink()
    counts = P.ops.launch_counts()
    path = with_tc(P, counts)
    text = out.getvalue()
    print(text, end="")
    cfg = P.registry.get(arch).with_sparsity(
        P.SparsityConfig(density=0.25, block=BS, where="ffn"))
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    losses = [e["loss"] for e in events if e["kind"] == "train.step"]
    err = [e for _, e in P.tree_items(res["opt_state"]["err"])]
    err_norm = float(torch.sqrt(sum(torch.sum(e.double() ** 2)
                                    for e in err)))
    want = _expected_launches(P, cfg, COMPRESS_STEPS, "two_pass")
    print(f"[compress] {arch} layers={cfg.n_layers}: launcher "
          f"{dt:.2f} s (init, {COMPRESS_STEPS} steps with --obs, "
          f"checkpoint); losses from its train.step events "
          f"{[round(v, 4) for v in losses]}; residual norm {err_norm:.4g}; "
          f"peak_memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
          f"GiB; launches={path} [{card}]")
    require("update path: two-pass" in text,
            f"{arch} --compress-grads did not print the two-pass path")
    require(len(losses) == COMPRESS_STEPS and all(np.isfinite(losses)),
            f"{arch} --compress-grads losses {losses}")
    require(all(bool(torch.isfinite(e).all()) for e in err),
            f"{arch} --compress-grads residuals not finite")
    require(counts == want and counts["junction_update_dw"] == 0,
            f"{arch} --compress-grads launches {counts} != {want}")
    params, state = res["params"], res["opt_state"]
    del res
    batch = next(P.LMTokenPipeline(cfg, TRAIN_B, TRAIN_S))
    _, _, grads = P.steps._value_and_grad(cfg, params, batch)
    t0 = time.perf_counter()
    r_card, e_card = gc.compress_tree(params, grads, state["err"])
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0

    def cpu(tree):
        return P.tree_map(lambda t: t.cpu() if torch.is_tensor(t) else t,
                          tree)

    r_cpu, e_cpu = gc.compress_tree(cpu(params), cpu(grads),
                                    cpu(state["err"]))
    n, same = 0, True
    for a, b in ((r_card, r_cpu), (e_card, e_cpu)):
        for (_, x), (_, y) in zip(P.tree_items(a), P.tree_items(b)):
            if torch.is_tensor(x) and x.is_floating_point():
                n += x.numel()
                same = same and bits_equal(x.cpu(), y)
    g_all = [g.float() for g in P.tree_leaves(grads) if torch.is_tensor(g)]
    r_all = [r for r, g in zip(P.tree_leaves(r_card), P.tree_leaves(grads))
             if torch.is_tensor(g)]
    rel = float(torch.sqrt(sum(torch.sum((r - g) ** 2)
                               for r, g in zip(r_all, g_all)))
                / torch.sqrt(sum(torch.sum(g ** 2) for g in g_all)))
    print(f"[compress] {arch}: compress_tree of one step's gradients, "
          f"{n / 2 / 1e6:.1f} M elements, {card_s * 1e3:.1f} ms on the "
          f"card: restored gradients and residuals equal to the CPU's bit "
          f"for bit: {same}; restored rel err over the tree {rel:.4g} "
          f"(printed) [{card}]")
    require(same, f"{arch}: compression on the card differs from the CPU")
    del params, state, grads, r_card, e_card
    torch.cuda.empty_cache()
    return path


def compress_phase(P, card):
    """launch/train.py --compress-grads (``compress_run``) on each of
    COMPRESS_RUNS, and the reference's property of compression on the
    card (``_compress_property``)."""
    _compress_property(P, card)
    return {f"compress_{arch}": compress_run(P, card, arch, layers)
            for arch, layers in COMPRESS_RUNS}


# ------------------------------------------------ the perf variant
# the dry run's perf-sparse variant (launch/dryrun._apply_variant): FFN
# density 0.125 at block 128, bf16-resident params with fp32 masters in
# Adam, the cross-entropy in chunks of 2048; stablelm-3b at full width
# and PERF_LAYERS layers, PERF_STEPS two-pass steps of TRAIN_B x TRAIN_S
PERF_LAYERS, PERF_STEPS, PERF_LR = 2, 3, 1e-4


def perf_cfg(P):
    return dataclasses.replace(P.dryrun._apply_variant(
        P.registry.get("stablelm-3b"), "perf-sparse"), n_layers=PERF_LAYERS)


def perf_phase(P, card):
    """The perf-sparse variant's train step with
    ``adam(constant_schedule(PERF_LR), master_copy=True)``: ``train_run``'s
    PERF_STEPS two-pass steps (exact fwd / dx / dw launches, none of
    update_dw: a master-copy Adam never fuses) and ``compare_train_step``
    over the same number of steps against the plain versions; the
    roofline of the same step counted on ``meta`` tensors
    (``roofline.analysis.analyze``) beside the measured step and its
    device time; the peak memory beside the same config with fp32 params
    and Adam without masters."""
    R = P.roofline
    require(R.PEAK_FLOPS == PEAK_OPS_PER_S[torch.bfloat16]
            and R.HBM_BW == HBM_BYTES_PER_S,
            "the roofline's H100 constants differ from this script's")
    cfg = perf_cfg(P)
    require(cfg.sparsity.block == BS, "perf: the variant's block moved")
    opt = P.optim.adam(P.optim.constant_schedule(PERF_LR), master_copy=True)
    path, run = train_run(P, cfg, opt, "two_pass", card, PERF_STEPS)
    require(path["junction_update_dw"] == 0,
            "perf: a master-copy Adam launched update_dw")
    compare_train_step(P, cfg, cfg.dtype, False, card,
                       {"n_layers": PERF_LAYERS}, opt, PERF_LR, PERF_STEPS)
    meta = P.M.init(cfg, seed=0, device="meta")
    batch = next(P.LMTokenPipeline(cfg, TRAIN_B, TRAIN_S))
    roof = R.analyze(P.steps.make_train_step(cfg, opt), meta,
                     opt.init(meta), {k: torch.as_tensor(v).to("meta")
                                      for k, v in batch.items()}, 0)
    shape = P.ShapeSpec("perf", TRAIN_S, TRAIN_B, "train")
    mf = R.model_flops(cfg, shape)
    med, dev_ms = run["step_s"], run["device_ms"]
    share = roof.dot_flops / med / R.PEAK_FLOPS
    print(f"[perf] roofline of the step (counted on meta): dot_flops "
          f"{roof.dot_flops:.4g}, mem_bytes {roof.mem_bytes:.4g} (eager, "
          f"every op's inputs and outputs), t_compute "
          f"{roof.t_compute * 1e3:.3f} ms, t_memory "
          f"{roof.t_memory * 1e3:.3f} ms, dominant {roof.dominant}; "
          f"measured: median step after the first {med * 1e3:.1f} ms, "
          f"kernels {dev_ms:.1f} ms ({dev_ms / (med * 1e3):.1%} busy); "
          f"achieved {roof.dot_flops / med:.4g} FLOP/s = {share:.2%} of "
          f"{R.PEAK_FLOPS:.4g}; model_flops {mf:.4g} (useful fraction "
          f"{R.useful_fraction(cfg, shape, roof.dot_flops, 1):.3f}), MFU "
          f"{mf / med / R.PEAK_FLOPS:.2%} [{card}]")
    require(roof.dot_flops > 0 and share <= 1.05,
            f"perf: dot_flops {roof.dot_flops}, share {share:.3f}")
    base = dataclasses.replace(cfg, param_dtype="float32")
    _, run32 = train_run(P, base,
                         P.optim.adam(P.optim.constant_schedule(PERF_LR)),
                         "two_pass", card, 2)
    print(f"[perf] peak memory of the steps: {run['peak_gib']:.2f} GiB (bf16 "
          f"params, fp32 masters) against {run32['peak_gib']:.2f} GiB (the "
          f"same config with fp32 params, Adam without masters) [{card}]")
    return {"perf": path}, run


# ------------------------------------------------------ the dry run
# launch/dryrun.py's cells run here at full size, one of each serving
# kind and the decode cell of the largest mesh: each counts on meta
DRYRUN_CELLS = [("stablelm-3b", "prefill_32k", "single", "perf-sparse"),
                ("whisper-base", "decode_32k", "single", "dense"),
                ("qwen3-moe-30b-a3b", "decode_32k", "multi", "dense")]


def dryrun_phase(P, card, run):
    """``launch/dryrun.run_cell`` on DRYRUN_CELLS into the git-ignored
    ``build/dryrun/`` (their ``[dryrun]`` lines): the dry run touches no
    card memory and launches no kernel.  Then the perf phase's own step
    (``perf_cfg``, batch TRAIN_B x TRAIN_S) counted on
    ``AbstractMesh((1, 1))`` (``dryrun.count_cell``): its predicted
    per-device bytes (at-rest shards + the eager peak on ``meta``)
    beside ``train_run``'s measured peak, its t_compute beside the
    measured step.  The at-rest bytes must not exceed the measured peak,
    and the roofline's HBM_CAPACITY must be the card's memory within 1 %;
    the ratios are printed, not held."""
    D, R = P.dryrun, P.roofline
    out = ROOT / "build" / "dryrun"
    mem0, launches0 = torch.cuda.memory_allocated(), P.ops.launch_counts()
    for arch, shape, mesh, variant in DRYRUN_CELLS:
        rec = D.run_cell(arch, shape, mesh, variant, out, force=True)
        require(rec["ok"], f"dryrun {rec['cell']}: {rec.get('error')}")
    cfg = perf_cfg(P)
    mesh = P.mesh.AbstractMesh((1, 1), ("data", "model"))
    t0 = time.perf_counter()
    rl, held = D.count_cell(cfg, P.ShapeSpec("perf", TRAIN_S, TRAIN_B,
                                             "train"), mesh)
    count_s = time.perf_counter() - t0
    require(torch.cuda.memory_allocated() == mem0
            and P.ops.launch_counts() == launches0,
            "the dry run touched the card")
    total = torch.cuda.get_device_properties(0).total_memory
    require(abs(R.HBM_CAPACITY / total - 1) <= 0.01,
            f"HBM_CAPACITY {R.HBM_CAPACITY} is not the card's {total}")
    at_rest = sum(held.values()) / 2**30
    peak = rl.memory_stats["peak_bytes"] / 2**30
    pred = at_rest + peak
    meas, step = run["peak_gib"], run["step_s"]
    require(at_rest <= meas, f"dryrun: at rest {at_rest:.3f} GiB above the "
            f"measured peak {meas:.3f}")
    print(f"[dryrun] the perf step ({cfg.name} perf-sparse, "
          f"{PERF_LAYERS} layers, {TRAIN_B} x {TRAIN_S}, "
          f"{D.execution(cfg)}) on "
          f"AbstractMesh((1, 1)), counted on meta in {count_s:.1f} s: "
          f"predicted per_device {pred:.3f} GiB (at rest {at_rest:.3f} + "
          f"eager peak {peak:.3f}) against the measured peak "
          f"{meas:.3f} GiB: ratio {pred / meas:.3f} (eager peak alone "
          f"{peak / meas:.3f}); t_compute {rl.t_compute * 1e3:.3f} ms, "
          f"t_memory {rl.t_memory * 1e3:.3f} ms against the measured step "
          f"{step * 1e3:.1f} ms: ratios {rl.t_compute / step:.4f}, "
          f"{rl.t_memory / step:.4f}; HBM_CAPACITY {R.HBM_CAPACITY} B, "
          f"the card's total_memory {total} B ({R.HBM_CAPACITY / total:.4f})"
          f" [{card}]")


# ------------------------------------------- the mesh and the pipeline
# launch/train.py --devices 1 --data 1 --model 1 (a one-rank NCCL group,
# params and Adam placed by their specs) against the same launcher
# without a mesh, and the fused step under that mesh against the plain
# step: stablelm-3b at full width and MESH_LAYERS layers
MESH_ARCH, MESH_LAYERS, MESH_STEPS = "stablelm-3b", 2, 3
# the pipeline's stages: a stablelm-3b layer's sparse MLP (wg with silu,
# wi, wo: 2560 <-> 6912 at kb 5 / 14, block 128) with its pre-norm and
# residual, bf16 compute on fp32 weights (bf16 weights would round
# most updates, and the two paths' roundings apart); PIPE_M microbatches
# of PIPE_ROWS rows.  The loss is half the squared error summed over a
# row, averaged over the rows.
PIPE_S, PIPE_M, PIPE_ROWS, PIPE_LR, PIPE_EPOCHS = 4, 8, 256, 1e-2, 2
# the reference's tanh case (tests/test_distributed.py): D 16, 4 stages,
# 8 microbatches of 4 rows, lr 0.05, 25 epochs, fp32
TANH = dict(D=16, S=4, M=8, rows=4, lr=0.05, epochs=25)


def _tree_bits_equal(P, a, b) -> bool:
    """Two trees equal bit for bit, leaf for leaf, whatever the dtypes."""
    return all(x.dtype == y.dtype and x.shape == y.shape and torch.equal(
        x.flatten().view(torch.uint8), y.flatten().view(torch.uint8))
        for (_, x), (_, y) in zip(P.tree_items(a), P.tree_items(b)))


def _launcher(P, argv, name):
    """launch/train.py's main on ``argv`` with its stdout printed: (the
    result, the per-step losses and seconds of its train.step events,
    the launches)."""
    ckpt = ROOT / "build" / f"mesh_{name}"
    sink = ckpt.with_suffix(".jsonl")
    shutil.rmtree(ckpt, ignore_errors=True)
    P.ops.reset_launch_counts()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = P.train.main(argv + ["--ckpt", str(ckpt), "--obs", str(sink)])
    torch.cuda.synchronize()
    counts = with_tc(P, P.ops.launch_counts())
    _, events = P.obs.read_events(str(sink))
    shutil.rmtree(ckpt, ignore_errors=True)
    sink.unlink()
    print(out.getvalue(), end="")
    steps = [e for e in events if e["kind"] == "train.step"]
    return (res, [e["loss"] for e in steps], [e["dt_s"] for e in steps],
            counts, out.getvalue())


def mesh_phase(P, card):
    """The mesh on the card: a one-rank NCCL group, then

    * ``launch/train.py --devices 1 --data 1 --model 1`` (the launcher's
      two-pass Adam) for MESH_STEPS steps of batch 8 x 256 against the
      same launcher without a mesh: losses and trained params equal bit
      for bit (one rank splits and sums nothing), exact launches, the
      bytes the rank holds at rest (the launcher's line);
    * the fused step (fused SGD with momentum, bf16 params) under the
      same mesh for MESH_FUSED (stablelm-3b, llava-next-mistral-7b,
      falcon-mamba-7b, qwen3-moe-30b-a3b, deepseek-v2-lite-16b and
      whisper-base at full width, cut in depth), ``_mesh_fused``: the
      partitioned route (``make_mesh_train_step``) and the gathered one
      against the plain step, from the same weights and batches: losses
      and params bit for bit, exact launches on the tensor cores (no dw,
      no gated_dw), the three step times.

    * the partitioned route (``steps.partitioned``: the dense family,
      two-pass) under the same mesh, ``_mesh_partitioned``: train,
      prefill and decode steps against the plain steps, its step time
      beside today's gathered mesh step, its predicted peak beside the
      measured one;
    * the MoE family's partitioned route the same way (``MESH_MOE``:
      qwen3-moe-30b-a3b and deepseek-v2-lite-16b sparse at full width
      and MESH_LAYERS layers, deepseek's first dense), bit for bit
      against the plain steps, through the gated kernels;
    * the ssm and hybrid families' partitioned route the same way
      (``MESH_SSM``: falcon-mamba-7b at 2 of its 64 layers, zamba2-2.7b at
      one super-block, its 6 Mamba-2 layers and the shared block), bit
      for bit against the plain steps, through fwd / dx / dw;
    * the vlm family's partitioned route the same way (``MESH_VLM``:
      llava-next-mistral-7b sparse at full width and MESH_LAYERS of its
      32 layers, 16 patches ahead of each row's text, attention under its
      4096-token window, the prefill's cache its ring), bit for bit
      against the plain steps, through fwd / dx / dw;
    * the audio family's partitioned route on the "sp" strategy the same
      way (``MESH_AUDIO``: whisper-base whole and sparse, its frames
      through the encoder), bit for bit against the plain steps, through
      fwd / dx / dw.

    Prints each path's median step time beside the plain path's, and for
    the two cells whose step waits on the host (zamba2-2.7b's and
    whisper-base's) the partitioned and plain steps in turns
    (``_host_split``)."""
    cfg = dataclasses.replace(
        P.registry.get(MESH_ARCH).with_sparsity(
            P.SparsityConfig(density=0.25, block=BS, where="ffn")),
        n_layers=MESH_LAYERS)
    argv = ["--arch", MESH_ARCH, "--sparse", "--layers", str(MESH_LAYERS),
            "--steps", str(MESH_STEPS), "--batch", str(TRAIN_B), "--seq",
            str(TRAIN_S)]
    P.mesh.start_one_rank_group("cuda")
    try:
        mesh = P.mesh.make_local_mesh(1, 1, "cuda")
        res, losses, dts, counts, text = _launcher(
            P, argv + ["--devices", "1", "--data", "1", "--model", "1"],
            "one_rank")
        got = P.sharding.gather(res["params"])
        del res
        want = _expected_launches(P, cfg, MESH_STEPS, "two_pass")
        plain, p_losses, p_dts, p_counts, _ = _launcher(P, argv, "plain")
        same = _tree_bits_equal(P, got, plain["params"])
        del plain, got
        torch.cuda.empty_cache()
        print(f"[mesh] launch/train.py --devices 1 {MESH_ARCH} "
              f"layers={MESH_LAYERS}: losses {losses}, median step "
              f"{statistics.median(dts) * 1e3:.1f} ms (steps "
              f"{[round(v * 1e3, 1) for v in dts]}) against the plain "
              f"launcher's {p_losses}, {statistics.median(p_dts) * 1e3:.1f} "
              f"ms ({[round(v * 1e3, 1) for v in p_dts]}); params equal "
              f"bit for bit: {same}; launches={counts} [{card}]")
        require("update path: two-pass" in text and "[train] mesh data=1"
                in text, "the mesh launcher did not take its path")
        require(losses == p_losses and same,
                "the one-rank mesh launcher differs from the plain one")
        require({k: counts[k] for k in want} == want and counts == p_counts,
                f"mesh launcher launches {counts} != {want}")
        paths = {"mesh_train": counts}
        for arch, depth in MESH_FUSED:
            fused_cfg = dataclasses.replace(
                P.registry.get(arch).with_sparsity(P.SparsityConfig(
                    density=0.25, block=BS, where="ffn")), **depth)
            paths["mesh_fused" + ("" if arch == MESH_ARCH else f"_{arch}")] \
                = _mesh_fused(P, fused_cfg, mesh, card)
        paths.update(_mesh_partitioned(P, cfg, mesh, card))
        for arch in MESH_MOE:
            moe_cfg = dataclasses.replace(
                P.registry.get(arch).with_sparsity(P.SparsityConfig(
                    density=0.25, block=BS, where="ffn")),
                n_layers=MESH_LAYERS)
            paths.update(_mesh_partitioned(P, moe_cfg, mesh, card,
                                           MOE_KEYS, MESH_MOE_TIMED, True))
        for arch, depth in MESH_SSM:
            ssm_cfg = dataclasses.replace(
                P.registry.get(arch).with_sparsity(P.SparsityConfig(
                    density=0.25, block=BS, where="ffn")), **depth)
            paths.update(_mesh_partitioned(P, ssm_cfg, mesh, card,
                                           DENSE_KEYS, MESH_MOE_TIMED, True))
            if ssm_cfg.family == "hybrid":
                _host_split(P, ssm_cfg, mesh, card)
        for arch, depth in (MESH_VLM, MESH_AUDIO):
            one_cfg = dataclasses.replace(
                P.registry.get(arch).with_sparsity(P.SparsityConfig(
                    density=0.25, block=BS, where="ffn")), **depth)
            paths.update(_mesh_partitioned(P, one_cfg, mesh, card,
                                           DENSE_KEYS, MESH_MOE_TIMED, True))
        _host_split(P, one_cfg, mesh, card)
    finally:
        torch.distributed.destroy_process_group()
    return paths


# the partitioned and plain steps in turns, MESH_PAIRS of each
# (``_host_split``), and the route's own host functions timed under
# cProfile there, by file and name
MESH_PAIRS = 8
HOST_FUNCS = (("sharding.py", "wrap_like"), ("partition.py", "local_tree"),
              ("sharding.py", "with_junction_views"),
              ("steps.py", "mesh_partition"), ("partition.py", "gather"),
              ("partition.py", "seq_shard"), ("partition.py", "tokens"),
              ("checkpoint.py", "checkpoint"))


def _host_split(P, cfg, mesh, card, pairs=MESH_PAIRS):
    """The partitioned and the plain two-pass Adam step of ``cfg`` in
    turns on the one-rank mesh from the same weights and batches,
    ``pairs`` steps each after a warm-up step each, the order swapped
    every pair: each step's wall time, the time the garbage collector
    paused it and the blocks it took from the card
    (``segment.all.allocated``: a cudaMalloc each); then one more step of
    each under cProfile: the Python calls, their own time and the
    cumulative time of the route's functions (HOST_FUNCS).  Prints every
    step's time with the median, least and most of each."""
    import cProfile
    import gc
    import pstats
    opt = P.optim.adam(P.optim.constant_schedule(MESH_LR))
    pipe = P.LMTokenPipeline(cfg, TRAIN_B, TRAIN_S)
    batches = [next(pipe) for _ in range(pairs + 2)]
    runs = {}
    for kind in ("plain", "partitioned"):
        params = P.M.init(cfg, seed=0, device="cuda")
        state = opt.init(params)
        if kind == "plain":
            step = P.steps.make_train_step(cfg, opt)
        else:
            specs = P.sharding.param_specs(cfg, params, mesh)
            params = P.sharding.place(params, specs, mesh)
            state = P.sharding.place_state(state, specs, mesh)
            step = P.steps.make_mesh_train_step(cfg, opt, mesh)
        runs[kind] = [step, params, state]
    paused = [0.0, 0.0]        # seconds paused in this step, the start

    def on_gc(phase, info):
        if phase == "start":
            paused[1] = time.perf_counter()
        else:
            paused[0] += time.perf_counter() - paused[1]

    def one(kind, i):
        step, params, state = runs[kind]
        torch.cuda.synchronize()
        seg = torch.cuda.memory_stats()["segment.all.allocated"]
        paused[0] = 0.0
        t0 = time.perf_counter()
        params, state, m = step(params, state, batches[i], i)
        float(m["loss"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        runs[kind][1:] = [params, state]
        return (dt * 1e3, paused[0] * 1e3,
                torch.cuda.memory_stats()["segment.all.allocated"] - seg)

    got = {k: [] for k in runs}
    gc.callbacks.append(on_gc)
    try:
        for kind in runs:
            one(kind, 0)
        for i in range(pairs):
            for kind in (("plain", "partitioned") if i % 2 == 0
                         else ("partitioned", "plain")):
                got[kind].append(one(kind, 1 + i))
    finally:
        gc.callbacks.remove(on_gc)
    prof = {}
    for kind in runs:
        pr = cProfile.Profile()
        pr.enable()
        one(kind, pairs + 1)
        pr.disable()
        st = pstats.Stats(pr)
        funcs = collections.Counter()
        for (path, _, name), (_, _, _, ct, _) in st.stats.items():
            key = (Path(path).name, name)
            if key in HOST_FUNCS:
                funcs[f"{key[0]}:{name}"] += round(ct * 1e3, 2)
        prof[kind] = (st.total_calls, st.total_tt * 1e3, dict(funcs))
    wraps = _wrap_times(P, runs["partitioned"][1:])
    del runs
    torch.cuda.empty_cache()

    def spread(vals):
        return (f"{[round(v, 1) for v in vals]} median "
                f"{statistics.median(vals):.1f} (least {min(vals):.1f}, "
                f"most {max(vals):.1f})")
    for kind in got:
        dts, gcs, segs = zip(*got[kind])
        print(f"[host] {cfg.name} {kind} step in turns ({pairs} after a "
              f"warm-up, one-rank mesh): ms {spread(dts)}; garbage "
              f"collector paused it ms {[round(v, 1) for v in gcs]}; "
              f"cudaMalloc {list(segs)} [{card}]")
    for kind, (calls, tt, funcs) in prof.items():
        print(f"[host] {cfg.name} {kind} step under cProfile: {calls} "
              f"Python calls, {tt:.1f} ms of their own time; route "
              f"functions cumulative ms {funcs} [{card}]")
    med = [statistics.median(v[0] for v in got[k]) for k in got]
    print(f"[host] {cfg.name}: partitioned / plain median "
          f"{med[1] / med[0]:.4f}; unwrapping and wrapping the "
          f"{wraps[0]} leaves of params and state, as a step does: "
          f"DTensor.to_local / from_local each {wraps[1]:.2f} ms, "
          f"partition.local_tree / sharding.wrap_like {wraps[2]:.2f} ms "
          f"[{card}]")


def _wrap_times(P, trees, reps=5):
    """(the DTensor leaves of ``trees``, the median ms of unwrapping and
    wrapping them all through ``to_local`` / ``from_local`` each, as the
    partitioned step did before, and through ``partition.local_tree`` /
    ``sharding.wrap_like``, as it does now)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.parallel import partition

    def wrap(t, like):
        if not isinstance(like, DTensor) or not t.is_floating_point():
            return like
        return DTensor.from_local(t, like.device_mesh, like.placements,
                                  run_check=False, shape=like.shape,
                                  stride=like.stride())

    def each():
        for tree in trees:
            local = P.tree_map(lambda t: t.to_local()
                               if isinstance(t, DTensor) else t, tree)
            P.tree_map(wrap, local, tree)

    def now():
        for tree in trees:
            P.sharding.wrap_like(partition.local_tree(tree), tree)
    times = {each: [], now: []}
    for _ in range(reps):
        for fn in times:
            t0 = time.perf_counter()
            fn()
            times[fn].append((time.perf_counter() - t0) * 1e3)
    n = sum(isinstance(t, DTensor) for tree in trees
            for t in P.tree_leaves(tree))
    return n, statistics.median(times[each]), statistics.median(times[now])


def _mesh_fused(P, cfg, mesh, card):
    """The fused step (fused SGD with momentum, bf16 params) under the
    one-rank ``mesh`` for ``cfg`` (a MESH_FUSED arch, sparse at full
    width, cut in depth): MESH_STEPS steps each through the partitioned
    route (``make_mesh_train_step``: ``steps.partitioned`` gives it
    every family's fused step), the gathered route
    (``make_gathered_mesh_train_step``) and the plain fused step, from
    the same weights and batches: losses and params bit for bit against
    the plain step on both routes, exact launches of fwd, dx and
    update_dw (and of a MoE's gated_fwd, gated_dx and update_gated_dw)
    on the tensor cores and none of dw or gated_dw, the three median
    step times after the first."""
    cfg = dataclasses.replace(cfg, fused_update=True, param_dtype="bfloat16")
    opt = P.optim.fused_sgd(P.optim.cosine_schedule(3e-4, 20, 100),
                            momentum=0.9)
    require(P.steps.partitioned(cfg, opt),
            f"{cfg.name}'s fused step is not on the partitioned route")
    pipe = P.LMTokenPipeline(cfg, TRAIN_B, TRAIN_S)
    batches = [next(pipe) for _ in range(MESH_STEPS)]

    def run(kind):
        params = P.M.init(cfg, seed=0, device="cuda")
        state = opt.init(params)
        if kind == "plain":
            step = P.steps.make_train_step(cfg, opt)
        else:
            specs = P.sharding.param_specs(cfg, params, mesh)
            params = P.sharding.place(params, specs, mesh)
            state = P.sharding.place_state(state, specs, mesh)
            make = (P.steps.make_mesh_train_step if kind == "partitioned"
                    else P.steps.make_gathered_mesh_train_step)
            step = make(cfg, opt, mesh)
        torch.cuda.synchronize()
        P.ops.reset_launch_counts()
        losses, dts = [], []
        for i, batch in enumerate(batches):
            t0 = time.perf_counter()
            params, state, m = step(params, state, batch, i)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            dts.append(time.perf_counter() - t0)
        counts = with_tc(P, P.ops.launch_counts())
        if kind != "plain":
            params = P.sharding.gather(params)
        return params, losses, dts, counts

    plain = run("plain")
    part = run("partitioned")
    gath = run("gathered")
    same = [_tree_bits_equal(P, r[0], plain[0]) and r[1] == plain[1]
            for r in (part, gath)]
    want = _expected_launches(P, cfg, MESH_STEPS, "fused")
    want_tc = _expected_tc(P, cfg, want)
    counts = part[3]
    keys = FUSED_KEYS + (GATED_FUSED_KEYS if cfg.family == "moe" else ())
    sub = {k: counts[k] for k in keys} | {
        f"{k}_tc": counts[f"{k}_tc"] for k in keys}
    med = [statistics.median(r[2][1:]) * 1e3 for r in (part, gath, plain)]
    print(f"[mesh] fused SGD step under the one-rank mesh, {cfg.name} "
          f"layers={cfg.n_layers} {cfg.dtype}: losses {part[1]} against "
          f"the plain step's {plain[1]}; params and losses bit for bit: "
          f"partitioned {same[0]}, gathered {same[1]}; median step after "
          f"the first: partitioned {med[0]:.1f} ms, gathered {med[1]:.1f} "
          f"ms, plain {med[2]:.1f} ms (steps "
          f"{[[round(v * 1e3, 1) for v in r[2]] for r in (part, gath, plain)]}"
          f"); launches {sub} [{card}]")
    require(all(same),
            f"{cfg.name}: the fused step under the mesh differs from the "
            "plain step")
    require({k: counts[k] for k in want} == want
            and all(counts[k] == plain[3][k] == gath[3][k] for k in sub)
            and counts["junction_dw"] == counts["junction_gated_dw"] == 0
            and all(counts[f"{k}_tc"] == want_tc[k] == want[k] > 0
                    for k in keys),
            f"{cfg.name}: mesh fused launches {counts} != {want}")
    del part, gath, plain
    torch.cuda.empty_cache()
    return sub


# the partitioned route's decode: the prompt's last MESH_DECODE positions
# are padding (the cache's size is the prompt's), decoded over greedily;
# its train step, today's gathered mesh step and the plain step run
# MESH_TIMED steps each (MESH_MOE_TIMED for the MoE family), in that
# order after the plain one
MESH_DECODE, MESH_LR, MESH_TIMED, MESH_MOE_TIMED = 4, 1e-3, 5, 3
MESH_MOE = ("qwen3-moe-30b-a3b", "deepseek-v2-lite-16b")
# the state-space families at full width: falcon-mamba-7b at 2 of its 64
# layers, zamba2-2.7b at one super-block (6 Mamba-2 layers, the shared
# block once)
MESH_SSM = (("falcon-mamba-7b", {"n_layers": 2}),
            ("zamba2-2.7b", {"n_layers": 6, "hybrid_attn_every": 6}))
# the vlm at full width: llava-next-mistral-7b at MESH_LAYERS of its 32
# layers, 16 patches a row (the vlm phase's) ahead of its text
MESH_VLM = ("llava-next-mistral-7b", {"n_layers": MESH_LAYERS,
                                      "num_patches": 16})
# the audio family on the "sp" strategy: whisper-base whole
MESH_AUDIO = ("whisper-base", {})
# the fused step's partitioned route: stablelm-3b and llava-next-mistral-
# 7b at MESH_LAYERS layers (llava with MESH_VLM's patches),
# falcon-mamba-7b at 2 of its 64, qwen3-moe-30b-a3b at MESH_LAYERS of its
# 48, deepseek-v2-lite-16b at its dense first layer and one MoE layer,
# whisper-base whole on the "sp" strategy
MESH_FUSED = ((MESH_ARCH, {"n_layers": MESH_LAYERS}), MESH_VLM,
              ("falcon-mamba-7b", {"n_layers": MESH_LAYERS}),
              ("qwen3-moe-30b-a3b", {"n_layers": MESH_LAYERS}),
              ("deepseek-v2-lite-16b", {"n_layers": 2}), MESH_AUDIO)
FUSED_KEYS = ("junction_fwd", "junction_dx", "junction_update_dw")
GATED_FUSED_KEYS = ("junction_gated_fwd", "junction_gated_dx",
                    "junction_update_gated_dw")
DENSE_KEYS = ("junction_fwd", "junction_dx", "junction_dw")
MOE_KEYS = DENSE_KEYS + ("junction_gated_fwd", "junction_gated_dx",
                         "junction_gated_dw")


def _mesh_partitioned(P, cfg, mesh, card, keys=DENSE_KEYS,
                      n_steps=MESH_TIMED, exact=False):
    """The partitioned route on the one-rank mesh (``cfg``: stablelm-3b,
    or a MESH_MOE arch, sparse at MESH_LAYERS layers, or a MESH_SSM, the
    MESH_VLM or the MESH_AUDIO arch at its depth, fp32 params, bf16
    compute):

    * ``n_steps`` two-pass Adam steps (clip 1.0) of batch TRAIN_B x
      TRAIN_S through ``make_mesh_train_step`` (partitioned), through
      today's gathered mesh step (``make_gathered_mesh_train_step``) and
      through the plain step, from the same weights and batches: losses,
      Adam's m and params within the train parity tolerance of the plain
      step (``STEP_TOL``, 2 lr a step plus an ulp), bit for bit where
      ``exact``; the launches of ``keys`` equal the plain step's, on
      tensor cores; the three median step times printed side by side;
    * its count on ``AbstractMesh((1, 1))`` (``dryrun.count_cell``): the
      predicted per-device bytes beside the measured peak;
    * the mesh prefill of TRAIN_B prompts of TRAIN_S - MESH_DECODE
      tokens (padded to TRAIN_S; a vlm's prompts are its pipeline's
      rows, their patches ahead of the text, and its decode positions
      count from the patches; whisper's carry their pipeline's frames)
      and MESH_DECODE greedy decode steps
      against the plain steps fed the same tokens: logits within
      ``LOGIT_REL_TOL`` (bit for bit where ``exact``), greedy tokens
      equal, the forward launches of ``keys`` equal;
    * one more partitioned and plain step each under the profiler
      (``step_breakdown``): the device time beside the wall time."""
    opt = P.optim.adam(P.optim.constant_schedule(MESH_LR))
    require(P.steps.partitioned(cfg, opt)
            and P.dryrun.execution(cfg) == "partitioned",
            f"{cfg.name} is not on the partitioned route")
    pipe = P.LMTokenPipeline(cfg, TRAIN_B, TRAIN_S)
    batches = [next(pipe) for _ in range(n_steps)]

    def run(kind):
        params = P.M.init(cfg, seed=0, device="cuda")
        state = opt.init(params)
        if kind == "plain":
            step = P.steps.make_train_step(cfg, opt)
        else:
            specs = P.sharding.param_specs(cfg, params, mesh)
            params = P.sharding.place(params, specs, mesh)
            state = P.sharding.place_state(state, specs, mesh)
            make = (P.steps.make_mesh_train_step if kind == "partitioned"
                    else P.steps.make_gathered_mesh_train_step)
            step = make(cfg, opt, mesh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() - sum(
            P.sharding.held_bytes(t)[0] for t in (params, state))
        P.ops.reset_launch_counts()
        losses, dts = [], []
        for i, batch in enumerate(batches):
            t0 = time.perf_counter()
            params, state, m = step(params, state, batch, i)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            dts.append(time.perf_counter() - t0)
        counts = with_tc(P, P.ops.launch_counts())
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        if kind != "gathered":
            step_breakdown(lambda: step(params, state, batches[-1], n_steps),
                           statistics.median(dts[1:]),
                           f"{cfg.name} {kind} mesh step", card, top=3)
        if kind != "plain":
            params, state = P.sharding.gather(params), P.sharding.gather(
                state)
        return params, state["m"], losses, dts, counts, peak

    plain = run("plain")
    part = run("partitioned")
    gath = run("gathered")
    tol = STEP_TOL["bfloat16"]
    reach = 2 * MESH_LR * adam_reach(n_steps) * (1 + 1e-5)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(part[2], plain[2]))
    m_err = max(rel_err(a, b) for (_, a), (_, b) in zip(
        P.tree_items(part[1]), P.tree_items(plain[1]))
        if a.is_floating_point() and a.dim())
    pairs = [(a, b) for (_, a), (_, b) in zip(P.tree_items(part[0]),
                                              P.tree_items(plain[0]))
             if a.is_floating_point()]
    p_ok = all(bool(((a.float() - b.float()).abs() <= reach + ULP[a.dtype]
                     * b.float().abs()).all()) for a, b in pairs)
    same = _tree_bits_equal(P, part[0], plain[0]) and part[2] == plain[2]
    # peaks: over the steps, above what was allocated before them other
    # than the step's own params and state (the earlier runs' results)
    sub = {k: part[4][k] for k in keys} | {
        f"{k}_tc": part[4][f"{k}_tc"] for k in keys}
    med = [statistics.median(r[3][1:]) * 1e3 for r in (part, gath, plain)]
    print(f"[mesh] partitioned two-pass Adam under the one-rank mesh, "
          f"{cfg.name} layers={cfg.n_layers} {cfg.dtype}: losses "
          f"{part[2]} against the plain step's {plain[2]} (rel "
          f"{loss_rel:.3g}, tol {tol['loss']}), Adam m rel_err "
          f"{m_err:.3g} (tol {tol['m']}), params within 2 lr a step plus "
          f"an ulp: {p_ok}, bit for bit: {same}; median step after the "
          f"first: partitioned {med[0]:.1f} ms, today's gathered mesh step "
          f"{med[1]:.1f} ms, plain {med[2]:.1f} ms; peak "
          f"{part[5]:.3f} / {gath[5]:.3f} / {plain[5]:.3f} GiB; launches "
          f"{sub} [{card}]")
    require(loss_rel <= tol["loss"] and m_err <= tol["m"] and p_ok
            and (same or not exact),
            "the partitioned mesh step differs from the plain step")
    require(all(part[4][k] == plain[4][k] and part[4][f"{k}_tc"]
                == plain[4][f"{k}_tc"] > 0 for k in keys),
            f"partitioned launches {part[4]} != plain {plain[4]}")
    require(gath[2] == plain[2], "the gathered mesh step moved")
    rl, held = P.dryrun.count_cell(cfg, P.ShapeSpec(
        "mesh", TRAIN_S, TRAIN_B, "train"), P.mesh.AbstractMesh(
            (1, 1), ("data", "model")))
    at_rest, peak = sum(held.values()) / 2**30, rl.memory_stats[
        "peak_bytes"] / 2**30
    print(f"[mesh] the partitioned step counted on AbstractMesh((1, 1)) "
          f"(dryrun.count_cell): predicted per_device {at_rest + peak:.3f} "
          f"GiB (at rest {at_rest:.3f} + eager peak {peak:.3f}) against the "
          f"measured peak {part[5]:.3f} GiB: ratio "
          f"{(at_rest + peak) / part[5]:.3f}; dot_flops {rl.dot_flops:.4g}, "
          f"t_compute {rl.t_compute * 1e3:.3f} ms against the measured "
          f"{med[0]:.1f} ms [{card}]")
    del part, gath, plain
    torch.cuda.empty_cache()
    name = "mesh_partitioned" + ("" if cfg.family == "dense"
                                 else f"_{cfg.name}")
    return {name: sub,
            f"{name}_serve": _mesh_partitioned_serve(P, cfg, mesh, card,
                                                     keys, exact)}


def _mesh_partitioned_serve(P, cfg, mesh, card, keys=DENSE_KEYS,
                            exact=False):
    """The partitioned prefill and decode steps against the plain ones
    (``_mesh_partitioned``'s last part): the launches of the forward
    kernels among ``keys``."""
    params = P.M.init(cfg, seed=0, device="cuda")
    placed = P.sharding.place(params, P.sharding.param_specs(
        cfg, params, mesh), mesh)
    batch = {k: torch.as_tensor(v).to("cuda") for k, v in next(
        P.LMTokenPipeline(cfg, TRAIN_B, TRAIN_S)).items()}
    tokens = batch.pop("tokens")
    off = batch["patches"].shape[1] if "patches" in batch else 0
    start = tokens.shape[1] - MESH_DECODE
    prompt = tokens.clone()
    prompt[:, start:] = 0

    def serve(on_mesh):
        P.ops.reset_launch_counts()
        if on_mesh:
            prefill = P.steps.make_mesh_prefill_step(cfg, mesh)
            decode = P.steps.make_mesh_decode_step(cfg, mesh)
            p, full = placed, lambda t: t.full_tensor()
        else:
            prefill = P.steps.make_prefill_step(cfg)
            decode = P.steps.make_decode_step(cfg)
            p, full = params, lambda t: t
        lg, cache, _ = prefill(p, {"tokens": prompt, **batch})
        logits, tok, picks = [full(lg)], tokens[:, start:start + 1], []
        for t in range(MESH_DECODE):
            lg, cache = decode(p, cache, tok, off + start + t)
            logits.append(full(lg))
            tok = logits[-1].argmax(-1).to(torch.int32)
            picks.append(tok)
        torch.cuda.synchronize()
        return (torch.stack(logits), torch.cat(picks, 1),
                with_tc(P, P.ops.launch_counts()))

    got, got_picks, counts = serve(True)
    want, want_picks, p_counts = serve(False)
    err, same = rel_err(got, want), bits_equal(got, want)
    fwd = [k for k in keys if k.endswith("fwd")]
    sub = {k: counts[k] for k in fwd} | {f"{k}_tc": counts[f"{k}_tc"]
                                         for k in fwd}
    print(f"[mesh] partitioned prefill of {cfg.name} {TRAIN_B} x {start} "
          f"tokens (padded to {tokens.shape[1]}; {off} patches ahead) and "
          f"{MESH_DECODE} greedy decode "
          f"steps against the plain steps: logits rel_err {err:.3g} (tol "
          f"{LOGIT_REL_TOL[torch.bfloat16]}), bit for bit {same}, greedy "
          f"tokens equal {torch.equal(got_picks, want_picks)}; launches "
          f"{sub} against {({k: p_counts[k] for k in sub})} [{card}]")
    require(err <= LOGIT_REL_TOL[torch.bfloat16]
            and torch.equal(got_picks, want_picks) and (same or not exact),
            "the partitioned prefill / decode differs from the plain steps")
    require(all(counts[k] == p_counts[k] > 0 and counts[f"{k}_tc"]
                == p_counts[f"{k}_tc"] for k in fwd),
            f"partitioned serving launches {counts} != {p_counts}")
    del params, placed
    torch.cuda.empty_cache()
    return sub


def _pipe_stages(P, seed=0):
    """PIPE_S stages' params stacked on a leading axis (fp32 masters, as
    the two-pass train path holds them), and the stage function: x +
    mlp(layernorm(x)) of a stablelm-3b layer's sparse MLP in bf16 (one
    pattern for every stage, weights drawn from ``seed``)."""
    cfg = P.registry.get("stablelm-3b").with_sparsity(
        P.SparsityConfig(density=0.25, block=BS, where="ffn"))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    stages = [{"norm": P.layers.norm_init(cfg.d_model, cfg.norm,
                                          torch.float32, "cuda"),
               "mlp": P.layers.mlp_init(gen, cfg, torch.float32, "cuda")}
              for _ in range(PIPE_S)]
    stacked = P.tree_map(lambda *ts: torch.stack(ts), stages[0],
                         *stages[1:])

    def stage_fn(p, x):
        h = P.layers.norm_apply(p["norm"], x, cfg.norm, cfg.norm_eps)
        return x + P.layers.mlp_apply(p["mlp"], h, cfg)
    return cfg, stacked, stage_fn


def _row_sq_loss(y, yt):
    """(dy, loss): half the squared error summed over a row, averaged
    over the rows; fp32 sums, dy in y's dtype."""
    d = y.float() - yt.float()
    rows = y.numel() // y.shape[-1]
    return (d / rows).to(y.dtype), 0.5 * (d * d).sum() / rows


def _pipe_calls(S, M, what):
    """The junction launches of a schedule over S stages of three
    junctions and M microbatches: gpipe's forward S*M stage forwards;
    its step also a backward of each; an async epoch S*M forwards and
    S*M vjps (each a recomputed forward and a backward)."""
    n = 3 * S * M
    return {"gpipe_forward": {"junction_fwd": n},
            "gpipe_step": {"junction_fwd": n, "junction_dx": n,
                           "junction_dw": n},
            "async_epoch": {"junction_fwd": 2 * n, "junction_dx": n,
                            "junction_dw": n}}[what]


def _timed_wall(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def pipeline_phase(P, card):
    """parallel/pipeline.py on the card, PIPE_S stablelm-3b MLP stages
    computing in bf16 on fp32 weights (``_pipe_stages``), PIPE_M
    microbatches of PIPE_ROWS bf16 rows:

    * ``gpipe_forward`` through the kernels equals the stages applied in
      order to each microbatch, bit for bit (the same kernel calls);
    * a ``gpipe_step`` and PIPE_EPOCHS ``async_pipeline_epoch`` epochs
      through the kernels, timed a tick, with the device-busy share of
      one more epoch (``step_breakdown``), and exact fwd / dx / dw
      launches (every one on the tensor cores);
    * the same epochs on the plain versions on the card: losses within
      STEP_TOL["bfloat16"]["loss"], each stage's weight updates within
      STEP_TOL["bfloat16"]["m"] (``rel_err``, as Adam's m is held);
    * the reference's tanh case (TANH) in fp32 on the card and on the
      CPU: its warm loss falls below 0.7 x the first epoch's on both, as
      tests/test_distributed.py asks; the gap printed."""
    PP, bsm = P.pipeline, P.bsm
    cfg, params, stage_fn = _pipe_stages(P)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    shape = (PIPE_M, PIPE_ROWS, cfg.d_model)
    xs = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    ys = (0.1 * torch.randn(shape, generator=gen, device="cuda")).to(
        torch.bfloat16)
    S, M = PIPE_S, PIPE_M
    counts = collections.Counter()

    def counted(what, fn, kernels=True):
        P.ops.reset_launch_counts()
        out, wall = _timed_wall(fn)
        if not kernels:
            return out, wall
        got = with_tc(P, P.ops.launch_counts())
        want = _pipe_calls(S, M, what)
        want = {**want, **{f"{k}_tc": v for k, v in want.items()}}
        require({k: got[k] for k in got if got[k]} == want,
                f"pipeline {what}: launches {got} != {want}")
        counts.update(got)
        return out, wall

    with torch.no_grad():
        outs, f_wall = counted("gpipe_forward",
                               lambda: PP.gpipe_forward(stage_fn, params, xs))
        seq = []
        for m in range(M):
            x = xs[m]
            for s in range(S):
                x = stage_fn(P.tree_map(lambda t: t[s], params), x)
            seq.append(x)
    fwd_same = bits_equal(outs, torch.stack(seq))
    (_, g_loss), g_wall = counted("gpipe_step", lambda: PP.gpipe_step(
        stage_fn, lambda y, yt: _row_sq_loss(y, yt)[1], params, xs, ys,
        PIPE_LR))
    torch.cuda.empty_cache()

    def epochs(kernels=True):
        p, all_losses, walls = params, [], []
        for _ in range(PIPE_EPOCHS):
            (p, losses), wall = counted("async_epoch", lambda: PP.
                                        async_pipeline_epoch(
                                            stage_fn, _row_sq_loss, p, xs,
                                            ys, PIPE_LR), kernels)
            all_losses.append(losses)
            walls.append(wall)
        return p, torch.stack(all_losses), walls

    kp, kl, walls = epochs()
    T = M + 2 * S
    step_breakdown(lambda: PP.async_pipeline_epoch(
        stage_fn, _row_sq_loss, kp, xs, ys, PIPE_LR), walls[-1],
        "async_pipeline_epoch", card)
    with contextlib.ExitStack() as stack:
        for name in ("fwd", "dx", "dw"):
            stack.enter_context(mock.patch.object(
                bsm, name, getattr(bsm, f"{name}_ref")))
        pp, pl, _ = epochs(kernels=False)
    kl, pl = kl[:, (S - 1) * T:], pl[:, (S - 1) * T:]    # the last stage's
    live = kl != 0
    loss_rel = float(((kl - pl).abs()[live] / pl.abs()[live]).max())
    upd_err = max(rel_err(a.float() - b.float(), c.float() - b.float())
                  for (_, a), (_, b), (_, c) in zip(
                      P.tree_items(kp), P.tree_items(params),
                      P.tree_items(pp)) if a.is_floating_point())
    tol = STEP_TOL["bfloat16"]
    print(f"[pipeline] {S} stages of a stablelm-3b MLP (bf16 compute, "
          f"fp32 weights), {M} x "
          f"{PIPE_ROWS} rows: gpipe_forward {f_wall * 1e3:.1f} ms = "
          f"{f_wall / (M + S - 1) * 1e3:.2f} ms a tick ({M + S - 1} ticks), "
          f"equal to the stages in order bit for bit: {fwd_same}; "
          f"gpipe_step {g_wall * 1e3:.1f} ms (loss {float(g_loss):.4f}) = "
          f"{g_wall / (2 * (M + S - 1)) * 1e3:.2f} ms a tick of "
          f"{2 * (M + S - 1)}; async epochs "
          f"{[round(w * 1e3, 1) for w in walls]} ms = "
          f"{walls[-1] / T * 1e3:.2f} ms a tick ({T} ticks); bubble "
          f"gpipe {PP.bubble_fraction(S, M):.3f}, async "
          f"{PP.bubble_fraction(S, M, 'async'):.1f}; kernels vs plain "
          f"versions: losses rel {loss_rel:.3g} (tol {tol['loss']}), "
          f"updates rel_err {upd_err:.3g} (tol {tol['m']}) [{card}]")
    require(fwd_same, "gpipe_forward differs from the stages in order")
    require(loss_rel <= tol["loss"] and upd_err <= tol["m"],
            "the async pipeline through the kernels differs from the plain "
            "versions")
    _tanh_converges(P, card)
    return {"pipeline": dict(counts)}


def _tanh_converges(P, card):
    PP, t = P.pipeline, TANH
    gen = torch.Generator().manual_seed(0)
    p0 = {"w": torch.randn((t["S"], t["D"], t["D"]), generator=gen) * 0.5,
          "b": torch.zeros((t["S"], t["D"]))}
    xs = torch.randn((t["M"], t["rows"], t["D"]), generator=gen)
    ys = torch.randn((t["M"], t["rows"], t["D"]), generator=gen) * 0.1

    def stage(p, x):
        return torch.tanh(x @ p["w"] + p["b"])

    def lg(y, yt):
        return 2 * (y - yt) / y.numel(), torch.mean((y - yt) ** 2)

    def warm(device):
        p = P.tree_map(lambda v: v.to(device), p0)
        x, y = xs.to(device), ys.to(device)
        out = []
        for _ in range(t["epochs"]):
            p, losses = PP.async_pipeline_epoch(stage, lg, p, x, y, t["lr"])
            out.append(float(losses[losses > 0].mean()))
        return out

    on_card, on_cpu = warm("cuda"), warm("cpu")
    gap = max(abs(a - b) / b for a, b in zip(on_card, on_cpu))
    print(f"[pipeline] the reference's tanh case ({t['epochs']} async "
          f"epochs, fp32): warm loss {on_card[0]:.5f} -> {on_card[-1]:.5f} "
          f"on the card, {on_cpu[0]:.5f} -> {on_cpu[-1]:.5f} on the CPU; "
          f"largest relative gap a epoch {gap:.3g} (printed) [{card}]")
    require(on_card[-1] < 0.7 * on_card[0] and on_cpu[-1] < 0.7 * on_cpu[0],
            "the async pipeline does not converge")


# ------------------------------------------------------ standalone kernels
# The four kernels the reference calls only through their own entry
# points (ops.fxp_qmatmul, ops.sigmoid_lut, selective_scan, mha), driven
# at full-width shapes of configurations the registry has.
# kernel vs plain version: the scan sums N fp32 terms a step in another
# order with the same expf, and its decay is at most 1, so an error does
# not grow along S; attention sums up to 8192 fp32 terms in another
# order (TOL); bf16 outputs may move by one bf16 ulp (TOL)
SCAN_ARCH, SCAN_SHAPES = "falcon-mamba-7b", ((1, 4096), (4, 1024))
# what the scan's checked cases must reach between them (scan_plan_kinds)
SCAN_KINDS = {"split", "unsplit", "ragged last chunk",
              "NT > 1, N not a multiple of NT", "plain loads"}
QMM_SHAPE, QMM_BIG = (512, 1024, 512), 4096
QMM_CHUNK = (1024, 16384, 1024)    # the K chunk sets qmatmul's split
LUT_SHAPES = ((512, 512), (8192, 8192))


def _attn_cases(P):
    """(what, B, Sq, Sk, (H, Hkv, D), causal, window, timed)."""
    def heads(arch):
        c = P.registry.get(arch)
        return c.n_heads, c.kv_heads, c.head_dim
    st, qw = heads("stablelm-3b"), heads("qwen3-moe-30b-a3b")
    lv = P.registry.get("llava-next-mistral-7b")
    return [
        ("stablelm-3b train batch", 8, 256, 256, st, True, 0, True),
        ("stablelm-3b", 1, 4096, 4096, st, True, 0, True),
        ("qwen3-moe-30b-a3b", 1, 4096, 4096, qw, True, 0, True),
        ("llava-next-mistral-7b", 1, 8192, 8192, heads(lv.name), True,
         lv.window, True),
        ("ragged non-causal", 2, 37, 53, qw, False, 0, False),
        ("ragged window", 2, 100, 100, st, True, 48, False),
        ("one query row", 1, 1, 4096, qw, False, 0, False),
        ("rows with no valid key", 1, 100, 70, st, True, 5, False),
    ]


# (what, B, Sq, Sk, (H, Hkv, D), causal, window), checked beside the
# drive in both types
ODD_ATTN = ("odd head_dim", 2, 50, 77, (4, 2, 36), True, 20)


def attn_pairs(Sq, Sk, causal, window) -> int:
    """(query, key) pairs the masks keep, a head."""
    q = np.arange(Sq)
    lo = np.maximum(0, q - window + 1) if window else np.zeros_like(q)
    hi = np.minimum(q, Sk - 1) if causal else np.full_like(q, Sk - 1)
    return int(np.maximum(0, hi - lo + 1).sum())


def bits_equal(got, want) -> bool:
    """Equal bit for bit (NaN payloads included)."""
    return got.shape == want.shape and got.dtype == want.dtype and bool(
        torch.equal(got.view(torch.int32), want.view(torch.int32)))


def scan_cases(registry):
    """(B, S, di, N, timed, dtypes) of the scan: the timed cases at
    SCAN_ARCH's d_inner and state, then checked ones; the last four reach
    between them every plan of SCAN_KINDS (a split whose last chunk ends
    in a part of a ring stage, NT 2 with N = 25 and 20, bf16 rows of 200
    bytes)."""
    c = registry.get(SCAN_ARCH)
    f32, bf16 = torch.float32, torch.bfloat16
    return [(B, S, c.d_inner, c.ssm_state, True, (f32, bf16))
            for B, S in SCAN_SHAPES] + [
        (2, 300, 1000, 8, False, (f32,)), (1, 129, 512, 32, False, (f32,)),
        (3, 70, 96, 5, False, (f32,)),
        (1, 4001, c.d_inner, c.ssm_state, False, (bf16,)),
        (2, 1000, 96, 25, False, (f32,)), (3, 70, 200, 20, False, (bf16,)),
        (1, 37, 100, 5, False, (bf16,))]


def scan_plan_kinds(ssk, B, S, di, N, elt) -> set:
    """What the plan of a scan case exercises (of SCAN_KINDS)."""
    nt, _, _, L, chunk = ssk.scan_plan(B, S, di, N)
    kinds = {"split" if L > 1 else "unsplit"}
    if L > 1 and (S - (L - 1) * chunk) % ssk.SCAN_STEPS:
        kinds.add("ragged last chunk")
    if nt > 1 and N % nt:
        kinds.add("NT > 1, N not a multiple of NT")
    if di * elt % 16:
        kinds.add("plain loads")
    return kinds


def standalone_kernel_phase(P, card):
    """Drive the four entry points once at every shape with the launch
    counts reset just before and read just after (exact counts); then
    hold each result against its plain version on the same inputs and
    time kernel, plain version and, where one PyTorch call computes the
    same function, that call.  Returns (the four kernels' JSON entries,
    the path's launch counts)."""
    dev = "cuda"
    gen = torch.Generator(device=dev)
    gen.manual_seed(15)
    timer, slow = Timer(), Timer(reps=3)   # the plain scan steps S times
    fxp = P.fxp

    # inputs, all made before the drive
    attn = []
    for what, B, Sq, Sk, (H, Hkv, D), causal, window, timed in \
            _attn_cases(P):
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.randn((B, Sq, H, D), generator=gen, device=dev)
            k = torch.randn((B, Sk, Hkv, D), generator=gen, device=dev)
            v = torch.randn((B, Sk, Hkv, D), generator=gen, device=dev)
            attn.append((what, B, Sq, Sk, H, Hkv, D, causal, window, timed,
                         dtype, *(t.to(dtype) for t in (q, k, v))))
    scan = []
    for i, (B, S, di, N, timed, dtypes) in enumerate(scan_cases(P.registry)):
        # the cases after the first five from their own generator (those
        # above and below keep their data)
        sgen = gen if i < 5 else torch.Generator(device=dev).manual_seed(
            23 + i)
        for dtype in dtypes:
            dt = torch.nn.functional.softplus(torch.randn(
                (B, S, di), generator=sgen, device=dev)) * 0.1
            xs = [torch.randn(shape, generator=sgen, device=dev)
                  for shape in ((B, S, di), (B, S, N), (B, S, N))]
            a = -torch.exp(torch.randn((di, N), generator=sgen,
                                       device=dev) * 0.3)
            h0 = torch.randn((B, di, N), generator=sgen, device=dev) * 0.1
            scan.append((B, S, di, N, timed, dtype,
                         [t.to(dtype) for t in (dt, *xs)] + [a, h0]))
    kinds = set().union(*(scan_plan_kinds(P.ssk, B, S, di, N,
                                          ins[0].element_size())
                          for B, S, di, N, _, _, ins in scan))
    require(kinds >= SCAN_KINDS,
            f"the scan's cases miss plans: {SCAN_KINDS - kinds}")
    qmm = []
    M, K, N = QMM_SHAPE
    for fmt in fxp.PAPER_TRIPLETS:
        lim = 1 << (fmt.bn + fmt.bf)
        a = torch.randint(-lim, lim, (M, K), generator=gen, device=dev,
                          dtype=torch.int32)
        w = torch.randint(-lim, lim, (K, N), generator=gen, device=dev,
                          dtype=torch.int32)
        qmm.append((f"{M}x{K}x{N}", fmt, True, a, w))
    big = fxp.PAPER_FMT
    lim = 1 << (big.bn + big.bf)
    qmm.append((f"{QMM_BIG}^3", big, True, *(
        torch.randint(-lim, lim, (QMM_BIG, QMM_BIG), generator=gen,
                      device=dev, dtype=torch.int32) for _ in range(2))))
    top = fxp.PAPER_TRIPLETS[-1]
    wa = torch.full((4, 1024), 2 ** 15 - 1, dtype=torch.int32, device=dev)
    ww = torch.full((1024, 3), 2 ** 15 - 1, dtype=torch.int32, device=dev)
    ww[:, 1] = -(2 ** 15)
    qmm.append(("int32 sum wraps 4x1024x3", top, False, wa, ww))
    qmm.append(("ragged 75x33x50", big, False, *(
        torch.randint(-lim, lim, shape, generator=gen, device=dev,
                      dtype=torch.int32) for shape in ((75, 33), (33, 50)))))
    # from their own generator (the cases above keep their data): codes
    # beyond 16 bits (every product on 10 plane pairs); K split over 128
    # blocks for occupancy (one output tile, 512 of K a block); and K
    # split by the chunk (QMM_CHUNK: 128 tiles, 8192 of K a block, two
    # blocks a tile), every low byte 0xff and, in output tile (0, 0),
    # every code 2^31 - 1, which takes each int32 accumulator to its
    # worst case (shift 3: 194820 a k, 1.596e9 over the 8192)
    qgen = torch.Generator(device=dev)
    qgen.manual_seed(22)
    M, K, N = QMM_SHAPE
    qmm.append((f"beyond 16 bits {M}x{K}x{N}", top, True, *(
        torch.randint(-2 ** 31, 2 ** 31 - 1, shape, generator=qgen,
                      device=dev, dtype=torch.int64).to(torch.int32)
        for shape in ((M, K), (K, N)))))
    qmm.append(("K split for occupancy 16x65536x16", top, False, *(
        (torch.randint(lo, 2 ** 23, shape, generator=qgen, device=dev,
                       dtype=torch.int32) << 8) | 0xFF
        for lo, shape in ((0, (16, 65536)), (-2 ** 23, (65536, 16))))))
    M, K, N = QMM_CHUNK
    ca, cw = ((torch.randint(-2 ** 23, 2 ** 23, shape, generator=qgen,
                             device=dev, dtype=torch.int32) << 8) | 0xFF
              for shape in ((M, K), (K, N)))
    ca[:P.fxk.TILE_M] = 2 ** 31 - 1
    cw[:, :P.fxk.TILE_N] = 2 ** 31 - 1
    require(P.fxk.qmatmul_plan(M, K, N)[1:] == (P.fxk.QMM_CHUNK_TILES, 2),
            f"qmatmul {M}x{K}x{N}: the K chunk does not set the split")
    qmm.append((f"K split by the chunk {M}x{K}x{N}", top, False, ca, cw))
    lut = []
    for fmt in (fxp.PAPER_FMT, top):
        table = torch.from_numpy(fxp.sigmoid_tables(fmt)[0]).to(dev)
        T = table.shape[0]
        for shape in LUT_SHAPES:
            lut.append((f"{shape[0]}x{shape[1]}", fmt, True, table,
                        torch.randint(0, T, shape, generator=gen, device=dev,
                                      dtype=torch.int32)))
        lut.append(("[2,3,77] out of range", fmt, False, table,
                    torch.randint(-2 * T, 2 * T, (2, 3, 77), generator=gen,
                                  device=dev, dtype=torch.int32)))
        flat = torch.randint(0, T, (1 + 37 * 77,), generator=gen, device=dev,
                             dtype=torch.int32)
        lut.append(("[37,77] unaligned", fmt, False, table,
                    flat[1:].view(37, 77)))

    # the path: every entry point once a case, counted
    P.ops.reset_launch_counts()
    attn_out = [P.fa.mha(q, k, v, causal=causal, window=window)
                for *_, causal, window, _, _, q, k, v in attn]
    scan_out = [P.ssk.selective_scan(*ins) for *_, ins in scan]
    qmm_out = [P.ops.fxp_qmatmul(a, w, bf=fmt.bf, bn=fmt.bn)
               for _, fmt, _, a, w in qmm]
    lut_out = [P.ops.sigmoid_lut(codes, table) for *_, table, codes in lut]
    torch.cuda.synchronize()
    counts = P.ops.launch_counts()
    want = dict.fromkeys(counts, 0)
    want.update(flash_attention=len(attn), selective_scan=len(scan),
                qmatmul=len(qmm), lut_lookup=len(lut))
    print(f"[standalone] launches={counts} [{card}]")
    require(counts == want, f"standalone launches {counts} != {want}")

    res = {k: {"max_abs_err": 0.0, "cases": []} for k in
           ("flash_attention", "selective_scan", "qmatmul", "lut_lookup")}

    def record(kind, what, err, k_ms, p_ms, lib_ms, nbytes, nops, dtype,
               main, bounds=None):
        """bounds: qmatmul's fxp_bounds or the scan's scan_bounds, in place
        of bytes and ops."""
        if bounds is None:
            bnd, by = bound_ms(nbytes, nops, dtype)
            bounds, text = {"bound_ms": bnd, "bound_by": by}, \
                f"bound_ms={bnd:.5f} ({by})"
        else:
            text = bounds.get("text") or bounds_text(bounds)
        row = {"case": what, "ms": k_ms, "plain_ms": p_ms,
               "bound_ms": bounds["bound_ms"],
               "bound_by": bounds["bound_by"], "library_ms": lib_ms}
        r = res[kind]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["cases"].append(row)
        if main:
            r.update({k: v for k, v in row.items() if k != "case"})
        lib = "none" if lib_ms is None else f"{lib_ms:.4f}"
        print(f"[kernel] {kind} {what}: max_abs_err={err:.3g} ms={k_ms:.4f} "
              f"plain_ms={p_ms:.4f} {text} library_ms={lib} [{card}]")

    # a head_dim that is not a multiple of 8 (rows that are not 16-byte
    # vectors), ragged Sq and Sk, window: checked, not on the counted path
    what, B, Sq, Sk, (H, Hkv, D), causal, window = ODD_ATTN
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (torch.randn((B, S, nh, D), generator=gen, device=dev)
                   .to(dtype) for S, nh in ((Sq, H), (Sk, Hkv), (Sk, Hkv)))
        got = P.fa.mha(q, k, v, causal=causal, window=window)
        qf, kf, vf = (t.transpose(1, 2).reshape(-1, t.shape[1], D)
                      for t in (q, k, v))
        ref = P.fa.attention_ref(qf, kf, vf, causal=causal, window=window)
        got = got.transpose(1, 2).reshape(B * H, Sq, D)
        err = max_err(got, ref)
        desc = (f"{what} B={B} Sq={Sq} Sk={Sk} H={H} Hkv={Hkv} D={D} "
                f"causal={causal} window={window} {str(dtype)[6:]}")
        require(close(got, ref, TOL[dtype]),
                f"flash_attention {desc} disagrees: err {err}")
        res["flash_attention"]["max_abs_err"] = max(
            res["flash_attention"]["max_abs_err"], err)
        print(f"[kernel] flash_attention {desc}: max_abs_err={err:.3g} "
              f"(tol {TOL[dtype]}) [{card}]")

    sdpa = torch.nn.functional.scaled_dot_product_attention
    for case, got in zip(attn, attn_out):
        (what, B, Sq, Sk, H, Hkv, D, causal, window, timed, dtype,
         q, k, v) = case
        qf = q.transpose(1, 2).reshape(B * H, Sq, D).contiguous()
        kf = k.transpose(1, 2).reshape(B * Hkv, Sk, D).contiguous()
        vf = v.transpose(1, 2).reshape(B * Hkv, Sk, D).contiguous()
        ref = P.fa.attention_ref(qf, kf, vf, causal=causal, window=window)
        got = got.transpose(1, 2).reshape(B * H, Sq, D)
        err = max_err(got, ref)
        desc = (f"{what} B={B} Sq={Sq} Sk={Sk} H={H} Hkv={Hkv} D={D} "
                f"causal={causal} window={window} {str(dtype)[6:]}")
        require(close(got, ref, TOL[dtype]),
                f"flash_attention {desc} disagrees: err {err}")
        if not timed:
            print(f"[kernel] flash_attention {desc}: max_abs_err={err:.3g} "
                  f"(tol {TOL[dtype]}) [{card}]")
            continue
        k_ms = timer.ms(lambda: P.fa.flash_attention(
            qf, kf, vf, causal=causal, window=window))
        p_ms = timer.ms(lambda: P.fa.attention_ref(
            qf, kf, vf, causal=causal, window=window))
        lib_ms = None
        if causal and Sq == Sk:
            q4, k4, v4 = (t.view(B, -1, t.shape[1], D) for t in (qf, kf, vf))
            if window:                   # one boolean [Sq, Sk] mask
                pos = torch.arange(Sq, device=dev)
                diff = pos[:, None] - pos[None, :]
                mask = (diff >= 0) & (diff < window)
                lib_ms = timer.ms(lambda: sdpa(q4, k4, v4, attn_mask=mask,
                                               enable_gqa=True))
                del mask, diff
            else:
                lib_ms = timer.ms(lambda: sdpa(q4, k4, v4, is_causal=True,
                                               enable_gqa=True))
        pairs = attn_pairs(Sq, Sk, causal, window) * B * H
        nbytes = (2 * qf.numel() + 2 * kf.numel()) * q.element_size()
        record("flash_attention", desc, err, k_ms, p_ms, lib_ms, nbytes,
               4 * D * pairs, dtype,
               what == "stablelm-3b" and dtype == torch.bfloat16)

    for (B, S, di, N, timed, dtype, ins), (y, h) in zip(scan, scan_out):
        ry, rh = P.ssk.selective_scan_ref(*ins)
        err = max(max_err(y, ry), max_err(h, rh))
        nt, _, _, L, chunk = P.ssk.scan_plan(B, S, di, N)
        desc = (f"B={B} S={S} di={di} N={N} {str(dtype)[6:]} plan: nt={nt} "
                f"L={L} chunk={chunk}")
        require(y.dtype == dtype and h.dtype == torch.float32
                and close(y, ry, TOL[dtype])
                and close(h, rh, TOL[torch.float32]),
                f"selective_scan {desc} disagrees: err {err}")
        if not timed:
            print(f"[kernel] selective_scan {desc}: max_abs_err={err:.3g} "
                  f"(tol {TOL[dtype]}) [{card}]")
            continue
        k_ms = timer.ms(lambda: P.ssk.selective_scan(*ins))
        p_ms = slow.ms(lambda: P.ssk.selective_scan_ref(*ins))
        # every operand once: hbm_bytes' model and A [di, N], which the
        # model leaves out
        nbytes = sum(t.numel() * t.element_size() for t in (*ins, y, h))
        if dtype == torch.float32:
            require(nbytes == P.ssk.hbm_bytes(B, S, di, N) + 4 * di * N,
                    "the scan's bytes disagree with hbm_bytes")
        record("selective_scan", f"{SCAN_ARCH} {desc}", err, k_ms, p_ms,
               None, nbytes, 0, torch.float32,
               B == 1 and dtype == torch.float32,
               bounds=scan_bounds(nbytes, B * S * di * N))

    for (what, fmt, timed, a, w), got in zip(qmm, qmm_out):
        ref = P.fxk.qmatmul_ref(a, w, bf=fmt.bf, bn=fmt.bn)
        desc = f"{what} fmt=({fmt.bw},{fmt.bn},{fmt.bf})"
        if fmt == top and what != "ragged 75x33x50":
            s = a[:1].double() @ w.double()
            require(float(s.abs().max()) > 2 ** 31,
                    f"qmatmul {desc}: the int32 sum does not wrap")
            desc += " int32 sum wraps"
        require(bits_equal(got, ref),
                f"qmatmul {desc} is not bit for bit its plain version")
        if not timed:
            print(f"[kernel] qmatmul {desc}: bit_equal=True [{card}]")
            continue
        M, K = a.shape
        N = w.shape[1]
        k_ms = timer.ms(lambda: P.fxk.qmatmul(a, w, bf=fmt.bf, bn=fmt.bn))
        p_ms = timer.ms(lambda: P.fxk.qmatmul_ref(a, w, bf=fmt.bf,
                                                  bn=fmt.bn))
        record("qmatmul", desc, 0.0, k_ms, p_ms, None,
               4 * (M * K + K * N + M * N), M * K * N, torch.int32,
               what == f"{M}x{K}x{N}" and (M, K, N) == QMM_SHAPE
               and fmt == fxp.PAPER_FMT,
               bounds=fxp_bounds(4 * (M * K + K * N + M * N), M * K * N,
                                 code_planes(a), code_planes(w)))

    for (what, fmt, timed, table, codes), got in zip(lut, lut_out):
        ref = P.slut.lut_lookup_ref(codes.reshape(-1, codes.shape[-1]),
                                    table).reshape(codes.shape)
        desc = f"{what} T={table.shape[0]}"
        nan = int(got.isnan().sum())
        require(bits_equal(got, ref),
                f"lut_lookup {desc} is not bit for bit its plain version")
        if not timed:
            print(f"[kernel] lut_lookup {desc}: bit_equal=True nan={nan} "
                  f"[{card}]")
            continue
        k_ms = timer.ms(lambda: P.slut.lut_lookup(codes, table))
        p_ms = timer.ms(lambda: P.slut.lut_lookup_ref(codes, table))
        lib_ms = timer.ms(lambda: table[codes])
        record("lut_lookup", desc, 0.0, k_ms, p_ms, lib_ms,
               8 * codes.numel() + 4 * table.numel(), 0, torch.float32,
               what == "{}x{}".format(*LUT_SHAPES[-1])
               and fmt == fxp.PAPER_FMT)
    for kind, r in res.items():
        require("ms" in r, f"{kind}: its main case was not timed")
    return res, counts


def load_port() -> types.SimpleNamespace:
    """The port's modules this script drives, from the checkout beside it;
    fp32 products in full fp32."""
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False   # full fp32 references
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch import optim
    from repro_torch.configs import registry
    from repro_torch.core import fixed_point as fxp
    from repro_torch.core.interleaver import reverse_block_pattern
    from repro_torch.core import quantize as qz
    from repro_torch.core.sparsity import SparsityConfig, make_block_pattern
    from repro_torch.data.pipeline import LMTokenPipeline
    from repro_torch.kernels import block_sparse_matmul as bsm
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fxp_qmatmul as fxk
    from repro_torch.kernels import ops
    from repro_torch.kernels import selective_scan as ssk
    from repro_torch.kernels import sigmoid_lut as slut
    from repro_torch import obs
    from repro_torch.configs import paper_mnist
    from repro_torch.core import junction_pipeline as JP
    from repro_torch.core import paper_net as PN
    from repro_torch.data.mnist import paper_dataset
    from repro_torch import search
    from repro_torch.configs.base import ShapeSpec, SweepConfig
    from repro_torch.launch import dryrun, obs_report, quant_sweep
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.launch import sweep
    from repro_torch.launch import mesh
    from repro_torch.launch import train as train_launcher
    from repro_torch.models import layers
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.parallel import pipeline, sharding
    from repro_torch.roofline import analysis as roofline
    from repro_torch.obs import percentile
    from repro_torch.serve import engine
    from repro_torch.train import grad_compress, steps, train_loop
    from repro_torch.tree import tree_items, tree_leaves, tree_map
    return types.SimpleNamespace(
        registry=registry, SparsityConfig=SparsityConfig,
        make_block_pattern=make_block_pattern,
        reverse_block_pattern=reverse_block_pattern, bsm=bsm, fa=fa, ops=ops,
        M=M, moe=moe, engine=engine, percentile=percentile, optim=optim,
        steps=steps,
        LMTokenPipeline=LMTokenPipeline, tree_items=tree_items,
        tree_leaves=tree_leaves, tree_map=tree_map,
        grad_compress=grad_compress, build=build,
        qz=qz, fxp=fxp, quant_sweep=quant_sweep, fxk=fxk, ssk=ssk,
        slut=slut, obs=obs, obs_report=obs_report, train_loop=train_loop,
        PN=PN, JP=JP, paper_mnist=paper_mnist, paper_dataset=paper_dataset,
        search=search, SweepConfig=SweepConfig, ShapeSpec=ShapeSpec,
        sweep=sweep,
        serve=serve_launcher, train=train_launcher, mesh=mesh,
        sharding=sharding, pipeline=pipeline, layers=layers,
        roofline=roofline, dryrun=dryrun)


def build_kernels(P) -> None:
    """Build every kernel source (one nvcc each, all started together) and
    print the build times and what ptxas reports."""
    t0 = time.perf_counter()
    secs = P.build.build_all()
    print(f"[build] {', '.join(f'{k} {v:.1f} s' for k, v in secs.items())}; "
          f"wall {time.perf_counter() - t0:.1f} s")
    for name in P.build.SOURCES:
        log = P.build.lib_path(name).with_suffix(".log")
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas] {name}: {line.strip()}")


def timed(name, fn, *args, **kw):
    """fn(*args, **kw), its wall time printed as the phase's seconds."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    print(f"[phase] {name}: {time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not under {ROOT / 'src'}",
              file=sys.stderr)
        return 1
    P = load_port()
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    build_kernels(P)

    timer = Timer()
    junction = timed("junction", junction_phase, P, timer, card)
    timed("route", route_phase, P, timer, card)
    decode = timed("decode", decode_phase, P, timer, card)
    quant = timed("quant_kernel", quant_kernel_phase, P, timer, card)
    paths = {}
    params, paths["serve"], outs = timed(
        "serve", serve_phase, P, card, "stablelm-3b",
        obs_path=ROOT / "build" / "obs" / "serve_stablelm-3b.jsonl")
    timed("telemetry", telemetry_phase, P, card, params)
    _, paths["serve_int8"], _ = timed("serve_int8", serve_phase, P, card,
                                      "stablelm-3b", params, "int8", outs)
    weight_cast_phase(params, timer, card)
    del params
    torch.cuda.empty_cache()
    bwd = timed("train_kernel", train_kernel_phase, P, timer, card)
    paths["train"] = timed("train", train_phase, P, card, "stablelm-3b")
    moe, moe_plain = timed("moe_kernel", moe_kernel_phase, P, timer, card)
    params, paths["moe_serve"], outs = timed(
        "moe_serve", serve_phase, P, card, "qwen3-moe-30b-a3b")
    _, paths["moe_serve_int8"], _ = timed(
        "moe_serve_int8", serve_phase, P, card, "qwen3-moe-30b-a3b", params,
        "int8", outs)
    weight_cast_phase(params, timer, card)
    del params
    torch.cuda.empty_cache()
    paths["moe_train"] = timed("moe_train", train_phase, P, card,
                               "qwen3-moe-30b-a3b", MOE_TRAIN_LAYERS)
    paths["sweep"] = timed("sweep", sweep_phase, P, card)
    paths["search"] = timed("search", search_phase, P, card)
    paths["static_serve"] = timed("static_serve", static_serve_phase, P,
                                  card)
    paths.update(timed("ssm", ssm_phase, P, card))
    paths.update(timed("hybrid", hybrid_phase, P, card))
    paths["dense_configs"] = timed("dense_configs", dense_configs_phase, P,
                                   timer, card)
    paths.update(timed("vlm", vlm_phase, P, timer, card))
    paths.update(timed("mla", mla_phase, P, timer, card))
    paths.update(timed("audio", audio_phase, P, timer, card))
    paths.update(timed("compress", compress_phase, P, card))
    perf_paths, perf_run = timed("perf", perf_phase, P, card)
    paths.update(perf_paths)
    timed("dryrun", dryrun_phase, P, card, perf_run)
    paths.update(timed("mesh", mesh_phase, P, card))
    paths.update(timed("pipeline", pipeline_phase, P, card))
    standalone, paths["standalone"] = timed(
        "standalone", standalone_kernel_phase, P, card)
    timed("paper", paper_phase, P, card)

    def launches(name):
        by = {p: c[name] for p, c in paths.items() if c.get(name)}
        return {"launches": sum(by.values()), "launches_by_path": by}

    def tc_launches(name):
        """The launches of the kernel's tensor-core entry point."""
        return {f"tc_{k}": v for k, v in launches(f"{name}_tc").items()}

    def at_e128(kind):
        """The kernel's times at qwen3-moe's down junction (E = 128)."""
        return {f"moe_{where}_{k}": v
                for where, row in moe_plain[kind].items()
                for k, v in zip(("ms", "plain_ms", "bound_ms", "simt_ms"),
                                row)}

    def tc_entry(name):
        """The tensor-core entry point of a kernel that has one."""
        if f"junction_{name}" not in P.ops.tc_launch_counts():
            return {}
        return {"tc_source": "src/repro_torch/csrc/junction_tc.cu",
                **tc_launches(f"junction_{name}")}

    kernels = [
        {"name": "junction_fwd", "route": "cuda",
         "source": "src/repro_torch/csrc/junction_fwd.cu",
         "replaces": "src/repro/kernels/block_sparse_matmul.py:381",
         **launches("junction_fwd"), **tc_entry("fwd"),
         **junction, "train_ms": bwd["fwd"]["ms"],
         "train_simt_ms": bwd["fwd"]["simt_ms"],
         "train_plain_ms": bwd["fwd"]["plain_ms"],
         "train_bound_ms": bwd["fwd"]["bound_ms"], **at_e128("fwd")},
        {"name": "flash_decode", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_decode.cu",
         "replaces": "src/repro/kernels/flash_attention.py:206",
         **launches("flash_decode"), **decode},
    ]
    for name, src, line in (("dx", "junction_dx.cu", 782),
                            ("dw", "junction_dw.cu", 949),
                            ("update_dw", "junction_dw.cu", 1172)):
        kernels.append({
            "name": f"junction_{name}", "route": "cuda",
            "source": f"src/repro_torch/csrc/{src}",
            "replaces": f"src/repro/kernels/block_sparse_matmul.py:{line}",
            **launches(f"junction_{name}"), **tc_entry(name), **bwd[name],
            **at_e128(name)})
    for name, src, line in (("gated_fwd", "junction_fwd.cu", 447),
                            ("gated_dx", "junction_dx.cu", 876),
                            ("gated_dw", "junction_dw.cu", 1040),
                            ("update_gated_dw", "junction_dw.cu", 1375)):
        kernels.append({
            "name": f"junction_{name}", "route": "cuda",
            "source": f"src/repro_torch/csrc/{src}",
            "replaces": f"src/repro/kernels/block_sparse_matmul.py:{line}",
            **launches(f"junction_{name}"), **tc_entry(name), **moe[name]})
    for name, line in (("fwd_int8", 531), ("gated_fwd_int8", 664),
                       ("fwd_fxp", 597)):
        kernels.append({
            "name": f"junction_{name}", "route": "cuda",
            "source": "src/repro_torch/csrc/junction_quant.cu",
            "replaces": f"src/repro/kernels/block_sparse_matmul.py:{line}",
            **launches(f"junction_{name}"), **quant[name]})
    for name, src, line in (
            ("flash_attention", "flash_attention.cu",
             "flash_attention.py:94"),
            ("selective_scan", "selective_scan.cu", "selective_scan.py:67"),
            ("qmatmul", "fxp_qmatmul.cu", "fxp_qmatmul.py:42"),
            ("lut_lookup", "sigmoid_lut.cu", "sigmoid_lut.py:22")):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{src}",
            "replaces": f"src/repro/kernels/{line}",
            **launches(name), **standalone[name]})
    for k in kernels:
        require(k["launches"] > 0, f"{k['name']} never ran on its path")
        require("tc_source" not in k or k["tc_launches"] > 0,
                f"{k['name']}'s tensor-core entry never ran on a path")
    print(card)                          # nvidia-smi's name, power.limit
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
