#!/usr/bin/env python3
"""Time the fixed-point kernels, ``junction_fwd_fxp`` and ``fxp_qmatmul``,
on one NVIDIA card beside the parent commit's, in turns.

    python3 chip_layouts.py [--parent DIR]

from the root of a checkout, on a machine with a CUDA card, nvcc and
PyTorch built for CUDA.  DIR holds the parent commit's
``src/repro_torch/csrc`` (for example ``git archive <parent>
src/repro_torch/csrc | tar -x -C build/parent``, then ``--parent
build/parent/src/repro_torch/csrc``; ``build/`` is git-ignored); its
``junction_quant.cu`` and ``fxp_qmatmul.cu`` are built under
``build/layouts/``, one nvcc each, started together.  Then:

1. the floor of ``chip_smoke.Timer`` (a one-element fill);
2. the IMMA instructions of ``fxp_qmatmul_kernel`` and
   ``junction_fxp_kernel`` in the built libraries (``cuobjdump -sass``);
3. at every shape ``chip_smoke.py`` times (qmatmul at 512 x 1024 x 512
   at every paper triplet and beyond 16 bits, at 4096^3 at the paper
   triplet, bw 8 and beyond 16 bits, the K split for occupancy at 16 x
   65536 x 16 and by the chunk at 1024 x 16384 x 1024; fwd_fxp at the
   sweep's two layers at every triplet and
   beyond 16 bits) and at fwd_fxp blocks 32 and 64: the landed kernel,
   with its K split for occupancy turned off where it has one
   (``fxp_qmatmul.TC_BLOCKS`` = 1), and, with DIR, the parent's kernels
   at their old C signatures, each output equal bit for bit to the plain
   version, timed in turns (``chip_smoke.in_turns``);
4. with DIR, ``chip_smoke.sweep_phase`` with the parent's fwd_fxp and
   the landed one, in turns: wall time and launch counts.

It exits 1 without a card and 2 when an output disagrees with its plain
version or a kernel holds no IMMA.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import torch

import chip_smoke as C

PARENT_SOURCES = ("junction_quant", "fxp_qmatmul")


def build_parent(P, parent: Path) -> dict[str, ctypes.CDLL]:
    """The parent's sources, each its own library; one nvcc each, all
    started together."""
    out = C.ROOT / "build" / "layouts"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in PARENT_SOURCES:
        lib = out / f"libparent_{name}.so"
        procs[name] = (subprocess.Popen(
            [P.build.find_nvcc(), *P.build.NVCC_FLAGS, "-I", str(parent),
             "-o", str(lib), str(parent / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the parent's {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def imma_counts(P, path) -> dict[str, int]:
    """IMMA instructions a kernel function in a built library."""
    nvcc = Path(P.build.find_nvcc())
    sass = subprocess.run([str(nvcc.with_name("cuobjdump")), "-sass",
                           str(path)], capture_output=True, text=True,
                          check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts.setdefault(fn, 0)
        elif "IMMA" in line and fn is not None:
            counts[fn] += 1
    return counts


def parent_qmatmul(lib):
    """The parent's fxp_qmatmul at its C signature (3 pointers, 5 ints)."""
    fn = lib.fxp_qmatmul
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(a, w, bf, bn):
        M, K = a.shape
        N = w.shape[1]
        out = torch.empty((M, N), dtype=torch.int32, device="cuda")
        err = fn(a.data_ptr(), w.data_ptr(), out.data_ptr(), M, K, N, bf, bn,
                 torch.cuda.current_stream().cuda_stream)
        C.require(err == 0, f"parent fxp_qmatmul: cudaError {err}")
        return out
    return call


def parent_fwd_fxp(P, lib):
    """The parent's junction_fwd_fxp at its C signature (7 pointers, 8
    ints), counted on ``bsm.fwd_fxp.launches`` like the landed one."""
    fn = lib.junction_fwd_fxp
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    counter = P.bsm.fwd_fxp          # the landed wrapper, before any patch

    def call(x, wq, idx, qfmt, lut, bias):
        E, M, n_in = x.shape
        _, nob, kb, bs, _ = wq.shape
        y = torch.empty((E, M, nob * bs), dtype=x.dtype, device="cuda")
        err = fn(x.data_ptr(), wq.data_ptr(), idx.data_ptr(),
                 qfmt.data_ptr(), lut.data_ptr(), bias.data_ptr(),
                 y.data_ptr(), E, M, n_in // bs, nob, kb, bs, lut.shape[0],
                 P.bsm._DTYPE_CODE[x.dtype],
                 torch.cuda.current_stream().cuda_stream)
        C.require(err == 0, f"parent junction_fwd_fxp: cudaError {err}")
        counter.launches += 1
        return y
    return call


def fxp_layouts(P, libs, timer, card) -> bool:
    """Parts 2-4; True when every output is its plain version's and both
    kernels hold IMMA."""
    ok = True
    for name, kernel in (("fxp_qmatmul", "fxp_qmatmul_kernel"),
                         ("junction_quant", "junction_fxp_kernel")):
        counts = {fn: n for fn, n in imma_counts(
            P, P.build.lib_path(name)).items() if kernel in fn}
        for fn, n in counts.items():
            print(f"[sass] {name}: {fn}: {n} IMMA instructions")
        ok &= bool(counts) and all(n > 0 for n in counts.values())
    gen = torch.Generator(device="cuda")
    gen.manual_seed(23)
    fxp = P.fxp
    old_q = parent_qmatmul(libs["fxp_qmatmul"]) if libs else None
    old_f = parent_fwd_fxp(P, libs["junction_quant"]) if libs else None

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device="cuda",
                             dtype=torch.int64).to(torch.int32)

    def run(label, fns, want):
        nonlocal ok
        for name, fn in fns.items():
            same = C.bits_equal(fn(), want)
            ok &= same
            print(f"[fxp] {label} {name}: bits equal to the plain "
                  f"version's: {same}")
        for name, ms in zip(fns, C.in_turns(timer, *fns.values())):
            print(f"[fxp] {label} {name}: {ms:.4f} ms [{card}]", flush=True)

    def unsplit(fn):
        def call():
            with mock.patch.object(P.fxk, "TC_BLOCKS", 1):
                return fn()
        return call

    top, paper, b8 = fxp.PAPER_TRIPLETS[-1], fxp.PAPER_FMT, \
        fxp.PAPER_TRIPLETS[0]
    M, K, N = C.QMM_SHAPE
    cases = []
    for fmt in fxp.PAPER_TRIPLETS:
        lim = 1 << (fmt.bn + fmt.bf)
        cases.append((f"qmatmul {M}x{K}x{N} fmt=({fmt.bw},{fmt.bn},{fmt.bf})",
                      fmt, ri(-lim, lim, (M, K)), ri(-lim, lim, (K, N))))
    cases.append((f"qmatmul {M}x{K}x{N} beyond 16 bits", top,
                  ri(-2 ** 31, 2 ** 31 - 1, (M, K)),
                  ri(-2 ** 31, 2 ** 31 - 1, (K, N))))
    B = C.QMM_BIG
    for what, fmt, lo, hi in (("paper", paper, None, None),
                              ("bw 8", b8, None, None),
                              ("beyond 16 bits", top, -2 ** 31, 2 ** 31 - 1)):
        lim = 1 << (fmt.bn + fmt.bf)
        lo, hi = (-lim, lim) if lo is None else (lo, hi)
        cases.append((f"qmatmul {B}^3 {what}", fmt, ri(lo, hi, (B, B)),
                      ri(lo, hi, (B, B))))
    cases.append(("qmatmul K split for occupancy 16x65536x16", top,
                  (ri(0, 2 ** 23, (16, 65536)) << 8) | 0xFF,
                  (ri(-2 ** 23, 2 ** 23, (65536, 16)) << 8) | 0xFF))
    # the K chunk sets the split; output tile (0, 0) at the accumulators'
    # worst case, as in chip_smoke.py
    M, K, N = C.QMM_CHUNK
    ca, cw = (ri(-2 ** 23, 2 ** 23, shape) << 8 | 0xFF
              for shape in ((M, K), (K, N)))
    ca[:P.fxk.TILE_M] = 2 ** 31 - 1
    cw[:, :P.fxk.TILE_N] = 2 ** 31 - 1
    cases.append((f"qmatmul K split by the chunk {M}x{K}x{N}", top, ca, cw))
    del ca, cw
    for label, fmt, a, w in cases:
        new = lambda a=a, w=w, f=fmt: P.fxk.qmatmul(a, w, bf=f.bf, bn=f.bn)
        fns = {}
        if old_q is not None:
            fns["parent"] = lambda a=a, w=w, f=fmt: old_q(a, w, f.bf, f.bn)
        plan = P.fxk.qmatmul_plan(*a.shape, w.shape[1])
        fns[f"landed plan={plan}"] = new
        with mock.patch.object(P.fxk, "TC_BLOCKS", 1):
            alone = P.fxk.qmatmul_plan(*a.shape, w.shape[1])
        if alone != plan:               # the chunk's split stays
            fns["unsplit"] = unsplit(new)
        want = P.fxk.qmatmul_ref(a, w, bf=fmt.bf, bn=fmt.bn)
        run(label, fns, want)
        del a, w, want
    del cases

    for sname, n_in, n_out, pseed in C.SWEEP_SHAPES:
        pat = P.make_block_pattern(n_in, n_out, 0.25, C.BS, seed=pseed)
        idx = torch.from_numpy(pat.idx).to("cuda")
        w = torch.randn((1, *pat.idx.shape, C.BS, C.BS), generator=gen,
                        device="cuda") * 0.05
        b = torch.randn((1, n_out), generator=gen, device="cuda")
        for fmt in fxp.PAPER_TRIPLETS + ["wide"]:
            kind = "wide" if fmt == "wide" else "spread"
            fmt = top if kind == "wide" else fmt
            args = C._fxp_operands(P, gen, w, b, fmt, kind, C.SWEEP_M, n_in)
            xf, wq, qf, lut, bq = args
            call = (xf, wq, idx, qf, lut, bq)
            new = lambda call=call: P.bsm.fwd_fxp(*call)
            fns = {}
            if old_f is not None:
                fns["parent"] = lambda call=call: old_f(*call)
            fns[f"landed plan={P.bsm.fxp_plan(1, C.SWEEP_M, *wq.shape[1:4])}"] \
                = new
            fns["unsplit"] = unsplit(new)
            tag = " beyond 16 bits" if kind == "wide" else \
                f" fmt=({fmt.bw},{fmt.bn},{fmt.bf})"
            label = f"fwd_fxp sweep {sname} {n_in}->{n_out} M={C.SWEEP_M}{tag}"
            run(label, fns, P.bsm.fwd_fxp_ref(*call))
    for bs in (32, 64):
        _, n_in, n_out, pseed = C.SWEEP_SHAPES[0]
        pat = P.make_block_pattern(n_in, n_out, 0.25, bs, seed=pseed)
        idx = torch.from_numpy(pat.idx).to("cuda")
        w = torch.randn((1, *pat.idx.shape, bs, bs), generator=gen,
                        device="cuda") * 0.05
        b = torch.randn((1, n_out), generator=gen, device="cuda")
        xf, wq, qf, lut, bq = C._fxp_operands(P, gen, w, b, paper, "spread",
                                              C.SWEEP_M, n_in)
        call = (xf, wq, idx, qf, lut, bq)
        fns = {}
        if old_f is not None:
            fns["parent"] = lambda call=call: old_f(*call)
        fns[f"landed plan={P.bsm.fxp_plan(1, C.SWEEP_M, *wq.shape[1:4])}"] = \
            lambda call=call: P.bsm.fwd_fxp(*call)
        run(f"fwd_fxp block {bs} {n_in}->{n_out} M={C.SWEEP_M}", fns,
            P.bsm.fwd_fxp_ref(*call))
    if old_f is not None:
        def sweep(kernel):
            def call():
                with mock.patch.object(P.bsm, "fwd_fxp", kernel):
                    t0 = time.perf_counter()
                    counts = C.sweep_phase(P, card)
                    return time.perf_counter() - t0, counts
            return call
        for name, fn in (("parent", sweep(old_f)),
                         ("landed", sweep(P.bsm.fwd_fxp)),
                         ("landed", sweep(P.bsm.fwd_fxp)),
                         ("parent", sweep(old_f))):
            secs, counts = fn()
            print(f"[fxp] sweep_phase with the {name} fwd_fxp: {secs:.3f} s, "
                  f"fwd_fxp launches {counts['junction_fwd_fxp']} [{card}]",
                  flush=True)
    return ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="the parent commit's src/repro_torch/csrc")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_layouts: no CUDA device", file=sys.stderr)
        return 1
    if opts.parent is not None and not all(
            (opts.parent / f"{n}.cu").is_file() for n in PARENT_SOURCES):
        print(f"chip_layouts: no {' or '.join(PARENT_SOURCES)} sources "
              f"under {opts.parent}", file=sys.stderr)
        return 1
    P = C.load_port()
    card = C.card_line()
    print(f"card: {card}")
    P.build.build_all()
    libs = build_parent(P, opts.parent) if opts.parent is not None else {}
    timer = C.Timer(reps=10)
    tiny = torch.empty(1, device="cuda")
    print(f"[floor] chip_smoke.Timer of a one-element fill: "
          f"{timer.ms(lambda: tiny.fill_(1.0)):.4f} ms [{card}]")
    ok = fxp_layouts(P, libs, timer, card)
    print(card)
    return 0 if ok else 2


if __name__ == "__main__":
    sys.exit(main())
