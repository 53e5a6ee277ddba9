#!/usr/bin/env python3
"""Time the selective scan, ``selective_scan``, on one NVIDIA card beside
the parent commit's, in turns.

    python3 chip_layouts.py [--parent DIR]

from the root of a checkout, on a machine with a CUDA card, nvcc and
PyTorch built for CUDA.  DIR holds the parent commit's
``src/repro_torch/csrc`` (for example ``git archive <parent>
src/repro_torch/csrc | tar -x -C build/parent``, then ``--parent
build/parent/src/repro_torch/csrc``; ``build/`` is git-ignored); its
``selective_scan.cu`` is built under ``build/layouts/``, beside the
landed sources.  Then:

1. the floor of ``chip_smoke.Timer`` (a one-element fill);
2. the static SASS counts (``cuobjdump -sass``) of MUFU.EX2 (one an
   element), SHFL, LDS and STS in every scan kernel function of the
   landed library and, with DIR, of the parent's, whole and in the hot
   loop, with the shared-memory and shuffle (MIO) instructions a
   MUFU.EX2 there;
3. at the four cases ``chip_smoke.py`` times (falcon-mamba-7b's d_inner
   and state, B1 x S4096 and B4 x S1024, fp32 and bf16): the landed plan,
   the sequence split forced off (L = 1) or on (L = 2), two lanes a
   channel at the landed split, four lanes unsplit and, at batch 1, 3
   and 12 chunks, and, with DIR, the parent's kernel at its C signature,
   each output against the plain version (``chip_smoke.TOL``), timed in
   turns (``chip_smoke.in_turns``).

It exits 1 without a card and 2 when an output disagrees with its plain
version or a landed kernel holds no MUFU.EX2.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path
from unittest import mock

import torch

import chip_smoke as C

PARENT_SOURCES = ("selective_scan",)
SASS_OPS = ("MUFU.EX2", "SHFL", "LDS", "STS")


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


def sass_functions(P, path) -> dict[str, list[tuple[int, str]]]:
    """(address, instruction) of each kernel function in a built library
    (``cuobjdump -sass``), by its name past the anonymous namespace."""
    nvcc = Path(P.build.find_nvcc())
    sass = subprocess.run([str(nvcc.with_name("cuobjdump")), "-sass",
                           str(path)], capture_output=True, text=True,
                          check=True).stdout
    funcs, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            m = re.search(r"\d+((?:selective_)?scan_\w+)", name)
            fn = m.group(1) if m else name
            funcs[fn] = []
        elif fn is not None:
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+([^;]*);", line)
            if m:
                funcs[fn].append((int(m.group(1), 16), m.group(2)))
    return funcs


def op_counts(instrs) -> dict[str, int]:
    """SASS_OPS among instructions (predicated ones included)."""
    pat = re.compile(r"(?:^|\s)(MUFU\.EX2|SHFL|LDS|STS)(?:\.[A-Z0-9_.]+)?\s")
    counts = dict.fromkeys(SASS_OPS, 0)
    for _, text in instrs:
        m = pat.search(text + " ")
        if m:
            counts[m.group(1)] += 1
    return counts


def hot_loop(instrs):
    """The instructions of the innermost loop (a backward branch's span)
    that holds a MUFU.EX2, or []."""
    best = []
    for addr, text in instrs:
        m = re.search(r"\bBRA\s+0x([0-9a-f]+)", text)
        if not m or int(m.group(1), 16) > addr:
            continue
        span = [(a, t) for a, t in instrs if int(m.group(1), 16) <= a <= addr]
        if any("MUFU.EX2" in t for _, t in span) and (
                not best or len(span) < len(best)):
            best = span
    return best


def print_sass(label, funcs) -> None:
    """Each kernel function's SASS_OPS, whole and in its hot loop, with
    the MIO instructions (SHFL, LDS, STS) a MUFU.EX2 (an element) there;
    static counts: a loop of shuffles counts once."""
    for fn, instrs in funcs.items():
        whole, loop = op_counts(instrs), op_counts(hot_loop(instrs))
        mio = loop["SHFL"] + loop["LDS"] + loop["STS"]
        per = f"{mio / loop['MUFU.EX2']:.3f}" if loop["MUFU.EX2"] else "-"
        print(f"[sass] {label} {fn}: function "
              + ", ".join(f"{op} {n}" for op, n in whole.items())
              + f"; hot loop ({len(hot_loop(instrs))} instructions) "
              + ", ".join(f"{op} {n}" for op, n in loop.items())
              + f"; MIO a MUFU.EX2 in the loop: {per}")


def parent_scan(lib):
    """The parent's selective_scan at its C signature (8 pointers, 5
    ints, the stream)."""
    fn = lib.selective_scan
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(dt, x, bc, cc, a, h0):
        B, S, di = dt.shape
        N = bc.shape[-1]
        y = torch.empty_like(dt)
        h = torch.empty((B, di, N), dtype=torch.float32, device="cuda")
        err = fn(dt.data_ptr(), x.data_ptr(), bc.data_ptr(), cc.data_ptr(),
                 a.data_ptr(), h0.data_ptr(), y.data_ptr(), h.data_ptr(), B,
                 S, di, N, 0 if dt.dtype == torch.float32 else 1,
                 torch.cuda.current_stream().cuda_stream)
        C.require(err == 0, f"parent selective_scan: cudaError {err}")
        return y, h
    return call


def forced(P, nt, L, fn):
    """``fn`` with the scan's plan forced to nt lanes a channel and (at
    most) L chunks."""
    ssk = P.ssk

    def plan(B, S, di, N):
        return (nt, ssk.scan_ns(N, nt), ssk.SCAN_THREADS // nt,
                *ssk.scan_chunks(S, L))

    def call():
        with mock.patch.object(ssk, "scan_plan", plan):
            return fn()
    return call


def scan_layouts(P, libs, timer, card) -> bool:
    """Parts 2 and 3; True when every output is within TOL of the plain
    version's and every landed kernel holds a MUFU.EX2."""
    landed = sass_functions(P, P.build.lib_path("selective_scan"))
    print_sass("landed", landed)
    ok = all(op_counts(instrs)["MUFU.EX2"] > 0
             for fn, instrs in landed.items() if "scan_kernel" in fn)
    if libs:
        print_sass("parent", sass_functions(
            P, C.ROOT / "build" / "layouts"
            / "libparent_selective_scan.so"))
    old = parent_scan(libs["selective_scan"]) if libs else None
    ssk = P.ssk
    gen = torch.Generator(device="cuda")
    gen.manual_seed(23)
    arch = P.registry.get(C.SCAN_ARCH)
    di, N = arch.d_inner, arch.ssm_state
    for B, S in C.SCAN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            dt = torch.nn.functional.softplus(torch.randn(
                (B, S, di), generator=gen, device="cuda")) * 0.1
            xs = [torch.randn(shape, generator=gen, device="cuda")
                  for shape in ((B, S, di), (B, S, N), (B, S, N))]
            a = -torch.exp(torch.randn((di, N), generator=gen,
                                       device="cuda") * 0.3)
            h0 = torch.randn((B, di, N), generator=gen, device="cuda") * 0.1
            ins = [t.to(dtype) for t in (dt, *xs)] + [a, h0]
            ry, rh = ssk.selective_scan_ref(*ins)
            nt, _, _, L, chunk = ssk.scan_plan(B, S, di, N)
            new = lambda ins=ins: ssk.selective_scan(*ins)
            fns = {}
            if old is not None:
                fns["parent"] = lambda ins=ins: old(*ins)
            fns[f"landed nt={nt} L={L} chunk={chunk}"] = new
            variants = [(nt, 2 if L == 1 else 1), (2, L), (4, 1)]
            if B == 1:
                variants += [(nt, 3), (nt, 12)]
            for vnt, vL in variants:
                vL, vchunk = ssk.scan_chunks(S, vL)
                fns[f"forced nt={vnt} L={vL} chunk={vchunk}"] = forced(
                    P, vnt, vL, new)
            label = f"{C.SCAN_ARCH} B={B} S={S} {str(dtype)[6:]}"
            for name, fn in fns.items():
                y, h = fn()
                err = max(C.max_err(y, ry), C.max_err(h, rh))
                good = C.close(y, ry, C.TOL[dtype]) and C.close(
                    h, rh, C.TOL[torch.float32])
                ok &= good
                print(f"[scan] {label} {name}: max_abs_err={err:.3g} "
                      f"within TOL: {good}")
            for name, ms in zip(fns, C.in_turns(timer, *fns.values())):
                print(f"[scan] {label} {name}: {ms:.4f} ms [{card}]",
                      flush=True)
            del ins, ry, rh, dt, xs
            torch.cuda.empty_cache()
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
    P.build.build_all(("selective_scan",))
    libs = build_parent(P, opts.parent) if opts.parent is not None else {}
    timer = C.Timer(reps=10)
    tiny = torch.empty(1, device="cuda")
    print(f"[floor] chip_smoke.Timer of a one-element fill: "
          f"{timer.ms(lambda: tiny.fill_(1.0)):.4f} ms [{card}]")
    ok = scan_layouts(P, libs, timer, card)
    print(card)
    return 0 if ok else 2


if __name__ == "__main__":
    sys.exit(main())
