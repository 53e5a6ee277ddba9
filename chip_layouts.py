#!/usr/bin/env python3
"""Time the int8 kernels' layouts on one NVIDIA card beside the parent
commit's kernel, and read the backward's dz rounding against the plain
versions.

    python3 chip_layouts.py [--parent DIR]

from the root of a checkout, on a machine with a CUDA card, nvcc and
PyTorch built for CUDA.  DIR holds the parent commit's
``src/repro_torch/csrc`` (for example ``git archive <parent>
src/repro_torch/csrc | tar -x -C build/parent``, then ``--parent
build/parent/src/repro_torch/csrc``; ``build/`` is git-ignored).  It
builds, under ``build/layouts/``, ``csrc/junction_quant.cu`` at ring
depths 2 and 4 (the source has 3) and, with DIR, the parent's
``junction_quant.cu``, ``junction_tc.cu``, ``junction_dx.cu`` and
``junction_dw.cu``, all nvcc processes started together.  Then:

1. the floor of ``chip_smoke.Timer`` (a one-element fill), and each case
   of 2. also after a flush that reads (``ReadFlush``);
2. ``fwd_int8`` at a stablelm-3b FFN layer (wg + wi + wo) at decode (M 4)
   and prefill (M 32), at qwen3-moe's down junction (E 128, M 4) and the
   sweep's 1024 -> 512 junction (E 6, M 512, fp32), ``gated_fwd_int8``
   at qwen3-moe's gate junction (E 128, M 4): the landed kernel, ring
   depths 2 and 4, no split and one slot a block (``bsm._INT8_BLOCKS``),
   the other path (``bsm.int8_variant``) and the parent's kernel, each
   output equal bit for bit to the landed kernel's, timed in turns
   (parent first and last, ``chip_smoke.in_turns``);
3. the path's crossover: dp4a against mma.sync from 4 to 64 rows at the
   stablelm layer and the qwen3 gate, beside ``bsm.INT8_MMA_MIN_M``;
4. with DIR, every kernel that rounds dz through ``act_bwd`` or
   ``gated_dz_t`` against the parent's, in turns: dx, dw and Adam
   update_dw at stablelm-3b's wg junction (M 2048, silu and gelu), and
   gated_dx, gated_dw and Adam update_gated_dw at qwen3-moe's gate
   junction (M 160), through both entry points;
5. ``gated_dw_rounding``: on seeds 1-4 at the gate junction (E 128, M
   160), both gated_dw entry points' error against ``gated_dw_ref`` and
   the Adam update_gated_dw's slot error against ``update_gated_dw_ref``,
   and the dz_g / dz_u elements each entry point rounds to the other bf16
   neighbour of the plain version's (read exactly by gated_dw of a
   one-hot x); the same count for dw's dz under gelu (and silu) at the
   wg junction; with DIR, the parent's counts beside them.

It exits 1 without a card and 2 when a layout disagrees with the landed
kernel or a check fails.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import subprocess
import sys
from pathlib import Path
from unittest import mock

import torch

import chip_smoke as C

RINGS = (2, 4)
PARENT_SOURCES = ("junction_quant", "junction_tc", "junction_dx",
                  "junction_dw")
CROSSOVER_ROWS = (4, 8, 16, 32, 64)


def build_libs(P, parent: Path | None) -> dict[str, ctypes.CDLL]:
    """The ring-depth variants of junction_quant.cu and the parent's
    sources, each its own library; one nvcc each, all started together."""
    out = C.ROOT / "build" / "layouts"
    out.mkdir(parents=True, exist_ok=True)
    srcs = {}
    text = (P.build.CSRC / "junction_quant.cu").read_text()
    landed = "constexpr int kInt8Stages = 3;"
    if landed not in text:
        raise RuntimeError("junction_quant.cu no longer sets kInt8Stages = 3")
    for depth in RINGS:
        src = out / f"junction_quant_ring{depth}.cu"
        src.write_text(text.replace(
            landed, f"constexpr int kInt8Stages = {depth};"))
        srcs[f"ring{depth}"] = (src, P.build.CSRC)
    if parent is not None:
        for name in PARENT_SOURCES:
            srcs[f"parent_{name}"] = (parent / f"{name}.cu", parent)
    procs = {}
    for key, (src, inc) in srcs.items():
        lib = out / f"lib{key}.so"
        procs[key] = (subprocess.Popen(
            [P.build.find_nvcc(), *P.build.NVCC_FLAGS, "-I", str(inc), "-o",
             str(lib), str(src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for key, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        libs[key] = ctypes.CDLL(str(lib))
    return libs


@contextlib.contextmanager
def using(P, libs: dict[str, ctypes.CDLL]):
    """The wrappers load the given libraries in place of the landed ones
    (by source name)."""
    load = P.build.load
    with mock.patch.object(P.build, "load",
                           lambda name: libs.get(name) or load(name)):
        yield


def variant_call(P, fn, libs=None, blocks=None, path=None):
    """``fn`` under another ring library, split rule or path."""
    def call():
        with contextlib.ExitStack() as st:
            if libs:
                st.enter_context(using(P, libs))
            if blocks is not None:
                st.enter_context(C.int8_split_rule(P, blocks))
            if path is not None:
                st.enter_context(mock.patch.object(P.bsm, "int8_variant",
                                                   lambda *_: path))
            return fn()
    return call


def parent_int8(lib, gated):
    """The parent's int8 entry point at its own C signature (fwd: 7
    pointers, 8 ints; gated: 8 pointers, 7 ints; then the stream)."""
    fn = getattr(lib, "junction_gated_fwd_int8" if gated
                 else "junction_fwd_int8")
    n_ptr, n_int = (8, 7) if gated else (7, 8)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _int8_junction(P, gen, shape, E, M, dtype, n_codes=1):
    if len(shape) == 5:                  # a TRAIN_SHAPES entry
        name, n_in, n_out, act, pseed = shape
    else:
        name, n_in, n_out, pseed = shape
        act = "none"
    _, idx, x, codes, _ = C._quant_case(P, gen, (name, n_in, n_out, pseed),
                                        E, M, dtype, n_codes=n_codes)
    b = torch.zeros((E, n_out), device="cuda")
    return dict(idx=idx, x=x, codes=codes, b=b, act=act, E=E, M=M)


def _int8_calls(P, j, parent_lib):
    """(landed call, parent call or None) of one int8 junction: the
    output tensor the call returns."""
    bsm = P.bsm
    x, idx, b, act = j["x"], j["idx"], j["b"], j["act"]
    E, M, n_in = x.shape
    if len(j["codes"]) == 2:
        (wg, sg), (wi, si) = j["codes"]
        nob, kb, bs = wg.shape[1:4]

        def landed():
            return bsm.gated_fwd_int8(x, wg, wi, idx, sg, si)

        def parent():
            h = torch.empty((E, M, nob * bs), dtype=x.dtype, device="cuda")
            err = parent_int8(parent_lib, True)(
                x.data_ptr(), wg.data_ptr(), wi.data_ptr(), idx.data_ptr(),
                sg.data_ptr(), si.data_ptr(), None, h.data_ptr(), E, M,
                n_in // bs, nob, kb, bs, bsm._DTYPE_CODE[x.dtype],
                torch.cuda.current_stream().cuda_stream)
            C.require(err == 0, f"parent gated_fwd_int8: cudaError {err}")
            return h
    else:
        ((wq, sc),) = j["codes"]
        nob, kb, bs = wq.shape[1:4]

        def landed():
            return bsm.fwd_int8(x, wq, idx, sc, b, act)

        def parent():
            y = torch.empty((E, M, nob * bs), dtype=x.dtype, device="cuda")
            err = parent_int8(parent_lib, False)(
                x.data_ptr(), wq.data_ptr(), idx.data_ptr(), sc.data_ptr(),
                b.data_ptr(), None, y.data_ptr(), E, M, n_in // bs, nob, kb,
                bs, bsm.ACTIVATIONS.index(act), bsm._DTYPE_CODE[x.dtype],
                torch.cuda.current_stream().cuda_stream)
            C.require(err == 0, f"parent fwd_int8: cudaError {err}")
            return y
    return landed, parent if parent_lib is not None else None


def _chain(calls):
    """One callable running several junction calls in order (a layer)."""
    return lambda: [c() for c in calls]


class ReadFlush:
    """A flush for ``chip_smoke.Timer`` that reads 96 MB instead of
    writing them: the L2 is left clean, so the timed kernel does not also
    write back the lines the usual flush leaves dirty."""

    def __init__(self):
        self.buf = torch.zeros(96 << 20, dtype=torch.uint8, device="cuda")

    def zero_(self):
        self.buf.max()


def int8_layouts(P, libs, timer, gen, card) -> bool:
    """Part 2: each case's layouts, held against the landed kernel and
    timed in turns; True when every layout gives the landed bits."""
    bsm = P.bsm
    parent_lib = libs.get("parent_junction_quant")
    bf16 = torch.bfloat16
    cases = {
        "stablelm-3b layer decode M=4": [
            _int8_junction(P, gen, s, 1, 4, bf16) for s in C.TRAIN_SHAPES],
        "stablelm-3b layer prefill M=32": [
            _int8_junction(P, gen, s, 1, 32, bf16) for s in C.TRAIN_SHAPES],
        "qwen3-moe gate E=128 M=4": [
            _int8_junction(P, gen, C.MOE_SHAPES[0], C.MOE_E, 4, bf16, 2)],
        "qwen3-moe down E=128 M=4": [
            _int8_junction(P, gen, C.MOE_SHAPES[1], C.MOE_E, 4, bf16)],
        "sweep l1 E=6 M=512 fp32": [
            _int8_junction(P, gen, C.SWEEP_SHAPES[0], C.SWEEP_E, C.SWEEP_M,
                           torch.float32)],
    }
    ok = True
    for label, js in cases.items():
        pairs = [_int8_calls(P, j, parent_lib) for j in js]
        landed = _chain([p[0] for p in pairs])
        j0 = js[0]
        w0 = j0["codes"][0][0]
        plan = bsm.int8_plan(j0["E"], j0["M"], *w0.shape[1:4])
        other = "mma" if plan[0] == "dp4a" else "dp4a"
        fns = {}
        if parent_lib is not None:
            fns["parent"] = _chain([p[1] for p in pairs])
        fns[f"landed {plan}"] = landed
        for depth in RINGS:
            fns[f"ring {depth}"] = variant_call(
                P, landed, libs={"junction_quant": libs[f"ring{depth}"]})
        fns["no split"] = variant_call(P, landed, blocks=C.UNSPLIT)
        fns["one slot a block"] = variant_call(P, landed, blocks=C.ONE_SLOT)
        fns[f"path {other}"] = variant_call(P, landed, path=other)
        want = landed()
        for name, fn in fns.items():
            got = fn()
            same = all(C.bits_equal(a, b) for a, b in zip(got, want))
            ok &= same
            print(f"[layout] int8 {label} {name}: bits equal to the landed "
                  f"kernel's: {same}")
        for name, ms in zip(fns, C.in_turns(timer, *fns.values())):
            print(f"[layout] int8 {label} {name}: {ms:.4f} ms [{card}]")
        clean = C.Timer(reps=timer.reps)
        clean.flush = ReadFlush()
        print(f"[flush] int8 {label} landed: {timer.ms(landed):.4f} ms after "
              f"a 96 MB write, {clean.ms(landed):.4f} ms after a 96 MB read "
              f"[{card}]")
    return ok


def crossover(P, timer, gen, card) -> None:
    """Part 3: dp4a against mma.sync by rows."""
    bf16 = torch.bfloat16
    for label, make in (
            ("stablelm-3b layer", lambda M: [
                _int8_junction(P, gen, s, 1, M, bf16)
                for s in C.TRAIN_SHAPES]),
            ("qwen3-moe gate E=128", lambda M: [
                _int8_junction(P, gen, C.MOE_SHAPES[0], C.MOE_E, M, bf16,
                               2)])):
        for M in CROSSOVER_ROWS:
            layer = _chain([_int8_calls(P, j, None)[0] for j in make(M)])
            fns = [variant_call(P, layer, path=p) for p in ("dp4a", "mma")]
            dp4a, mma = C.in_turns(timer, *fns)
            print(f"[crossover] int8 {label} M={M}: dp4a {dp4a:.4f} ms, "
                  f"mma {mma:.4f} ms; the route takes "
                  f"{P.bsm.int8_variant(M, C.BS)} (INT8_MMA_MIN_M="
                  f"{P.bsm.INT8_MMA_MIN_M}) [{card}]")


def act_bwd_times(P, libs, timer, gen, card) -> None:
    """Part 4: the kernels that round dz through act_bwd / gated_dz_t,
    the parent's and the landed, in turns, through both entry points (the
    updates step the same weights and slots again at every call)."""
    bsm = P.bsm
    parent = {n: libs[f"parent_{n}"] for n in PARENT_SOURCES[1:]}
    hyp = torch.tensor(C.ADAM_HYP, device="cuda")
    rows = []
    for act in ("silu", "gelu"):
        name, n_in, n_out, _, pseed = C.TRAIN_SHAPES[0]
        t, pt = C._train_inputs(P, gen, (name, n_in, n_out, act, pseed), 1,
                                torch.bfloat16)
        mom, vel = C._adam_slots(gen, t["w"].shape)
        rev = (pt["rev_ob"], pt["rev_t"], pt["rev_cnt"])
        rows += [
            (f"dx wg {act}", lambda t=t, act=act, rev=rev: bsm.dx(
                t["dy"], t["w"], *rev, t["res"], act)),
            (f"dw wg {act}", lambda t=t, act=act, idx=pt["idx"]: bsm.dw(
                t["x"], t["dy"], idx, t["res"], act, False)),
            (f"update_dw wg {act} Adam",
             lambda t=t, act=act, idx=pt["idx"], m=mom, v=vel: bsm.update_dw(
                 t["x"], t["dy"], idx, t["res"], t["w"], None, m, None, hyp,
                 vel=v, act=act, with_bias=False))]
    t, pt = C._moe_inputs(P, gen, C.MOE_SHAPES[0], C.MOE_E,
                          C.MOE_M["train"], torch.bfloat16)
    mom, vel = C._adam_slots(gen, t["w"].shape)
    dw_args = (t["x"], t["dy"], pt["idx"], t["g"], t["u"])
    rows += [
        ("gated_dx gate M=160", lambda: bsm.gated_dx(
            t["dy"], t["w"], t["wi"], pt["rev_ob"], pt["rev_t"],
            pt["rev_cnt"], t["g"], t["u"])),
        ("gated_dw gate M=160", lambda: bsm.gated_dw(*dw_args)),
        ("update_gated_dw gate M=160 Adam", lambda: bsm.update_gated_dw(
            *dw_args, t["w"], t["wi"], mom, mom.clone(), hyp, vg=vel,
            vi=vel.clone()))]
    for name, fn in rows:
        for entry in ("tc", "simt"):
            new = C.forced_call(P, entry, fn)

            def old(new=new):
                with using(P, parent):
                    return new()
            p, n = C.in_turns(timer, old, new)
            print(f"[act_bwd] {name} ({entry}): parent {p:.4f} ms, landed "
                  f"{n:.4f} ms ({100 * (n / p - 1):+.1f} %) [{card}]")
    del t, pt
    torch.cuda.empty_cache()


def _dw_of(x, idx, dz, bs=C.BS):
    """Plain fp32 sums over M of x against a given branch gradient, as
    ``gated_dw_ref`` sums them."""
    E, M, n_in = x.shape
    xb = x.reshape(E, M, n_in // bs, bs).float()
    dzb = dz.reshape(E, M, idx.shape[0], bs).float()
    return torch.stack([torch.einsum("emoa,emoc->eoac",
                                     xb[:, :, idx[:, k].long(), :], dzb)
                        for k in range(idx.shape[1])], dim=2)


def _one_hot_x(x, r0, rows, bs=C.BS):
    """An x that is one-hot in each input block: x[m, j*bs + a] = 1 for
    a = m - r0 (rows r0 .. r0 + rows - 1); dw of it sums one product a
    term, so slot 0's dw rows are dz's rows r0 .. r0 + bs - 1 exactly."""
    E, M, n_in = x.shape
    oh = torch.zeros_like(x).reshape(E, M, n_in // bs, bs)
    a = torch.arange(rows, device=x.device)
    oh[:, r0 + a, :, a] = 1.0
    return oh.reshape(E, M, n_in)


def _kernel_dz(P, variant, x, dy, idx, extra, gated):
    """dz as ``variant``'s gated_dw ((dz_g, dz_u)) or dw ((dz,)) rounds
    it, [E, M, nob*bs] in dy's dtype: one call of a one-hot x a bs rows."""
    E, M, _ = x.shape
    nob = idx.shape[0]
    zs = [torch.empty_like(dy) for _ in range(2 if gated else 1)]
    for r0 in range(0, M, C.BS):
        rows = min(C.BS, M - r0)
        oh = _one_hot_x(x, r0, rows)
        if gated:
            dws = C.forced_call(P, variant, lambda: P.bsm.gated_dw(
                oh, dy, idx, *extra))()
        else:
            dws = C.forced_call(P, variant, lambda: P.bsm.dw(
                oh, dy, idx, *extra, False))()[:1]
        for z, dwv in zip(zs, dws):
            # dwv[e, o, 0, a, c] = dz[e, r0 + a, o*bs + c]
            z[:, r0:r0 + rows] = (dwv[:, :, 0, :rows].permute(0, 2, 1, 3)
                                  .reshape(E, rows, nob * C.BS)
                                  .to(z.dtype))
    return zs


def gated_dw_rounding(P, libs, card, seeds=(1, 2, 3, 4)) -> bool:
    """Part 5; True when every error is within its tolerance."""
    bsm = P.bsm
    parent = {n: libs[f"parent_{n}"] for n in PARENT_SOURCES[1:]
              if f"parent_{n}" in libs}
    sources = [("landed", {})] + ([("parent", parent)] if parent else [])
    hyp = torch.tensor(C.ADAM_HYP, device="cuda")
    lim = C.REL_TOL["bf16_sum"]
    ok = True
    M = C.MOE_M["train"]
    for seed in seeds:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        t, pt = C._moe_inputs(P, gen, C.MOE_SHAPES[0], C.MOE_E, M,
                              torch.bfloat16)
        args = (t["x"], t["dy"], pt["idx"], t["g"], t["u"])
        want = bsm.gated_dw_ref(*args)
        plain_dz = bsm._gated_dz(t["dy"], t["g"], t["u"])
        mom, vel = C._adam_slots(gen, t["w"].shape)
        init = (t["w"], t["wi"], mom, mom, vel, vel)
        plain = [v.clone() for v in init]
        bsm.update_gated_dw_ref(*args, *plain[:4], hyp, vg=plain[4],
                                vi=plain[5])
        for src, lib in sources:
            for variant in ("simt", "tc"):
                with using(P, lib):
                    got = C.forced_call(P, variant,
                                        lambda: bsm.gated_dw(*args))()
                    dz = _kernel_dz(P, variant, t["x"], t["dy"], pt["idx"],
                                    (t["g"], t["u"]), True)
                    st = [v.clone() for v in init]
                    C.forced_call(P, variant, lambda: bsm.update_gated_dw(
                        *args, *st[:4], hyp, vg=st[4], vi=st[5]))()
                err = [C.rel_err(a, b) for a, b in zip(got, want)]
                upd = max(C.rel_err(a, b) for a, b in zip(st[2:], plain[2:]))
                flips = [int((k != q).sum()) for k, q in zip(dz, plain_dz)]
                own = [C.rel_err(a, _dw_of(t["x"], pt["idx"], z))
                       for a, z in zip(got, dz)]
                if src == "landed":
                    ok &= max(err + [upd]) <= lim
                print(f"[rounding] {src} gated_dw {variant} seed={seed} "
                      f"E={C.MOE_E} M={M}: rel_err dwg {err[0]:.3g} dwi "
                      f"{err[1]:.3g}, update_gated_dw Adam slots {upd:.3g} "
                      f"(tol {lim:.3g}); dz elements that differ from the "
                      f"plain dz: dz_g {flips[0]} dz_u {flips[1]} of "
                      f"{dz[0].numel()}; rel_err against the plain sums of "
                      f"its own dz: dwg {own[0]:.3g} dwi {own[1]:.3g} "
                      f"[{card}]")
        del t, pt, want, plain_dz, plain
        torch.cuda.empty_cache()
    # dw's dz under gelu and silu at stablelm-3b's wg junction
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seeds[0])
    for act in ("gelu", "silu"):
        name, n_in, n_out, _, pseed = C.TRAIN_SHAPES[0]
        t, pt = C._train_inputs(P, gen, (name, n_in, n_out, act, pseed), 1,
                                torch.bfloat16, M=1024)
        plain_dz = bsm._dz(t["dy"], t["res"], act)[0]
        for src, lib in sources:
            for variant in ("simt", "tc"):
                with using(P, lib):
                    (dz,) = _kernel_dz(P, variant, t["x"], t["dy"],
                                       pt["idx"], (t["res"], act), False)
                print(f"[rounding] {src} dw {variant} {name} act={act} "
                      f"M=1024: dz elements that differ from the plain dz: "
                      f"{int((dz != plain_dz).sum())} of {dz.numel()} "
                      f"[{card}]")
        del t, pt, plain_dz
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
    if opts.parent is not None and not (
            opts.parent / "junction_quant.cu").is_file():
        print(f"chip_layouts: no junction_quant.cu under {opts.parent}",
              file=sys.stderr)
        return 1
    P = C.load_port()
    card = C.card_line()
    print(f"card: {card}")
    P.build.build_all()
    libs = build_libs(P, opts.parent)
    timer = C.Timer(reps=10)
    tiny = torch.empty(1, device="cuda")
    print(f"[floor] chip_smoke.Timer of a one-element fill: "
          f"{timer.ms(lambda: tiny.fill_(1.0)):.4f} ms [{card}]")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(19)
    ok = int8_layouts(P, libs, timer, gen, card)
    crossover(P, timer, gen, card)
    if opts.parent is not None:
        act_bwd_times(P, libs, timer, gen, card)
    ok &= gated_dw_rounding(P, libs, card)
    print(card)
    return 0 if ok else 2


if __name__ == "__main__":
    sys.exit(main())
