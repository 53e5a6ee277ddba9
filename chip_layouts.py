#!/usr/bin/env python3
"""Time the layouts of the tensor-core gated update on one NVIDIA card.

    python3 chip_layouts.py

from the root of a checkout, on a machine with a CUDA card, nvcc and
PyTorch built for CUDA.  It builds ``update_gated_tc_kernel`` of
``src/repro_torch/csrc/junction_tc.cu`` at block 128 in four layouts —
whole slots or 64-column halves of a slot, K steps of 64 or 32 rows of
M, one or two blocks an SM — as extra entry points of a library of its
own under ``build/layouts/``, holds each against the plain version
(``update_gated_dw_ref``) at qwen3-moe-30b-a3b's expert gate junction
(128 experts, 2048 -> 768 at density 0.25, Adam) at an expert's
training rows (M = 160) and a decode tick's capacity (M = 4), and times
them in turns (a b c d e e d c b a, ``chip_smoke.Timer``) with the SIMT
entry point ``junction_update_gated_dw`` as the fifth.  The layout the
source launches is ``kGatedNA`` / ``kGatedKM`` / ``kGatedMinB``.  It
exits 1 without a card and 2 when a layout disagrees with the plain
version.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

import chip_smoke as C

# (entry point, columns a block, rows a K step, blocks an SM)
LAYOUTS = [("whole_k64_1", 128, 64, 1), ("whole_k32_1", 128, 32, 1),
           ("half_k64_1", 64, 64, 1), ("half_k32_2", 64, 32, 2)]
ENTRY = """
extern "C" int {name}(const void* x, const void* dh, const void* g,
                      const void* u, const void* idx, const void* hyp,
                      void* wg, void* wi, void* mg, void* mi, void* vg,
                      void* vi, void* bad, void* health, int E, int M,
                      int nib, int nob, int kb, void* stream) {{
  return launch_update_gated<128, {na}, {km}, {minb}>(
      x, dh, g, u, idx, hyp, wg, wi, mg, mi, vg, vi, bad, health, E, M, nib,
      nob, kb, (cudaStream_t)stream);
}}
"""


def build_layouts(P) -> ctypes.CDLL:
    """The four layouts as entry points of one library, from the source
    as it stands."""
    out = C.ROOT / "build" / "layouts"
    out.mkdir(parents=True, exist_ok=True)
    src = out / "gated_layouts.cu"
    src.write_text(f'#include "{P.build.CSRC / "junction_tc.cu"}"\n' + "".join(
        ENTRY.format(name=n, na=na, km=km, minb=mb)
        for n, na, km, mb in LAYOUTS))
    lib = out / "libgated_layouts.so"
    r = subprocess.run([P.build.find_nvcc(), *P.build.NVCC_FLAGS, "-o",
                        str(lib), str(src)], capture_output=True, text=True)
    for line in (r.stdout + r.stderr).splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print(f"[ptxas] {line.strip()}")
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{r.stdout}{r.stderr}")
    handle = ctypes.CDLL(str(lib))
    for name, *_ in LAYOUTS:
        getattr(handle, name).argtypes = [ctypes.c_void_p] * 14 + [
            ctypes.c_int] * 5 + [ctypes.c_void_p]
    return handle


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_layouts: no CUDA device", file=sys.stderr)
        return 1
    P = C.load_port()
    card = C.card_line()
    print(f"card: {card}")
    lib = build_layouts(P)
    bsm = P.bsm
    timer = C.Timer(reps=10)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(19)
    hyp = torch.tensor(C.ADAM_HYP, device="cuda")
    ok = True
    for M in (C.MOE_M["train"], C.MOE_M["decode"]):
        t, pt = C._moe_inputs(P, gen, C.MOE_SHAPES[0], C.MOE_E, M,
                              torch.bfloat16)
        E = C.MOE_E
        nob, kb = pt["idx"].shape
        h7 = hyp.expand(E, len(C.ADAM_HYP)).contiguous()
        mom, vel = C._adam_slots(gen, t["w"].shape)
        init = (t["w"], t["wi"], mom, mom, vel, vel)
        args = (t["x"], t["dy"], pt["idx"], t["g"], t["u"])
        plain = [v.clone() for v in init]
        bsm.update_gated_dw_ref(*args, *plain[:4], hyp, vg=plain[4],
                                vi=plain[5])

        def layout(name, st):
            fn = getattr(lib, name)

            def call():
                bad = torch.zeros((E, nob), dtype=torch.int32, device="cuda")
                health = torch.empty((E,), dtype=torch.int32, device="cuda")
                err = fn(*(v.data_ptr() for v in args[:2]), args[3].data_ptr(),
                         args[4].data_ptr(), args[2].data_ptr(),
                         h7.data_ptr(), *(s.data_ptr() for s in st),
                         bad.data_ptr(), health.data_ptr(), E, M,
                         t["x"].shape[2] // C.BS, nob, kb,
                         torch.cuda.current_stream().cuda_stream)
                if err != 0:
                    raise RuntimeError(f"{name} launch failed: {err}")
            return call

        def simt(st):
            return C.forced_call(P, "simt", lambda: bsm.update_gated_dw(
                *args, *st[:4], hyp, vg=st[4], vi=st[5]))

        states = {n: [v.clone() for v in init] for n, *_ in LAYOUTS}
        states["simt"] = [v.clone() for v in init]
        fns = {n: layout(n, states[n]) for n, *_ in LAYOUTS}
        fns["simt"] = simt(states["simt"])
        for name, fn in fns.items():
            fn()
            torch.cuda.synchronize()
            k = states[name]
            w_ok = (C._adam_w_ok(k[0], plain[0], t["w"], k[2], plain[2],
                                 k[4], plain[4])
                    and C._adam_w_ok(k[1], plain[1], t["wi"], k[3],
                                     plain[3], k[5], plain[5]))
            err = max(C.rel_err(a, b) for a, b in zip(k[2:], plain[2:]))
            good = w_ok and err <= C.REL_TOL["bf16_sum"]
            ok &= good
            print(f"[layout] {name} E={E} M={M} Adam: weights held "
                  f"{w_ok}, slot rel_err {err:.3g} (tol "
                  f"{C.REL_TOL['bf16_sum']:.3g})")
        names = list(fns)
        ms = {n: [] for n in names}
        for n in names + names[::-1]:
            ms[n].append(timer.ms(fns[n]))
        for n in names:
            print(f"[layout] update_gated_dw {n} E={E} M={M} bf16 Adam: "
                  f"{ms[n][0]:.4f} / {ms[n][1]:.4f} ms, mean "
                  f"{sum(ms[n]) / 2:.4f} [{card}]")
        del t, pt, states, fns, plain
        torch.cuda.empty_cache()
    print(card)
    return 0 if ok else 2


if __name__ == "__main__":
    sys.exit(main())
