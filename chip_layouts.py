#!/usr/bin/env python3
"""Time the layouts of two tensor-core gated kernels on one NVIDIA card,
and trace gated_dw's error against its plain version to dz's rounding.

    python3 chip_layouts.py

from the root of a checkout, on a machine with a CUDA card, nvcc and
PyTorch built for CUDA.  It builds, as extra entry points of a library
of its own under ``build/layouts/``, two kernels of
``src/repro_torch/csrc/junction_tc.cu`` at block 128 in several layouts:

* ``update_gated_tc_kernel`` in four: whole slots or 64-column halves of
  a slot, K steps of 64 or 32 rows of M, one or two blocks an SM (the
  source launches ``kGatedNA`` / ``kGatedKM`` / ``kGatedMinB``);
* ``gated_dx_kernel`` in five: K steps of 64 or 32 of an output block's
  columns, the whole input block or 64-column halves of it a block, one
  or two blocks an SM (the source launches ``kGatedDxKS`` /
  ``kGatedDxNA`` / ``kGatedDxMinB``).

It holds each against its plain version (``update_gated_dw_ref``, Adam;
``gated_dx_ref``) at qwen3-moe-30b-a3b's expert gate junction (128
experts, 2048 -> 768 at density 0.25) at an expert's training rows (M =
160) and a decode tick's capacity (M = 4), and times them in turns (a b
c ... c b a, ``chip_smoke.in_turns``) with the kernel's SIMT entry point
(``junction_update_gated_dw``, ``junction_gated_dx``) first and last.

Then, on several seeds at the gate junction and M = 160, it reads both
gated_dw entry points' error against ``gated_dw_ref`` and where it comes
from: it reads the dz_g and dz_u that each entry point rounds (gated_dw
of a one-hot x returns them exactly), counts the elements that round to
the other bf16 neighbour of the plain version's dz, and reads the error
again against the plain sums of the kernel's own dz.  It exits 1 without
a card and 2 when a layout disagrees with the plain version.
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
# (entry point, columns of an output block a K step, columns of the input
# block a block, blocks an SM)
DX_LAYOUTS = [("dx_k64_1", 64, 128, 1), ("dx_k32_1", 32, 128, 1),
              ("dx_k32_2", 32, 128, 2), ("dx_half_k64_1", 64, 64, 1),
              ("dx_half_k32_2", 32, 64, 2)]
DX_ENTRY = """
extern "C" int {name}(const void* dh, const void* g, const void* u,
                      const void* wg, const void* wi, const void* rev_ob,
                      const void* rev_t, const void* rev_cnt, void* dx,
                      int E, int M, int nob, int kb, int nib, int fb,
                      void* stream) {{
  return launch_reverse<128, {ks}, {na}, 2, {minb}>(
      dh, g, u, wg, wi, rev_ob, rev_t, rev_cnt, dx, E, M, nob, kb, nib, fb,
      kNone, (cudaStream_t)stream);
}}
"""


def build_layouts(P) -> ctypes.CDLL:
    """Every layout as an entry point of one library, from the source as
    it stands."""
    out = C.ROOT / "build" / "layouts"
    out.mkdir(parents=True, exist_ok=True)
    src = out / "gated_layouts.cu"
    src.write_text(
        f'#include "{P.build.CSRC / "junction_tc.cu"}"\n'
        + "".join(ENTRY.format(name=n, na=na, km=km, minb=mb)
                  for n, na, km, mb in LAYOUTS)
        + "".join(DX_ENTRY.format(name=n, ks=ks, na=na, minb=mb)
                  for n, ks, na, mb in DX_LAYOUTS))
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
    for name, *_ in DX_LAYOUTS:
        getattr(handle, name).argtypes = [ctypes.c_void_p] * 9 + [
            ctypes.c_int] * 6 + [ctypes.c_void_p]
    return handle


def update_layouts(P, lib, timer, gen, card) -> bool:
    """The gated update's layouts and its SIMT entry point (Adam), held
    and timed; True when every layout holds."""
    bsm = P.bsm
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
        for n, ms in zip(fns, C.in_turns(timer, *fns.values())):
            print(f"[layout] update_gated_dw {n} E={E} M={M} bf16 Adam: "
                  f"{ms:.4f} ms [{card}]")
        del t, pt, states, fns, plain
        torch.cuda.empty_cache()
    return ok


def dx_layouts(P, lib, timer, gen, card) -> bool:
    """The gated dx's layouts and its SIMT entry point, held and timed;
    True when every layout holds."""
    bsm = P.bsm
    ok = True
    lim = C.REL_TOL["bf16_out"]
    for M in (C.MOE_M["train"], C.MOE_M["decode"]):
        t, pt = C._moe_inputs(P, gen, C.MOE_SHAPES[0], C.MOE_E, M,
                              torch.bfloat16)
        E = C.MOE_E
        nob, kb = pt["idx"].shape
        nib, fb = pt["rev_ob"].shape
        args = (t["dy"], t["w"], t["wi"], pt["rev_ob"], pt["rev_t"],
                pt["rev_cnt"], t["g"], t["u"])
        want = bsm.gated_dx_ref(*args)
        outs = {}

        def layout(name):
            fn = getattr(lib, name)
            out = outs[name] = torch.empty_like(want)

            def call():
                err = fn(t["dy"].data_ptr(), t["g"].data_ptr(),
                         t["u"].data_ptr(), t["w"].data_ptr(),
                         t["wi"].data_ptr(), pt["rev_ob"].data_ptr(),
                         pt["rev_t"].data_ptr(), pt["rev_cnt"].data_ptr(),
                         out.data_ptr(), E, M, nob, kb, nib, fb,
                         torch.cuda.current_stream().cuda_stream)
                if err != 0:
                    raise RuntimeError(f"{name} launch failed: {err}")
            return call

        fns = {n: layout(n) for n, *_ in DX_LAYOUTS}

        def simt():
            outs["simt"] = bsm.gated_dx(*args)
        fns["simt"] = C.forced_call(P, "simt", simt)
        for name, fn in fns.items():
            fn()
            torch.cuda.synchronize()
            err = C.rel_err(outs[name], want)
            ok &= err <= lim
            print(f"[layout] {name} E={E} M={M}: rel_err {err:.3g} (tol "
                  f"{lim:.3g})")
        for n, ms in zip(fns, C.in_turns(timer, *fns.values())):
            print(f"[layout] gated_dx {n} E={E} M={M} bf16: {ms:.4f} ms "
                  f"[{card}]")
        del t, pt, fns, outs, want
        torch.cuda.empty_cache()
    return ok


def _dw_of(x, idx, dz, bs=C.BS):
    """Plain fp32 sums over M of x against a given branch gradient, as
    ``gated_dw_ref`` sums them."""
    E, M, n_in = x.shape
    xb = x.reshape(E, M, n_in // bs, bs).float()
    dzb = dz.reshape(E, M, idx.shape[0], bs).float()
    return torch.stack([torch.einsum("emoa,emoc->eoac",
                                     xb[:, :, idx[:, k].long(), :], dzb)
                        for k in range(idx.shape[1])], dim=2)


def _kernel_dz(P, variant, t, pt):
    """(dz_g, dz_u) [E, M, nob*bs] bf16 exactly as ``variant``'s gated_dw
    rounds them: gated_dw of an x that is one-hot in each input block
    (x[m, j*bs + a] = 1 for a = m - r0) sums one product a term, so slot
    0's dw rows are dz's rows r0 .. r0 + bs - 1; one call a bs rows."""
    E, M, n_in = t["x"].shape
    nob = pt["idx"].shape[0]
    zs = [torch.empty_like(t["dy"]) for _ in range(2)]
    for r0 in range(0, M, C.BS):
        rows = min(C.BS, M - r0)
        x = torch.zeros_like(t["x"]).reshape(E, M, n_in // C.BS, C.BS)
        a = torch.arange(rows, device=x.device)
        x[:, r0 + a, :, a] = 1.0
        dws = C.forced_call(P, variant, lambda: P.bsm.gated_dw(
            x.reshape(E, M, n_in), t["dy"], pt["idx"], t["g"], t["u"]))()
        for z, dwv in zip(zs, dws):
            # dwv[e, o, 0, a, c] = dz[e, r0 + a, o*bs + c]
            z[:, r0:r0 + rows] = (dwv[:, :, 0, :rows].permute(0, 2, 1, 3)
                                  .reshape(E, rows, nob * C.BS)
                                  .to(z.dtype))
    return zs


def gated_dw_rounding(P, card, seeds=(1, 2, 3, 4)) -> None:
    """gated_dw's error against its plain version at the gate junction
    (E = 128, M = 160) on several seeds, through both entry points, and
    the count of dz elements the kernels round to the other bf16
    neighbour of the plain version's dz."""
    bsm = P.bsm
    M = C.MOE_M["train"]
    for seed in seeds:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        t, pt = C._moe_inputs(P, gen, C.MOE_SHAPES[0], C.MOE_E, M,
                              torch.bfloat16)
        args = (t["x"], t["dy"], pt["idx"], t["g"], t["u"])
        want = bsm.gated_dw_ref(*args)
        plain_dz = bsm._gated_dz(t["dy"], t["g"], t["u"])
        # the plain dz again with the kernels' sigmoid, 1 / (1 + exp(-g))
        d, g, u = (t[k].float() for k in ("dy", "g", "u"))
        sg = 1.0 / (1.0 + torch.exp(-g))
        exp_dz = ((d * u * (sg * (1.0 + g * (1.0 - sg)))).bfloat16(),
                  (d * (g * sg)).bfloat16())
        del d, g, u, sg
        for variant in ("simt", "tc"):
            got = C.forced_call(P, variant, lambda: bsm.gated_dw(*args))()
            err = [C.rel_err(a, b) for a, b in zip(got, want)]
            dz = _kernel_dz(P, variant, t, pt)
            flips = [int((k != q).sum()) for k, q in zip(dz, plain_dz)]
            exp_flips = [int((k != q).sum()) for k, q in zip(dz, exp_dz)]
            own = [C.rel_err(a, _dw_of(t["x"], pt["idx"], z))
                   for a, z in zip(got, dz)]
            print(f"[rounding] gated_dw {variant} seed={seed} E={C.MOE_E} "
                  f"M={M}: rel_err dwg {err[0]:.3g} dwi {err[1]:.3g} (tol "
                  f"{C.REL_TOL['bf16_sum']:.3g}); dz elements that differ "
                  f"from the plain dz: dz_g {flips[0]} dz_u {flips[1]} of "
                  f"{dz[0].numel()} (from 1 / (1 + exp(-g)): "
                  f"{exp_flips[0]}, {exp_flips[1]}); rel_err against the "
                  f"plain sums of its own dz: dwg {own[0]:.3g} dwi "
                  f"{own[1]:.3g} [{card}]")
        del t, pt, want, plain_dz, exp_dz
        torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_layouts: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False   # full fp32 references
    P = C.load_port()
    card = C.card_line()
    print(f"card: {card}")
    lib = build_layouts(P)
    timer = C.Timer(reps=10)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(19)
    ok = update_layouts(P, lib, timer, gen, card)
    ok &= dx_layouts(P, lib, timer, gen, card)
    gated_dw_rounding(P, card)
    print(card)
    return 0 if ok else 2


if __name__ == "__main__":
    sys.exit(main())
