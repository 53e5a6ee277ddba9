"""Build the CUDA kernels under ``csrc/`` and load them with ctypes.

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, at first use, into ``build/kernels/``
at the root of the checkout.  A library is cached under a hash of its
source, the shared headers (``csrc/*.cuh``) and the compiler flags, so an
edit rebuilds it.  No ``--use_fast_math``: the update kernel's guards and
``isfinite``, and the parity of ``expf`` in the attention and scan
kernels with their plain versions, need IEEE semantics.  There is no
fallback: a missing ``nvcc``, a missing card or a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("junction_fwd", "junction_dx", "junction_tc", "junction_dw",
           "junction_quant", "flash_decode", "flash_attention",
           "selective_scan", "fxp_qmatmul", "sigmoid_lut")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """Path of nvcc: on PATH, else under $CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)"
                       " — the CUDA kernels cannot be built")


def lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build_all(names=SOURCES) -> dict[str, float]:
    """Compile every source that has no cached library, one nvcc process
    per source, all started together.  Returns {name: seconds} for the
    sources built (the ptxas report goes to ``<lib>.log``)."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the kernels build only for the card")
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    secs, errors = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of kernel library ``name``, built if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(str(lib_path(name)))
        _loaded[name] = lib
    return lib


_TICKETS: dict[str, torch.Tensor] = {}


def tickets(device, n: int) -> torch.Tensor:
    """The device's int32 tickets of a split kernel's combine (the last
    block of a split to arrive adds the parts), allocated zero once and
    grown when a call needs more; every kernel that takes them leaves them
    zero, and the kernels that share them run on one stream in turn."""
    t = _TICKETS.get(str(device))
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _TICKETS[str(device)] = t
    return t
