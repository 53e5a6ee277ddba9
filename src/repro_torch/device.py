"""Where the port's entry points run."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The card unless the caller names another device.  Asking for the
    card (explicitly or by default) where there is none raises; nothing
    falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found; pass device='cpu' to run "
                           "on the CPU")
    return dev


def plain_route(t: torch.Tensor, name: str) -> bool:
    """A kernel wrapper's route for its operand ``t``: True to run the
    plain PyTorch version (a CPU tensor, or a ``meta`` tensor, whose ops
    only carry shapes, so a step can be counted without allocating), False
    to launch the kernel (a CUDA tensor).  Any other device raises."""
    if t.device.type in ("cpu", "meta"):
        return True
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu, meta or cuda, not {t.device}")
    return False
