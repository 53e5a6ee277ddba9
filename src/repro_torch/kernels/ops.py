"""Public entry of the junction kernels, and the kernels' launch counts.

``junction_matmul`` is the forward of the pre-defined-sparse junction
y = act(x @ W_sparse + bias).  A 4-D weight ``[nob, kb, bs, bs]`` is a
single junction (the kernels' E=1 case): x may carry any leading dims and
the result is squeezed back.  A 5-D weight ``[E, nob, kb, bs, bs]`` is E
units sharing one pattern.  The weight is cast to x's dtype on every call
(the masters stay fp32) and a junction without bias gets a zero bias, as
the reference does.  ``bsm.fwd`` picks the CUDA kernel for a CUDA tensor
and the plain version for a CPU tensor.  Forward only: the autograd
Function comes with the backward kernels.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import block_sparse_matmul as bsm
from repro_torch.kernels import flash_attention as fa


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last ``reset_launch_counts``."""
    return {"junction_fwd": bsm.fwd.launches,
            "flash_decode": fa.flash_decode.launches}


def reset_launch_counts() -> None:
    bsm.fwd.launches = 0
    fa.flash_decode.launches = 0


def junction_matmul(x, w, idx, *, bias=None, act: str = "none"):
    single = w.dim() == 4
    if single:
        lead = x.shape[:-1]
        x3 = x.reshape(1, -1, x.shape[-1])
        w5 = w[None]
        b2 = None if bias is None else bias[None]
    else:
        x3, w5, b2 = x, w, bias
    E = x3.shape[0]
    _, nob, _, bs, _ = w5.shape
    b = (torch.zeros((E, nob * bs), dtype=x.dtype, device=x.device)
         if b2 is None else b2.to(x.dtype))
    y = bsm.fwd(x3.contiguous(), w5.to(x.dtype).contiguous(), idx,
                b.contiguous(), act=act)
    return y.reshape(*lead, nob * bs) if single else y
