"""Pre-defined-sparse linear layer: the paper's junction on tensors.

A sparse junction's params are a dict with the weight tiles
``w [nob, kb, bs, bs]`` and the static pattern leaves ``idx``,
``rev_ob``, ``rev_t``, ``rev_cnt`` (int32); a dense layer's params hold
``w [n_in, n_out]``.  Either may carry a bias ``b [n_out]``.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.sparsity import SparsityConfig, make_block_pattern
from repro_torch.kernels import block_sparse_matmul as bsm
from repro_torch.kernels import ops

Params = dict[str, Any]
PATTERN_LEAVES = ("idx", "rev_ob", "rev_t", "rev_cnt")


def is_sparse(params: Params) -> bool:
    return "idx" in params


def init_dense(gen: torch.Generator, n_in: int, n_out: int, *,
               bias: bool = False, dtype=torch.float32, device="cpu",
               scale: float | None = None) -> Params:
    scale = float(scale if scale is not None else 1.0 / np.sqrt(n_in))
    p: Params = {"w": torch.randn((n_in, n_out), generator=gen, dtype=dtype,
                                  device=device) * scale}
    if bias:
        p["b"] = torch.zeros((n_out,), dtype=dtype, device=device)
    return p


def init_sparse(gen: torch.Generator, n_in: int, n_out: int,
                sp: SparsityConfig, *, bias: bool = False,
                dtype=torch.float32, device="cpu", seed: int = 0) -> Params:
    """Glorot-normal init over the kept edges: variance 2/(d_in + d_out)
    over the actual degrees, not the dense widths."""
    pat = make_block_pattern(n_in, n_out, sp.density, sp.block, seed=seed)
    d_in = pat.fan_in_blocks * pat.block
    d_out = pat.fan_out_blocks * pat.block
    scale = float(np.sqrt(2.0 / (d_in + d_out)))
    shape = (pat.n_out_blocks, pat.fan_in_blocks, pat.block, pat.block)
    p: Params = {"w": torch.randn(shape, generator=gen, dtype=dtype,
                                  device=device) * scale}
    for name in PATTERN_LEAVES:
        p[name] = torch.as_tensor(getattr(pat, name), dtype=torch.int32,
                                  device=device)
    if bias:
        p["b"] = torch.zeros((n_out,), dtype=dtype, device=device)
    return p


def init_linear(gen: torch.Generator, n_in: int, n_out: int, *, family: str,
                sp: SparsityConfig | None, bias: bool = False,
                dtype=torch.float32, device="cpu", seed: int = 0) -> Params:
    """Dense unless the paper's technique applies and the dims tile."""
    if (sp is not None and sp.applies_to(family)
            and n_in % sp.block == 0 and n_out % sp.block == 0
            and n_in // sp.block >= 2):
        return init_sparse(gen, n_in, n_out, sp, bias=bias, dtype=dtype,
                           device=device, seed=seed)
    return init_dense(gen, n_in, n_out, bias=bias, dtype=dtype, device=device)


def apply_dense(params: Params, x: torch.Tensor) -> torch.Tensor:
    y = x @ params["w"].to(x.dtype)
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y


def apply(params: Params, x: torch.Tensor, *, act: str = "none"
          ) -> torch.Tensor:
    """y = act(x @ W + b): the junction kernel for a sparse layer, a
    dense product with the same activation formula otherwise."""
    if is_sparse(params):
        return ops.junction_matmul(x, params["w"], params["idx"],
                                   bias=params.get("b"), act=act)
    y = apply_dense(params, x)
    return y if act == "none" else bsm.act_fwd(y, act).to(y.dtype)
