"""The reference's oracles (``src/repro/kernels/ref.py``) at its layouts,
each a thin adapter around the kernel's plain version in this package:
one body a function, no second copy.  Nothing on a main path calls them."""
from __future__ import annotations

import torch

from repro_torch.core.interleaver import reverse_block_pattern
from repro_torch.kernels import block_sparse_matmul as bsm
from repro_torch.kernels.fxp_qmatmul import qmatmul_ref
from repro_torch.kernels.selective_scan import selective_scan_ref
from repro_torch.kernels.sigmoid_lut import lut_lookup_ref


# ----------------------------------------------------------- block-sparse
def block_sparse_matmul(x, w, idx):
    """x [M, nib*bs]; w [nob, kb, bs, bs]; idx [nob, kb] -> y [M, nob*bs]
    (w rounded to x's dtype, fp32 sums, y in x's dtype)."""
    nob, _, bs, _ = w.shape
    bias = torch.zeros((1, nob * bs), dtype=x.dtype, device=x.device)
    return bsm.fwd_ref(x[None], w.to(x.dtype)[None], idx, bias)[0]


def block_sparse_dx(dy, w, idx, n_in_blocks):
    """dy [M, nob*bs] -> dx [M, nib*bs] (scatter-add through the pattern,
    w rounded to dy's dtype, fp32 sums, dx in dy's dtype)."""
    rev = reverse_block_pattern(idx.cpu().numpy(), n_in_blocks)
    rev_ob, rev_t, rev_cnt = (torch.from_numpy(r).to(idx.device)
                              for r in rev)
    return bsm.dx_ref(dy[None], w.to(dy.dtype)[None], rev_ob, rev_t,
                      rev_cnt)[0]


def block_sparse_dw(x, dy, idx):
    """dw [nob, kb, bs, bs] = x_block^T @ dy_block per kept edge-bundle,
    in fp32."""
    return bsm.dw_ref(x[None], dy[None], idx, with_bias=False)[0][0]


# ----------------------------------------------------------- fixed point
def fxp_qmatmul(a_code, w_code, bf: int, bn: int):
    """Integer fixed-point matmul: int32 accumulate, round-half-up shift by
    bf, saturate to the (bw=bn+bf+1) two's-complement range."""
    return qmatmul_ref(a_code, w_code, bf=bf, bn=bn)


# ----------------------------------------------------------- LUT sigmoid
def sigmoid_lut(codes, table):
    """codes int32 in [0, len(table)) -> table[codes]."""
    return lut_lookup_ref(codes, table)


# ----------------------------------------------------------- selective scan
def selective_scan(dt, x, bc, cc, a, h0):
    """Sequential oracle of the fused Mamba-1 scan kernel: (y, h_last)."""
    return selective_scan_ref(dt, x, bc, cc, a, h0)
