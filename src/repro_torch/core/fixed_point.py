"""The paper's fixed-point arithmetic (Sec. III-C), bit for bit.

A bit triplet (b_w, b_n, b_f) is total bits, integer bits and fraction
bits, with b_w = b_n + b_f + 1 (sign): values lie on the grid 2^-b_f in
[-2^b_n, 2^b_n - 2^-b_f].  ``quantize`` rounds to the grid (half to even)
and saturates; ``encode`` / ``decode`` map between grid values and their
two's-complement codes in [0, 2^b_w); ``sigmoid_tables`` pre-evaluates
sigma and sigma' at every code, as the FPGA's lookup tables do (sigma to
b_f fraction bits, sigma' to b_f - 2).

Values are fp32 numbers held on the grid: every operation is followed
by ``quantize`` (adders and multipliers clip instead of wrapping), and a
sum is a clipping tree adder of depth log2(n) (``tree_sum_clipped``),
clipped at every node as the FPGA's is (Sec. III-D-3).  A product is
rounded once to fp32 before ``quantize``; no operation is fused.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["FxpFormat", "PAPER_TRIPLETS", "PAPER_FMT", "quantize", "q_mul",
           "q_add", "tree_sum_clipped", "encode", "decode", "sigmoid_tables",
           "lut_sigmoid", "relu_clipped"]


@dataclasses.dataclass(frozen=True)
class FxpFormat:
    bw: int   # total bits
    bn: int   # integer bits
    bf: int   # fraction bits

    def __post_init__(self):
        if self.bw != self.bn + self.bf + 1:
            raise ValueError("b_w = b_n + b_f + 1")

    @property
    def scale(self) -> float:
        return float(2 ** self.bf)

    @property
    def max_val(self) -> float:
        return float(2 ** self.bn) - 1.0 / self.scale

    @property
    def min_val(self) -> float:
        return -float(2 ** self.bn)

    @property
    def n_codes(self) -> int:
        return 2 ** self.bw


# Table II of the paper
PAPER_TRIPLETS = [FxpFormat(8, 2, 5), FxpFormat(10, 2, 7), FxpFormat(10, 3, 6),
                  FxpFormat(12, 3, 8), FxpFormat(16, 4, 11)]
PAPER_FMT = FxpFormat(12, 3, 8)   # the chosen configuration


def quantize(x: torch.Tensor, fmt: FxpFormat) -> torch.Tensor:
    """Round to the grid in fp32 and saturate to [min_val, max_val]."""
    q = torch.round(x.float() * fmt.scale) / fmt.scale
    return torch.clamp(q, fmt.min_val, fmt.max_val)


def q_mul(a, b, fmt: FxpFormat) -> torch.Tensor:
    return quantize(a * b, fmt)


def q_add(a, b, fmt: FxpFormat) -> torch.Tensor:
    return quantize(a + b, fmt)


def tree_sum_clipped(x: torch.Tensor, fmt: FxpFormat,
                     axis: int = -1) -> torch.Tensor:
    """Pairwise reduction over ``axis`` with clipping at every adder node:
    the hardware's log2(n)-deep tree adder.  The axis is padded to a power
    of two with zeros (exact on the grid)."""
    x = x.movedim(axis, -1)
    n = x.shape[-1]
    p = 1 << (n - 1).bit_length()
    if p != n:
        x = torch.nn.functional.pad(x, (0, p - n))
    while x.shape[-1] > 1:
        x = q_add(x[..., 0::2], x[..., 1::2], fmt)
    return x[..., 0]


def encode(x: torch.Tensor, fmt: FxpFormat) -> torch.Tensor:
    """A grid value -> its int32 code in [0, 2^bw) (two's complement)."""
    i = torch.round(torch.clamp(x.float(), fmt.min_val, fmt.max_val)
                    * fmt.scale).to(torch.int32)
    return torch.where(i < 0, i + fmt.n_codes, i)


def decode(code: torch.Tensor, fmt: FxpFormat) -> torch.Tensor:
    i = torch.where(code >= fmt.n_codes // 2, code - fmt.n_codes, code)
    return i.float() / fmt.scale


def code_values(fmt: FxpFormat) -> np.ndarray:
    """The value of every code 0 .. 2^bw - 1, in float64."""
    codes = np.arange(fmt.n_codes)
    return np.where(codes >= fmt.n_codes // 2, codes - fmt.n_codes,
                    codes) / fmt.scale


def sigmoid_tables(fmt: FxpFormat) -> tuple[np.ndarray, np.ndarray]:
    """(sigma table, sigma' table) as float32, one entry per code: sigma
    rounded to b_f fraction bits, sigma' (range [0, 1/4]) to b_f - 2."""
    sig = 1.0 / (1.0 + np.exp(-code_values(fmt)))
    dsig = sig * (1.0 - sig)
    sig_q = np.round(sig * fmt.scale) / fmt.scale
    dscale = 2 ** max(1, fmt.bf - 2)
    dsig_q = np.round(dsig * dscale) / dscale
    return sig_q.astype(np.float32), dsig_q.astype(np.float32)


def _take(table: torch.Tensor, code: torch.Tensor) -> torch.Tensor:
    """table[code] for int32 codes of any shape."""
    return torch.index_select(table, 0, code.reshape(-1)).reshape(code.shape)


def lut_sigmoid(x: torch.Tensor, fmt: FxpFormat, tables=None):
    """(sigma(x), sigma'(x)) by lookup on the code of x.  ``tables`` is
    ``sigmoid_tables(fmt)``, as numpy or as tensors (already on x's device,
    they are not copied)."""
    if tables is None:
        tables = sigmoid_tables(fmt)
    sig_t, dsig_t = (torch.as_tensor(t, device=x.device) for t in tables)
    code = encode(x, fmt)
    return _take(sig_t, code), _take(dsig_t, code)


def relu_clipped(x: torch.Tensor, fmt: FxpFormat, clip_at: float):
    """ReLU clipped at 8 (= 2^b_n) or 1 (Sec. III-C-4), and its derivative."""
    y = torch.clamp(x, 0.0, clip_at)
    dy = ((x > 0) & (x < clip_at)).float()
    return quantize(y, fmt), dy
