"""Pre-defined structured sparsity at block granularity.

A junction between widths (n_in, n_out) keeps a fixed fan-in of
``kb`` input blocks per output block, chosen before training and never
changed.  Each kept edge bundle is a dense (block x block) tile.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import interleaver as il

__all__ = ["SparsityConfig", "BlockPattern", "block_fan_in",
           "make_block_pattern"]


@dataclasses.dataclass(frozen=True)
class SparsityConfig:
    """How the technique is applied inside a model.

    density: fraction of block connections kept (1.0 = dense layer).
    block: tile edge.
    where: which linear families to sparsify ("ffn", "attn", "all", or
        families joined by "+").
    """

    density: float = 0.125
    block: int = 128
    where: str = "ffn"
    seed: int = 0

    def applies_to(self, family: str) -> bool:
        if self.density >= 1.0:
            return False
        return self.where == "all" or family in self.where.split("+")


@dataclasses.dataclass(frozen=True)
class BlockPattern:
    """Block pattern idx[n_out_blocks, fan_in_blocks] and its reverse."""

    n_in: int
    n_out: int
    block: int
    idx: np.ndarray        # [nob, kb] int32 — input block per slot
    rev_ob: np.ndarray     # [nib, fb] int32 — output block reading input block
    rev_t: np.ndarray      # [nib, fb] int32 — slot within that output block
    rev_cnt: np.ndarray    # [nib] int32 — valid reverse slots

    @property
    def n_in_blocks(self) -> int:
        return self.n_in // self.block

    @property
    def n_out_blocks(self) -> int:
        return self.n_out // self.block

    @property
    def fan_in_blocks(self) -> int:
        return int(self.idx.shape[1])

    @property
    def fan_out_blocks(self) -> int:
        return int(self.rev_ob.shape[1])


def block_fan_in(n_in_blocks: int, density: float) -> int:
    """Fan-in block count kb ~= density * n_in_blocks.  Python's round()
    rounds halves to even (13.5 -> 14, 12.5 -> 12), as the reference does."""
    return min(n_in_blocks, max(1, round(density * n_in_blocks)))


def make_block_pattern(n_in: int, n_out: int, density: float,
                       block: int = 128, seed: int = 0) -> BlockPattern:
    if n_in % block or n_out % block:
        raise ValueError(
            f"dims ({n_in},{n_out}) must be multiples of block={block}")
    nib, nob = n_in // block, n_out // block
    kb = block_fan_in(nib, density)
    idx = il.block_circulant_pattern(nib, nob, kb, seed=seed)
    rev_ob, rev_t, rev_cnt = il.reverse_block_pattern(idx, nib)
    return BlockPattern(n_in=n_in, n_out=n_out, block=block, idx=idx,
                        rev_ob=rev_ob, rev_t=rev_t, rev_cnt=rev_cnt)
