"""Pre-defined structured sparsity: fixed fan-in and fan-out, chosen
before training and never changed.

* neuron level (``NeuronPattern``): the paper's own junction, each
  output neuron reading ``d_in`` input neurons traced through a
  clash-free interleaver (the bit-faithful network, core/paper_net.py);
* block level (``BlockPattern``): a junction between widths (n_in,
  n_out) keeps a fixed fan-in of ``kb`` input blocks per output block,
  each kept edge bundle a dense (block x block) tile.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import interleaver as il

__all__ = ["SparsityConfig", "NeuronPattern", "BlockPattern", "block_fan_in",
           "make_block_pattern", "make_neuron_pattern"]


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
class NeuronPattern:
    """The paper's junction pattern: idx[n_out, d_in], the input neuron of
    each edge."""

    n_in: int
    n_out: int
    d_in: int
    idx: np.ndarray  # [n_out, d_in] int32

    @property
    def d_out(self) -> int:
        return self.n_out * self.d_in // self.n_in

    @property
    def n_weights(self) -> int:
        return self.n_out * self.d_in

    @property
    def density(self) -> float:
        return self.n_weights / (self.n_in * self.n_out)


def make_neuron_pattern(n_in: int, n_out: int, d_in: int, z: int | None = None,
                        seed: int = 0) -> NeuronPattern:
    """The paper's junction: weight k = j*d_in + f (right neuron j, edge f)
    is numbered on the right and traced through a clash-free interleaver
    pi to left neuron pi(k) mod n_in, so every left neuron has exactly
    d_out edges; no right neuron reads a left neuron twice."""
    W = n_out * d_in
    if W % n_in:
        raise ValueError("W must be divisible by n_in for integral fan-out")
    d_out = W // n_in
    z = z if z is not None else d_in
    pi = il.sv_ss_interleaver(W, z, seed=seed)
    left = (pi % n_in).astype(np.int32)
    counts = np.bincount(left, minlength=n_in)
    if not np.all(counts == d_out):
        left = _balance_assignment(left, n_in, d_out)
    idx = left.reshape(n_out, d_in)
    idx = il._rebalance_rows(idx.astype(np.int64), n_in).astype(np.int32)
    return NeuronPattern(n_in=n_in, n_out=n_out, d_in=d_in, idx=idx)


def _balance_assignment(left: np.ndarray, n_in: int, d_out: int) -> np.ndarray:
    """Reassign surplus edges of over-used left neurons to under-used ones,
    deterministically (the last edges of a neuron move first)."""
    left = left.astype(np.int64).copy()
    counts = np.bincount(left, minlength=n_in)
    surplus = [n for n in range(n_in) for _ in range(max(0, counts[n] - d_out))]
    deficit = [n for n in range(n_in) for _ in range(max(0, d_out - counts[n]))]
    s_pos: dict[int, list[int]] = {}
    for i, v in enumerate(left):
        s_pos.setdefault(int(v), []).append(i)
    for di, n in enumerate(surplus):
        left[s_pos[n].pop()] = deficit[di]
    return left.astype(np.int32)


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
