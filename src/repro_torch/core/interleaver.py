"""Clash-free interleavers and block-level sparsity patterns (numpy only).

The patterns are static: built once on the host before any weight
exists and never changed, so they stay numpy and are handed to the
device as int32 index tensors.

* ``affine_interleaver``: pi(k) = (a*k + b) mod W with a coprime to W and
  z, so any z consecutive weights touch z distinct banks (bank = j mod z).
* ``sv_ss_interleaver``: the SV+SS family, a per-sweep starting vector
  (a multiple of z) added to the affine sweep, repaired to a permutation
  with the bank residues kept; ``is_clash_free`` checks the property.
* ``block_circulant_pattern`` gives every output block the same fan-in
  and every input block a fan-out within +-1 of the others;
  ``reverse_block_pattern`` transposes it for the backward pass.
"""
from __future__ import annotations

import math

import numpy as np

__all__ = ["affine_interleaver", "sv_ss_interleaver", "is_clash_free",
           "block_circulant_pattern", "reverse_block_pattern"]


def _coprime_step(n: int, preferred: int) -> int:
    """Smallest a >= preferred with gcd(a, n) == 1."""
    a = max(1, preferred)
    while math.gcd(a, n) != 1:
        a += 1
    return a


def affine_interleaver(n_weights: int, z: int, seed: int = 0) -> np.ndarray:
    """pi(k) = (a*k + b) mod W with gcd(a, W) = gcd(a, z) = 1: an int32
    permutation of [0, W) whose every z consecutive entries lie in z
    distinct banks mod z."""
    if n_weights % z != 0:
        raise ValueError(f"W={n_weights} must be divisible by z={z}")
    rng = np.random.default_rng(seed)
    base = int(rng.integers(1, n_weights))
    a = _coprime_step(n_weights * z // math.gcd(n_weights, z), base)
    while math.gcd(a, n_weights) != 1 or math.gcd(a, z) != 1:
        a += 1
    b = int(rng.integers(0, n_weights))
    k = np.arange(n_weights, dtype=np.int64)
    return ((a * k + b) % n_weights).astype(np.int32)


def sv_ss_interleaver(n_weights: int, z: int, seed: int = 0) -> np.ndarray:
    """SV+SS clash-free interleaver: the weights go in sweeps of z, each
    sweep the affine map plus its own starting vector, a multiple of z, so
    a sweep's bank residues stay a permutation of Z_z while successive
    sweeps land on other rows."""
    if n_weights % z != 0:
        raise ValueError(f"W={n_weights} must be divisible by z={z}")
    n_sweeps = n_weights // z
    rng = np.random.default_rng(seed + 1)
    base = affine_interleaver(n_weights, z, seed)
    sv = (rng.integers(0, n_sweeps, size=n_sweeps) * z).astype(np.int64)
    out = np.empty(n_weights, dtype=np.int32)
    for s in range(n_sweeps):
        sl = slice(s * z, (s + 1) * z)
        out[sl] = (base[sl].astype(np.int64) + sv[s]) % n_weights
    # starting vectors can collide across sweeps: repair to a permutation,
    # moving entries by multiples of z only
    return _repair_permutation(out, z)


def _repair_permutation(idx: np.ndarray, z: int) -> np.ndarray:
    """Make idx a permutation by moving duplicate rows (row = idx // z) of
    each bank column (idx % z) to that column's free rows, in order."""
    n = idx.shape[0]
    out = idx.astype(np.int64).copy()
    n_rows = n // z
    for bank in range(z):
        sel = np.where(out % z == bank)[0]
        used = np.zeros(n_rows, dtype=bool)
        dup_positions = []
        for p in sel[np.argsort(sel)]:
            r = out[p] // z
            if used[r]:
                dup_positions.append(p)
            else:
                used[r] = True
        free_rows = np.where(~used)[0].tolist()
        for p, r in zip(dup_positions, free_rows):
            out[p] = r * z + bank
    assert len(np.unique(out)) == n, "repair failed to produce a permutation"
    return out.astype(np.int32)


def is_clash_free(pi: np.ndarray, z: int) -> bool:
    """Each cycle's z accesses hit z distinct banks."""
    n = pi.shape[0]
    if n % z:
        return False
    banks = (pi % z).reshape(n // z, z)
    return all(len(np.unique(row)) == z for row in banks)


def block_circulant_pattern(n_in_blocks: int, n_out_blocks: int,
                            fan_in_blocks: int, seed: int = 0) -> np.ndarray:
    """idx[n_out_blocks, fan_in_blocks]: the input block ids each output
    block reads.

    Every output block has exactly ``fan_in_blocks`` distinct inputs.
    Every input block appears ``n_out_blocks * fan_in_blocks / n_in_blocks``
    times when that divides, otherwise within +-1 of it.
    """
    if fan_in_blocks > n_in_blocks:
        raise ValueError("fan_in_blocks cannot exceed n_in_blocks")
    total = n_out_blocks * fan_in_blocks
    if total % n_in_blocks != 0:
        # ragged case: near-balanced deterministic schedule (+-1 fan-out)
        rng = np.random.default_rng(seed)
        reps = total // n_in_blocks
        stride = _coprime_step(
            n_in_blocks, 1 + int(rng.integers(1, max(2, n_in_blocks))))
        extra = (np.arange(total % n_in_blocks, dtype=np.int64) * stride
                 ) % n_in_blocks
        flat = np.concatenate([
            np.tile(np.arange(n_in_blocks, dtype=np.int64), reps), extra])
        perm = (np.arange(total, dtype=np.int64)
                * _coprime_step(total, stride)) % total
        idx = flat[perm].reshape(n_out_blocks, fan_in_blocks)
        return _rebalance_rows(idx, n_in_blocks).astype(np.int32)
    rng = np.random.default_rng(seed)
    hop = _coprime_step(n_in_blocks, max(1, n_in_blocks // fan_in_blocks))
    # drawn only to keep the generator's stream in step with the stride draw
    rng.integers(0, n_in_blocks, size=n_out_blocks)
    ob = np.arange(n_out_blocks, dtype=np.int64)
    t = np.arange(fan_in_blocks, dtype=np.int64)
    stride = _coprime_step(n_in_blocks, 1 + int(rng.integers(1, n_in_blocks)))
    idx = (ob[:, None] * stride + t[None, :] * hop) % n_in_blocks
    for r in range(n_out_blocks):
        row = idx[r]
        if len(np.unique(row)) != fan_in_blocks:
            offset = 1
            while True:
                cand = (row + offset) % n_in_blocks
                if len(np.unique(cand)) == fan_in_blocks:
                    idx[r] = cand
                    break
                offset += 1
    counts = np.bincount(idx.reshape(-1), minlength=n_in_blocks)
    if not np.all(counts == total // n_in_blocks):
        # exactly balanced schedule, scattered with a coprime stride
        flat = np.tile(np.arange(n_in_blocks, dtype=np.int64),
                       total // n_in_blocks)
        perm = (np.arange(total, dtype=np.int64) * stride) % total
        idx = flat[perm].reshape(n_out_blocks, fan_in_blocks)
        idx = _rebalance_rows(idx, n_in_blocks)
    return idx.astype(np.int32)


def _rebalance_rows(idx: np.ndarray, n_in: int) -> np.ndarray:
    """Swap duplicated in-row entries between rows until all rows are sets."""
    idx = idx.copy()
    n_out, k = idx.shape
    for _ in range(4 * n_out):
        bad = None
        for r in range(n_out):
            u, c = np.unique(idx[r], return_counts=True)
            if np.any(c > 1):
                bad = (r, int(u[np.argmax(c > 1)]))
                break
        if bad is None:
            return idx
        r, v = bad
        # find a row that lacks v and holds an element row r lacks
        for r2 in range(n_out):
            if r2 == r or v in idx[r2]:
                continue
            for j2 in range(k):
                w = idx[r2, j2]
                if w not in idx[r]:
                    j = int(np.where(idx[r] == v)[0][0])
                    idx[r, j], idx[r2, j2] = w, v
                    break
            else:
                continue
            break
    return idx


def reverse_block_pattern(idx: np.ndarray, n_in_blocks: int,
                          strict: bool = False
                          ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(rev_ob, rev_t, rev_cnt): for each input block, the (output block,
    slot) pairs that read it, padded to the largest fan-out with (0, 0);
    rev_cnt[ib] is the number of valid pairs.  strict=True raises unless
    every input block has the same fan-out."""
    n_out, k = idx.shape
    counts = np.bincount(idx.reshape(-1), minlength=n_in_blocks)
    fan_out = int(counts.max())
    if strict and counts.min() != counts.max():
        raise ValueError("pattern is not fan-out balanced")
    rev_ob = np.zeros((n_in_blocks, fan_out), dtype=np.int32)
    rev_t = np.zeros((n_in_blocks, fan_out), dtype=np.int32)
    fill = np.zeros(n_in_blocks, dtype=np.int64)
    for ob in range(n_out):
        for t in range(k):
            ib = int(idx[ob, t])
            rev_ob[ib, fill[ib]] = ob
            rev_t[ib, fill[ib]] = t
            fill[ib] += 1
    return rev_ob, rev_t, fill.astype(np.int32)
