"""Deterministic, restartable data pipeline.

The iterator is a pure function of (seed, step): a checkpoint stores the
two integers and a restart resumes bit for bit.  Batches are numpy, made
exactly as the reference's pipeline makes them, so both packages train
on the same tokens.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass
class LMTokenPipeline:
    """Synthetic language-model token stream (runs of consecutive tokens
    with 15 % noise, so the loss can fall).  A vlm batch also holds
    P = min(num_patches, seq_len // 2) fp32 patch embeddings [B, P, d]
    and keeps the first seq_len - P tokens, so that patches and text
    fill seq_len positions.  An audio batch also holds enc_frames fp32
    frame embeddings [B, enc_frames, d] for the encoder, drawn after the
    tokens from the same generator.  State = (seed, step)."""
    cfg: ArchConfig
    batch_size: int
    seq_len: int
    seed: int = 0
    step: int = 0

    def state(self) -> dict:
        return {"seed": self.seed, "step": self.step}

    @classmethod
    def from_state(cls, cfg, batch_size, seq_len, state):
        return cls(cfg, batch_size, seq_len, seed=state["seed"],
                   step=state["step"])

    def _make(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng((self.seed << 20) ^ step)
        V = cfg.raw_vocab or cfg.vocab
        B, S = self.batch_size, self.seq_len
        base = rng.integers(0, V - S - 2, size=(B, 1))
        runs = base + np.arange(S)[None, :]
        noise = rng.integers(0, V, size=(B, S))
        mask = rng.random((B, S)) < 0.15
        batch = {"tokens": np.where(mask, noise, runs % V).astype(np.int32)}
        if cfg.family == "vlm":
            P = min(cfg.num_patches, S // 2)
            batch["patches"] = rng.standard_normal(
                (B, P, cfg.d_model)).astype(np.float32)
            batch["tokens"] = batch["tokens"][:, :S - P]
        if cfg.family == "audio":
            batch["frames"] = rng.standard_normal(
                (B, cfg.enc_frames, cfg.d_model)).astype(np.float32)
        return batch

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        b = self._make(self.step)
        self.step += 1
        return b
