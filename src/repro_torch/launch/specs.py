"""Stand-ins for every model input, and small concrete batches.

``batch_struct(cfg, shape)`` is the train / prefill batch of a
``ShapeSpec`` as tensors on the ``meta`` device (shapes and dtypes, no
storage), ``decode_inputs_struct`` the decode step's token and position.
The modality frontends are stubs: whisper gets frame embeddings, llava
patch embeddings.  ``concrete_batch`` draws a small batch of the same
structure from a ``torch.Generator``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_struct(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """The abstract train / prefill batch: tokens [B, L] int32 (a vlm's
    first min(num_patches, L // 2) positions are bf16 patches [B, P, d]
    ahead of L - P tokens); the audio family adds bf16 frames [B,
    enc_frames, d]."""
    B, L = shape.global_batch, shape.seq_len
    batch = {}
    if cfg.family == "vlm":
        npatch = min(cfg.num_patches, L // 2)
        batch["patches"] = _meta((B, npatch, cfg.d_model), torch.bfloat16)
        batch["tokens"] = _meta((B, L - npatch), torch.int32)
    else:
        batch["tokens"] = _meta((B, L), torch.int32)
    if cfg.family == "audio":
        batch["frames"] = _meta((B, cfg.enc_frames, cfg.d_model),
                                torch.bfloat16)
    return batch


def decode_inputs_struct(cfg: ArchConfig, shape: ShapeSpec):
    """The decode step's token [B, 1] and position [] (int32 each)."""
    return (_meta((shape.global_batch, 1), torch.int32),
            _meta((), torch.int32))


def concrete_batch(cfg: ArchConfig, batch_size: int, seq_len: int,
                   gen: torch.Generator) -> dict:
    """A batch of ``batch_struct``'s structure on ``gen``'s device:
    int32 tokens uniform in [0, raw_vocab or vocab), fp32
    standard-normal patches and frames."""
    kw = dict(generator=gen, device=gen.device)
    V = cfg.raw_vocab or cfg.vocab
    batch = {}
    if cfg.family == "vlm":
        npatch = min(cfg.num_patches, seq_len // 2)
        batch["patches"] = torch.randn((batch_size, npatch, cfg.d_model),
                                       **kw)
        batch["tokens"] = torch.randint(0, V, (batch_size, seq_len - npatch),
                                        dtype=torch.int32, **kw)
    else:
        batch["tokens"] = torch.randint(0, V, (batch_size, seq_len),
                                        dtype=torch.int32, **kw)
    if cfg.family == "audio":
        batch["frames"] = torch.randn((batch_size, cfg.enc_frames,
                                       cfg.d_model), **kw)
    return batch
