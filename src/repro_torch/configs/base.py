"""Architecture configuration.

``registry.get(name)`` resolves the assigned architectures; reduced
variants for CPU tests come from ``ArchConfig.reduced()``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.sparsity import SparsityConfig


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN hidden width
    num_shared: int = 0           # shared (always-on) experts
    d_shared: int = 0             # hidden width of the shared expert block
    capacity_factor: float = 1.25
    group_size: int = 2048        # GShard dispatch group
    aux_loss_weight: float = 1e-2
    first_dense_layers: int = 0   # deepseek-v2: layer 0 is a dense FFN


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | ssm | hybrid | moe | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int                    # padded to a shardable multiple
    raw_vocab: int = 0
    # attention
    attn_kind: str = "full"       # full | sliding | mla | none
    window: int = 0               # sliding window size
    qkv_bias: bool = False
    partial_rotary: float = 1.0   # fraction of head_dim rotated (stablelm 0.25)
    rope_theta: float = 1e6
    mla: Optional[MLAConfig] = None
    # ssm
    ssm_kind: str = ""            # mamba1 | mamba2
    ssm_state: int = 0
    d_inner: int = 0
    conv_width: int = 4
    ssm_head_dim: int = 64        # mamba2
    dt_rank: int = 0              # mamba1 (0 -> ceil(d_model/16))
    # hybrid (zamba2): shared attention block every k ssm layers
    hybrid_attn_every: int = 0
    # moe
    moe: Optional[MoEConfig] = None
    # enc-dec (whisper): encoder layers + stub frame count
    enc_layers: int = 0
    enc_frames: int = 0
    # vlm (llava): stub patch count
    num_patches: int = 0
    # misc
    act: str = "silu"
    norm: str = "rmsnorm"         # rmsnorm | layernorm
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    max_seq: int = 8192           # per-request sequence bound
    # distribution: "tp" (tensor parallel) or "sp" (sequence parallel:
    # small models whose head counts do not divide the model axis);
    # parallel/sharding.py and parallel/hints.py read it
    strategy: str = "tp"
    # dtype of the selective-scan elements ([B, c, d_inner, N] decay and
    # input tensors of a chunk); the carry between chunks stays fp32
    ssm_scan_dtype: str = "float32"
    # numerics
    dtype: str = "bfloat16"       # compute dtype
    param_dtype: str = "float32"  # master parameter dtype
    attn_chunk: int = 1024        # online-softmax kv chunk
    ssm_chunk: int = 128          # selective-scan chunk
    # the paper's technique
    sparsity: Optional[SparsityConfig] = None
    # training
    remat: bool = True            # recompute each layer in the backward
    loss_chunk: int = 0           # CE in sequence chunks of this size (0: off)
    # cast fp32 params to bf16 once per step, before the layers
    cast_params_once: bool = False
    # junction engine: "auto" and "pallas" run the kernels on a CUDA
    # tensor and their plain versions on a CPU tensor; "jnp" keeps the
    # two-pass update path
    engine: str = "auto"
    # fused BP+UP: the optimizer step runs inside the junctions' backward
    # (train/steps.fused_update_eligible says when it applies)
    fused_update: bool = False

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def dt_rank_(self) -> int:
        return self.dt_rank or -(-self.d_model // 16)

    @property
    def d_inner_(self) -> int:
        return self.d_inner or 2 * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner_ // self.ssm_head_dim

    def with_sparsity(self, sp: SparsityConfig) -> "ArchConfig":
        return dataclasses.replace(self, sparsity=sp)

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU tests."""
        kw = dict(
            n_layers=min(self.n_layers, 2),
            d_model=128,
            n_heads=4,
            kv_heads=(min(self.kv_heads, 4) if self.kv_heads >= self.n_heads
                      else 2),
            head_dim=32,
            d_ff=256,
            vocab=256,
            raw_vocab=256,
            d_inner=256,
            dt_rank=8,
            ssm_head_dim=32,
            enc_layers=min(self.enc_layers, 2),
            enc_frames=16 if self.enc_frames else 0,
            num_patches=8 if self.num_patches else 0,
            window=min(self.window, 64) if self.window else 0,
            max_seq=512,
            attn_chunk=32,
            ssm_chunk=16,
            hybrid_attn_every=2 if self.hybrid_attn_every else 0,
        )
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe, num_experts=8, top_k=2, d_expert=64,
                d_shared=64 if self.moe.num_shared else 0, group_size=64)
        if self.mla is not None:
            kw["mla"] = MLAConfig(kv_lora_rank=32, qk_nope_head_dim=32,
                                  qk_rope_head_dim=16, v_head_dim=32)
        if self.sparsity is not None:
            kw["sparsity"] = dataclasses.replace(self.sparsity, block=32)
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Analytic parameter count of the dense model (every junction at
        its full width; the reference's, for MODEL_FLOPS = 6 N D)."""
        d, f, L, V = self.d_model, self.d_ff, self.n_layers, self.vocab
        emb = V * d * (1 if self.tie_embeddings else 2)
        if self.family in ("dense", "vlm", "moe") or self.attn_kind != "none":
            if self.attn_kind == "mla":
                m = self.mla
                qd = self.n_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                per_attn = (d * qd + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                            + m.kv_lora_rank * self.n_heads
                            * (m.qk_nope_head_dim + m.v_head_dim)
                            + self.n_heads * m.v_head_dim * d)
            else:
                per_attn = (d * self.n_heads * self.head_dim
                            + 2 * d * self.kv_heads * self.head_dim
                            + self.n_heads * self.head_dim * d)
        else:
            per_attn = 0
        gated = 3 if self.act == "silu" else 2
        if self.family == "moe":
            mo = self.moe
            per_layer = per_attn + mo.num_experts * gated * d * mo.d_expert
            if mo.num_shared:
                per_layer += gated * d * mo.d_shared
        elif self.family in ("ssm", "hybrid"):
            di, N = self.d_inner_, self.ssm_state
            if self.ssm_kind == "mamba1":
                R = self.dt_rank_
                per_layer = (d * 2 * di + self.conv_width * di
                             + di * (R + 2 * N) + R * di + di * N + di
                             + di * d)
            else:  # mamba2
                H = self.ssm_heads
                per_layer = (d * (2 * di + 2 * N + H)
                             + self.conv_width * (di + 2 * N) + H + di
                             + di * d)
        else:
            per_layer = per_attn + gated * d * f
        total = emb + L * per_layer
        if self.family == "hybrid" and self.hybrid_attn_every:
            # the shared attention block, counted once
            total += (d * self.n_heads * self.head_dim * 2
                      + 2 * d * self.kv_heads * self.head_dim
                      + gated * d * self.d_ff)
        if self.family == "audio":
            total += self.enc_layers * (4 * d * d + 2 * d * f)
            total += self.n_layers * 4 * d * d
        if self.family == "moe" and self.moe.first_dense_layers:
            total += self.moe.first_dense_layers * (
                gated * d * f - self.moe.num_experts * gated * d
                * self.moe.d_expert)
        return int(total)

    def active_param_count(self) -> int:
        """N_active for MoE MODEL_FLOPS: every expert's weights swapped for
        the top_k a token runs through."""
        if self.family != "moe":
            return self.param_count()
        mo = self.moe
        gated = 3
        all_experts = self.n_layers * mo.num_experts * gated * self.d_model \
            * mo.d_expert
        active = self.n_layers * mo.top_k * gated * self.d_model * mo.d_expert
        return int(self.param_count() - all_experts + active)


@dataclasses.dataclass(frozen=True)
class SweepConfig:
    """A population sweep (``search/scheduler.run_sweep``): the rounds of
    successive halving and how each cohort's step runs.  The cohort size
    E comes from the candidate list.

    rounds: successive-halving rounds; after each, the live members are
        ranked by eval loss and cut to ``keep_fraction`` (a pruned slot's
        mask entry and hyp row are zeroed in place: no shape changes).
    steps_per_round: E-batched train steps between two rankings.
    batch_size / eval_samples: the shared minibatch and held-out sizes.
    seed: the cohorts' weight-init seed (``run_sweep`` states the rule).
    engine: "auto" and "pallas" run the junction kernels (their plain
        versions on a CPU tensor), where ``fused`` applies the update
        inside the backward (``update_dw``); "jnp" keeps the two-pass
        step (gradients through ``dw``, then the update in PyTorch), as
        ``ArchConfig.engine`` does.
    quarantine: a member whose loss or update health goes non-finite is
        masked and hyp-zeroed in the middle of the round (the prune
        applied at once) and recorded in the ledger.
    """
    rounds: int = 3
    steps_per_round: int = 20
    batch_size: int = 128
    eval_samples: int = 512
    keep_fraction: float = 0.5
    seed: int = 0
    engine: str = "auto"
    fused: bool = True
    quarantine: bool = True


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """A cell's input shape: ``global_batch`` sequences of ``seq_len``
    tokens, for a train step, a prefill or a decode step."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def long_context_ok(cfg: ArchConfig) -> bool:
    """long_500k runs only for sub-quadratic attention: the state-space
    families and sliding windows."""
    return (cfg.family in ("ssm", "hybrid")
            or cfg.attn_kind == "sliding")


def valid_cells(cfg: ArchConfig):
    """The shapes of SHAPES that ``cfg`` runs, in SHAPES' order."""
    for s in SHAPES.values():
        if s.name == "long_500k" and not long_context_ok(cfg):
            continue
        yield s
