"""The assigned architecture configs, one entry each."""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig

# [ssm] falcon-mamba-7b — 64L d4096, attn-free, vocab 65024, state 16 (mamba1)
FALCON_MAMBA_7B = ArchConfig(
    name="falcon-mamba-7b", family="ssm", n_layers=64, d_model=4096,
    n_heads=0, kv_heads=0, head_dim=0, d_ff=0, vocab=65024, raw_vocab=65024,
    attn_kind="none", ssm_kind="mamba1", ssm_state=16, d_inner=8192,
    dt_rank=256, act="silu", norm="rmsnorm",
)

# [dense] stablelm-3b — 32L d2560 32H MHA ff6912 vocab 50304, partial rotary 25%
STABLELM_3B = ArchConfig(
    name="stablelm-3b", family="dense", n_layers=32, d_model=2560,
    n_heads=32, kv_heads=32, head_dim=80, d_ff=6912, vocab=50304,
    raw_vocab=50304, partial_rotary=0.25, rope_theta=1e4, norm="layernorm",
)

# [dense] qwen2-72b — 80L d8192 64H kv8 ff29568 vocab 152064, QKV bias
QWEN2_72B = ArchConfig(
    name="qwen2-72b", family="dense", n_layers=80, d_model=8192,
    n_heads=64, kv_heads=8, head_dim=128, d_ff=29568, vocab=152064,
    raw_vocab=152064, qkv_bias=True, rope_theta=1e6,
)

# [dense] deepseek-7b — 30L d4096 32H MHA ff11008 vocab 102400 (llama arch)
DEEPSEEK_7B = ArchConfig(
    name="deepseek-7b", family="dense", n_layers=30, d_model=4096,
    n_heads=32, kv_heads=32, head_dim=128, d_ff=11008, vocab=102400,
    raw_vocab=102400, rope_theta=1e4,
)

# [dense] command-r-plus-104b — 64L d12288 96H kv8 ff33792 vocab 256000,
# no bias, tied embeddings
COMMAND_R_PLUS_104B = ArchConfig(
    name="command-r-plus-104b", family="dense", n_layers=64, d_model=12288,
    n_heads=96, kv_heads=8, head_dim=128, d_ff=33792, vocab=256000,
    raw_vocab=256000, tie_embeddings=True, rope_theta=1e4, norm="layernorm",
)

# [hybrid] zamba2-2.7b — 54 mamba2 layers d2560 state 64 + shared attention
# block every 6 layers (32H MHA hd80, ff 10240)
ZAMBA2_2P7B = ArchConfig(
    name="zamba2-2.7b", family="hybrid", n_layers=54, d_model=2560,
    n_heads=32, kv_heads=32, head_dim=80, d_ff=10240, vocab=32000,
    raw_vocab=32000, ssm_kind="mamba2", ssm_state=64, d_inner=5120,
    ssm_head_dim=64, hybrid_attn_every=6, rope_theta=1e4,
)

# [vlm] llava-next-mistral-7b — mistral backbone, sliding window 4096,
# patch frontend stubbed
LLAVA_NEXT_MISTRAL_7B = ArchConfig(
    name="llava-next-mistral-7b", family="vlm", n_layers=32, d_model=4096,
    n_heads=32, kv_heads=8, head_dim=128, d_ff=14336, vocab=32000,
    raw_vocab=32000, attn_kind="sliding", window=4096, num_patches=576,
    rope_theta=1e4,
)

# [moe] deepseek-v2-lite-16b — 27L d2048 16H MLA(kv_lora 512), 64 routed +
# 2 shared experts top-6, expert ff 1408, first layer dense (ff 10944)
DEEPSEEK_V2_LITE_16B = ArchConfig(
    name="deepseek-v2-lite-16b", family="moe", n_layers=27, d_model=2048,
    n_heads=16, kv_heads=16, head_dim=128, d_ff=10944, vocab=102400,
    raw_vocab=102400, attn_kind="mla",
    mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=64, top_k=6, d_expert=1408, num_shared=2,
                  d_shared=2816, first_dense_layers=1),
    rope_theta=1e4,
)

# [moe] qwen3-moe-30b-a3b — 48L d2048 32H kv4, 128 experts top-8, expert ff 768
QWEN3_MOE_30B_A3B = ArchConfig(
    name="qwen3-moe-30b-a3b", family="moe", n_layers=48, d_model=2048,
    n_heads=32, kv_heads=4, head_dim=128, d_ff=768, vocab=151936,
    raw_vocab=151936,
    moe=MoEConfig(num_experts=128, top_k=8, d_expert=768),
    rope_theta=1e6,
)

# [audio] whisper-base — 6L enc + 6L dec, d512 8H ff2048, conv frontend
# stubbed; vocab 51865 padded to 51968
WHISPER_BASE = ArchConfig(
    name="whisper-base", family="audio", n_layers=6, d_model=512,
    n_heads=8, kv_heads=8, head_dim=64, d_ff=2048, vocab=51968,
    raw_vocab=51865, enc_layers=6, enc_frames=1500, act="gelu",
    norm="layernorm", max_seq=32768 + 8, strategy="sp",
)

ARCHS: dict[str, ArchConfig] = {
    c.name: c for c in [
        FALCON_MAMBA_7B, STABLELM_3B, QWEN2_72B, DEEPSEEK_7B,
        COMMAND_R_PLUS_104B, ZAMBA2_2P7B, LLAVA_NEXT_MISTRAL_7B,
        DEEPSEEK_V2_LITE_16B, QWEN3_MOE_30B_A3B, WHISPER_BASE,
    ]
}


def get(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]
