"""Assigned architecture config — see registry.py for source notes."""
from repro_torch.configs.registry import QWEN3_MOE_30B_A3B as CONFIG

__all__ = ["CONFIG"]
