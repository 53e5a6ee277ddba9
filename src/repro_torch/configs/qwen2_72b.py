"""Assigned architecture config — see registry.py for source notes."""
from repro_torch.configs.registry import QWEN2_72B as CONFIG

__all__ = ["CONFIG"]
