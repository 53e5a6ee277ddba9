"""Assigned architecture config — see registry.py for source notes."""
from repro_torch.configs.registry import DEEPSEEK_V2_LITE_16B as CONFIG

__all__ = ["CONFIG"]
