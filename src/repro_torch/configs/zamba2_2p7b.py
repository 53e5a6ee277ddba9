"""Assigned architecture config — see registry.py for source notes."""
from repro_torch.configs.registry import ZAMBA2_2P7B as CONFIG

__all__ = ["CONFIG"]
