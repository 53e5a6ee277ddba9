"""Assigned architecture config — see registry.py for source notes."""
from repro_torch.configs.registry import STABLELM_3B as CONFIG

__all__ = ["CONFIG"]
