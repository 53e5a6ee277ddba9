"""Assigned architecture config — see registry.py for source notes."""
from repro_torch.configs.registry import COMMAND_R_PLUS_104B as CONFIG

__all__ = ["CONFIG"]
