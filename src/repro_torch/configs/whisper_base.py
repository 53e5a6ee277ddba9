"""Assigned architecture config — see registry.py for source notes."""
from repro_torch.configs.registry import WHISPER_BASE as CONFIG

__all__ = ["CONFIG"]
