"""Assigned architecture config — see registry.py for source notes."""
from repro_torch.configs.registry import LLAVA_NEXT_MISTRAL_7B as CONFIG

__all__ = ["CONFIG"]
