"""The shared artifact stamp: one meta schema for every results file.

    {git_sha, backend, torch_version, tag, timestamp}

``launch/obs_report.py --json`` stamps its report through
:func:`artifact_meta`.  The reference's schema carries ``jax_version``
and ``backend = jax.default_backend()``; here they are ``torch_version``
and the torch device type (``cuda`` or ``cpu``).
"""
from __future__ import annotations

import subprocess
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def git_sha() -> str:
    """Short HEAD sha of the checkout this package lies in, with a -dirty
    marker when the tree has uncommitted changes (numbers measured on a
    dirty tree must not be attributed to the clean commit); "unknown"
    outside a git checkout."""
    try:
        sha = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], cwd=ROOT,
            capture_output=True, text=True, timeout=10, check=True,
        ).stdout.strip()
        dirty = subprocess.run(
            ["git", "status", "--porcelain"], cwd=ROOT,
            capture_output=True, text=True, timeout=10, check=True,
        ).stdout.strip()
        return f"{sha}-dirty" if dirty else sha
    except Exception:
        return "unknown"


def artifact_meta(tag: str) -> dict:
    """The stamp.  ``backend`` is ``cuda`` where a card is present (the
    port's entry points run there by default), ``cpu`` elsewhere."""
    import torch
    return {
        "git_sha": git_sha(),
        "backend": "cuda" if torch.cuda.is_available() else "cpu",
        "torch_version": torch.__version__,
        "tag": tag,
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
    }
