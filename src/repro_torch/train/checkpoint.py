"""Fault-tolerant checkpointing of trees of tensors through numpy.

* Atomic and durable: written to a temporary directory (arrays.npz, then
  manifest.json, each fsynced), renamed into place, parent fsynced; a
  crash never leaves a torn checkpoint under a final name.
* Fallback restore: ``restore_latest`` verifies each candidate's checksum
  (every byte with ``full_checksum=True`` at save time, the first MiB of
  each leaf otherwise) and falls back past unreadable ones.
* Healthy marks and retention: ``mark_healthy`` flags rollback targets;
  ``gc_checkpoints(keep_last_k)`` never deletes the latest healthy one.
* Async: ``AsyncSaver`` copies the tree to host memory at once and
  writes it on a thread, so the train loop may go on updating its
  tensors in place.
* Bitwise restart: params, optimizer state and the data iterator's state
  round-trip exactly; bf16 leaves travel as their raw 16-bit patterns.
* Part of a tree: a ``like`` dict that holds some of the saved tree's
  top-level keys (``{"params": params}`` of a ``{"params", "opt"}``
  checkpoint, as the serve launcher's ``--ckpt`` does) restores those
  subtrees alone, by the leaf paths the manifest lists.
* Each restored leaf takes the shape and dtype of ``like``'s leaf: a
  saved shape that differs raises ``CheckpointMismatch`` (never a
  skipped leaf, never a fall back to an older checkpoint); a saved dtype
  that differs is cast to ``like``'s (``Tensor.to``: exact where the
  dtypes are equal, rounded to nearest from fp32 to bf16).
* Trees placed on a device mesh (``parallel/sharding.place``): every
  rank gathers each DTensor leaf in the same order (a collective, in the
  caller's thread), rank 0 alone writes, and a restore places each full
  leaf as ``like``'s leaf is placed.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import threading
from pathlib import Path
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.parallel.sharding import place_as
from repro_torch.tree import (tree_items, tree_leaves, tree_structure,
                              tree_unflatten_like)

_SENTINEL = "manifest.json"


class CheckpointMismatch(ValueError):
    """The checkpoint's tree or a leaf's shape does not fit ``like``."""
_HEALTHY = "HEALTHY"
_RAW16 = {torch.bfloat16: "bfloat16"}


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """A host copy of ``leaf`` as numpy, and its logical dtype name."""
    if not torch.is_tensor(leaf):
        a = np.array(leaf)
        return a, str(a.dtype)
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype in _RAW16:
        return t.view(torch.int16).numpy(), _RAW16[t.dtype]
    return t.numpy(), str(t.numpy().dtype)


def _to_tensor(a: np.ndarray, dtype_name: str, like, path: str
               ) -> torch.Tensor:
    t = torch.from_numpy(np.array(a))
    if dtype_name == "bfloat16":
        t = t.view(torch.bfloat16)
    if not torch.is_tensor(like):
        return t
    if t.shape != like.shape:
        raise CheckpointMismatch(f"leaf {path}: saved {tuple(t.shape)}, "
                                 f"expected {tuple(like.shape)}")
    return place_as(t.to(device=like.device, dtype=like.dtype), like)


def _checksum(arrays: list[np.ndarray], full: bool = False) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(str(a.shape).encode())
        h.update(str(a.dtype).encode())
        b = a.tobytes()
        h.update(b if full else b[:1 << 20])
    return h.hexdigest()[:16]


def _fsync_dir(path):
    """Best-effort directory fsync: makes the rename itself durable."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _host_tree(tree):
    leaves = [_to_host(leaf) for leaf in tree_leaves(tree)]
    return ([a for a, _ in leaves], [d for _, d in leaves],
            tree_structure(tree), [p for p, _ in tree_items(tree)])


def _write(ckpt_dir: Path, step: int, arrays, dtypes, structure, paths,
           extra: dict | None, full_checksum: bool) -> Path | None:
    """The checkpoint's directory, or None on a rank other than 0 of a
    process group (rank 0 writes for all)."""
    if dist.is_initialized() and dist.get_rank() != 0:
        return None
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:010d}"
    tmp = Path(tempfile.mkdtemp(dir=ckpt_dir, prefix=f".tmp_{step}_"))
    try:
        with open(tmp / "arrays.npz", "wb") as f:
            np.savez(f, **{f"leaf_{i}": a for i, a in enumerate(arrays)})
            f.flush()
            os.fsync(f.fileno())
        manifest = {"step": step, "n_leaves": len(arrays), "dtypes": dtypes,
                    "treedef": structure, "paths": paths,
                    "checksum": _checksum(arrays, full=full_checksum),
                    "checksum_mode": "full" if full_checksum else "head",
                    "extra": extra or {}}
        with open(tmp / _SENTINEL, "w") as f:
            json.dump(manifest, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
        _fsync_dir(ckpt_dir)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def save(ckpt_dir, step: int, tree: Any, extra: dict | None = None,
         full_checksum: bool = False) -> Path | None:
    """Atomic synchronous save of a tree of tensors (None on a rank that
    does not write)."""
    return _write(Path(ckpt_dir), step, *_host_tree(tree), extra,
                  full_checksum)


class AsyncSaver:
    """Copies the tree to the host at once, writes it on a thread.
    ``wait()`` joins the write and re-raises its error."""

    def __init__(self):
        self._thread: threading.Thread | None = None
        self.last_path: Path | None = None
        self.error: BaseException | None = None

    def save(self, ckpt_dir, step, tree, extra=None, full_checksum=False):
        self.wait()
        host = _host_tree(tree)

        def _run():
            try:
                self.last_path = _write(Path(ckpt_dir), step, *host, extra,
                                        full_checksum)
            except BaseException as e:  # surfaced on wait()
                self.error = e

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.error is not None:
            err, self.error = self.error, None
            raise err


def complete_steps(ckpt_dir) -> list[int]:
    """Ascending steps of every complete checkpoint (manifest present)."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return []
    steps = []
    for d in ckpt_dir.iterdir():
        if d.name.startswith("step_") and (d / _SENTINEL).exists():
            try:
                steps.append(int(d.name.split("_")[1]))
            except ValueError:
                continue
    return sorted(steps)


def latest_step(ckpt_dir) -> int | None:
    steps = complete_steps(ckpt_dir)
    return steps[-1] if steps else None


def mark_healthy(ckpt_dir, step: int):
    """Promote a checkpoint to a rollback target (the guardian does so
    only once it has survived a health window of further training)."""
    d = Path(ckpt_dir) / f"step_{step:010d}"
    with open(d / _HEALTHY, "w") as f:
        f.write("ok")
        f.flush()
        os.fsync(f.fileno())
    _fsync_dir(d)


def is_healthy(ckpt_dir, step: int) -> bool:
    return (Path(ckpt_dir) / f"step_{step:010d}" / _HEALTHY).exists()


def latest_healthy_step(ckpt_dir) -> int | None:
    healthy = [s for s in complete_steps(ckpt_dir) if is_healthy(ckpt_dir, s)]
    return healthy[-1] if healthy else None


def gc_checkpoints(ckpt_dir, keep_last_k: int, log=None) -> list[int]:
    """Delete complete checkpoints beyond the newest ``keep_last_k``,
    never the latest healthy one.  Returns the deleted steps."""
    steps = complete_steps(ckpt_dir)
    if keep_last_k is None or len(steps) <= keep_last_k:
        return []
    protect = set(steps[-keep_last_k:])
    h = latest_healthy_step(ckpt_dir)
    if h is not None:
        protect.add(h)
    removed = []
    for s in steps:
        if s in protect:
            continue
        shutil.rmtree(Path(ckpt_dir) / f"step_{s:010d}", ignore_errors=True)
        removed.append(s)
    if removed and log:
        log(f"[ckpt] gc removed steps {removed} (keep_last_k={keep_last_k})")
    return removed


def _select(manifest: dict, like, d: Path) -> list[int]:
    """The indices of the saved leaves that fill ``like``: all of them
    when the structures are equal, else those under ``like``'s top-level
    keys, each subtree complete and in order."""
    if manifest["treedef"] == tree_structure(like):
        return list(range(manifest["n_leaves"]))
    saved = manifest.get("paths")
    if saved is None or not isinstance(like, dict):
        raise CheckpointMismatch(f"checkpoint {d} holds another tree "
                                 "structure")
    want = [p for p, _ in tree_items(like)]
    pick = []
    for key in like:
        sub = [i for i, p in enumerate(saved)
               if p == key or p.startswith(key + "/")]
        if [saved[i] for i in sub] != [p for p in want
                                       if p == key or
                                       p.startswith(key + "/")]:
            raise CheckpointMismatch(f"checkpoint {d}: subtree {key!r} "
                                     "holds other leaves")
        pick += sub
    return pick


def restore(ckpt_dir, step: int, like: Any,
            verify: bool = True) -> tuple[Any, dict]:
    """Restore into the structure of ``like`` (the whole saved tree, or
    some of its top-level keys); each leaf lands on the device, and in the
    dtype, of ``like``'s leaf, whose values are ignored."""
    d = Path(ckpt_dir) / f"step_{step:010d}"
    manifest = json.loads((d / _SENTINEL).read_text())
    with np.load(d / "arrays.npz") as data:
        arrays = [data[f"leaf_{i}"] for i in range(manifest["n_leaves"])]
    full = manifest.get("checksum_mode", "head") == "full"
    if verify and _checksum(arrays, full=full) != manifest["checksum"]:
        raise IOError(f"checkpoint {d} failed checksum verification")
    pick = _select(manifest, like, d)
    leaves = [_to_tensor(arrays[i], manifest["dtypes"][i], lk, path)
              for i, (path, lk) in zip(pick, tree_items(like))]
    return tree_unflatten_like(like, leaves), manifest["extra"]


def restore_latest(ckpt_dir, like, log=None):
    """(step, tree, extra) from the newest verifiable checkpoint, falling
    back past unreadable ones; (None, None, None) when none is left.  A
    checkpoint that reads but does not fit ``like`` raises
    ``CheckpointMismatch``."""
    for s in reversed(complete_steps(ckpt_dir)):
        try:
            tree, extra = restore(ckpt_dir, s, like)
            return s, tree, extra
        except CheckpointMismatch:
            raise
        except Exception as e:   # torn npz, bad json, failed checksum, ...
            if log:
                log(f"[ckpt] step {s} unreadable ({type(e).__name__}: {e}) "
                    "— falling back to an older checkpoint")
    return None, None, None
