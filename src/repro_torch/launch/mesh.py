"""Device meshes over torch.distributed process groups.

A mesh here is a ``torch.distributed.device_mesh.DeviceMesh``: one rank
a process, each rank one device (the card, or a CPU process under gloo).
Functions, not module-level constants: importing this module starts no
process group.  ``AbstractMesh`` names axes and sizes without devices,
for the sharding rules at production scale (parallel/sharding.py reads
``mesh_dim_names`` and ``shape`` of either kind).

* ``make_local_mesh(data, model, device)`` — a (data, model) mesh over
  the current process group, whose world size must be data * model.  At
  1 x 1 with no group yet it starts a one-rank group itself (NCCL on the
  card, gloo on the CPU, over an in-process store: no network, no
  file).
* ``make_production_mesh(multi_pod)`` — (16, 16) data x model, or
  (2, 16, 16) pod x data x model; the world must hold 256 or 512 ranks.
"""
from __future__ import annotations

import dataclasses
import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis sizes and names, no devices: ``shape`` and
    ``mesh_dim_names`` as a ``DeviceMesh`` has them."""
    shape: tuple
    mesh_dim_names: tuple


def compat_mesh(shape, axes, device_type: str) -> DeviceMesh:
    """A named mesh of ``shape`` over the ranks of the current group."""
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 0


def start_one_rank_group(device) -> None:
    """A process group of one rank (this process) over an in-process
    store: NCCL for the card, gloo for the CPU."""
    dev = resolve_device(device)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)


def make_local_mesh(data: int = 1, model: int = 1, device=None
                    ) -> DeviceMesh:
    """The (data, model) mesh over the current process group (started
    here at 1 x 1 when there is none).  A group of another world size,
    or none at a larger mesh, raises: nothing runs on fewer ranks."""
    dev = resolve_device(device)
    n = data * model
    if not dist.is_initialized() and n == 1:
        start_one_rank_group(dev)
    if _world() != n:
        raise RuntimeError(
            f"mesh ({data}, {model}) needs a process group of world size "
            f"{n}, have {_world() or 'none'} (launch/train.py --devices "
            f"{n} starts it)")
    return compat_mesh((data, model), ("data", "model"), dev.type)


def make_production_mesh(*, multi_pod: bool = False, device=None
                         ) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    if _world() != n:
        raise RuntimeError(
            f"mesh {shape} needs a process group of {n} ranks, have "
            f"{_world() or 'none'}")
    return compat_mesh(shape, axes, resolve_device(device).type)
