"""Three-term roofline of one call, from the aten ops it dispatches
(NVIDIA H100 SXM constants).

    compute    = dot_FLOPs / PEAK_FLOPS
    memory     = HBM_bytes / HBM_BW
    collective = collective_bytes / LINK_BW

The port's counterpart of ``src/repro/roofline/analysis.py``.  The counts
come from ``dispatch.DispatchCounter`` (in place of the reference's HLO
walker), per rank: each process counts the ops it runs.  Left out are the
fields that describe only XLA's compiled module: ``n_while`` and
``trip_counts`` (eager PyTorch runs no loops of its own: each op is
counted each time it runs), ``spurious_f32_bytes`` (XLA-CPU's widening of
bf16 loop state) and ``raw_cost`` (XLA's ``cost_analysis``).
``memory_stats`` holds the bytes of the call's arguments and outputs and
its eager peak of live bytes (``DispatchCounter.peak_bytes``, the
arguments included).
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils._pytree import tree_leaves

from repro_torch.roofline import dispatch

# NVIDIA H100 SXM, per card (NVIDIA H100 Tensor Core GPU data sheet)
PEAK_FLOPS = 989e12        # dense bf16 on the tensor cores
HBM_BW = 3.35e12           # bytes/s
LINK_BW = 450e9            # NVLink 4, bytes/s each way (900 GB/s both ways)
# bytes a process can hold on an H100 80GB HBM3: CUDA's totalGlobalMem
# (torch.cuda.get_device_properties(0).total_memory) as read on the card,
# 81079 MiB (80 GiB of HBM3 less what the card keeps back)
HBM_CAPACITY = 85_017_493_504


@dataclasses.dataclass
class Roofline:
    dot_flops: float
    mem_bytes: float
    coll_bytes: float
    t_compute: float
    t_memory: float
    t_collective: float
    dominant: str
    coll_detail: dict
    memory_stats: dict

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def _bytes_once(tree) -> int:
    """Bytes of the distinct storages the tensors of ``tree`` view."""
    seen = {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
            for t in tree_leaves(tree) if torch.is_tensor(t)}
    return sum(seen.values())


def make_roofline(dot_flops: float, mem_bytes: float, coll_detail: dict,
                  memory_stats: dict) -> Roofline:
    """The three terms of the counts; ``coll_detail`` maps a collective
    kind to its (bytes, count)."""
    coll = sum(b for b, _ in coll_detail.values())
    t_c = dot_flops / PEAK_FLOPS
    t_m = mem_bytes / HBM_BW
    t_l = coll / LINK_BW
    dominant = max(("compute", t_c), ("memory", t_m), ("collective", t_l),
                   key=lambda kv: kv[1])[0]
    return Roofline(
        dot_flops=dot_flops, mem_bytes=mem_bytes, coll_bytes=coll,
        t_compute=t_c, t_memory=t_m, t_collective=t_l, dominant=dominant,
        coll_detail={k: {"bytes": b, "count": n}
                     for k, (b, n) in coll_detail.items()},
        memory_stats=memory_stats)


def analyze(fn, *args, **kwargs) -> Roofline:
    """``fn(*args, **kwargs)`` run once under ``DispatchCounter``: its
    roofline.  On ``meta`` tensors nothing is allocated."""
    with dispatch.DispatchCounter((args, kwargs)) as c:
        out = fn(*args, **kwargs)
    return make_roofline(
        c.dot_flops, c.mem_bytes, c.coll_detail,
        {"argument_bytes": _bytes_once((args, kwargs)),
         "output_bytes": _bytes_once(out), "peak_bytes": c.peak_bytes})


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE), D = tokens processed.

    For decode shapes D = global_batch (one token each); train/prefill
    D = seq*batch.  Training costs 3x the forward pass (fwd + 2x bwd)."""
    n = cfg.active_param_count()
    if shape.kind == "decode":
        toks = shape.global_batch
        return 2.0 * n * toks
    toks = shape.tokens
    mult = 3.0 if shape.kind == "train" else 1.0
    return 2.0 * n * toks * mult


def useful_fraction(cfg, shape, per_device_dot_flops: float,
                    n_chips: int) -> float:
    """MODEL_FLOPS / counted FLOPs — how much counted compute is 'useful'."""
    total_hlo = per_device_dot_flops * n_chips
    mf = model_flops(cfg, shape)
    return mf / total_hlo if total_hlo else 0.0
