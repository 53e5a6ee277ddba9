"""Junction pipelining: the paper's operational model, quantified.

``core.paper_net.train_epoch_pipelined`` runs the clocked schedule bit
for bit; this module holds the paper's resource and throughput model
(Secs. III-D-3, III-D-6, III-E): multiplier and adder counts as functions
of the degrees of parallelism z_i, and the block-cycle throughput model
behind Fig. 8, the reconfiguration trade-off that is the paper's
headline feature.  Pure Python arithmetic over ``PaperNetConfig``.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.paper_net import PaperNetConfig

CLOCK_HZ = 15e6     # the paper's achieved clock (Sec. III-D-6)


@dataclasses.dataclass(frozen=True)
class ResourceModel:
    """Arithmetic-unit counts from Sec. III-D-3."""
    ff_multipliers: int        # sum_i z_i
    bp_multipliers: int        # 2 * sum_{i>=2} z_i
    up_multipliers: int        # sum_i z_i
    up_adders: int             # sum_i (z_i + z_i/d_in_i)
    sigmoid_luts: int          # sum_i z_i / d_in_i
    bp_partial_sums: int       # sum_{i>=2} z_i

    @property
    def total_multipliers(self) -> int:
        return self.ff_multipliers + self.bp_multipliers + self.up_multipliers


def resources(cfg: PaperNetConfig) -> ResourceModel:
    zs = cfg.z
    d_ins = [cfg.d_in(i) for i in range(cfg.n_junctions)]
    return ResourceModel(
        ff_multipliers=sum(zs),
        bp_multipliers=2 * sum(zs[1:]),
        up_multipliers=sum(zs),
        up_adders=sum(z + z // d for z, d in zip(zs, d_ins)),
        sigmoid_luts=sum(z // d for z, d in zip(zs, d_ins)),
        bp_partial_sums=sum(zs[1:]),
    )


def block_cycle_s(cfg: PaperNetConfig, clock_hz: float = CLOCK_HZ) -> float:
    """Seconds per input at ideal throughput (pipeline full): the longest
    junction block cycle (all junctions are tuned equal in Table I)."""
    return max(cfg.block_cycles(i) for i in range(cfg.n_junctions)) / clock_hz


def throughput_inputs_per_s(cfg: PaperNetConfig,
                            clock_hz: float = CLOCK_HZ) -> float:
    return 1.0 / block_cycle_s(cfg, clock_hz)


def speedup_vs_sequential(cfg: PaperNetConfig) -> float:
    """The 3L factor: FF+BP+UP x L junctions run concurrently."""
    return 3.0 * cfg.n_junctions


def z_sweep_configs(base: PaperNetConfig, factors=(0.25, 0.5, 1.0, 2.0, 4.0)):
    """Fig. 8: scale all z_i (keeping z_i <= W_i and z_i >= d_in_i where
    possible), returning (config, total_z, block_cycle_s, resources)."""
    rows = []
    for f in factors:
        zs = []
        ok = True
        for i in range(base.n_junctions):
            z = int(base.z[i] * f)
            z = max(1, min(z, base.weights(i)))
            if base.weights(i) % z:
                ok = False
                break
            zs.append(z)
        if not ok:
            continue
        cfg = dataclasses.replace(base, z=tuple(zs))
        rows.append({
            "factor": f,
            "total_z": sum(zs),
            "block_cycle_s": block_cycle_s(cfg),
            "throughput_per_s": throughput_inputs_per_s(cfg),
            "multipliers": resources(cfg).total_multipliers,
        })
    return rows
