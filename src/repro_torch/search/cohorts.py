"""Cohorts: a list of candidates grouped into same-structure populations.

E candidates share one launch a junction only when they share every
static input of the kernels.  ``bucket`` groups candidate specs by
``population.structure_key`` and ``bucket_quant`` groups quantization
configs by ``quantize.structure_key``; both keep the order of first
appearance of the cohorts and the caller's order within each, and
``member_ids[slot]`` maps a population slot back to the caller's index.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core.quantize import structure_key as quant_structure_key
from repro_torch.search.population import CandidateSpec, structure_key


def _groups(items, key) -> list[tuple[tuple, list[int]]]:
    groups: dict[tuple, list[int]] = {}
    for i, item in enumerate(items):
        groups.setdefault(key(item), []).append(i)
    return list(groups.items())


@dataclasses.dataclass(frozen=True)
class Cohort:
    """One same-structure bucket of candidate specs."""
    key: tuple
    specs: tuple[CandidateSpec, ...]
    member_ids: tuple[int, ...]

    @property
    def size(self) -> int:
        return len(self.specs)


def bucket(specs: Sequence[CandidateSpec]) -> list[Cohort]:
    return [Cohort(key=k, specs=tuple(specs[i] for i in ids),
                   member_ids=tuple(ids))
            for k, ids in _groups(specs, structure_key)]


@dataclasses.dataclass(frozen=True)
class QuantCohort:
    """One stacked quantized population: int8 widths and granularities
    share a cohort (int8 codes, [E, nob, kb] scales); each fxp triplet
    and table activation is its own (int32 codes, one table)."""
    key: tuple
    configs: tuple
    member_ids: tuple[int, ...]

    @property
    def size(self) -> int:
        return len(self.configs)


def bucket_quant(configs: Sequence) -> list[QuantCohort]:
    return [QuantCohort(key=k, configs=tuple(configs[i] for i in ids),
                        member_ids=tuple(ids))
            for k, ids in _groups(configs, quant_structure_key)]
