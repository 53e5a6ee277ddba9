"""The JSON ledger of a population sweep: each member's lineage.

One record a candidate: its config, the cohort and slot it trained in,
its train-loss curve (a loss a step while live), its eval losses (one a
round while live), the rounds it survived, when it was pruned or
quarantined, and whether it won.  ``Ledger.save`` writes one stamped
artifact (``meta`` through ``artifacts.artifact_meta``, the stamp every
results file of the port carries) that ``Ledger.load`` reads back; its
keys are the reference's.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional

from repro_torch.artifacts import artifact_meta


def make_meta(tag: str = "") -> dict:
    """The artifact stamp (``artifacts.artifact_meta``)."""
    return artifact_meta(tag)


@dataclasses.dataclass
class MemberRecord:
    member: int                 # the caller's candidate index
    config: dict                # CandidateSpec.to_dict()
    cohort: int                 # cohort index (bucket order)
    slot: int                   # population slot within the cohort
    loss_curve: list = dataclasses.field(default_factory=list)
    eval_losses: list = dataclasses.field(default_factory=list)
    rounds_survived: int = 0
    pruned_at: Optional[int] = None   # round index; None: never pruned
    # {"round": r, "step": global step} when the scheduler quarantined
    # the member in the middle of a round for a non-finite loss or update
    # (a prune by rank happens at a round's end and leaves it None)
    quarantined_at: Optional[dict] = None
    winner: bool = False

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class Ledger:
    def __init__(self, meta: dict | None = None,
                 members: list[MemberRecord] | None = None):
        self.meta = meta or {}
        self.members = members or []

    def add(self, record: MemberRecord) -> MemberRecord:
        self.members.append(record)
        return record

    def winner(self) -> MemberRecord | None:
        for m in self.members:
            if m.winner:
                return m
        return None

    def survivors(self) -> list[MemberRecord]:
        return [m for m in self.members if m.pruned_at is None]

    def to_dict(self) -> dict:
        w = self.winner()
        return {
            "meta": self.meta,
            "members": [m.to_dict() for m in self.members],
            "winner": w.to_dict() if w is not None else None,
        }

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)
            f.write("\n")

    @classmethod
    def load(cls, path: str) -> "Ledger":
        with open(path) as f:
            data = json.load(f)
        members = [MemberRecord(**m) for m in data.get("members", [])]
        return cls(meta=data.get("meta", {}), members=members)
