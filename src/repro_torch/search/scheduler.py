"""Successive halving over E-batched population cohorts.

``run_sweep`` takes a list of candidates, buckets it into same-structure
cohorts (search/cohorts.py), stacks each cohort into one population
(search/population.py) and runs ``SweepConfig.rounds`` of

    steps_per_round E-batched train steps a cohort, one shared batch
      -> each member's eval loss on the held-out split
      -> rank every live member across cohorts, keep the best
         keep_fraction, prune the rest

Members rank on the per-sample total squared error (``loss * n_out``),
so cohorts of other output widths (zero-padded targets) compare fairly,
and a non-finite eval loss ranks +inf: a diverged member is pruned first
and never wins.

Pruning is in place: a pruned member's mask entry goes to 0 (its loss
leaves the objective, so its gradients are exact zeros) and its hyp row
to all zeros (the update kernels then write w' = w and zero slots, for
SGD and Adam alike).  No tensor a step sees changes shape.

Quarantine (``SweepConfig.quarantine``, on by default) is the same
mechanism applied in the middle of a round: after every step each live
member's loss and update health (``make_population_step(with_health=
True)``: on the fused path the update kernels' own non-finite counts,
since the gradients never reach device memory) are read, and a member
that went non-finite is masked and hyp-zeroed at once and recorded in
the ledger (``quarantined_at``).  Members are independent, so the
survivors' parameters are bitwise those of a cohort that never held it.

The losses and health of a step reach the host in one copy, the eval
losses of a cohort in one copy a round; nothing else is read back.  The
returned ``SweepResult`` carries the lineage ``Ledger`` and the cohorts'
final states.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

from repro_torch.configs.base import SweepConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import block_sparse_matmul as bsm
from repro_torch.kernels import ops
from repro_torch.obs import telemetry as obs
from repro_torch.search import cohorts as ch
from repro_torch.search import population as pop
from repro_torch.search.ledger import Ledger, MemberRecord, make_meta


@dataclasses.dataclass
class CohortState:
    cohort: ch.Cohort
    params: list
    mom: tuple              # the slot trees (population.init_slots)
    hyp: torch.Tensor       # [E, HYP_K], a zeroed row = pruned
    mask: torch.Tensor      # [E] f32, 0 = pruned
    records: list[MemberRecord]
    step: callable
    evaluate: callable
    t_train_pad: torch.Tensor   # train targets padded to the cohort's width
    t_eval_pad: torch.Tensor    # eval targets, ditto

    @property
    def out_width(self) -> int:
        return self.cohort.specs[0].layers[-1]

    @property
    def is_adam(self) -> bool:
        # one kind a cohort: opt is part of the structure key
        return self.cohort.specs[0].opt == "adam"


@dataclasses.dataclass
class SweepResult:
    ledger: Ledger
    states: list[CohortState]

    def winning_params(self):
        """The winner's single-model params."""
        w = self.ledger.winner()
        if w is None:
            return None
        return pop.member_slice(self.states[w.cohort].params, w.slot)


def _pad_targets(t: np.ndarray, width: int) -> np.ndarray:
    """One-hot targets padded with zero columns to a cohort's output
    width (the paper pads 10 MNIST classes to its 32-wide output)."""
    if t.shape[1] > width:
        raise ValueError(f"targets wider ({t.shape[1]}) than the output "
                         f"layer ({width})")
    if t.shape[1] == width:
        return t
    out = np.zeros((t.shape[0], width), t.dtype)
    out[:, :t.shape[1]] = t
    return out


def _batch_indices(n: int, batch: int, step: int,
                   device="cpu") -> torch.Tensor:
    """The wrapping minibatch of the shared train split at ``step``, made
    on ``device`` (no host-to-device copy): every cohort sees the same
    data stream."""
    start = (step * batch) % n
    return torch.arange(start, start + batch, device=device) % n


def _score(loss: float, out_width: int) -> float:
    """The rank key across cohorts: the per-sample total squared error
    (mean * width undoes the padding's dilution); a non-finite loss ranks
    last."""
    s = float(loss) * out_width
    return s if math.isfinite(s) else math.inf


def _quarantine(st: CohortState, rec: MemberRecord, rnd: int,
                global_step: int, recorder: "obs.Recorder | None" = None):
    """Isolate a diverged member in the middle of a round: zero its mask
    entry (its loss leaves the shared objective, so the others' gradients
    are what they would be without it) and its hyp row (lr = 0 freezes
    what is left of it), and record it apart from a prune by rank."""
    st.mask[rec.slot] = 0.0
    st.hyp[rec.slot] = 0.0
    rec.pruned_at = rnd
    rec.quarantined_at = {"round": rnd, "step": global_step}
    if recorder is not None:
        recorder.count("sweep.quarantined")
        recorder.emit(obs.SweepRound(
            action="quarantine", round=rnd, member=rec.member,
            cohort=rec.cohort, slot=rec.slot,
            detail={"step": global_step}))


def run_sweep(specs: Sequence[pop.CandidateSpec], x_train, t_train,
              x_eval, t_eval, cfg: SweepConfig, *, tag: str = "",
              recorder: "obs.Recorder | None" = None,
              device=None) -> SweepResult:
    """Train every candidate population-parallel and halve successively,
    on ``device`` (the card unless the caller names another).

    x_* [N, n_in] float, t_* [N, n_classes] one-hot (padded to each
    cohort's output width).  Cohort ci's weights come from
    ``init_population(cfg.seed * 1_000_003 + ci, ...)``, the port's own
    rule (the reference folds ci into a JAX key; its weights are not
    reproduced).  Returns the ledger (winner marked) and the cohorts'
    final states.

    ``recorder`` gets one ``obs.SweepRound`` for each decision: rank (one
    a round, the scored table in ``detail``), prune and quarantine (one a
    member, its cohort and slot attached) and winner, from values already
    on the host."""
    dev = resolve_device(device)
    specs = list(specs)
    x_train = np.asarray(x_train, np.float32)
    t_train = np.asarray(t_train, np.float32)
    x_eval = np.asarray(x_eval, np.float32)[:cfg.eval_samples]
    t_eval = np.asarray(t_eval, np.float32)[:cfg.eval_samples]
    fused = cfg.fused and ops.resolve_engine(cfg.engine) == "pallas"

    ledger = Ledger(meta=dict(make_meta(tag), engine=cfg.engine,
                              rounds=cfg.rounds,
                              steps_per_round=cfg.steps_per_round,
                              n_candidates=len(specs)))
    x_train_d = torch.from_numpy(x_train).to(dev)
    x_eval_d = torch.from_numpy(x_eval).to(dev)
    states: list[CohortState] = []
    for ci, cohort in enumerate(ch.bucket(specs)):
        spec0 = cohort.specs[0]
        if x_train.shape[1] != spec0.layers[0]:
            raise ValueError(
                f"cohort {ci}: input width {spec0.layers[0]} != data "
                f"width {x_train.shape[1]}")
        params = pop.init_population(cfg.seed * 1_000_003 + ci,
                                     cohort.specs, device=dev)
        records = [ledger.add(MemberRecord(
            member=mid, config=s.to_dict(), cohort=ci, slot=slot))
            for slot, (mid, s) in enumerate(zip(cohort.member_ids,
                                                cohort.specs))]
        states.append(CohortState(
            cohort=cohort, params=params,
            mom=pop.init_slots(params, cohort.specs),
            hyp=pop.hyp_table(cohort.specs, device=dev),
            mask=torch.ones((cohort.size,), dtype=torch.float32,
                            device=dev),
            records=records,
            step=pop.make_population_step(spec0.act, fused=fused,
                                          with_health=cfg.quarantine),
            evaluate=pop.make_population_eval(spec0.act),
            # constant a cohort: padded and uploaded once
            t_train_pad=torch.from_numpy(
                _pad_targets(t_train, spec0.layers[-1])).to(dev),
            t_eval_pad=torch.from_numpy(
                _pad_targets(t_eval, spec0.layers[-1])).to(dev)))

    n_train = x_train.shape[0]
    batch = min(cfg.batch_size, n_train)
    global_step = 0
    n_live = len(specs)
    for rnd in range(cfg.rounds):
        # -- train: steps_per_round E-batched steps a cohort, shared data
        for _ in range(cfg.steps_per_round):
            bi = _batch_indices(n_train, batch, global_step, dev)
            xb = x_train_d.index_select(0, bi)
            for st in states:
                if all(r.pruned_at is not None for r in st.records):
                    continue        # the whole cohort pruned: no step
                if st.is_adam:
                    # every live member steps in lockstep; on a zeroed row
                    # t is harmless (lr = 0, masked gradients are zeros)
                    st.hyp[:, bsm.COL_T] = float(global_step + 1)
                out = st.step(st.params, st.mom, st.hyp, st.mask, xb,
                              st.t_train_pad.index_select(0, bi))
                st.params, st.mom, losses = out[:3]
                # the step's one device-to-host copy
                host = (torch.stack([losses, out[3]]) if cfg.quarantine
                        else losses[None]).cpu().numpy()
                for rec in st.records:
                    if rec.pruned_at is not None:
                        continue
                    loss = float(host[0, rec.slot])
                    rec.loss_curve.append(loss)
                    if cfg.quarantine and (not math.isfinite(loss)
                                           or host[1, rec.slot] > 0):
                        _quarantine(st, rec, rnd, global_step,
                                    recorder=recorder)
            global_step += 1

        # -- eval: every member's loss, the live ones ranked
        scored = []      # (width-normalized score, cohort index, slot)
        for ci, st in enumerate(states):
            if all(r.pruned_at is not None for r in st.records):
                continue
            ev = st.evaluate(st.params, x_eval_d, st.t_eval_pad
                             ).cpu().numpy()
            for rec, loss in zip(st.records, ev):
                if rec.pruned_at is None:
                    rec.eval_losses.append(float(loss))
                    rec.rounds_survived = rnd + 1
                    scored.append((_score(loss, st.out_width), ci, rec.slot))
        if recorder is not None and scored:
            recorder.emit(obs.SweepRound(
                action="rank", round=rnd,
                detail={"live": len(scored), "scores": [
                    {"member": states[ci].records[slot].member,
                     "cohort": ci, "slot": slot,
                     "score": s if math.isfinite(s) else None}
                    for s, ci, slot in sorted(scored)]}))

        # -- halve: keep the best keep_fraction across cohorts
        if rnd < cfg.rounds - 1 and len(scored) > 1:
            scored.sort()
            n_keep = max(1, int(math.ceil(len(scored) * cfg.keep_fraction)))
            for sc, ci, slot in scored[n_keep:]:
                st = states[ci]
                st.mask[slot] = 0.0
                st.hyp[slot] = 0.0
                st.records[slot].pruned_at = rnd
                if recorder is not None:
                    recorder.count("sweep.pruned")
                    recorder.emit(obs.SweepRound(
                        action="prune", round=rnd,
                        member=st.records[slot].member, cohort=ci,
                        slot=slot,
                        detail={"score": sc if math.isfinite(sc)
                                else None}))
            n_live = n_keep

    # -- winner: the best final score among the survivors
    best = min(((_score(m.eval_losses[-1], st.out_width), m.member)
                for st in states for m in st.records
                if m.pruned_at is None and m.eval_losses), default=None)
    if best is not None and math.isfinite(best[0]):
        for m in ledger.members:
            m.winner = m.member == best[1]
        if recorder is not None:
            w = next(m for m in ledger.members if m.winner)
            recorder.emit(obs.SweepRound(
                action="winner", round=cfg.rounds - 1, member=w.member,
                cohort=w.cohort, slot=w.slot, detail={"score": best[0]}))
    ledger.meta["live_at_end"] = n_live
    ledger.meta["quarantined"] = sum(
        1 for m in ledger.members if m.quarantined_at is not None)
    return SweepResult(ledger=ledger, states=states)
