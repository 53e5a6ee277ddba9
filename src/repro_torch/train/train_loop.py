"""Train loop: checkpoint and restart, divergence guardian, straggler
watch.

* Auto-resume from the newest verifiable checkpoint (params, optimizer
  state, data-iterator state, step: a bitwise continuation; a corrupt
  newest checkpoint falls back to the one before it).
* A checkpoint every ``ckpt_every`` steps (written on a thread) and on
  exit, with optional ``keep_last_k`` retention.
* ``fail_at_step``: an injected crash, for restart tests.
* Straggler watch: a step slower than ``straggler_factor`` x the median
  of a rolling window is reported through ``on_straggler``.

Divergence guardian (``GuardianConfig``): it trips on a non-finite loss,
on metrics["nonfinite"] > 0 (the update wrote non-finite parameters:
the fused path's in-kernel health counts, the two-pass path's gradient
scan) or on a loss spike beyond ``spike_factor`` x the window median.
A checkpoint becomes a rollback target only after surviving
``health_window`` further steps.  On a trip the loop restores the latest
healthy checkpoint (the fused step may have written the tripped update
into its input tensors; they are dropped), shrinks the lr by
``lr_backoff`` through the step's ``lr_scale``, skips the offending
batch, and retries; after ``max_retries`` trips it raises
``GuardianTripped``.

Telemetry: with a ``recorder`` (obs.Recorder) the loop emits one
``TrainStep`` event a step it adopts and the ``Guardian`` (trip,
rollback, backoff, recovery) and ``Checkpoint`` (save, promote, gc)
lifecycle events.  It records only values it already read on the host:
the loss it reads for honest step timing, and ``nonfinite`` on the
guardian path only (``obs.NOT_SAMPLED`` without a guardian).
"""
from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import Callable, Optional

import numpy as np

from repro_torch.obs import telemetry as obs
from repro_torch.train import checkpoint as ckpt_mod


@dataclasses.dataclass
class GuardianConfig:
    window: int = 32            # rolling loss window for the spike sentinel
    spike_factor: float = 10.0  # trip when loss > factor * window median
    min_history: int = 8        # spike sentinel armed after this many losses
    health_window: int = 10     # steps a checkpoint must survive -> healthy
    lr_backoff: float = 0.5     # lr_scale multiplier per trip
    max_retries: int = 3        # trips before giving up
    skip_offending_batch: bool = True


class GuardianTripped(RuntimeError):
    """The guardian exhausted ``max_retries``."""

    def __init__(self, msg: str, trips: list[dict]):
        super().__init__(msg)
        self.trips = trips


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int
    ckpt_dir: str
    ckpt_every: int = 100
    log_every: int = 10
    straggler_window: int = 50
    straggler_factor: float = 3.0
    fail_at_step: Optional[int] = None      # test hook: simulated crash
    guardian: Optional[GuardianConfig] = None
    keep_last_k: Optional[int] = None       # retention GC (None = keep all)
    full_checksum: bool = False             # digest every byte at save time


class StragglerMonitor:
    def __init__(self, window: int, factor: float,
                 on_straggler: Callable[[int, float, float], None] | None = None):
        self.times = deque(maxlen=window)
        self.factor = factor
        self.count = 0
        self.on_straggler = on_straggler or (lambda *a: None)

    def observe(self, step: int, dt: float):
        if len(self.times) >= 8:
            med = float(np.median(self.times))
            if dt > self.factor * med:
                self.count += 1
                self.on_straggler(step, dt, med)
        self.times.append(dt)


def _batch_tokens(batch) -> int:
    """Token count of a batch for tokens/s, from shapes alone (nothing is
    read): the ``tokens`` field's element count when present (LM
    pipelines), else the leading dim of the first leaf."""
    if isinstance(batch, dict) and "tokens" in batch:
        return math.prod(batch["tokens"].shape)
    leaves = list(batch.values()) if isinstance(batch, dict) else [batch]
    return int(leaves[0].shape[0]) if leaves else 0


def run(cfg: TrainLoopConfig, train_step, params, opt_state, pipeline,
        log: Callable[[str], None] = print,
        recorder: "obs.Recorder | None" = None) -> dict:
    """Returns {params, opt_state, step, history, straggler_count,
    guardian}.  ``train_step(params, opt_state, batch, step[, lr_scale])``
    is ``train.steps.make_train_step``'s; the 5-argument form is used
    only with a ``GuardianConfig``.  ``pipeline`` is a restartable
    iterator with ``state()`` and seed/step attributes.  ``recorder``
    gets the events of the module docstring."""
    g = cfg.guardian
    saver = ckpt_mod.AsyncSaver()
    state_like = {"params": params, "opt": opt_state}
    step = 0

    def _save_extra():
        return {"step": step, "data_state": pipeline.state()}

    def _restore(at):
        tree, extra = ckpt_mod.restore(cfg.ckpt_dir, at, state_like)
        pipeline.step = extra["data_state"]["step"]
        pipeline.seed = extra["data_state"]["seed"]
        return tree["params"], tree["opt"], extra["step"]

    found, tree, extra = ckpt_mod.restore_latest(cfg.ckpt_dir, state_like,
                                                 log=log)
    if found is not None:
        params, opt_state = tree["params"], tree["opt"]
        step = extra["step"]
        pipeline.step = extra["data_state"]["step"]
        pipeline.seed = extra["data_state"]["seed"]
        log(f"[train] resumed from step {step}")

    lr_scale = 1.0
    trips: list[dict] = []
    bad_data_steps: set[int] = set()
    loss_win: deque = deque(maxlen=g.window) if g else deque()
    pending_healthy: list[int] = []
    if g is not None and ckpt_mod.latest_healthy_step(cfg.ckpt_dir) is None:
        # the starting state is the rollback floor until a later
        # checkpoint survives the health window
        if found is None:
            ckpt_mod.save(cfg.ckpt_dir, step,
                          {"params": params, "opt": opt_state},
                          extra=_save_extra(),
                          full_checksum=cfg.full_checksum)
        ckpt_mod.mark_healthy(cfg.ckpt_dir, step)

    mon = StragglerMonitor(cfg.straggler_window, cfg.straggler_factor,
                           on_straggler=lambda s, dt, med: log(
                               f"[straggler] step {s}: {dt*1e3:.1f}ms vs "
                               f"median {med*1e3:.1f}ms"))
    history = []
    rec = recorder
    dt_ema: float | None = None
    awaiting_recovery = False
    try:
        while step < cfg.total_steps:
            if cfg.fail_at_step is not None and step == cfg.fail_at_step:
                raise RuntimeError(f"injected failure at step {step}")
            data_step = pipeline.state()["step"] if g is not None else None
            batch = next(pipeline)
            if g is not None and data_step in bad_data_steps:
                log(f"[guardian] skipping poisoned batch "
                    f"(data step {data_step})")
                continue
            t0 = time.perf_counter()
            if g is not None:
                new_params, new_opt, metrics = train_step(
                    params, opt_state, batch, step, lr_scale)
            else:
                new_params, new_opt, metrics = train_step(
                    params, opt_state, batch, step)
            loss = float(metrics["loss"])   # waits for the card: honest time
            dt = time.perf_counter() - t0

            if g is not None:
                nonfinite = float(metrics.get("nonfinite", 0.0))
                why = None
                if not np.isfinite(loss):
                    why = f"non-finite loss {loss}"
                elif nonfinite > 0:
                    why = (f"{int(nonfinite)} non-finite update "
                           "leaves/tiles (in-kernel health flags)")
                elif len(loss_win) >= g.min_history:
                    med = float(np.median(loss_win))
                    if loss > g.spike_factor * max(med, 1e-12):
                        why = (f"loss spike {loss:.4g} > "
                               f"{g.spike_factor}x median {med:.4g}")
                if why is not None:
                    trips.append({"step": step, "data_step": data_step,
                                  "reason": why, "lr_scale": lr_scale})
                    if rec is not None:
                        rec.count("train.guardian.trips")
                        rec.emit(obs.Guardian(
                            action="trip", step=step,
                            detail={"reason": why, "data_step": data_step,
                                    "lr_scale": lr_scale}))
                    if g.skip_offending_batch:
                        bad_data_steps.add(data_step)
                    if len(trips) > g.max_retries:
                        raise GuardianTripped(
                            f"guardian exhausted {g.max_retries} retries; "
                            f"last trip at step {step}: {why} "
                            f"(trip history: {trips})", trips)
                    saver.wait()
                    h = ckpt_mod.latest_healthy_step(cfg.ckpt_dir)
                    if h is None:
                        raise GuardianTripped(
                            f"guardian tripped at step {step} ({why}) with "
                            "no healthy checkpoint to roll back to", trips)
                    tripped_at = step
                    params, opt_state, step = _restore(h)
                    lr_scale *= g.lr_backoff
                    loss_win.clear()
                    pending_healthy.clear()
                    if rec is not None:
                        rec.emit(obs.Guardian(
                            action="rollback", step=step,
                            detail={"from_step": tripped_at}))
                        rec.emit(obs.Guardian(
                            action="backoff", step=step,
                            detail={"lr_scale": lr_scale}))
                        rec.gauge("train.lr_scale", lr_scale)
                    awaiting_recovery = True
                    log(f"[guardian] TRIP: {why} — rolled back to healthy "
                        f"step {step}, lr_scale -> {lr_scale:.4g}, retry "
                        f"{len(trips)}/{g.max_retries}")
                    continue
                loss_win.append(loss)

            params, opt_state = new_params, new_opt
            mon.observe(step, dt)
            if rec is not None:
                if awaiting_recovery:
                    # the first step adopted after a rollback
                    rec.emit(obs.Guardian(
                        action="recovery", step=step,
                        detail={"trips": len(trips), "lr_scale": lr_scale}))
                    awaiting_recovery = False
                dt_ema = dt if dt_ema is None else 0.9 * dt_ema + 0.1 * dt
                n_tok = _batch_tokens(batch)
                rec.count("train.steps")
                rec.observe("train.dt_s", dt)
                rec.emit(obs.TrainStep(
                    step=step, loss=loss,
                    nonfinite=(nonfinite if g is not None
                               else obs.NOT_SAMPLED),
                    lr_scale=lr_scale, dt_s=dt, dt_ema_s=dt_ema,
                    tokens_per_s=(n_tok / dt if dt > 0 else 0.0)))
            step += 1
            if step % cfg.log_every == 0 or step == cfg.total_steps:
                history.append({"step": step, "loss": loss, "dt_s": dt})
                log(f"[train] step {step} loss {loss:.4f} ({dt*1e3:.0f} ms)")
            if step % cfg.ckpt_every == 0:
                saver.save(cfg.ckpt_dir, step,
                           {"params": params, "opt": opt_state},
                           extra=_save_extra(),
                           full_checksum=cfg.full_checksum)
                if rec is not None:
                    rec.count("train.ckpt.saves")
                    rec.emit(obs.Checkpoint(action="save", step=step,
                                            detail={"async": True}))
                if g is not None:
                    pending_healthy.append(step)
                if cfg.keep_last_k is not None:
                    removed = ckpt_mod.gc_checkpoints(
                        cfg.ckpt_dir, cfg.keep_last_k, log=log)
                    if rec is not None and removed:
                        rec.emit(obs.Checkpoint(
                            action="gc", step=step,
                            detail={"removed": list(removed)}))
            if g is not None:
                while pending_healthy and (
                        pending_healthy[0] + g.health_window <= step):
                    s = pending_healthy[0]
                    comp = ckpt_mod.complete_steps(cfg.ckpt_dir)
                    if s in comp:
                        ckpt_mod.mark_healthy(cfg.ckpt_dir, s)
                        pending_healthy.pop(0)
                        if rec is not None:
                            rec.emit(obs.Checkpoint(
                                action="promote", step=s,
                                detail={"survived": g.health_window}))
                    elif comp and s < comp[-1]:
                        pending_healthy.pop(0)   # overwritten or GC'd
                    else:
                        break                    # async write still in flight
    finally:
        saver.wait()
        ckpt_mod.save(cfg.ckpt_dir, step, {"params": params, "opt": opt_state},
                      extra=_save_extra(), full_checksum=cfg.full_checksum)
        if rec is not None:
            rec.emit(obs.Checkpoint(action="save", step=step,
                                    detail={"final": True}))
        if cfg.keep_last_k is not None:
            removed = ckpt_mod.gc_checkpoints(cfg.ckpt_dir, cfg.keep_last_k,
                                              log=log)
            if rec is not None and removed:
                rec.emit(obs.Checkpoint(action="gc", step=step,
                                        detail={"removed": list(removed)}))
    guardian_info = {"trips": trips, "lr_scale": lr_scale,
                     "skipped_data_steps": sorted(bad_data_steps)}
    return {"params": params, "opt_state": opt_state, "step": step,
            "history": history, "straggler_count": mon.count,
            "guardian": guardian_info if g is not None else None}
