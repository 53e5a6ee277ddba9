"""Flight recorder: one telemetry layer for train, sweep and serve.

The train loop, ``ContinuousEngine`` and (in time) the sweep scheduler
record through a :class:`Recorder`, so one run produces one
machine-readable timeline that ``repro_torch.launch.obs_report`` renders.

The recorder carries three aggregate families plus an event stream:

* **counters**: monotonically increasing ints (``count``): steps run,
  requests finished per outcome, checkpoints written;
* **gauges**: latest-value floats (``gauge``): pages in use, slots
  decoding, the current lr_scale;
* **histograms**: bounded sample windows (``observe``) with
  nearest-rank percentiles (:func:`percentile`): step latency, TTFT,
  inter-token latency;
* **events**: typed frozen dataclasses (:class:`TrainStep`,
  :class:`Guardian`, :class:`Checkpoint`, :class:`RequestSpan`,
  :class:`SweepRound`) appended to a bounded in-memory ring and, when a
  ``path`` is given, streamed as one JSON line each (JSONL).  The sink
  opens with a ``meta`` header line and :meth:`Recorder.close` appends a
  ``summary`` line holding the final counters, gauges and histogram
  digests.

No-extra-device-sync contract
-----------------------------
The recorder is host-only.  It never synchronizes the card, never
launches a kernel and never copies from the device: producers hand it
values the step already brought to the host (the ``float(metrics
["loss"])`` the train loop reads for honest step timing, the sampled
tokens the serve scheduler copies anyway).  Every recorded value passes
:func:`_ensure_host`, which raises ``TypeError`` on any ``torch.Tensor``;
tests count the host reads (``Tensor.item`` / ``tolist`` / ``cpu`` /
``__array__``) of a serve run and of train steps with and without a
recorder, and ``chip_smoke.py`` counts the card's synchronizing runtime
calls the same way.  A value a producer did not already read is recorded
as the sentinel ``-1.0`` (``NOT_SAMPLED``), never fetched.

Event schema
------------
Each JSONL line is ``{"kind": ..., "ts": ..., "seq": ..., **fields}``;
``kind`` names the dataclass (``train.step``, ``guardian``,
``checkpoint``, ``serve.span``, ``sweep.round``, plus the ``meta`` /
``summary`` frame lines).  ``seq`` is the per-recorder emission index,
``ts`` host wall-clock seconds.  ``read_events`` reads a file back.

Span lifecycle (``serve.span``)
-------------------------------
One event per finished request, emitted by ``ContinuousEngine`` when
its slot frees: ``enqueue_tick`` (arrival) -> ``admit_tick`` (pages
allocated, slot taken) -> ``prefill_chunks`` fixed-shape chunks ->
``first_token_tick`` / ``ttft_s`` (sampled from the last prefill chunk's
logits) -> ``finish_tick`` with ``outcome`` in {``eos``, ``max_new``,
``guard``}.  ``ttft_s`` / ``first_token_tick`` are ``-1`` when the
request never produced a token (guard-terminated during prefill).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import sys
import time
from collections import deque
from pathlib import Path
from typing import Any, ClassVar, IO, Iterable, Optional

__all__ = [
    "Checkpoint", "Guardian", "Histogram", "NOT_SAMPLED", "Recorder",
    "RequestSpan", "SweepRound", "TrainStep", "percentile", "profile_ctx",
    "read_events",
]

#: histogram value meaning "producer did not sync this value on this
#: path" — recorded instead of forcing a device→host transfer
NOT_SAMPLED = -1.0


def percentile(samples: Iterable[float], q: float) -> float:
    """Nearest-rank percentile: the q-th percentile of n samples is the
    ``ceil(q/100 * n)``-th smallest OBSERVED value.

    Unlike linear interpolation (``np.percentile``'s default), this never
    invents a value between samples, and the small-sample behavior is the
    honest one: p99 of fewer than 100 samples is the max — with 2 latency
    measurements there is no evidence for anything between them, and an
    SLO check must see the worst observed, not an interpolation past it.
    """
    xs = sorted(float(v) for v in samples)
    if not xs:
        raise ValueError("percentile of an empty sample set")
    if not 0.0 < q <= 100.0:
        raise ValueError(f"percentile q must be in (0, 100], got {q}")
    rank = math.ceil(q / 100.0 * len(xs))   # 1-based nearest rank
    return xs[max(rank, 1) - 1]


@contextlib.contextmanager
def profile_ctx(trace_dir: str | None):
    """A ``torch.profiler`` trace of the enclosed run, written as a Chrome
    trace (``trace.json``) into ``trace_dir``, for the launchers'
    ``--profile DIR`` (None: no-op).  It records the card's kernels when a
    card is present and the host's ops always."""
    if trace_dir is None:
        yield None
        return
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(trace_dir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))


def _ensure_host(name: str, v: Any) -> Any:
    """The no-extra-device-sync guard: recording a tensor could copy it
    from the card, a transfer the step did not already pay for, so every
    ``torch.Tensor`` is refused and the producer converts at its own sync
    point.  (torch is looked up in ``sys.modules``: where it was never
    imported there is nothing to guard.)"""
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(v, torch.Tensor):
        raise TypeError(
            f"telemetry value {name!r} is a torch.Tensor: the recorder only "
            "consumes values already returned to host (no-extra-device-sync "
            "contract, obs/telemetry.py); convert with float()/int()/"
            ".tolist() at the step's own sync point")
    return v


# ------------------------------------------------------------- event types
@dataclasses.dataclass(frozen=True)
class TrainStep:
    """One adopted train step (train/train_loop.py).  ``nonfinite`` is
    the health count when the guardian already read it, else the
    ``NOT_SAMPLED`` sentinel."""
    KIND: ClassVar[str] = "train.step"
    step: int
    loss: float
    nonfinite: float
    lr_scale: float
    dt_s: float
    dt_ema_s: float
    tokens_per_s: float


@dataclasses.dataclass(frozen=True)
class Guardian:
    """Guardian lifecycle: ``action`` ∈ trip | rollback | backoff |
    recovery, in that order per incident.  ``step`` is the train-loop
    step the action refers to (trip: the step whose update was
    discarded; rollback/backoff/recovery: the healthy step training
    resumed from)."""
    KIND: ClassVar[str] = "guardian"
    action: str
    step: int
    detail: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class Checkpoint:
    """Checkpoint lifecycle: ``action`` ∈ save | promote | gc (promote =
    the healthy mark after surviving the guardian's health window)."""
    KIND: ClassVar[str] = "checkpoint"
    action: str
    step: int
    detail: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class RequestSpan:
    """One finished serve request — the whole lifecycle in one event
    (see the module docstring's span section)."""
    KIND: ClassVar[str] = "serve.span"
    rid: int
    outcome: str            # eos | max_new | guard
    enqueue_tick: int
    admit_tick: int
    first_token_tick: int   # -1: never produced a token
    finish_tick: int
    prefill_chunks: int
    n_tokens: int
    ttft_s: float           # admit -> first token wall time; -1: no token
    wall_s: float           # admit -> finish wall time


@dataclasses.dataclass(frozen=True)
class SweepRound:
    """Population-sweep scheduler event (``search/scheduler.run_sweep``):
    ``action`` ∈ rank (one per round, scores in ``detail``) | prune |
    quarantine | winner (one per affected member, its cohort/slot
    attached so the sweep ledger and the telemetry share one
    timeline)."""
    KIND: ClassVar[str] = "sweep.round"
    action: str
    round: int
    member: int = -1
    cohort: int = -1
    slot: int = -1
    detail: dict = dataclasses.field(default_factory=dict)


EVENT_TYPES = (TrainStep, Guardian, Checkpoint, RequestSpan, SweepRound)


# --------------------------------------------------------------- histogram
class Histogram:
    """Bounded sample window: the newest ``cap`` observations (deque) plus
    lifetime count/sum, so percentiles cover the recent window while the
    mean stays exact over the whole run."""

    __slots__ = ("samples", "count", "total")

    def __init__(self, cap: int = 65536):
        self.samples: deque = deque(maxlen=cap)
        self.count = 0
        self.total = 0.0

    def observe(self, v: float) -> None:
        v = float(v)
        self.samples.append(v)
        self.count += 1
        self.total += v

    def percentile(self, q: float) -> float:
        return percentile(self.samples, q)

    def summary(self) -> dict:
        if not self.samples:
            return {"count": 0}
        return {
            "count": self.count,
            "mean": self.total / self.count,
            "min": min(self.samples),
            "max": max(self.samples),
            "p50": self.percentile(50),
            "p90": self.percentile(90),
            "p99": self.percentile(99),
        }


# ---------------------------------------------------------------- recorder
class Recorder:
    """The flight recorder.  Construct with ``path=`` for a JSONL sink
    (or ``None`` for in-memory only), hand it to the producers
    (``train_loop.run(recorder=)``, ``ContinuousEngine(recorder=)``),
    and ``close()`` it (or use it as a context manager) when the run
    ends.  Several producers may share one recorder: their events land
    on one timeline, ordered by ``seq``."""

    def __init__(self, path: str | None = None, *, ring: int = 4096,
                 meta: dict | None = None, hist_cap: int = 65536):
        self.counters: dict[str, int] = {}
        self.gauges: dict[str, float] = {}
        self.hists: dict[str, Histogram] = {}
        self.ring: deque = deque(maxlen=ring)
        self.n_events = 0
        self._hist_cap = hist_cap
        self._t0 = time.time()
        self._sink: Optional[IO[str]] = None
        if path is not None:
            self._sink = open(path, "w")
            self._write_frame("meta", dict(meta or {}, t0=self._t0))

    # -- aggregates
    def count(self, name: str, n: int = 1) -> None:
        _ensure_host(name, n)
        self.counters[name] = self.counters.get(name, 0) + int(n)

    def gauge(self, name: str, value: float) -> None:
        _ensure_host(name, value)
        self.gauges[name] = float(value)

    def observe(self, name: str, value: float) -> None:
        _ensure_host(name, value)
        h = self.hists.get(name)
        if h is None:
            h = self.hists[name] = Histogram(self._hist_cap)
        h.observe(value)

    # -- events
    def emit(self, event) -> None:
        """Record one typed event (an EVENT_TYPES dataclass instance):
        append to the ring, stream to the JSONL sink."""
        if not isinstance(event, EVENT_TYPES):
            raise TypeError(f"emit() takes a telemetry event dataclass, "
                            f"got {type(event).__name__}")
        fields = dataclasses.asdict(event)
        for k, v in fields.items():
            _ensure_host(f"{event.KIND}.{k}", v)
        self.ring.append(event)
        if self._sink is not None:
            self._write_frame(event.KIND, fields)
        else:
            self.n_events += 1

    def events(self, kind: str | None = None) -> list:
        """Ring contents (newest-``ring`` events), optionally filtered."""
        return [e for e in self.ring if kind is None or e.KIND == kind]

    # -- lifecycle
    def summary(self) -> dict:
        return {
            "n_events": self.n_events,
            "counters": dict(self.counters),
            "gauges": dict(self.gauges),
            "histograms": {k: h.summary() for k, h in self.hists.items()},
        }

    def close(self) -> None:
        if self._sink is not None:
            self._write_frame("summary", self.summary())
            self._sink.close()
            self._sink = None

    def _write_frame(self, kind: str, fields: dict) -> None:
        rec = {"kind": kind, "ts": time.time(), "seq": self.n_events}
        rec.update(fields)
        self.n_events += 1
        self._sink.write(json.dumps(rec) + "\n")

    def __enter__(self) -> "Recorder":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):  # best-effort: never leak an unsummarized sink
        try:
            self.close()
        except Exception:
            pass


def read_events(path: str) -> tuple[dict, list[dict]]:
    """(meta, events) from a JSONL sink file.  ``meta`` is the header
    frame's fields ({} for a truncated file); ``events`` every non-frame
    line as a dict, in ``seq`` order.  The trailing ``summary`` frame, if
    the recorder was closed cleanly, is returned as the last event with
    ``kind == "summary"`` so reports can cross-check their own
    aggregation against the recorder's."""
    meta: dict = {}
    events: list[dict] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if rec.get("kind") == "meta":
                meta = {k: v for k, v in rec.items()
                        if k not in ("kind", "ts", "seq")}
            else:
                events.append(rec)
    return meta, events
