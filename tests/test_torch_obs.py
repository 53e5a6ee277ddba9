"""The port's flight-recorder telemetry against the contracts of
tests/test_obs.py, on the CPU.

Layers under test, bottom-up:
  * obs/telemetry: nearest-rank percentile (equal to the reference's),
    histogram and recorder mechanics, the JSONL round trip (files the
    reference's ``read_events`` reads too), and the no-extra-device-sync
    guard (recording any torch.Tensor is a TypeError);
  * artifacts: the meta stamp round-trips through the reference's BENCH
    loader and through ``obs_report --json``;
  * train/train_loop: a poisoned run emits trip -> rollback -> backoff
    -> recovery in order with the loop's own step ids, plus checkpoint
    save / promote events; without a guardian the per-step record carries
    NOT_SAMPLED;
  * serve/engine: every finished request reconstructs a full span
    (validated by launch/obs_report.check_span);
  * launch/obs_report: ``--check-spans`` passes a good sink and fails a
    broken one;
  * the no-extra-sync contract in place of the reference's "jaxpr
    unchanged" test: the port's host reads (``Tensor.item`` / ``tolist``
    / ``cpu`` / ``numpy`` / ``__array__`` and the scalar conversions)
    over a reduced serve run and three train steps are counted, and the
    counts are equal with and without a recorder.
"""
import collections
import contextlib
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.obs import telemetry as jtel

from repro_torch import artifacts
from repro_torch.configs.base import ArchConfig
from repro_torch.core.sparsity import SparsityConfig
from repro_torch.data.pipeline import LMTokenPipeline
from repro_torch.launch import obs_report
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as tlaunch
from repro_torch.launch.obs_report import build_report, check_span
from repro_torch.models import model as M
from repro_torch.obs import (Checkpoint, Guardian, Histogram, NOT_SAMPLED,
                             Recorder, RequestSpan, SweepRound, TrainStep,
                             percentile, profile_ctx, read_events)
from repro_torch.optim import constant_schedule, fused_sgd
from repro_torch.serve.engine import ContinuousEngine, Request, ServeConfig
from repro_torch.train.steps import make_train_step
from repro_torch.train.train_loop import GuardianConfig, TrainLoopConfig, run

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------- percentile helper
def test_percentile_single_sample():
    for q in (1, 50, 99, 100):
        assert percentile([7.25], q) == 7.25


def test_percentile_two_samples():
    """p50 of two is the smaller, p99 / p100 the max (never a value
    interpolated past the larger observation)."""
    assert percentile([2.0, 1.0], 50) == 1.0
    assert percentile([2.0, 1.0], 99) == 2.0
    assert percentile([2.0, 1.0], 100) == 2.0


def test_percentile_hundred_samples():
    xs = list(range(1, 101))
    assert [percentile(xs, q) for q in (1, 50, 99, 100)] == [1, 50, 99, 100]


def test_percentile_small_sample_p99_is_max():
    for n in (1, 2, 5, 50, 99):
        xs = np.random.default_rng(n).standard_normal(n).tolist()
        assert percentile(xs, 99) == max(xs)
        for q in (1, 10, 50, 90, 99, 100):
            assert percentile(xs, q) == jtel.percentile(xs, q)


def test_percentile_rejects_bad_input():
    with pytest.raises(ValueError):
        percentile([], 50)
    with pytest.raises(ValueError):
        percentile([1.0], 0)
    with pytest.raises(ValueError):
        percentile([1.0], 101)


# ------------------------------------------------------- recorder mechanics
def test_histogram_summary_and_window():
    h = Histogram(cap=4)
    for v in (5.0, 1.0, 2.0, 3.0, 4.0):     # 5.0 leaves the window
        h.observe(v)
    s = h.summary()
    assert s["count"] == 5 and s["mean"] == pytest.approx(3.0)
    assert s["min"] == 1.0 and s["max"] == 4.0
    assert h.percentile(99) == 4.0
    assert Histogram().summary() == {"count": 0}


def _step_event(i, loss=None):
    return TrainStep(step=i, loss=float(i) if loss is None else loss,
                     nonfinite=NOT_SAMPLED, lr_scale=1.0, dt_s=0.1,
                     dt_ema_s=0.1, tokens_per_s=10.0)


def test_recorder_ring_and_jsonl_round_trip(tmp_path):
    p = str(tmp_path / "obs.jsonl")
    with Recorder(p, ring=3, meta={"launcher": "test", "tag": "t"}) as r:
        r.count("steps", 2)
        r.count("steps")
        r.gauge("lr", 0.5)
        r.observe("dt", 0.25)
        for i in range(5):
            r.emit(_step_event(i))
    assert r.counters["steps"] == 3
    assert [e.step for e in r.events("train.step")] == [2, 3, 4]
    meta, events = read_events(p)
    assert meta["launcher"] == "test" and meta["tag"] == "t"
    steps = [e for e in events if e["kind"] == "train.step"]
    assert [e["step"] for e in steps] == [0, 1, 2, 3, 4]
    assert [e["seq"] for e in events] == sorted(e["seq"] for e in events)
    assert events[-1]["kind"] == "summary"
    assert events[-1]["counters"]["steps"] == 3
    assert events[-1]["histograms"]["dt"]["count"] == 1
    # the reference's reader takes the port's file as it is
    assert jtel.read_events(p) == (meta, events)


def test_event_schema_equals_reference():
    """Every event type has the reference's kind and fields, so one report
    reads the sinks of both packages."""
    for ours, ref in ((TrainStep, jtel.TrainStep), (Guardian, jtel.Guardian),
                      (Checkpoint, jtel.Checkpoint),
                      (RequestSpan, jtel.RequestSpan),
                      (SweepRound, jtel.SweepRound)):
        assert ours.KIND == ref.KIND
        assert ([(f.name, f.type) for f in dataclasses.fields(ours)]
                == [(f.name, f.type) for f in dataclasses.fields(ref)])
    assert NOT_SAMPLED == jtel.NOT_SAMPLED


def test_recorder_emit_rejects_untyped_events():
    with pytest.raises(TypeError):
        Recorder().emit({"kind": "train.step"})


def test_recorder_rejects_tensors():
    """The no-extra-device-sync guard: any tensor is refused (on the card
    reading one would copy it back), a host float is fine."""
    r = Recorder()
    for t in (torch.tensor(1.5), torch.ones(2), torch.tensor(3)):
        with pytest.raises(TypeError, match="no-extra-device-sync"):
            r.gauge("lr", t)
        with pytest.raises(TypeError, match="no-extra-device-sync"):
            r.observe("dt", t)
        with pytest.raises(TypeError, match="no-extra-device-sync"):
            r.count("steps", t)
        with pytest.raises(TypeError, match="no-extra-device-sync"):
            r.emit(_step_event(0, loss=t))
    r.gauge("lr", float(torch.tensor(1.5)))
    assert r.gauges["lr"] == 1.5 and r.n_events == 0


def test_profile_ctx_writes_a_chrome_trace(tmp_path):
    with profile_ctx(None) as prof:
        assert prof is None
    with profile_ctx(str(tmp_path / "prof")):
        torch.ones(4).add_(1)
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert trace["traceEvents"]


# -------------------------------------------------- artifact meta stamping
def test_artifact_meta_round_trips(tmp_path):
    from benchmarks.run import load_artifact

    meta = artifacts.artifact_meta("obs-test")
    assert set(meta) == {"git_sha", "backend", "torch_version", "tag",
                         "timestamp"}
    assert meta["tag"] == "obs-test"
    assert meta["torch_version"] == torch.__version__
    assert meta["backend"] == ("cuda" if torch.cuda.is_available() else "cpu")
    assert isinstance(meta["git_sha"], str) and meta["git_sha"]
    stamped = tmp_path / "BENCH_stamped.json"
    stamped.write_text(json.dumps({"meta": meta, "results": {"x": 1.5}}))
    assert load_artifact(str(stamped)) == (meta, {"x": 1.5})


# ---------------------------------------------------- guardian event stream
N_IN, N_OUT, BATCH = 32, 8, 16


@dataclasses.dataclass
class PoisonPipeline:
    """(seed, step) regression stream, t = sigmoid(x @ w_true), with the
    chosen data steps poisoned by an infinite input."""
    w_true: np.ndarray
    poison_steps: frozenset = frozenset()
    seed: int = 0
    step: int = 0

    def state(self):
        return {"seed": self.seed, "step": self.step}

    def __iter__(self):
        return self

    def __next__(self):
        rng = np.random.default_rng((self.seed << 20) ^ self.step)
        x = rng.standard_normal((BATCH, N_IN)).astype(np.float32)
        t = 1.0 / (1.0 + np.exp(-(x @ self.w_true)))
        if self.step in self.poison_steps:
            x[0, 0] = np.inf
        self.step += 1
        return {"x": x, "t": t.astype(np.float32)}


def _w_true():
    return np.random.default_rng(7).standard_normal(
        (N_IN, N_OUT)).astype(np.float32) * 0.3


def _regression_step(lr=0.5, momentum=0.9):
    """A 5-argument train step (params, opt, batch, step, lr_scale) on one
    sigmoid layer, SGD with momentum; metrics as the port's steps give
    them (tensors the loop reads)."""
    def step_fn(params, opt_state, batch, step, lr_scale=1.0):
        x, t = torch.from_numpy(batch["x"]), torch.from_numpy(batch["t"])
        y = torch.sigmoid(x @ params["w"] + params["b"])
        err = y - t
        loss = torch.mean(err ** 2)
        g = 2 * err * y * (1 - y) / err.numel()
        grads = {"w": x.T @ g, "b": g.sum(0)}
        mom = {k: momentum * opt_state[k] + grads[k] for k in grads}
        new = {k: params[k] - lr * lr_scale * mom[k] for k in params}
        bad = sum((~torch.isfinite(v)).sum() for v in new.values())
        return new, mom, {"loss": loss, "nonfinite": bad.float()}
    params = {"w": torch.zeros(N_IN, N_OUT), "b": torch.zeros(N_OUT)}
    return step_fn, params, {k: torch.zeros_like(v) for k, v in params.items()}


def test_guardian_event_stream_matches_loop_state(tmp_path):
    """Poison at data step 12, ckpt_every 5: the trip at 12 rolls back to
    step 5 (the step-10 checkpoint had not survived its health window)."""
    step_fn, params, opt_state = _regression_step()
    total, poison_at = 30, 12
    g = GuardianConfig(health_window=5, lr_backoff=0.5, max_retries=3,
                       min_history=4)
    rec = Recorder(str(tmp_path / "obs.jsonl"))
    res = run(TrainLoopConfig(total, str(tmp_path / "ck"), ckpt_every=5,
                              log_every=5, guardian=g),
              step_fn, params, opt_state,
              PoisonPipeline(_w_true(), frozenset([poison_at])),
              log=lambda s: None, recorder=rec)
    rec.close()

    assert res["step"] == total
    trips = res["guardian"]["trips"]
    assert len(trips) == 1
    gev = rec.events("guardian")
    assert [e.action for e in gev] == ["trip", "rollback", "backoff",
                                      "recovery"]
    trip, rollback, backoff, recovery = gev
    assert trip.step == trips[0]["step"] == poison_at
    assert trip.detail["data_step"] == poison_at
    assert trip.detail["reason"] == trips[0]["reason"]
    assert rollback.step == 5 and rollback.detail["from_step"] == poison_at
    assert backoff.detail["lr_scale"] == res["guardian"]["lr_scale"] == 0.5
    assert recovery.step == rollback.step
    assert recovery.detail["lr_scale"] == 0.5
    assert rec.counters["train.guardian.trips"] == 1
    assert rec.gauges["train.lr_scale"] == 0.5

    meta, events = read_events(str(tmp_path / "obs.jsonl"))
    kinds = [(e["kind"], e.get("action")) for e in events]
    i_trip = kinds.index(("guardian", "trip"))
    i_rec = kinds.index(("guardian", "recovery"))
    assert i_trip < i_rec
    pre = [e for e in events[:i_trip] if e["kind"] == "train.step"]
    post = [e for e in events[i_rec:] if e["kind"] == "train.step"]
    assert pre[-1]["step"] == poison_at - 1
    assert post[0]["step"] == rollback.step
    assert all(e["lr_scale"] == 0.5 for e in post)
    assert all(e["nonfinite"] == 0.0 for e in pre + post)
    saves = [e["step"] for e in events
             if e["kind"] == "checkpoint" and e["action"] == "save"]
    promotes = [e["step"] for e in events
                if e["kind"] == "checkpoint" and e["action"] == "promote"]
    assert 5 in saves and 10 in saves and total in saves
    assert promotes == sorted(promotes) and len(promotes) >= 1
    assert all(s in saves for s in promotes)
    # the report renders the log in seq order
    report = build_report(events)
    assert [e["action"] for e in report["guardian"]
            if e["kind"] == "guardian"] == ["trip", "rollback", "backoff",
                                            "recovery"]


def test_checkpoint_gc_events(tmp_path):
    step_fn, params, opt_state = _regression_step()
    rec = Recorder()
    run(TrainLoopConfig(6, str(tmp_path / "ck"), ckpt_every=2, keep_last_k=1),
        step_fn, params, opt_state, PoisonPipeline(_w_true()),
        log=lambda s: None, recorder=rec)
    gc = [e for e in rec.events("checkpoint") if e.action == "gc"]
    assert gc and all(e.detail["removed"] for e in gc)
    assert rec.counters["train.ckpt.saves"] == 3


def test_train_steps_without_guardian_use_sentinel(tmp_path):
    step_fn, params, opt_state = _regression_step()
    rec = Recorder()
    run(TrainLoopConfig(6, str(tmp_path / "ck"), ckpt_every=50),
        step_fn, params, opt_state, PoisonPipeline(_w_true()),
        log=lambda s: None, recorder=rec)
    steps = rec.events("train.step")
    assert [e.step for e in steps] == list(range(6))
    assert all(e.nonfinite == NOT_SAMPLED for e in steps)
    assert all(e.tokens_per_s > 0 and e.dt_s > 0 for e in steps)
    assert rec.hists["train.dt_s"].count == 6


# ------------------------------------------------------ serve request spans
def _serve_cfg():
    return ArchConfig(
        name="obs-serve", family="dense", n_layers=2, d_model=128,
        n_heads=4, kv_heads=2, head_dim=32, d_ff=256, vocab=128,
        act="silu", max_seq=64, attn_chunk=32, dtype="float32",
        sparsity=SparsityConfig(density=0.25, block=32, where="ffn"))


SERVE = ServeConfig(max_new_tokens=8, eos_token=-1, slots=2, page_size=8,
                    prefill_chunk=8, max_seq=32)


def _requests(cfg, n=5, new=8):
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, cfg.vocab, size=(n, 12)).astype(np.int32)
    return [Request(rid=i, prompt=prompts[i], max_new_tokens=new,
                    arrival=2 * i) for i in range(n)]


def test_serve_spans_full_lifecycle(tmp_path):
    cfg = _serve_cfg()
    params = M.init(cfg, 0, "cpu")
    NEW = 8
    p = str(tmp_path / "serve.jsonl")
    rec = Recorder(p)
    ce = ContinuousEngine(cfg, params, SERVE, device="cpu", recorder=rec)
    outs = ce.serve(_requests(cfg, new=NEW))
    rec.close()
    plain = ContinuousEngine(cfg, params, SERVE, device="cpu")
    assert plain.serve(_requests(cfg, new=NEW)).keys() == outs.keys()
    assert plain.stats["launches"] == ce.stats["launches"]
    for k in ("ticks", "decode_ticks", "prefill_chunks"):
        assert plain.stats[k] == ce.stats[k]

    spans = rec.events("serve.span")
    assert sorted(s.rid for s in spans) == list(range(5))
    for s in spans:
        assert s.outcome == "max_new"
        assert (s.enqueue_tick <= s.admit_tick <= s.first_token_tick
                <= s.finish_tick)
    meta, events = read_events(p)
    ev_spans = [e for e in events if e["kind"] == "serve.span"]
    assert len(ev_spans) == 5
    for e in ev_spans:
        assert check_span(e) is None, check_span(e)
        assert e["n_tokens"] == NEW
        assert e["prefill_chunks"] >= 2     # 12-token prompt, 8-wide chunks
        assert e["ttft_s"] >= 0
    for rid, v in ce.stats["latency"].items():
        assert v["outcome"] == "max_new"
        assert v["n_tokens"] == NEW and v["ttft_s"] >= 0
        assert v["first_token_tick"] >= v["admitted"]
    assert rec.hists["serve.ttft_s"].count == 5
    assert rec.hists["serve.itl_s"].count == 5 * (NEW - 1)
    assert rec.gauges["serve.pages_in_use"] == 0
    assert rec.gauges["serve.slots_free"] == 2
    assert rec.counters["serve.finish.max_new"] == 5
    assert rec.counters["serve.ticks"] == ce.stats["ticks"]
    report = build_report(events)
    assert report["serve"]["requests"] == 5
    assert report["serve"]["outcomes"] == {"max_new": 5}
    assert report["serve"]["ttft_p99_s"] is not None


def test_serve_guard_span_outcome():
    cfg = _serve_cfg()
    params = M.init(cfg, 0, "cpu")
    params["final_norm"] = {k: torch.full_like(v, float("nan"))
                            for k, v in params["final_norm"].items()}
    rec = Recorder()
    ce = ContinuousEngine(cfg, params, dataclasses.replace(
        SERVE, max_new_tokens=4), device="cpu", recorder=rec)
    ce.serve(_requests(cfg, n=2, new=4))
    spans = rec.events("serve.span")
    assert len(spans) == 2
    for s in spans:
        assert s.outcome == "guard"
        assert s.first_token_tick == -1 and s.ttft_s == -1.0
        d = dataclasses.asdict(s)
        d["kind"] = s.KIND
        assert check_span(d) is None
    assert rec.counters["serve.finish.guard"] == 2
    assert ce.nonfinite_terminated == 2


# ------------------------------------------------------------- obs_report
def _span_sink(tmp_path, name, **override):
    p = str(tmp_path / name)
    with Recorder(p, meta={"launcher": "test"}) as r:
        for i in range(3):
            fields = dict(rid=i, outcome="max_new", enqueue_tick=i,
                          admit_tick=i + 1, first_token_tick=i + 3,
                          finish_tick=i + 9, prefill_chunks=2, n_tokens=6,
                          ttft_s=0.01, wall_s=0.05)
            if i == 1:
                fields.update(override)
            r.emit(RequestSpan(**fields))
    return p


@pytest.mark.parametrize("override,why", [
    ({"admit_tick": 0}, "before enqueue"),
    ({"first_token_tick": -1}, "no first token"),
    ({"n_tokens": 0}, "no output tokens"),
    ({"outcome": "lost"}, "unknown outcome"),
    ({"first_token_tick": 20}, "outside"),
])
def test_obs_report_check_spans(tmp_path, capsys, override, why):
    good = _span_sink(tmp_path, "good.jsonl")
    out_json = str(tmp_path / "report.json")
    assert obs_report.main([good, "--check-spans", "--json", out_json]) == 0
    assert "spans OK: 3/3" in capsys.readouterr().out
    stamped = json.loads(Path(out_json).read_text())
    assert set(stamped["meta"]) == {"git_sha", "backend", "torch_version",
                                    "tag", "timestamp"}
    assert stamped["report"]["serve"]["requests"] == 3
    bad = _span_sink(tmp_path, "bad.jsonl", **override)
    assert obs_report.main([bad, "--check-spans"]) == 1
    assert why in capsys.readouterr().err
    empty = str(tmp_path / "empty.jsonl")
    Recorder(empty).close()
    assert obs_report.main([empty, "--check-spans"]) == 1


# ------------------------------------------- no extra host read by telemetry
_HOST_READS = ("item", "tolist", "cpu", "numpy", "__array__", "__float__",
               "__int__", "__bool__")


@contextlib.contextmanager
def _count_host_reads():
    """Count every call of a tensor method that reads values back to the
    host, by name."""
    counts = collections.Counter()
    with pytest.MonkeyPatch.context() as mp:
        for name in _HOST_READS:
            orig = getattr(torch.Tensor, name)

            def wrap(self, *a, _orig=orig, _name=name, **k):
                counts[_name] += 1
                return _orig(self, *a, **k)
            mp.setattr(torch.Tensor, name, wrap)
        yield counts


def test_serve_host_reads_equal_with_and_without_recorder():
    cfg = _serve_cfg()
    params = M.init(cfg, 0, "cpu")
    seen = []
    for rec in (None, Recorder()):
        ce = ContinuousEngine(cfg, params, SERVE, device="cpu", recorder=rec)
        with _count_host_reads() as counts:
            outs = ce.serve(_requests(cfg))
        seen.append((dict(counts), {k: v.tolist() for k, v in outs.items()}))
    assert seen[0] == seen[1]
    assert sum(seen[0][0].values()) > 0, "the counter saw no read at all"
    assert len(rec.events("serve.span")) == 5


def test_train_host_reads_equal_with_and_without_recorder(tmp_path):
    cfg = ArchConfig(name="obs-train", family="dense", n_layers=2,
                     d_model=128, n_heads=4, kv_heads=4, head_dim=32,
                     d_ff=256, vocab=128, act="silu", max_seq=64,
                     attn_chunk=32, dtype="float32", param_dtype="float32",
                     fused_update=True,
                     sparsity=SparsityConfig(0.25, 32, "ffn"))
    opt = fused_sgd(constant_schedule(3e-2), momentum=0.9)
    seen = []
    for i, rec in enumerate((None, Recorder())):
        params = M.init(cfg, 0, "cpu")
        loop = TrainLoopConfig(3, str(tmp_path / f"ck{i}"), ckpt_every=100,
                               guardian=GuardianConfig())
        with _count_host_reads() as counts:
            res = run(loop, make_train_step(cfg, opt), params,
                      opt.init(params), LMTokenPipeline(cfg, 2, 16),
                      log=lambda s: None, recorder=rec)
        seen.append((dict(counts), res["step"]))
    assert seen[0] == seen[1]
    assert seen[0][0].get("__float__", 0) >= 6    # loss and nonfinite a step
    assert [e.step for e in rec.events("train.step")] == [0, 1, 2]
    assert all(e.nonfinite == 0.0 for e in rec.events("train.step"))


# --------------------------------------------------------------- launchers
def test_launchers_write_obs_and_profile(tmp_path, capsys):
    sink = str(tmp_path / "serve.jsonl")
    outs = tserve.main(["--reduce", "--sparse", "--continuous", "--device",
                        "cpu", "--requests", "3", "--prompt-len", "10",
                        "--max-new", "4", "--slots", "2", "--page-size", "8",
                        "--prefill-chunk", "8", "--obs", sink, "--profile",
                        str(tmp_path / "prof")])
    assert sorted(outs) == [0, 1, 2]
    meta, events = read_events(sink)
    assert meta["launcher"] == "serve" and meta["device"] == "cpu"
    spans = [e for e in events if e["kind"] == "serve.span"]
    assert len(spans) == 3 and all(check_span(e) is None for e in spans)
    assert (tmp_path / "prof" / "trace.json").is_file()
    assert obs_report.main([sink, "--check-spans"]) == 0

    tsink = str(tmp_path / "train.jsonl")
    res = tlaunch.main(["--reduce", "--sparse", "--steps", "2", "--batch",
                        "2", "--seq", "16", "--device", "cpu", "--ckpt",
                        str(tmp_path / "ck"), "--obs", tsink])
    assert res["step"] == 2
    meta, events = read_events(tsink)
    assert meta["launcher"] == "train"
    assert [e["step"] for e in events if e["kind"] == "train.step"] == [0, 1]
    assert "telemetry ->" in capsys.readouterr().out
