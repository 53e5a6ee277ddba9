"""Render flight-recorder JSONL runs into a human summary.

    PYTHONPATH=src python -m repro_torch.launch.obs_report \
        OBS_train.jsonl OBS_serve.jsonl --check-spans --json OBS_report.json

Takes one or more ``--obs`` sink files (obs/telemetry.py), a train run,
a serve trace or any mix, and prints the merged timeline in four
sections: the train throughput curve, the guardian / checkpoint event
log, the per-request serve latency table (p50 / p99 by the shared
nearest-rank ``obs.percentile``) and the sweep round table.

``--check-spans`` also validates every ``serve.span`` event's lifecycle
(enqueue <= admit <= first token <= finish, tokens produced, a
guard-terminated request allowed no first token) and exits non-zero on
any violation.

``--json OUT`` writes the machine-readable report stamped with
``repro_torch.artifacts.artifact_meta``.
"""
from __future__ import annotations

import argparse
import json
import sys


def _downsample(xs: list, n: int) -> list:
    """At most n entries, evenly spaced, always keeping first and last."""
    if len(xs) <= n:
        return xs
    idx = [round(i * (len(xs) - 1) / (n - 1)) for i in range(n)]
    return [xs[i] for i in dict.fromkeys(idx)]


def check_span(ev: dict) -> str | None:
    """One serve.span lifecycle violation (str) or None when valid."""
    rid = ev.get("rid")
    if ev.get("outcome") not in ("eos", "max_new", "guard"):
        return f"span rid={rid}: unknown outcome {ev.get('outcome')!r}"
    if not ev.get("enqueue_tick", 0) <= ev.get("admit_tick", -1):
        return (f"span rid={rid}: admitted (tick {ev.get('admit_tick')}) "
                f"before enqueue (tick {ev.get('enqueue_tick')})")
    if ev.get("admit_tick", 0) > ev.get("finish_tick", -1):
        return (f"span rid={rid}: finished (tick {ev.get('finish_tick')}) "
                f"before admit (tick {ev.get('admit_tick')})")
    ft = ev.get("first_token_tick", -1)
    if ft >= 0:
        if not ev.get("admit_tick", 0) <= ft <= ev.get("finish_tick", 0):
            return (f"span rid={rid}: first token (tick {ft}) outside "
                    f"[admit, finish]")
        if ev.get("ttft_s", -1.0) < 0:
            return f"span rid={rid}: first token at tick {ft} but no ttft"
    elif ev.get("outcome") != "guard":
        return (f"span rid={rid}: no first token on a "
                f"{ev.get('outcome')}-finished request")
    if ev.get("n_tokens", 0) <= 0:
        return f"span rid={rid}: finished with no output tokens"
    if ev.get("prefill_chunks", 0) <= 0:
        return f"span rid={rid}: finished without prefilling"
    return None


def build_report(events: list[dict]) -> dict:
    """The merged report dict from a (possibly multi-file) event list."""
    from repro_torch.obs import percentile

    by_kind: dict[str, list[dict]] = {}
    for ev in events:
        by_kind.setdefault(ev.get("kind", "?"), []).append(ev)

    report: dict = {"n_events": len(events)}

    steps = by_kind.get("train.step", [])
    if steps:
        dts = [e["dt_s"] for e in steps if e.get("dt_s", 0) > 0]
        report["train"] = {
            "steps": len(steps),
            "first_loss": steps[0]["loss"], "last_loss": steps[-1]["loss"],
            "dt_p50_s": percentile(dts, 50) if dts else None,
            "dt_p99_s": percentile(dts, 99) if dts else None,
            "tokens_per_s_last_ema": (steps[-1]["tokens_per_s"]
                                      if steps else None),
            "curve": [{"step": e["step"], "loss": e["loss"],
                       "tokens_per_s": e["tokens_per_s"],
                       "dt_ema_s": e["dt_ema_s"]}
                      for e in _downsample(steps, 20)],
        }

    glog = by_kind.get("guardian", []) + by_kind.get("checkpoint", [])
    if glog:
        glog.sort(key=lambda e: e.get("seq", 0))
        report["guardian"] = [
            {"kind": e["kind"], "action": e["action"], "step": e["step"],
             "detail": e.get("detail", {})} for e in glog]

    spans = by_kind.get("serve.span", [])
    if spans:
        walls = [e["wall_s"] for e in spans]
        ttfts = [e["ttft_s"] for e in spans if e.get("ttft_s", -1) >= 0]
        outcomes: dict[str, int] = {}
        for e in spans:
            outcomes[e["outcome"]] = outcomes.get(e["outcome"], 0) + 1
        report["serve"] = {
            "requests": len(spans), "outcomes": outcomes,
            "wall_p50_s": percentile(walls, 50),
            "wall_p99_s": percentile(walls, 99),
            "ttft_p50_s": percentile(ttfts, 50) if ttfts else None,
            "ttft_p99_s": percentile(ttfts, 99) if ttfts else None,
            "spans": sorted(spans, key=lambda e: e["rid"]),
        }

    rounds = by_kind.get("sweep.round", [])
    if rounds:
        tbl = []
        for e in sorted(rounds, key=lambda e: (e["round"],
                                               e.get("seq", 0))):
            row = {"round": e["round"], "action": e["action"]}
            if e.get("member", -1) >= 0:
                row.update(member=e["member"], cohort=e["cohort"],
                           slot=e["slot"])
            if e.get("action") == "rank":
                row["live"] = e.get("detail", {}).get("live")
            tbl.append(row)
        report["sweep"] = tbl

    summaries = by_kind.get("summary", [])
    if summaries:
        report["recorder_summary"] = summaries[-1]
    return report


def _print_report(report: dict, log=print) -> None:
    tr = report.get("train")
    if tr:
        log(f"[obs] train: {tr['steps']} steps, loss "
            f"{tr['first_loss']:.4f} -> {tr['last_loss']:.4f}, "
            f"step p50 {tr['dt_p50_s']*1e3:.1f}ms "
            f"p99 {tr['dt_p99_s']*1e3:.1f}ms")
        for p in tr["curve"]:
            log(f"[obs]   step {p['step']:>6} loss {p['loss']:.4f} "
                f"{p['tokens_per_s']:.0f} tok/s "
                f"(ema {p['dt_ema_s']*1e3:.1f}ms)")
    for e in report.get("guardian", []):
        log(f"[obs] {e['kind']:>10} {e['action']:<9} step {e['step']:>6} "
            f"{e['detail']}")
    sv = report.get("serve")
    if sv:
        t50 = (f"{sv['ttft_p50_s']*1e3:.1f}" if sv["ttft_p50_s"] is not None
               else "-")
        t99 = (f"{sv['ttft_p99_s']*1e3:.1f}" if sv["ttft_p99_s"] is not None
               else "-")
        log(f"[obs] serve: {sv['requests']} requests {sv['outcomes']}, "
            f"wall p50 {sv['wall_p50_s']*1e3:.1f}ms "
            f"p99 {sv['wall_p99_s']*1e3:.1f}ms, "
            f"ttft p50 {t50}ms p99 {t99}ms")
        for s in sv["spans"]:
            log(f"[obs]   rid {s['rid']:>4} {s['outcome']:<8} "
                f"enq {s['enqueue_tick']:>4} adm {s['admit_tick']:>4} "
                f"tok1 {s['first_token_tick']:>4} "
                f"fin {s['finish_tick']:>4} "
                f"chunks {s['prefill_chunks']} n {s['n_tokens']} "
                f"wall {s['wall_s']*1e3:.1f}ms")
    for r in report.get("sweep", []):
        who = (f" member {r['member']} (cohort {r['cohort']} "
               f"slot {r['slot']})" if "member" in r else
               f" live={r.get('live')}")
        log(f"[obs] sweep round {r['round']}: {r['action']}{who}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("paths", nargs="+",
                    help="flight-recorder JSONL sink file(s)")
    ap.add_argument("--check-spans", action="store_true",
                    help="validate every serve.span lifecycle; exit 1 on "
                         "any violation")
    ap.add_argument("--json", default=None, metavar="OUT",
                    help="write the artifact_meta-stamped report JSON")
    ap.add_argument("--tag", default="obs",
                    help="artifact meta tag for --json")
    args = ap.parse_args(argv)

    from repro_torch.obs import read_events

    events: list[dict] = []
    for p in args.paths:
        meta, evs = read_events(p)
        print(f"[obs] {p}: {len(evs)} events "
              f"(meta: {meta.get('launcher', '?')})")
        events.extend(evs)

    report = build_report(events)
    _print_report(report)

    rc = 0
    if args.check_spans:
        spans = [e for e in events if e.get("kind") == "serve.span"]
        bad = [v for v in (check_span(e) for e in spans) if v]
        for v in bad:
            print(f"[obs] SPAN VIOLATION: {v}", file=sys.stderr)
        if not spans:
            print("[obs] SPAN VIOLATION: --check-spans with no serve.span "
                  "events", file=sys.stderr)
            rc = 1
        elif bad:
            rc = 1
        else:
            print(f"[obs] spans OK: {len(spans)}/{len(spans)} requests "
                  "reconstruct a full lifecycle")

    if args.json:
        from repro_torch.artifacts import artifact_meta
        with open(args.json, "w") as f:
            json.dump({"meta": artifact_meta(args.tag), "report": report},
                      f, indent=1)
        print(f"[obs] report -> {args.json}")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
