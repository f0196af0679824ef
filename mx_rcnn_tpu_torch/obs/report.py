"""Merge one run's observability artifacts into a single report.

The port's counterpart of the JAX package's ``tools/obs_report.py``
(whose ``build_report`` it matches on the same directory), runnable
where JAX is not installed:

    python -m mx_rcnn_tpu_torch.obs.report OBS_DIR [--stage-log LOG] \\
        [--out OBS_DIR/report.json] [--trace-out OBS_DIR/trace.json]

Inputs (all optional — the report carries whatever exists):

* ``<obs-dir>/journal.jsonl``   — typed event journal (``obs/journal.py``)
* ``<obs-dir>/spans.jsonl``     — finished spans, one Chrome-trace event
  per line
* ``<obs-dir>/flight_*.json``   — flight-recorder postmortem dumps
* ``--stage-log`` file(s)       — stdout with ``{"metric": ...}`` JSON
  lines

Outputs:

* ``--out`` (default ``<obs-dir>/report.json``) — counts per event kind,
  the reconstructed **incident timeline** (preemption, engine death,
  worker death, checkpoint, rollback ... in journal order), an **slo**
  section, the per-tenant and data-plane sections from the last
  ``metrics_flush`` snapshot, flight-dump summaries and any stage lines.
* ``--trace-out`` (default ``<obs-dir>/trace.json``; ``none`` skips it)
  — the span lines wrapped in a Chrome-trace ``{"traceEvents": [...]}``
  array, loadable in Perfetto next to the ``torch.profiler`` traces of
  ``utils/profiling.py``.

The last line of stdout is one JSON summary (``{"metric": "obs_report",
...}``).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

from mx_rcnn_tpu_torch.obs.metrics import parse_labels

# Event kinds that mark state changes in an incident, in no particular
# order — the TIMELINE order comes from the journal, these only filter
# routine chatter (metrics_flush, shed) out of it.
INCIDENT_KINDS = frozenset({
    "worker_death", "worker_retired", "worker_wedged", "service_fallback",
    "cache_quarantine", "shm_quarantine", "cache_evict",
    "guardian_rollback", "rollback_restored", "guardian_loss_spike",
    "training_diverged", "preempt_drain",
    "checkpoint_saved", "checkpoint_restored",
    "engine_dead", "engine_killed",
    "fleet_quarantine", "fleet_reinstate", "fleet_retire", "weight_swap",
    "breaker_transition", "ladder_transition",
    "slo_burn_start", "slo_burn_stop",
    "fleet_scale_up", "fleet_scale_down",
    "fleet_replica_added", "fleet_replica_retired",
    "gateway_weight_roll",
    "deploy_candidate", "deploy_shadow_start", "deploy_shadow_verdict",
    "deploy_promote", "deploy_reject", "deploy_rollback", "deploy_resume",
    "tenant_quota_tightened", "tenant_quota_restored",
})


def _slo_section(journal: list[dict], t0: float) -> dict:
    """Control-plane story from the journal alone: the error-budget
    trajectory (every ``metrics_flush`` snapshot carries the
    ``slo_error_budget_remaining{slo=...}`` gauge), burn-alert
    transitions, and the fleet-resize decisions with the signals the
    autoscaler acted on."""
    budget_timeline: list[dict] = []
    burn_alerts: list[dict] = []
    resize_decisions: list[dict] = []
    for rec in journal:
        kind = rec.get("kind")
        payload = rec.get("payload") or {}
        t_s = round(rec.get("ts", t0) - t0, 3)
        if kind == "metrics_flush":
            series = (payload.get("snapshot") or {}).get(
                "slo_error_budget_remaining"
            )
            if isinstance(series, dict) and series:
                point = {"t_s": t_s}
                for label, v in series.items():
                    # label is 'slo="availability"' — keep just the value.
                    name = label.split('"')[1] if '"' in label else label
                    point[name] = round(v, 6) if isinstance(v, float) else v
                budget_timeline.append(point)
        elif kind in ("slo_burn_start", "slo_burn_stop"):
            burn_alerts.append({
                "t_s": t_s, "event": kind.rsplit("_", 1)[-1],
                **{k: v for k, v in payload.items()},
            })
        elif kind in ("fleet_scale_up", "fleet_scale_down"):
            resize_decisions.append({
                "t_s": t_s,
                "direction": kind.rsplit("_", 1)[-1],
                **{k: v for k, v in payload.items()},
            })
    return {
        "budget_timeline": budget_timeline,
        "burn_alerts": burn_alerts,
        "resize_decisions": resize_decisions,
    }


def _pack_section(journal: list[dict]) -> dict:
    """Packing / zero-copy efficiency from the last ``metrics_flush``
    snapshot: the ``serve_batch_occupancy`` histogram collapsed to a
    device-call count + mean fill, and the shm ring counters — so a
    report always answers "were the device calls full and did the data
    plane copy" without re-scraping /metrics."""
    snap: dict = {}
    for rec in journal:
        if rec.get("kind") == "metrics_flush":
            s = (rec.get("payload") or {}).get("snapshot") or {}
            if s:
                snap = s  # keep the LAST flush (cumulative series)
    out: dict = {}
    occ = snap.get("serve_batch_occupancy")
    if isinstance(occ, dict) and occ:
        calls = sum(
            v.get("count", 0) for v in occ.values() if isinstance(v, dict)
        )
        filled = sum(
            v.get("sum", 0.0) for v in occ.values() if isinstance(v, dict)
        )
        out["batch_occupancy"] = {
            "device_calls": calls,
            "mean": round(filled / calls, 4) if calls else None,
        }
    for name in ("data_shm_bytes_total", "data_shm_ring_stalls_total",
                 "data_shm_quarantines_total",
                 "serve_cache_hits_total", "serve_cache_coalesced_total",
                 "serve_cache_evictions_total"):
        series = snap.get(name)
        if isinstance(series, dict) and series:
            out[name] = round(sum(
                v for v in series.values() if isinstance(v, (int, float))
            ), 2)
    size = snap.get("serve_cache_size")
    if isinstance(size, dict) and size:
        # Gauge: last value wins per series; one shared cache per router.
        vals = [v for v in size.values() if isinstance(v, (int, float))]
        if vals:
            out["serve_cache_size"] = vals[-1]
    return out


def _tenant_section(journal: list[dict], t0: float) -> dict:
    """Per-tenant story when multi-tenancy ran: request
    outcomes from the ``tenant``-labelled ``fleet_requests_total`` rows of
    the last ``metrics_flush`` snapshot, quota rejections from
    ``serve_quota_exceeded_total``, and the per-tenant burn/governor
    timeline (burn transitions on tenant-scoped SLOs plus quota
    tighten/restore actions).  Empty when the run had no tenancy — the
    metrics carry no ``tenant`` label then, by design."""
    snap: dict = {}
    for rec in journal:
        if rec.get("kind") == "metrics_flush":
            s = (rec.get("payload") or {}).get("snapshot") or {}
            if s:
                snap = s  # cumulative series: the LAST flush wins
    tenants: dict[str, dict] = {}

    def ent(name: str) -> dict:
        return tenants.setdefault(name, {
            "requests": {}, "quota_rejections": 0, "timeline": [],
        })

    series = snap.get("fleet_requests_total")
    if isinstance(series, dict):
        for key, v in series.items():
            lbl = parse_labels(key)
            name = lbl.get("tenant")
            if not name or not isinstance(v, (int, float)):
                continue
            outcomes = ent(name)["requests"]
            outcome = lbl.get("outcome", "?")
            outcomes[outcome] = outcomes.get(outcome, 0) + int(round(v))
    series = snap.get("serve_quota_exceeded_total")
    if isinstance(series, dict):
        for key, v in series.items():
            name = parse_labels(key).get("tenant")
            if name and isinstance(v, (int, float)):
                ent(name)["quota_rejections"] += int(round(v))
    for rec in journal:
        kind = rec.get("kind")
        if kind not in ("slo_burn_start", "slo_burn_stop",
                        "tenant_quota_tightened", "tenant_quota_restored"):
            continue
        payload = rec.get("payload") or {}
        name = payload.get("tenant")
        if not name:
            continue  # fleet-wide burn: not one tenant's story
        ent(name)["timeline"].append({
            "t_s": round(rec.get("ts", t0) - t0, 3), "kind": kind,
            **{k: v for k, v in payload.items() if k != "tenant"},
        })
    return tenants


def _read_jsonl(path: str) -> list[dict]:
    if not os.path.exists(path):
        return []
    out = []
    with open(path, "rb") as f:
        for line in f:
            try:
                rec = json.loads(line.decode("utf-8", "replace"))
            except ValueError:
                continue  # torn/corrupt line — same tolerance as obs.journal
            if isinstance(rec, dict):
                out.append(rec)
    return out


def _order_key(rec: dict):
    # Wall clock first (cross-process), monotonic as the tiebreaker
    # (same-process events can share a rounded wall timestamp).
    return (rec.get("ts", 0.0), rec.get("ts_mono_ns", 0))


def build_report(
    obs_dir: str, stage_logs: tuple[str, ...] = ()
) -> tuple[dict, list[dict]]:
    """(report dict, chrome-trace span events) for one obs directory."""
    journal = sorted(
        _read_jsonl(os.path.join(obs_dir, "journal.jsonl")), key=_order_key
    )
    spans = _read_jsonl(os.path.join(obs_dir, "spans.jsonl"))
    flights = []
    for path in sorted(glob.glob(os.path.join(obs_dir, "flight_*.json"))):
        try:
            with open(path) as f:
                dump = json.load(f)
        except (OSError, ValueError):
            continue
        flights.append({
            "path": path,
            "trigger": dump.get("trigger"),
            "run_id": dump.get("run_id"),
            "entries": len(dump.get("entries", [])),
            "kinds": sorted({
                e.get("kind") for e in dump.get("entries", [])
                if isinstance(e, dict) and e.get("kind")
            }),
        })

    t0 = journal[0]["ts"] if journal else 0.0
    events_by_kind: dict[str, int] = {}
    timeline = []
    for rec in journal:
        kind = rec.get("kind", "?")
        events_by_kind[kind] = events_by_kind.get(kind, 0) + 1
        if kind in INCIDENT_KINDS:
            timeline.append({
                "t_s": round(rec.get("ts", t0) - t0, 3),
                "subsystem": rec.get("subsystem"),
                "kind": kind,
                "pid": rec.get("pid"),
                "payload": rec.get("payload", {}),
            })

    stage_lines = []
    for log_path in stage_logs:
        if not os.path.exists(log_path):
            continue
        with open(log_path, "rb") as f:
            for line in f:
                try:
                    rec = json.loads(line.decode("utf-8", "replace"))
                except ValueError:
                    continue
                if isinstance(rec, dict) and ("metric" in rec or "bench" in rec):
                    stage_lines.append(rec)

    traces: dict[str, int] = {}
    for s in spans:
        tid = (s.get("args") or {}).get("trace_id")
        if tid:
            traces[tid] = traces.get(tid, 0) + 1

    report = {
        "obs_dir": os.path.abspath(obs_dir),
        "run_ids": sorted({r.get("run_id", "-") for r in journal}),
        "journal_records": len(journal),
        "events_by_kind": dict(sorted(events_by_kind.items())),
        "incident_timeline": timeline,
        "slo": _slo_section(journal, t0),
        "tenants": _tenant_section(journal, t0),
        "data_plane": _pack_section(journal),
        "spans": {
            "count": len(spans),
            "traces": len(traces),
            "max_spans_per_trace": max(traces.values(), default=0),
        },
        "flight_dumps": flights,
        "stage_lines": stage_lines,
    }
    return report, spans


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("obs_dir", help="directory obs.configure() wrote into")
    p.add_argument("--stage-log", action="append", default=[],
                   help="log with JSON metric lines (repeatable)")
    p.add_argument("--out", default=None, help="report path (default: <obs_dir>/report.json)")
    p.add_argument("--trace-out", default=None,
                   help="Chrome-trace wrap of spans.jsonl (default: <obs_dir>/trace.json; "
                        "'none' to skip)")
    args = p.parse_args(argv)
    if not os.path.isdir(args.obs_dir):
        p.error(f"{args.obs_dir} is not a directory")

    report, spans = build_report(args.obs_dir, tuple(args.stage_log))

    trace_out = args.trace_out
    if trace_out is None:
        trace_out = os.path.join(args.obs_dir, "trace.json")
    if trace_out != "none" and spans:
        with open(trace_out, "w") as f:
            json.dump({"traceEvents": spans}, f)
        report["trace_file"] = os.path.abspath(trace_out)

    out = args.out or os.path.join(args.obs_dir, "report.json")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"[obs_report] {report['journal_records']} journal record(s), "
          f"{report['spans']['count']} span(s), "
          f"{len(report['flight_dumps'])} flight dump(s) -> {out}",
          file=sys.stderr)
    print(json.dumps({
        "metric": "obs_report",
        "value": {
            "events": report["journal_records"],
            "incidents": len(report["incident_timeline"]),
            "spans": report["spans"]["count"],
            "flight_dumps": len(report["flight_dumps"]),
        },
        "path": os.path.abspath(out),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
