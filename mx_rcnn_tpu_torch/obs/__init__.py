"""mx_rcnn_tpu_torch.obs — the observability plane (the port of
``mx_rcnn_tpu/obs/__init__.py``).

One host-side module for four telemetry surfaces:

* **journal**  — crash-safe typed JSONL event log (obs/journal.py)
* **metrics**  — process-wide registry + /metrics endpoint (obs/metrics.py,
  obs/endpoint.py)
* **spans**    — request/step tracing -> Chrome-trace JSON (obs/tracing.py)
* **flight**   — bounded ring dumped on death (obs/flight.py)

The plane is a process-wide singleton with two modes:

* **Unconfigured** (the default): events still derive their log lines
  (obs/events.py) and land in the flight ring; metrics still count
  in-process; nothing touches the filesystem, no endpoint binds and
  neither the engine nor the train loop opens a span.  Steady-state cost is a dict append.
* **Configured** (``obs.configure(out_dir=...)``, wired from the train
  loop via ``cfg.obs``): events append to ``<out_dir>/journal.jsonl``,
  finished spans to ``<out_dir>/spans.jsonl``, flight dumps to
  ``<out_dir>/flight_*.json``, and an optional ``/metrics`` HTTP
  endpoint serves the registry.  ``python -m mx_rcnn_tpu_torch.obs.report
  DIR`` merges a directory into one report.

Nothing here runs on the card: the plane reads the world from the host.
"""

from __future__ import annotations

import atexit
import logging
import os
import threading
import time
import uuid
from typing import Callable, Optional

from . import events as _events
from .flight import FlightRecorder
from .journal import Journal, read_journal
from .metrics import (
    DEFAULT_LATENCY_BUCKETS_S,
    Counter,
    Gauge,
    Histogram,
    Registry,
)
from .tracing import Span, Tracer, new_trace_id

__all__ = [
    "configure", "close", "reset", "is_configured", "out_dir", "run_id",
    "emit", "counter", "gauge", "histogram", "registry", "render_metrics",
    "span", "tracer", "new_trace_id", "spans_enabled",
    "flight_dump", "flight", "install_crash_handler",
    "register_status", "unregister_status", "metrics_port",
    "Journal", "read_journal", "Registry", "Counter", "Gauge", "Histogram",
    "Span", "Tracer", "FlightRecorder", "DEFAULT_LATENCY_BUCKETS_S",
]

log = logging.getLogger(__name__)

_lock = threading.RLock()
_registry = Registry()
_flight = FlightRecorder()
_tracer = Tracer()
_journal: Optional[Journal] = None
_server = None  # MetricsServer | None (lazy import keeps http out of the cold path)
_run_id: str = "-"
_out_dir: Optional[str] = None
_spans_fd: Optional[int] = None
_spans_on = True
_flush_thread: Optional[threading.Thread] = None
_flush_stop = threading.Event()
# Status providers survive endpoint off: /statusz needs a server, but the
# journal flush and flight dumps can still snapshot them.
_status_providers: dict[str, Callable[[], dict]] = {}


def _span_sink(s: Span) -> None:
    rec = s.to_chrome()
    _flight.record({"type": "span", **rec})
    fd = _spans_fd
    if fd is not None and _spans_on:
        import json

        try:
            os.write(fd, (json.dumps(rec, default=str) + "\n").encode())
        except OSError:
            pass


_tracer.set_sink(_span_sink)


# -- lifecycle ----------------------------------------------------------------


def configure(
    out_dir: str,
    run_id: Optional[str] = None,
    metrics_port: Optional[int] = None,
    spans: bool = True,
    flight_size: int = 512,
    flush_s: float = 0.0,
) -> str:
    """Turn on the durable surfaces.  Idempotent per process (a second
    call re-points the plane at the new directory).

    ``metrics_port``: None = no endpoint, 0 = ephemeral port (read it
    back via :func:`metrics_port`).  ``flush_s`` > 0 starts a background
    thread writing a ``metrics_flush`` journal event every period, so
    headless runs keep the registry's history.  Returns the run id.
    """
    global _journal, _server, _run_id, _out_dir, _spans_fd, _spans_on
    global _flight, _flush_thread
    with _lock:
        close()
        _run_id = run_id or (
            time.strftime("%Y%m%d-%H%M%S") + "-" + uuid.uuid4().hex[:6]
        )
        _out_dir = os.path.abspath(out_dir)
        os.makedirs(_out_dir, exist_ok=True)
        _journal = Journal(os.path.join(_out_dir, "journal.jsonl"), _run_id)
        _spans_on = bool(spans)
        _spans_fd = os.open(
            os.path.join(_out_dir, "spans.jsonl"),
            os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644,
        )
        new_ring = FlightRecorder(flight_size)
        for entry in _flight.entries():  # keep pre-configure history
            new_ring.record(entry)
        new_ring.out_dir = _out_dir
        new_ring.run_id = _run_id
        _flight = new_ring
        if metrics_port is not None and metrics_port >= 0:
            from .endpoint import MetricsServer

            _server = MetricsServer(_registry, port=metrics_port).start()
            for name, fn in _status_providers.items():
                _server.register_status(name, fn)
        if flush_s and flush_s > 0:
            _flush_stop.clear()
            _flush_thread = threading.Thread(
                target=_flush_loop, args=(float(flush_s),),
                name="obs-metrics-flush", daemon=True,
            )
            _flush_thread.start()
        emit("obs", "configured", {
            "out_dir": _out_dir,
            "metrics_port": metrics_port if _server is None else _server.port,
            "spans": _spans_on, "flush_s": flush_s,
        })
        return _run_id


def _flush_loop(period_s: float) -> None:
    while not _flush_stop.wait(period_s):
        flush_metrics()


def flush_metrics() -> None:
    """Write one metrics_flush event carrying the registry snapshot."""
    emit("obs", "metrics_flush", {"snapshot": _registry.snapshot()})


def close() -> None:
    """Flush + close every durable surface (leaves the in-memory ring,
    registry and status providers intact)."""
    global _journal, _server, _spans_fd, _out_dir, _flush_thread
    with _lock:
        _flush_stop.set()
        if _flush_thread is not None:
            _flush_thread.join(timeout=2.0)
            _flush_thread = None
        if _journal is not None:
            flush_metrics()
            _journal.close()
            _journal = None
        if _server is not None:
            _server.close()
            _server = None
        if _spans_fd is not None:
            try:
                os.close(_spans_fd)
            except OSError:
                pass
            _spans_fd = None
        _flight.out_dir = None
        _out_dir = None


def reset() -> None:
    """Test hook: close + fresh registry/ring/run-id (providers cleared)."""
    global _registry, _flight, _run_id
    with _lock:
        close()
        _registry = Registry()
        _flight = FlightRecorder()
        _run_id = "-"
        _status_providers.clear()


atexit.register(close)


def is_configured() -> bool:
    return _journal is not None


def out_dir() -> Optional[str]:
    return _out_dir


def run_id() -> str:
    return _run_id


def metrics_port() -> Optional[int]:
    s = _server
    return None if s is None else s.port


# -- events -------------------------------------------------------------------


def emit(
    subsystem: str,
    kind: str,
    payload: Optional[dict] = None,
    *,
    logger: Optional[logging.Logger] = None,
) -> dict:
    """Emit one typed event: flight ring always, journal when configured,
    and the derived log line (obs/events.py) through ``logger`` (or the
    obs logger).  Returns the event record.  Never raises."""
    payload = payload or {}
    rec = {
        "type": "event",
        "run_id": _run_id,
        "ts": round(time.time(), 3),
        "ts_mono_ns": time.monotonic_ns(),
        "pid": os.getpid(),
        "subsystem": subsystem,
        "kind": kind,
        "payload": payload,
    }
    try:
        _flight.record(rec)
        j = _journal
        if j is not None:
            j.write({k: v for k, v in rec.items() if k != "type"})
        lvl, line = _events.render(subsystem, kind, payload)
        lg = logger or log
        if lg.isEnabledFor(lvl):
            lg.log(lvl, "%s", line)
        _registry.counter(
            "obs_events_total", "typed events emitted",
        ).inc(subsystem=subsystem, kind=kind)
    except Exception:  # noqa: BLE001 - telemetry must never hurt the host
        pass
    return rec


# -- metrics ------------------------------------------------------------------


def registry() -> Registry:
    return _registry


def counter(name: str, help: str = "") -> Counter:
    return _registry.counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:
    return _registry.gauge(name, help)


def histogram(name: str, help: str = "", buckets=DEFAULT_LATENCY_BUCKETS_S
              ) -> Histogram:
    return _registry.histogram(name, help, buckets)


def render_metrics() -> str:
    return _registry.render()


def register_status(name: str, fn: Callable[[], dict]) -> None:
    """Expose a snapshot callable on /statusz (+ /healthz liveness when it
    reports an ``alive`` field).  Safe before or after configure()."""
    with _lock:
        _status_providers[name] = fn
        if _server is not None:
            _server.register_status(name, fn)


def unregister_status(name: str) -> None:
    with _lock:
        _status_providers.pop(name, None)
        if _server is not None:
            _server.unregister_status(name)


# -- spans --------------------------------------------------------------------


def tracer() -> Tracer:
    return _tracer


def spans_enabled() -> bool:
    return _spans_fd is not None and _spans_on


def span(name: str, *, subsystem: str = "app",
         trace_id: Optional[str] = None, parent_id: Optional[str] = None,
         attrs: Optional[dict] = None) -> Span:
    return _tracer.span(
        name, subsystem=subsystem, trace_id=trace_id, parent_id=parent_id,
        attrs=attrs,
    )


# -- flight recorder ----------------------------------------------------------


def flight() -> FlightRecorder:
    return _flight


def flight_dump(trigger: str, extra: Optional[dict] = None) -> Optional[str]:
    """Dump the ring; returns the artifact path (None when unconfigured)."""
    path = _flight.dump(trigger, extra)
    if path is not None:
        counter("obs_flight_dumps_total", "flight recorder dumps").inc(
            trigger=trigger
        )
        j = _journal
        if j is not None:
            j.write({
                "subsystem": "obs", "kind": "flight_dump",
                "payload": {"trigger": trigger, "path": path},
            })
    return path


def install_crash_handler() -> None:
    _flight.install_crash_handler()
