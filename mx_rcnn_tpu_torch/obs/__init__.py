"""mx_rcnn_tpu_torch.obs — the observability plane, unconfigured.

The port of ``mx_rcnn_tpu/obs/__init__.py`` in the one mode the serving
engine uses unless ``obs.configure`` is called: events derive their log
lines (obs/events.py) and land in the flight ring (obs/flight.py);
metrics count in-process (obs/metrics.py); nothing touches the
filesystem, no endpoint binds and no span is recorded.  The configured
mode (``configure``, the journal, spans, flight dumps and the
``/metrics`` endpoint) is not ported yet, and neither are the engine's
calls into it (``spans_enabled``, ``flight_dump``).

Nothing here runs on the card: the plane reads the world from the host.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Optional

from . import events as _events
from .flight import FlightRecorder
from .metrics import (
    DEFAULT_LATENCY_BUCKETS_S,
    Counter,
    Gauge,
    Histogram,
    Registry,
)

__all__ = [
    "emit", "counter", "gauge", "histogram", "registry", "render_metrics",
    "flight",
    "Registry", "Counter", "Gauge", "Histogram", "FlightRecorder",
    "DEFAULT_LATENCY_BUCKETS_S",
]

log = logging.getLogger(__name__)

_registry = Registry()
_flight = FlightRecorder()
_run_id = "-"


# -- events -------------------------------------------------------------------


def emit(
    subsystem: str,
    kind: str,
    payload: Optional[dict] = None,
    *,
    logger: Optional[logging.Logger] = None,
) -> dict:
    """Emit one typed event: into the flight ring, and the derived log line
    (obs/events.py) through ``logger`` (or the obs logger).  Returns the
    event record.  Never raises."""
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


# -- flight recorder ----------------------------------------------------------


def flight() -> FlightRecorder:
    return _flight

