"""Request/step span tracing -> Chrome-trace (Perfetto-loadable) events.

The port's own copy of ``mx_rcnn_tpu/obs/tracing.py``.  Spans are
explicit host-side begin/end windows with ids:

* ``trace_id``   — one per request (or train step); a caller that passes
  its own trace_id to ``InferenceEngine.submit`` gets the engine's spans
  under it, so the whole request tree is one query away.
* ``span_id`` / ``parent_id`` — parent/child integrity (the engine's
  queue/device spans are children of its ``engine_request`` span, which
  is a child of the caller's ``parent_span_id`` when given).

Finished spans are appended to ``spans.jsonl`` — one Chrome-trace
complete event (``"ph": "X"``, ts/dur in microseconds) per line, via the
same single-``write(2)`` crash-safe discipline as the journal.  Load a
run in Perfetto/chrome://tracing by wrapping the lines in a JSON array
(``obs/report.py`` emits exactly that), where they sit beside the
``torch.profiler`` Chrome traces from ``utils/profiling.py``.

When the plane is unconfigured, spans still flow into the in-memory
flight ring (cheap dict append) so a crash dump carries the last
requests' timings even if nobody asked for a trace file.
"""

from __future__ import annotations

import os
import threading
import time
import uuid
from typing import Callable, Optional

__all__ = ["Span", "Tracer", "new_trace_id"]


def new_trace_id() -> str:
    return uuid.uuid4().hex[:16]


class Span:
    """One explicit begin/end window.  Context-manager or manual end()."""

    __slots__ = (
        "name", "subsystem", "trace_id", "span_id", "parent_id",
        "attrs", "_t0_ns", "dur_ns", "_tracer", "_ended", "_ts_wall",
    )

    def __init__(self, tracer: "Tracer", name: str, subsystem: str,
                 trace_id: Optional[str], parent_id: Optional[str],
                 attrs: Optional[dict]) -> None:
        self.name = name
        self.subsystem = subsystem
        self.trace_id = trace_id or new_trace_id()
        self.span_id = uuid.uuid4().hex[:16]
        self.parent_id = parent_id
        self.attrs = dict(attrs or {})
        self._tracer = tracer
        self._t0_ns = time.monotonic_ns()
        self._ts_wall = round(time.time(), 3)
        self.dur_ns = 0
        self._ended = False

    def child(self, name: str, attrs: Optional[dict] = None) -> "Span":
        return self._tracer.span(
            name, subsystem=self.subsystem, trace_id=self.trace_id,
            parent_id=self.span_id, attrs=attrs,
        )

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def end(self, **attrs) -> None:
        if self._ended:
            return
        self._ended = True
        if attrs:
            self.attrs.update(attrs)
        self.dur_ns = time.monotonic_ns() - self._t0_ns
        self._tracer._finish(self)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        self.end()

    def to_chrome(self) -> dict:
        """Chrome-trace "complete" event; ts/dur in microseconds on the
        process monotonic clock (one timeline per pid)."""
        return {
            "ph": "X",
            "name": self.name,
            "cat": self.subsystem,
            "ts": self._t0_ns / 1e3,
            "dur": self.dur_ns / 1e3,
            "pid": os.getpid(),
            "tid": threading.get_ident() % 2**31,
            "args": {
                "trace_id": self.trace_id,
                "span_id": self.span_id,
                "parent_id": self.parent_id,
                "ts_wall": self._ts_wall,
                **self.attrs,
            },
        }


class Tracer:
    """Span factory; routes finished spans to a sink (plane-installed)."""

    def __init__(self, sink: Optional[Callable[[Span], None]] = None) -> None:
        self._sink = sink

    def set_sink(self, sink: Optional[Callable[[Span], None]]) -> None:
        self._sink = sink

    def span(self, name: str, *, subsystem: str = "app",
             trace_id: Optional[str] = None,
             parent_id: Optional[str] = None,
             attrs: Optional[dict] = None) -> Span:
        return Span(self, name, subsystem, trace_id, parent_id, attrs)

    def _finish(self, span: Span) -> None:
        sink = self._sink
        if sink is not None:
            try:
                sink(span)
            except Exception:  # noqa: BLE001 - tracing must never throw up
                pass
