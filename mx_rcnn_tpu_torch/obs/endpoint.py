"""Stdlib-only HTTP endpoint: /metrics, /healthz, /readyz, /statusz.

The port's own copy of ``mx_rcnn_tpu/obs/endpoint.py``.  A
``ThreadingHTTPServer`` on a daemon thread — no new dependencies, no
interference with process exit.  Port 0 binds an ephemeral port
(``server.port`` reports the real one), which is what the tests and
``chip_smoke.py`` use.  It binds 127.0.0.1 only.

``/healthz`` and ``/statusz`` ride registered *status providers*:
callables returning a JSON-able dict (such as ``engine.stats()``, which
wraps ``serve/health.py``'s snapshot).  ``/healthz`` returns 200 when every
provider that reports an ``alive`` field says True (503 otherwise);
``/statusz`` returns the full merged snapshot as JSON.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from .metrics import Registry

__all__ = ["MetricsServer"]

log = logging.getLogger(__name__)


class MetricsServer:
    """Daemon-thread HTTP server exposing one registry + status providers."""

    def __init__(self, registry: Registry, port: int = 0,
                 host: str = "127.0.0.1") -> None:
        self.registry = registry
        self._providers: dict[str, Callable[[], dict]] = {}
        self._plock = threading.Lock()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a) -> None:  # no stderr per scrape
                pass

            def _send(self, code: int, body: bytes,
                      ctype: str = "text/plain; charset=utf-8") -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self) -> None:  # noqa: N802 - http.server API
                path = self.path.split("?", 1)[0]
                try:
                    if path == "/metrics":
                        self._send(
                            200, outer.registry.render().encode("utf-8"),
                            "text/plain; version=0.0.4; charset=utf-8",
                        )
                    elif path == "/healthz":
                        ok, status = outer.health()
                        self._send(
                            200 if ok else 503,
                            (json.dumps(status) + "\n").encode("utf-8"),
                            "application/json",
                        )
                    elif path == "/readyz":
                        ok, status = outer.readiness()
                        self._send(
                            200 if ok else 503,
                            (json.dumps(status) + "\n").encode("utf-8"),
                            "application/json",
                        )
                    elif path == "/statusz":
                        self._send(
                            200,
                            (json.dumps(outer.status(), default=str,
                                        indent=2) + "\n").encode("utf-8"),
                            "application/json",
                        )
                    else:
                        self._send(404, b"not found\n")
                except Exception as e:  # noqa: BLE001 - scrape must not kill
                    try:
                        self._send(500, f"{type(e).__name__}: {e}\n".encode())
                    except OSError:
                        pass

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="obs-metrics-http",
            daemon=True,
        )

    def start(self) -> "MetricsServer":
        self._thread.start()
        log.info("obs: /metrics endpoint on 127.0.0.1:%d", self.port)
        return self

    def close(self) -> None:
        try:
            self._server.shutdown()
            self._server.server_close()
        except OSError:
            pass

    # -- status providers --------------------------------------------------

    def register_status(self, name: str, fn: Callable[[], dict]) -> None:
        """Register (or replace) a named snapshot provider for /statusz."""
        with self._plock:
            self._providers[name] = fn

    def unregister_status(self, name: str) -> None:
        with self._plock:
            self._providers.pop(name, None)

    def status(self) -> dict:
        with self._plock:
            providers = dict(self._providers)
        out = {}
        for name, fn in providers.items():
            try:
                out[name] = fn()
            except Exception as e:  # noqa: BLE001 - one bad provider != 500
                out[name] = {"error": f"{type(e).__name__}: {e}"}
        return out

    def health(self) -> tuple[bool, dict]:
        """(all-alive, per-provider alive map).  Providers that don't
        report ``alive`` count as healthy (they're stats, not liveness)."""
        status = self.status()
        alive = {
            name: bool(snap.get("alive", True))
            for name, snap in status.items()
            if isinstance(snap, dict)
        }
        ok = all(alive.values()) if alive else True
        return ok, {"ok": ok, "providers": alive}

    def readiness(self) -> tuple[bool, dict]:
        """Routability, distinct from liveness: 503 the moment any
        provider reports ``draining`` True or ``ready`` False, so an
        external balancer stops sending work while a drain
        completes — the process is still *alive* the whole time."""
        status = self.status()
        ready = {
            name: (
                bool(snap.get("ready", True))
                and not bool(snap.get("draining", False))
                and bool(snap.get("alive", True))
            )
            for name, snap in status.items()
            if isinstance(snap, dict)
        }
        ok = all(ready.values()) if ready else True
        return ok, {"ok": ok, "providers": ready}
