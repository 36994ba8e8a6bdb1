"""Metrics + debug snapshot endpoint (``launch/serve.py --metrics-port``).

Serves a registry and live component state over HTTP on a background
thread:

    GET /               JSON index of every mounted endpoint
    GET /metrics        Prometheus text exposition
    GET /metrics.json   flat JSON snapshot (same keys the bench JSONs use)
    GET /healthz        liveness probe (the process answers)
    GET /readyz         readiness probe: 503 until the engine's ``warmup()``
                        completed — load drivers must not count cold-compile
                        time as serving latency
    GET /debug/flight   the flight recorder's postmortem bundle, on demand
    GET /debug/<name>   any registered debug provider (slots, pool,
                        sessions, placement, ...) as JSON

Stdlib-only (``http.server``); fine for scrape-rate traffic, not a
user-facing proxy.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional

from repro_torch.obs import flightrec
from repro_torch.obs.metrics import MetricsRegistry


class MetricsServer:
    def __init__(self, registry: MetricsRegistry, port: int = 0,
                 host: str = "127.0.0.1", *,
                 ready_check: Optional[Callable[[], bool]] = None,
                 debug: Optional[Dict[str, Callable[[], Any]]] = None,
                 recorder: Optional[flightrec.FlightRecorder] = None):
        reg = registry
        self._debug: Dict[str, Callable[[], Any]] = dict(debug or {})
        srv = self

        class Handler(BaseHTTPRequestHandler):
            def _reply(self, body: bytes, ctype: str, code: int = 200):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _json(self, obj, code: int = 200):
                self._reply(json.dumps(obj, indent=1, default=str).encode(),
                            "application/json", code)

            def do_GET(self):
                if self.path == "/":
                    self._json({"endpoints": srv.endpoints()})
                elif self.path == "/metrics":
                    self._reply(reg.to_prometheus().encode(),
                                "text/plain; version=0.0.4")
                elif self.path == "/metrics.json":
                    self._json(reg.snapshot())
                elif self.path == "/healthz":
                    self._reply(b"ok\n", "text/plain")
                elif self.path == "/readyz":
                    if ready_check is None or ready_check():
                        self._reply(b"ready\n", "text/plain")
                    else:
                        self._reply(b"warming\n", "text/plain", 503)
                elif self.path == "/debug/flight":
                    rec = (recorder if recorder is not None
                           else flightrec.get_recorder())
                    self._json(rec.bundle(reg))
                elif self.path.startswith("/debug/"):
                    name = self.path[len("/debug/"):]
                    fn = srv._debug.get(name)
                    if fn is None:
                        self.send_error(404)
                        return
                    try:
                        self._json(fn())
                    except Exception as e:  # noqa: BLE001 — debug surface
                        self._json({"error": f"{type(e).__name__}: {e}"},
                                   code=500)
                else:
                    self.send_error(404)

            def log_message(self, *args):       # scrapes are not news
                pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._thread: Optional[threading.Thread] = None

    def add_debug(self, name: str, fn: Callable[[], Any]) -> None:
        """Mount (or replace) ``/debug/<name>``."""
        self._debug[name] = fn

    def endpoints(self):
        return (["/metrics", "/metrics.json", "/healthz", "/readyz",
                 "/debug/flight"]
                + sorted(f"/debug/{n}" for n in self._debug))

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "MetricsServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="metrics-httpd", daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


def serve_metrics(registry: MetricsRegistry, port: int = 0,
                  host: str = "127.0.0.1", *,
                  ready_check: Optional[Callable[[], bool]] = None,
                  debug: Optional[Dict[str, Callable[[], Any]]] = None,
                  recorder: Optional[flightrec.FlightRecorder] = None
                  ) -> MetricsServer:
    """Start serving ``registry`` in the background; returns the server
    (``.port`` for the bound port, ``.stop()`` to shut down)."""
    return MetricsServer(registry, port, host, ready_check=ready_check,
                         debug=debug, recorder=recorder).start()
