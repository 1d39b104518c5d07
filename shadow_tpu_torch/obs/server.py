"""Stdlib-only background HTTP server for the live telemetry plane: the
counterpart of `shadow_tpu.obs.server`.

`MetricsServer` runs a `ThreadingHTTPServer` on a daemon thread bound
to 127.0.0.1 (`--metrics-port`; port 0 asks the kernel for an
ephemeral port, printed to stderr in a parseable line so harnesses can
find it). Three endpoints:

- `/metrics`      OpenMetrics exposition from `MetricsRegistry.render`
- `/healthz`      `HealthState.snapshot()` as JSON; HTTP 200 while ok
                  or degraded, 503 once failed
- `/summary.json` registry totals + health + flight-recorder occupancy
                  + scrape counts (scrape counts live here, NOT in
                  `/metrics`, which must stay byte-stable between
                  heartbeats)

Handler threads only *read* registry/health state (both are
internally locked); the run loop never blocks on a scrape.
"""

from __future__ import annotations

import http.server
import json
import sys
import threading


OPENMETRICS_CT = ("application/openmetrics-text; version=1.0.0; "
                  "charset=utf-8")


class BaseHandler(http.server.BaseHTTPRequestHandler):
    """Shared handler discipline of both HTTP planes (this metrics
    exporter and `serve.http`'s request plane): HTTP/1.1 with explicit
    Content-Length (keep-alive safe), silent access logs, and the one
    `_send` helper. Blocking socket work stays on the handler threads
    spawned by ThreadingHTTPServer, never on the window loop's or the
    launch worker's thread."""

    server_version = "shadow-tpu/1"
    protocol_version = "HTTP/1.1"

    OPENMETRICS_CT = OPENMETRICS_CT

    def log_message(self, format, *args):  # noqa: A002 - stdlib signature
        pass  # scrapes must not spam the run's stderr

    def _send(self, status: int, body: bytes, ctype: str) -> None:
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


class _Handler(BaseHandler):
    server_version = "shadow-tpu-metrics/1"

    def do_GET(self):  # noqa: N802 - stdlib signature
        srv: "MetricsServer" = self.server.owner  # type: ignore[attr-defined]
        path = self.path.split("?", 1)[0]
        if path == "/metrics":
            srv.count_scrape("metrics")
            body = srv.registry.render().encode("utf-8")
            self._send(200, body, self.OPENMETRICS_CT)
        elif path == "/healthz":
            srv.count_scrape("healthz")
            body = (json.dumps(srv.health.snapshot(), sort_keys=True)
                    + "\n").encode("utf-8")
            self._send(srv.health.http_status(), body,
                       "application/json")
        elif path == "/summary.json":
            srv.count_scrape("summary")
            doc = {
                "totals": srv.registry.totals(),
                "health": srv.health.snapshot(),
                "scrapes": srv.scrapes(),
            }
            if srv.recorder is not None:
                snap = srv.recorder.snapshot()
                doc["flight_recorder"] = {
                    "capacity": snap["capacity"],
                    "heartbeats": len(snap["heartbeats"]),
                    "events": len(snap["events"]),
                }
            body = (json.dumps(doc, sort_keys=True)
                    + "\n").encode("utf-8")
            self._send(200, body, "application/json")
        else:
            self._send(404, b"not found\n", "text/plain")


class MetricsServer:
    """Owns the ThreadingHTTPServer + its daemon thread.

    Usage: ``srv = MetricsServer(registry, health, recorder, port=0)``
    then ``srv.start()`` (prints the serving line with the resolved
    port), and ``srv.close()`` from the run loop's shutdown path.
    """

    def __init__(self, registry, health, recorder=None, *,
                 port: int = 0, host: str = "127.0.0.1",
                 _stream=None):
        self.registry = registry
        self.health = health
        self.recorder = recorder
        self._stream = _stream if _stream is not None else sys.stderr
        self._scrapes: dict[str, int] = {}
        self._scrape_lock = threading.Lock()
        self._httpd = http.server.ThreadingHTTPServer(
            (host, int(port)), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.owner = self  # type: ignore[attr-defined]
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> "MetricsServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="shadow-tpu-metrics", daemon=True)
        self._thread.start()
        host = self._httpd.server_address[0]
        print(f"metrics: serving http://{host}:{self.port}/metrics "
              "(+/healthz, /summary.json)",
              file=self._stream, flush=True)
        return self

    def count_scrape(self, endpoint: str) -> None:
        with self._scrape_lock:
            self._scrapes[endpoint] = self._scrapes.get(endpoint, 0) + 1

    def scrapes(self) -> dict:
        with self._scrape_lock:
            return dict(self._scrapes)

    def close(self) -> None:
        if self._thread is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)
        self._thread = None
