"""Stdlib-only HTTP request plane for the resident scenario service:
the counterpart of `shadow_tpu.serve.http`, with the same endpoints,
status codes and JSON bodies.

Mirrors `obs.server.MetricsServer`'s shape (ThreadingHTTPServer on a
daemon thread, `BaseHandler` discipline: HTTP/1.1 + Content-Length,
silent logs). Endpoints:

- POST /submit       scenario request JSON -> {"request_id", "class"}
                     (400 on a bad request, 503 draining or degraded)
- GET  /result/<id>  200 done/error/timeout record, 202 while
                     queued/running (the record carries streamed
                     progress), 404 unknown
- GET  /queue        packer (per-class depth + oldest-waiting age) +
                     cache + launch snapshot
- GET  /trace/<id>   the request's span tree (docs/18-Serve-Tracing.md);
                     404 when tracing is off (--trace-requests) or the
                     rid is unknown/evicted
- GET  /metrics      serve-plane OpenMetrics (`ServeMetrics.render`)
- GET  /healthz      {"status": "ok" | "draining" | "degraded"};
                     only "ok" is HTTP 200

Blocking socket work (accept/recv inside ThreadingHTTPServer) happens
ONLY on handler threads — never on the launch worker. A handler takes
the service's lock only to copy a record, so it stays light beside the
worker's dispatch-bound beat loop.
"""

from __future__ import annotations

import http.server
import json
import sys
import threading

from shadow_tpu_torch.obs.server import BaseHandler
from shadow_tpu_torch.serve.service import ServiceUnavailable, SimService

_MAX_BODY = 1 << 20  # a scenario request is a few hundred bytes


def _json_bytes(doc) -> bytes:
    return (json.dumps(doc, sort_keys=True) + "\n").encode("utf-8")


class ServeHandler(BaseHandler):
    server_version = "shadow-tpu-serve/1"

    @property
    def _svc(self) -> SimService:
        return self.server.owner.service  # type: ignore[attr-defined]

    def do_POST(self):  # noqa: N802 - stdlib signature
        path = self.path.split("?", 1)[0]
        if path != "/submit":
            self._send(404, b"not found\n", "text/plain")
            return
        try:
            n = int(self.headers.get("Content-Length", 0))
            if n > _MAX_BODY:
                raise ValueError(f"body of {n} bytes exceeds {_MAX_BODY}")
            doc = json.loads(self.rfile.read(n) or b"{}")
            out = self._svc.submit(doc)
        except ServiceUnavailable as e:
            self._send(503, _json_bytes({"error": str(e)}),
                       "application/json")
            return
        except (ValueError, KeyError, TypeError) as e:
            self._send(400, _json_bytes({"error": str(e)}),
                       "application/json")
            return
        self._send(200, _json_bytes(out), "application/json")

    def do_GET(self):  # noqa: N802 - stdlib signature
        svc = self._svc
        path = self.path.split("?", 1)[0]
        if path.startswith("/result/"):
            rid = path[len("/result/"):]
            rec = svc.result(rid)
            if rec is None:
                self._send(404, _json_bytes({"error": f"unknown request "
                                             f"id {rid!r}"}),
                           "application/json")
            else:
                status = (200 if rec["status"] in ("done", "error",
                                                   "timeout") else 202)
                self._send(status, _json_bytes(rec), "application/json")
        elif path.startswith("/trace/"):
            rid = path[len("/trace/"):]
            tree = svc.trace(rid)
            if tree is not None:
                self._send(200, _json_bytes(tree), "application/json")
            elif svc.tracer is None:
                self._send(404, _json_bytes(
                    {"error": "tracing is off; start the service with "
                              "--trace-requests (docs/18-Serve-"
                              "Tracing.md)"}), "application/json")
            else:
                self._send(404, _json_bytes(
                    {"error": f"no trace for request id {rid!r} "
                              "(unknown or evicted)"}),
                    "application/json")
        elif path == "/queue":
            self._send(200, _json_bytes(svc.queue_snapshot()),
                       "application/json")
        elif path == "/metrics":
            body = svc.metrics.render().encode("utf-8")
            self._send(200, body, self.OPENMETRICS_CT)
        elif path == "/healthz":
            health = svc.health()
            self._send(200 if health["status"] == "ok" else 503,
                       _json_bytes(health), "application/json")
        else:
            self._send(404, b"not found\n", "text/plain")


class ServeServer:
    """Owns the ThreadingHTTPServer + its daemon thread (the exact
    MetricsServer lifecycle: `start()` prints a parseable serving line
    with the resolved port, `close()` from the shutdown path)."""

    def __init__(self, service: SimService, *, port: int = 0,
                 host: str = "127.0.0.1", _stream=None):
        self.service = service
        self._stream = _stream if _stream is not None else sys.stderr
        self._httpd = http.server.ThreadingHTTPServer(
            (host, int(port)), ServeHandler)
        self._httpd.daemon_threads = True
        self._httpd.owner = self  # type: ignore[attr-defined]
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> "ServeServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="shadow-tpu-serve-http", daemon=True)
        self._thread.start()
        host = self._httpd.server_address[0]
        print(f"serve: listening http://{host}:{self.port}/submit "
              "(+/result/<id>, /trace/<id>, /queue, /metrics, "
              "/healthz)",
              file=self._stream, flush=True)
        return self

    def close(self) -> None:
        if self._thread is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)
        self._thread = None
