"""A copy of ``repro.obs.server`` (stdlib only).

Live telemetry endpoint: a stdlib-only HTTP server on a background
thread, engine-agnostic by construction.

The server never imports the engine — it takes *callables*:

* ``metrics_fn() -> str`` serves ``/metrics`` as Prometheus text
  exposition (``text/plain; version=0.0.4``), typically
  ``Engine.prometheus_text`` or ``MetricsRegistry.prometheus_text``;
* ``livez_fn() -> dict`` serves ``/livez`` as JSON — windowed live
  rates (``Engine.live_metrics``), callable mid-run;
* ``trace_fn(since: int) -> (events, cursor, missed)`` serves
  ``/trace?since=N`` as JSON: an incremental trace-segment flush
  (``TraceRecorder.segment``), so a scraper can tail a run's trace
  without re-downloading the ring buffer each poll.

Callables the caller doesn't wire return 404 on their route.  Handler
exceptions become a 500 with the error name in the body — a broken
callable must never kill the serving thread.  ``port=0`` binds an
ephemeral port; :attr:`TelemetryServer.port` reports the bound one.

Threading note: the engine is single-threaded host code between its
steps; the registry mutates plain floats and the trace ring buffer is
snapshot-copied inside ``segment``, so read-only scrapes from this
thread race benignly (a scrape sees a value from one step or the
next, never a torn structure).
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable
from urllib.parse import parse_qs, urlparse

CONTENT_TYPE_METRICS = "text/plain; version=0.0.4; charset=utf-8"


class TelemetryServer:
    """``/metrics`` + ``/livez`` + ``/trace`` on a daemon thread."""

    def __init__(
        self,
        *,
        metrics_fn: Callable[[], str] | None = None,
        livez_fn: Callable[[], dict] | None = None,
        trace_fn: Callable[[int], tuple] | None = None,
        host: str = "127.0.0.1",
        port: int = 0,
    ):
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # no stderr chatter per scrape
                pass

            def _reply(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 (stdlib handler API)
                url = urlparse(self.path)
                try:
                    if url.path == "/metrics" and outer.metrics_fn is not None:
                        self._reply(200, outer.metrics_fn().encode(),
                                    CONTENT_TYPE_METRICS)
                    elif url.path == "/livez" and outer.livez_fn is not None:
                        body = json.dumps(outer.livez_fn()).encode()
                        self._reply(200, body, "application/json")
                    elif url.path == "/trace" and outer.trace_fn is not None:
                        q = parse_qs(url.query)
                        since = int(q.get("since", ["0"])[0])
                        events, cursor, missed = outer.trace_fn(since)
                        body = json.dumps({
                            "events": events, "cursor": cursor, "missed": missed,
                        }).encode()
                        self._reply(200, body, "application/json")
                    else:
                        self._reply(404, b"not found", "text/plain")
                except Exception as exc:  # a scrape must never kill the thread
                    msg = f"{type(exc).__name__}: {exc}".encode()
                    self._reply(500, msg, "text/plain")

        self.metrics_fn = metrics_fn
        self.livez_fn = livez_fn
        self.trace_fn = trace_fn
        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="repro-telemetry", daemon=True
        )
        self._thread.start()

    @property
    def port(self) -> int:
        """The actually-bound port (useful with ``port=0``)."""
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def close(self) -> None:
        self._httpd.shutdown()
        self._thread.join(timeout=5.0)
        self._httpd.server_close()

    def __enter__(self) -> "TelemetryServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
