"""HTTP exporter: serves a registry's metrics in Prometheus text format.

A ``ThreadingHTTPServer`` on its own daemon thread; each scrape renders
the registry on the handler thread, so a slow scraper never blocks the
application (and, per the scrape-path rules in DESIGN.md §15.3, never
blocks the pager either — the render path takes no shard locks).

Off by default.  ``UMAP_TELEMETRY_PORT`` (unset/empty/``0`` = disabled)
turns it on process-wide; ``UMAP_TELEMETRY_HOST`` (default ``127.0.0.1``)
picks the bind address.  ``port=0`` in code binds an ephemeral port
(read it back from ``exporter.port`` — the test harness path).
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .registry import CONTENT_TYPE, TelemetryRegistry, default_registry

DEFAULT_HOST = "127.0.0.1"

_INDEX = (b"<html><head><title>umap telemetry</title></head>"
          b"<body><h1>umap telemetry</h1>"
          b'<p><a href="/metrics">/metrics</a></p></body></html>')


class _Handler(BaseHTTPRequestHandler):
    # set per-server in TelemetryExporter.start()
    registry: TelemetryRegistry

    def do_GET(self):  # noqa: N802 (http.server API)
        if self.path.split("?", 1)[0] == "/metrics":
            try:
                body = self.server.registry.render().encode("utf-8")
            except Exception as exc:  # render must never kill the server
                self.send_error(500, explain=f"scrape failed: {exc!r}")
                return
            self.send_response(200)
            self.send_header("Content-Type", CONTENT_TYPE)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif self.path == "/":
            self.send_response(200)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(_INDEX)))
            self.end_headers()
            self.wfile.write(_INDEX)
        else:
            self.send_error(404)

    def log_message(self, fmt, *args):  # silence per-scrape stderr noise
        pass


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True
    registry: TelemetryRegistry


class TelemetryExporter:
    def __init__(self, registry: Optional[TelemetryRegistry] = None,
                 port: int = 0, host: str = DEFAULT_HOST):
        self.registry = registry if registry is not None else default_registry()
        self._requested_port = port
        self.host = host
        self._server: Optional[_Server] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "TelemetryExporter":
        if self._server is not None:
            return self
        server = _Server((self.host, self._requested_port), _Handler)
        server.registry = self.registry
        self._server = server
        self._thread = threading.Thread(
            target=server.serve_forever, name="umap-telemetry-exporter",
            daemon=True)
        self._thread.start()
        return self

    @property
    def port(self) -> int:
        if self._server is None:
            return self._requested_port
        return self._server.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def close(self) -> None:
        server, self._server = self._server, None
        thread, self._thread = self._thread, None
        if server is not None:
            server.shutdown()
            server.server_close()
        if thread is not None:
            thread.join(timeout=5.0)
