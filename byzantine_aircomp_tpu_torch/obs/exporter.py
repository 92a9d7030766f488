"""Scrape endpoint: /metrics (Prometheus text format) + /healthz.

The port's copy of ``byzantine_aircomp_tpu/obs/exporter.py``: a stdlib
HTTP server on a daemon thread, so a run on the card can be watched by any
Prometheus-compatible scraper, or plain curl, with no client library.  The
server only READS the :class:`~.metrics.MetricsRegistry` (whose lock makes
each scrape a consistent point-in-time view); it never touches the
training thread, the device, the event stream or the record.

Lifecycle: the harness starts the exporter right after the registry is
built (so scrapes succeed while the first round is still being set up or
captured) and closes it in the same ``finally`` that closes the sinks, so
run end and crash both shut the port down and join the thread.  ``port=0``
binds a port the OS picks (tests); the bound port is on ``.port`` after
``start()``.  A failed bind raises from ``start()``.

``routes`` mounts extra endpoints on the same port without subclassing
the handler: a callable ``(method, raw_path, body, headers) ->
Optional[(status, content_type, body_bytes)]`` tried before the built-in
``/metrics``/``/healthz`` handling (``None`` falls through).  ``raw_path``
keeps the query string and ``headers`` is a plain lower-cased dict (the
experiment server's bearer-token check reads ``authorization``).  The
experiment server (``serve/server.py``) rides this hook, so one socket
serves both its run API and the scrape surface.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional

from .metrics import MetricsRegistry

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

#: extra-route hook: (method, raw_path_with_query, body, headers) ->
#: (status, content_type, body) or None to fall through to the built-ins
RouteFn = Callable[[str, str, bytes, Dict[str, str]], Optional[tuple]]


class MetricsExporter:
    """Background /metrics + /healthz server over one registry."""

    def __init__(
        self,
        registry: MetricsRegistry,
        port: int = 0,
        host: str = "0.0.0.0",
        health_fn: Optional[Callable[[], Dict[str, Any]]] = None,
        routes: Optional[RouteFn] = None,
    ) -> None:
        self.registry = registry
        self._requested_port = port
        self._host = host
        self._health_fn = health_fn
        self._routes = routes
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> Optional[int]:
        return self._server.server_address[1] if self._server else None

    def start(self) -> "MetricsExporter":
        if self._server is not None:
            return self
        exporter = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args) -> None:  # silence request spam
                pass

            def _reply(self, status: int, ctype: str, body: bytes) -> None:
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _try_routes(self, method: str) -> bool:
                if exporter._routes is None:
                    return False
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length) if length else b""
                headers = {k.lower(): v for k, v in self.headers.items()}
                hit = exporter._routes(method, self.path, body, headers)
                if hit is None:
                    return False
                self._reply(*hit)
                return True

            def do_POST(self) -> None:
                if not self._try_routes("POST"):
                    self._reply(404, "text/plain", b"")

            def do_GET(self) -> None:
                route = self.path.split("?", 1)[0]
                if self._try_routes("GET"):
                    pass
                elif route == "/metrics":
                    self._reply(200, CONTENT_TYPE, exporter.registry.render().encode())
                elif route == "/healthz":
                    health = exporter._health_fn() if exporter._health_fn else {"ok": True}
                    self._reply(200 if health.get("ok") else 503, "application/json",
                                json.dumps(health).encode())
                else:
                    self._reply(404, "text/plain", b"")

        self._server = ThreadingHTTPServer(
            (self._host, self._requested_port), Handler
        )
        self._server.daemon_threads = True
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name="aircomp-metrics-exporter",
            daemon=True,
        )
        self._thread.start()
        return self

    def close(self) -> None:
        server, thread = self._server, self._thread
        self._server = self._thread = None
        if server is not None:
            server.shutdown()
            server.server_close()
        if thread is not None:
            thread.join(timeout=5.0)

    def __enter__(self) -> "MetricsExporter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()
