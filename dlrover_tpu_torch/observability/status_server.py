"""Plain-HTTP observatory endpoints on the master: ``/metrics`` +
``/status``.

Copy of ``dlrover_tpu/observability/status_server.py``.

The native C++ exporter (``observability/metrics.py``
``MetricsExporter``) serves per-RANK metrics on 28888+rank for the
training processes; the MASTER had no scrape surface at all — its
gauges (goodput ledger, node health, straggler scores, control-plane
rate) only existed in the registry file.  This server is the master's
own surface, deliberately dependency-free (``http.server`` from the
standard library, threaded, daemonized):

- ``GET /metrics`` — Prometheus text exposition of the master
  registry (health gauges refreshed on demand so a scrape never
  reads values staler than the snapshot it could have computed);
- ``GET /status``  — the full observatory snapshot as JSON (the same
  payload the ``JobStatusRequest`` RPC returns; ``scripts/top.py``
  can read either);
- anything else — 404.

Off by default: the master only starts it when ``--status_port`` is
given AND the observatory kill-switch is on.
"""

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from dlrover_tpu_torch.common.log import default_logger as logger


class StatusServer:
    """Threaded HTTP server wrapping a metrics registry + a status
    snapshot callable."""

    def __init__(
        self,
        port: int,
        registry=None,
        snapshot_fn: Optional[Callable[[], dict]] = None,
        health_engine=None,
        telemetry=None,
        serving_refresh=None,
        host: str = "0.0.0.0",
    ):
        self._port = port
        self._host = host
        self._registry = registry
        self._snapshot_fn = snapshot_fn
        self._health = health_engine
        #: the master's self-telemetry collector (None = self-obs
        #: off): its sweep gauges refresh at scrape time like the
        #: health engine's
        self._telemetry = telemetry
        #: zero-arg serving-plane refresh hook (None = no co-located
        #: serving engine or DLROVER_TPU_SERVE_OBS=0): lets a scrape
        #: pull the replica gauges/health current before rendering
        self._serving_refresh = serving_refresh
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        """The BOUND port (resolves a requested port of 0)."""
        if self._httpd is not None:
            return self._httpd.server_address[1]
        return self._port

    def _build_handler(self):
        server = self

        class _Handler(BaseHTTPRequestHandler):
            # one handler class per server instance so the closure
            # carries the registry/snapshot without globals
            def log_message(self, fmt, *args):  # noqa: N802
                pass  # scrapes must not spam the master's stdout

            def _send(self, code: int, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802
                path = self.path.split("?", 1)[0].rstrip("/") or "/"
                try:
                    if path == "/metrics":
                        if server._health is not None:
                            # scrape-time freshness: the throttled
                            # report-path refresh may be seconds old
                            server._health.refresh_gauges()
                        if server._telemetry is not None:
                            server._telemetry.refresh_gauges()
                        if server._serving_refresh is not None:
                            server._serving_refresh()
                        text = (
                            server._registry.render_text()
                            if server._registry is not None
                            else ""
                        )
                        self._send(
                            200,
                            text.encode(),
                            "text/plain; version=0.0.4",
                        )
                    elif path == "/status":
                        snap = (
                            server._snapshot_fn()
                            if server._snapshot_fn is not None
                            else {}
                        )
                        self._send(
                            200,
                            json.dumps(snap, default=str).encode(),
                            "application/json",
                        )
                    else:
                        self._send(404, b"not found\n", "text/plain")
                except Exception as e:  # noqa: BLE001 - a bad scrape must not kill the thread
                    try:
                        self._send(
                            500, f"{e}\n".encode(), "text/plain"
                        )
                    except OSError:
                        pass

        return _Handler

    def start(self):
        if self._httpd is not None:
            return
        self._httpd = ThreadingHTTPServer(
            (self._host, self._port), self._build_handler()
        )
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="status-server",
            daemon=True,
        )
        self._thread.start()
        logger.info(
            "observatory status server on :%d (/metrics, /status)",
            self.port,
        )

    def stop(self):
        if self._httpd is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
