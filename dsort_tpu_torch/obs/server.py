"""Stdlib HTTP endpoint serving a `Telemetry` snapshot.

Counterpart of ``dsort_tpu/obs/server.py``: a daemon-threaded
``ThreadingHTTPServer`` with ``/metrics`` (Prometheus text,
`Telemetry.render_prometheus`), ``/json`` (`Telemetry.snapshot`) and
``/healthz``.  It binds localhost by default; ``port=0`` takes an
ephemeral port (`MetricsServer.port` reports it).  A request reads one
snapshot and never touches scheduler state, so a slow scraper cannot stall
a job.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from dsort_tpu_torch.utils.logging import get_logger

log = get_logger("obs.server")

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class MetricsServer:
    """Background HTTP server exposing one `Telemetry` registry."""

    def __init__(self, telemetry, port: int = 0, host: str = "127.0.0.1"):
        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # scrapes are not job events
                pass

            def do_GET(self):
                try:
                    if self.path.split("?")[0] == "/metrics":
                        body = telemetry.render_prometheus().encode("utf-8")
                        ctype = PROMETHEUS_CONTENT_TYPE
                    elif self.path.split("?")[0] == "/json":
                        body = (
                            json.dumps(telemetry.snapshot()) + "\n"
                        ).encode("utf-8")
                        ctype = "application/json"
                    elif self.path.split("?")[0] == "/healthz":
                        body, ctype = b"ok\n", "text/plain"
                    else:
                        self.send_error(404)
                        return
                except Exception as e:  # a torn snapshot must not 500-loop
                    log.warning("metrics snapshot failed: %s", e)
                    self.send_error(500)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.telemetry = telemetry
        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = int(self._httpd.server_address[1])
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name=f"dsort-metrics-{self.port}",
        )
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()

    def __enter__(self) -> "MetricsServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
