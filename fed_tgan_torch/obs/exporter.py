"""In-trainer telemetry exporter: /metrics, /healthz, /journal over HTTP
(counterpart of ``fed_tgan_tpu/obs/exporter.py:49-231``).

The live half of the observability plane: while ``obs report`` reads a
finished journal, the exporter lets dashboards and ``obs watch`` see a
run *in flight*.  It is a daemon-threaded stdlib HTTP server started
inside the training process (opt-in via ``--obs-port``), so it must be
invisible to the device: every endpoint reads host-side state only --
the process metrics registry, a :class:`HealthState` dict the trainer
updates with values it already holds on the host, and the journal file
on disk.  No endpoint touches a CUDA tensor; the module never imports
torch.

Endpoints:

``/metrics``
    The process-wide registry in Prometheus text format
    (``render_prometheus()``), including the per-client labeled ledger
    series the trainer publishes.

``/healthz``
    JSON snapshot of training health: round progress, rounds/s,
    watchdog alarm/rollback counts, quarantine census, cohort info.

``/journal``
    The run journal as NDJSON.  ``?offset=N`` returns bytes from file
    offset ``N`` (incremental polling; the response carries the next
    offset in ``X-Journal-Offset``).  ``?follow=1`` keeps the socket
    open and tail-streams new lines as the trainer appends them, until
    the client disconnects or the exporter drains.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional
from urllib.parse import parse_qs, urlparse

from fed_tgan_torch.obs.journal import get_journal
from fed_tgan_torch.obs.registry import get_registry

__all__ = ["HealthState", "TelemetryExporter", "get_health"]

_FOLLOW_POLL_S = 0.1


class HealthState:
    """Thread-safe bag of host-side health fields for ``/healthz``.

    Writers (trainer, watchdog, multihost ranks) call ``update`` with
    plain scalars/lists they already hold on host -- a dict merge under
    a lock, nothing device-visible.  Readers get a copy via
    ``snapshot``.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._fields: Dict[str, object] = {}
        self._started = time.time()

    def update(self, **fields) -> None:
        with self._lock:
            self._fields.update(fields)
            self._fields["updated_ts"] = round(time.time(), 3)

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            out = dict(self._fields)
        out.setdefault("status", "idle")
        out["uptime_s"] = round(time.time() - self._started, 3)
        return out

    def reset(self) -> None:
        with self._lock:
            self._fields.clear()


_HEALTH = HealthState()


def get_health() -> HealthState:
    """The process-wide health state the exporter serves at /healthz."""
    return _HEALTH


def _make_handler(exporter: "TelemetryExporter"):
    class _Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *args) -> None:  # quiet by design
            pass

        def _send(self, code: int, body: bytes, ctype: str,
                  extra: Optional[Dict[str, str]] = None) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (extra or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self) -> None:  # noqa: N802 (stdlib handler API)
            parsed = urlparse(self.path)
            try:
                if parsed.path == "/metrics":
                    body = exporter.registry.render_prometheus().encode()
                    self._send(200, body, "text/plain; version=0.0.4")
                elif parsed.path == "/healthz":
                    body = json.dumps(exporter.health.snapshot(),
                                      default=str).encode()
                    self._send(200, body, "application/json")
                elif parsed.path == "/journal":
                    self._journal(parse_qs(parsed.query))
                else:
                    self._send(404, b"not found", "text/plain")
            except (BrokenPipeError, ConnectionResetError):
                pass  # client went away mid-response

        def _journal(self, query) -> None:
            path = exporter.journal_path
            if path is None:
                self._send(404, b"no journal installed", "text/plain")
                return
            try:
                offset = int(query.get("offset", ["0"])[0])
            except ValueError:
                offset = 0
            follow = query.get("follow", ["0"])[0] in ("1", "true")
            try:
                fh = open(path, "rb")
            except OSError:
                self._send(404, b"journal file missing", "text/plain")
                return
            with fh:
                fh.seek(offset)
                data = fh.read()
                if not follow:
                    self._send(200, data, "application/x-ndjson",
                               {"X-Journal-Offset": str(offset + len(data))})
                    return
                # follow mode: close-delimited stream, flushed per poll
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("Connection", "close")
                self.end_headers()
                while True:
                    if data:
                        self.wfile.write(data)
                        self.wfile.flush()
                    if exporter.draining:
                        return
                    time.sleep(_FOLLOW_POLL_S)
                    data = fh.read()

    return _Handler


class TelemetryExporter:
    """Opt-in background HTTP exporter for one training process.

    Lifecycle mirrors ``serve.service.SamplingService``: ``start()`` binds
    and spins a daemon serve thread, ``shutdown()`` drains follow
    streams, stops the server, and joins.  ``port=0`` binds an
    ephemeral port (tests); the bound port is ``self.port``.
    """

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 registry=None, journal_path: Optional[str] = None,
                 health: Optional[HealthState] = None) -> None:
        self._port = int(port)
        self.host = host
        self.registry = registry if registry is not None else get_registry()
        self._journal_path = journal_path
        self.health = health if health is not None else get_health()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self.draining = False

    @property
    def journal_path(self) -> Optional[str]:
        if self._journal_path is not None:
            return self._journal_path
        j = get_journal()
        return j.path if j is not None else None

    @property
    def port(self) -> int:
        if self._httpd is not None:
            return self._httpd.server_address[1]
        return self._port

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "TelemetryExporter":
        if self._httpd is not None:
            return self
        handler = _make_handler(self)
        self._httpd = ThreadingHTTPServer((self.host, self._port), handler)
        self._httpd.daemon_threads = True
        self.draining = False
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            kwargs={"poll_interval": 0.05},
            name="obs-exporter",
            daemon=True,
        )
        self._thread.start()
        return self

    def shutdown(self) -> None:
        if self._httpd is None:
            return
        self.draining = True  # unblocks ?follow=1 streams
        time.sleep(_FOLLOW_POLL_S)
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        self._httpd = None
        self._thread = None

    def __enter__(self) -> "TelemetryExporter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.shutdown()
