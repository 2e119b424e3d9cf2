"""Stdlib HTTP sampling server (counterpart of
``fed_tgan_tpu/serve/service.py:71-300, 391-460, 479``).

Handler threads validate and enqueue; one worker drains a bounded queue
and runs each request through the :class:`SamplingEngine`.  A full queue
sheds with 503.  Shutdown answers everything already queued, then stops.

Endpoints:

- ``GET /sample?rows&seed&offset&column&value&header``: ``text/csv``
  bytes; rows [offset, offset + rows) of stream ``seed``, so contiguous
  chunks concatenate to the one-shot response;
- ``GET /healthz``: JSON liveness, model id, device and counters.

Metrics, the journal, canary promotion, hot reload, the fleet and the
front door of the JAX package are not ported yet.
"""

from __future__ import annotations

import json
import queue
import threading
import time
import urllib.parse
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from fed_tgan_torch.serve.engine import ConditionError, SamplingEngine
from fed_tgan_torch.serve.registry import LoadedModel

_STOP = object()


@dataclass
class _Request:
    n: int
    seed: int
    offset: int
    condition: Optional[int]
    header: bool
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[bytes] = None
    error: Optional[str] = None
    status: int = 500


class SamplingService:
    """One engine behind a bounded-queue HTTP server."""

    def __init__(self, model: LoadedModel, host: str = "127.0.0.1",
                 port: int = 0, queue_size: int = 64,
                 request_timeout_s: float = 120.0):
        self.model = model
        self.engine = SamplingEngine(model)
        self.request_timeout_s = request_timeout_s
        self._host, self._port = host, port
        self._queue: queue.Queue = queue.Queue(maxsize=max(1, int(queue_size)))
        self._draining = threading.Event()
        self._counts_lock = threading.Lock()
        self.counts = {"requests": 0, "rows": 0, "errors": 0, "shed": 0}
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._worker_thread: Optional[threading.Thread] = None
        self._serve_thread: Optional[threading.Thread] = None

    # ----------------------------------------------------------- lifecycle

    def start(self) -> "SamplingService":
        self._httpd = ThreadingHTTPServer((self._host, self._port),
                                          _make_handler(self))
        self._httpd.daemon_threads = True
        self._worker_thread = threading.Thread(
            target=self._worker, name="serve-worker", daemon=True)
        self._worker_thread.start()
        self._serve_thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.05},
            name="serve-http", daemon=True)
        self._serve_thread.start()
        return self

    @property
    def port(self) -> int:
        assert self._httpd is not None, "start() first"
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self._host}:{self.port}"

    def shutdown(self) -> None:
        """Stop accepting, answer everything queued, stop."""
        self._draining.set()
        self._queue.put(_STOP)
        if self._worker_thread is not None:
            self._worker_thread.join(timeout=max(self.request_timeout_s, 10))
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        if self._serve_thread is not None:
            self._serve_thread.join(timeout=10)

    # -------------------------------------------------------- request path

    def _count(self, **deltas) -> None:
        with self._counts_lock:
            for k, v in deltas.items():
                self.counts[k] += v

    def submit(self, req: _Request) -> bool:
        """Enqueue; False = shed (queue full or draining)."""
        if self._draining.is_set():
            return False
        try:
            self._queue.put_nowait(req)
            return True
        except queue.Full:
            self._count(shed=1)
            return False

    def _worker(self) -> None:
        while True:
            req = self._queue.get()
            if req is _STOP:
                return
            try:
                req.result = self.engine.sample_csv_bytes(
                    req.n, seed=req.seed, offset=req.offset,
                    condition=req.condition, header=req.header)
                req.status = 200
                self._count(requests=1, rows=req.n)
            except Exception as exc:  # noqa: BLE001 — becomes the 500 body
                req.error, req.status = repr(exc), 500
                self._count(errors=1)
            finally:
                req.done.set()

    def health(self) -> dict:
        with self._counts_lock:
            counts = dict(self.counts)
        return {
            "status": "draining" if self._draining.is_set() else "ok",
            "model_id": self.model.model_id,
            "model_name": self.model.artifact.name,
            "device": str(self.engine.device),
            "queue_depth": self._queue.qsize(),
            **counts,
        }


def _make_handler(service: SamplingService):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # without NODELAY, Nagle + delayed ACK stall small responses ~40 ms
        disable_nagle_algorithm = True

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _send(self, status: int, body: bytes, ctype: str,
                  extra: Optional[dict] = None) -> None:
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (extra or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, status: int, obj: dict,
                       extra: Optional[dict] = None) -> None:
            self._send(status, json.dumps(obj).encode(), "application/json",
                       extra)

        def do_GET(self):
            parsed = urllib.parse.urlsplit(self.path)
            if parsed.path == "/healthz":
                self._send_json(200, service.health())
            elif parsed.path == "/sample":
                params = {k: v[-1] for k, v in
                          urllib.parse.parse_qs(parsed.query).items()}
                self._handle_sample(params)
            else:
                self._send_json(404, {"error": f"no route {parsed.path}"})

        def _handle_sample(self, params: dict) -> None:
            try:
                n = int(params.get("rows", 0))
                seed = int(params.get("seed", 0))
                offset = int(params.get("offset", 0))
                header = str(params.get("header", "1")) not in ("0", "false")
                if n <= 0:
                    raise ValueError(f"rows={n}: need a positive row count")
                if offset < 0:
                    raise ValueError(f"offset={offset}: must be >= 0")
            except ValueError as exc:
                self._send_json(400, {"error": str(exc)})
                return
            condition = None
            if params.get("column"):
                try:
                    condition = service.engine.resolve_condition(
                        params["column"], params.get("value"))
                except ConditionError as exc:
                    self._send_json(400, {"error": str(exc)})
                    return
            req = _Request(n=n, seed=seed, offset=offset,
                           condition=condition, header=header)
            if not service.submit(req):
                self._send_json(503, {"error": "draining" if
                                      service._draining.is_set()
                                      else "queue full"},
                                extra={"Retry-After": "1"})
                return
            if not req.done.wait(timeout=service.request_timeout_s):
                self._send_json(504, {"error": "request timed out in queue"})
                return
            if req.status == 200 and req.result is not None:
                self._send(200, req.result, "text/csv")
            else:
                self._send_json(req.status, {"error": req.error or "failed"})

    return Handler


# ------------------------------------------------------------------- CLI


def serve_main(argv=None) -> int:
    """``python -m fed_tgan_torch serve <artifact> [flags]``."""
    import argparse

    from fed_tgan_torch.serve.registry import ArtifactError, open_model

    ap = argparse.ArgumentParser(
        prog="python -m fed_tgan_torch serve",
        description="serve synthetic rows from a port artifact over HTTP")
    ap.add_argument("artifact", help="run out-dir / models dir / "
                    "synthesizer dir")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7799,
                    help="0 = ephemeral (printed at startup)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--allow-meta-mismatch", action="store_true",
                    help="serve even when the meta JSON postdates the "
                         "synthesizer")
    args = ap.parse_args(argv)
    try:
        model = open_model(args.artifact, device=args.device,
                           allow_meta_mismatch=args.allow_meta_mismatch)
    except ArtifactError as exc:
        print(f"serve: {exc}")
        return 2
    service = SamplingService(model, host=args.host, port=args.port).start()
    print(f"serving model {model.model_id} ({model.artifact.name}) on "
          f"{service.url} [{service.engine.device}] (endpoints: /sample "
          "/healthz; Ctrl-C drains and exits)", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        print("serve: draining...", flush=True)
        service.shutdown()
    return 0
