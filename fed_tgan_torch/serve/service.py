"""Stdlib HTTP sampling server and its CLI client (counterpart of
``fed_tgan_tpu/serve/service.py:71-365, 479-635``).

Request path: HTTP handler threads validate and enqueue; N batch workers
(``workers``) each drain their own shard of a bounded queue, coalescing
up to ``max_batch`` queued requests per cycle, and run them through the
engine against one :class:`~.engine.EngineSnapshot` per batch, so a hot
reload never swaps the model out from under requests already grouped.  A
``coalesce_window_s`` holds a forming batch for more traffic.  A full
queue sheds with 503 and a Retry-After taken from the drain rate of all
workers; a request that waits past ``request_timeout_s`` gets 504.
Worker 0 polls the :class:`~.registry.ModelRegistry` for a new
generation every ``reload_interval_s``.  Shutdown drains: new requests
are refused, everything already queued is answered, then the workers
exit.

Endpoints:

- ``GET/POST /sample``: rows/seed/offset/column/value/header; ``text/csv``
  rows [offset, offset + rows) of stream ``seed``, so contiguous chunks
  concatenate to the one-shot response (the engine's determinism
  contract);
- ``GET /healthz``: JSON liveness, model id, device, counters and the
  promotion state;
- ``GET /metrics``: Prometheus text.

``promote="canary"`` puts a :class:`~.canary.CanaryGate` on the reload
poll: a new generation is scored in shadow and adopted only when the
gate promotes it, so a rejected one never contributes a byte to a
response.  The process journal gets ``serve_stages`` (about one every
5 s while requests flow, and one at shutdown) and ``serve_reload``.
``serve --sanitize`` runs every steady chunk under the sanitizers' sync
guard (its copy to the host sanctioned) and reports the builds, the syncs
and the serving budget after the drain (exit 4 on a violation).
"""

from __future__ import annotations

import itertools
import json
import queue
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

from fed_tgan_torch.obs.journal import emit as _emit_event
from fed_tgan_torch.serve.engine import ConditionError, SamplingEngine
from fed_tgan_torch.serve.metrics import DrainRate, ServiceMetrics
from fed_tgan_torch.serve.registry import ModelRegistry

_STOP = object()


@dataclass
class _Request:
    n: int
    seed: int
    offset: int
    condition: Optional[int]
    header: bool
    enqueued_at: float = field(default_factory=time.time)
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[bytes] = None
    error: Optional[str] = None
    status: int = 500
    # stamped when a worker pulls the request off its queue; stage
    # seconds accumulate in ``stages`` (host clocks only)
    popped_at: float = 0.0
    stages: dict = field(default_factory=dict)


def stamp_wait(req, t_start: float) -> None:
    """``queue_wait`` ends at the pop, ``batch_form`` when this request's
    own processing starts (the wait behind earlier batch members), so the
    stages sum to the server-side latency."""
    popped = req.popped_at or t_start
    req.stages["queue_wait"] = max(0.0, popped - req.enqueued_at)
    req.stages["batch_form"] = max(0.0, t_start - popped)


class BatchWorkers:
    """N batch workers over a bounded queue sharded one shard per worker
    (round-robin admission; each worker drains only its own shard), with
    ``max_batch`` coalescing, the coalesce window, a reload poll on
    worker 0 and a draining shutdown.  Subclasses give ``_process`` (one
    formed batch) and ``_maybe_reload``."""

    def _init_queues(self, queue_size: int, workers: int, max_batch: int,
                     coalesce_window_s: float, request_timeout_s: float,
                     reload_interval_s: float) -> None:
        self.max_batch = max(1, int(max_batch))
        self.workers = max(1, int(workers))
        self.coalesce_window_s = max(0.0, float(coalesce_window_s))
        self.request_timeout_s = request_timeout_s
        self.reload_interval_s = reload_interval_s
        total = max(1, int(queue_size))
        per = -(-total // self.workers)
        self._queue_size = per * self.workers
        self._queues: List[queue.Queue] = [
            queue.Queue(maxsize=per) for _ in range(self.workers)]
        self._rr = itertools.count()
        self._drain_rate = DrainRate()
        self._last_stage_emit = float("-inf")
        self._draining = threading.Event()
        self._last_reload_check = time.monotonic()
        self._worker_threads: List[threading.Thread] = []

    def start_workers(self):
        """Start only the batch workers (no HTTP): the seam where a test
        enqueues a backlog first and then watches it batch."""
        self._worker_threads = [
            threading.Thread(target=self._worker, args=(i,),
                             name=f"serve-batch-worker-{i}", daemon=True)
            for i in range(self.workers)]
        for t in self._worker_threads:
            t.start()
        return self

    def queue_depth(self) -> int:
        return sum(q.qsize() for q in self._queues)

    def capacity_retry_after(self) -> float:
        """503 Retry-After: queued work over the measured drain rate of
        all workers, clamped to [0.05, 30] s; 1 s before any batch has
        completed."""
        rate = self._drain_rate.rate()
        if rate <= 0.0:
            return 1.0
        return min(30.0, max(0.05, (self.queue_depth() + 1) / rate))

    def _enqueue(self, req) -> bool:
        """Round-robin over the shards; a full shard tries the rest."""
        start = next(self._rr) % self.workers
        for j in range(self.workers):
            try:
                self._queues[(start + j) % self.workers].put_nowait(req)
                return True
            except queue.Full:
                continue
        return False

    def _stop_workers(self, drain: bool, fail) -> None:
        self._draining.set()
        if not drain:  # fail queued requests instead of computing them
            for q in self._queues:
                while True:
                    try:
                        req = q.get_nowait()
                    except queue.Empty:
                        break
                    if req is not _STOP:
                        fail(req)
        for q in self._queues:
            try:
                q.put_nowait(_STOP)
            except queue.Full:
                pass  # that worker is alive and draining; _draining ends it
        for t in self._worker_threads:
            t.join(timeout=max(self.request_timeout_s, 10))

    def _worker(self, wid: int = 0) -> None:
        q = self._queues[wid]
        while True:
            try:
                item = q.get(timeout=0.05)
            except queue.Empty:
                if self._draining.is_set():
                    return
                if wid == 0:  # one reload poller is enough
                    self._poll_reload()
                continue
            if item is _STOP:
                self._process(self._drain_remaining(q), wid)
                self._emit_stages(force=True)
                return
            item.popped_at = time.time()
            batch = [item]
            stop = False
            # hold a forming batch for at most coalesce_window_s while the
            # shard is quiet, so closed-loop clients land in this batch
            deadline = (time.monotonic() + self.coalesce_window_s
                        if self.coalesce_window_s > 0 else 0.0)
            while len(batch) < self.max_batch:
                try:
                    nxt = q.get_nowait()
                except queue.Empty:
                    wait = deadline - time.monotonic()
                    if wait <= 0 or self._draining.is_set():
                        break
                    try:
                        nxt = q.get(timeout=wait)
                    except queue.Empty:
                        break
                if nxt is _STOP:
                    stop = True
                    break
                nxt.popped_at = time.time()
                batch.append(nxt)
            self._process(batch, wid)
            self._emit_stages()
            if stop:
                self._process(self._drain_remaining(q), wid)
                self._emit_stages(force=True)
                return
            if wid == 0:
                self._poll_reload()

    def _drain_remaining(self, q: queue.Queue) -> list:
        batch = []
        while True:
            try:
                req = q.get_nowait()
            except queue.Empty:
                return batch
            if req is not _STOP:
                req.popped_at = time.time()
                batch.append(req)

    def _emit_stages(self, force: bool = False) -> None:
        """Rate-limited ``serve_stages`` journal summaries (about one every
        5 s, ``force`` at shutdown) of :meth:`_stage_snapshots`:
        ``{tenant or None: {stage: {count, p50_ms, p99_ms}}}``."""
        now = time.monotonic()
        if not force and now - self._last_stage_emit < 5.0:
            return
        snaps = self._stage_snapshots()
        if snaps:
            self._last_stage_emit = now
            for tenant, stages in snaps.items():
                _emit_event("serve_stages", stages=stages,
                            **({} if tenant is None else {"tenant": tenant}))

    def _poll_reload(self) -> None:
        if self.reload_interval_s <= 0:
            return
        now = time.monotonic()
        if now - self._last_reload_check < self.reload_interval_s:
            return
        self._last_reload_check = now
        self._maybe_reload()


class SamplingService(BatchWorkers):
    """One registry-backed engine behind a bounded-queue HTTP server; the
    model lives on the registry's device."""

    def __init__(self, registry: ModelRegistry, host: str = "127.0.0.1",
                 port: int = 0, max_batch: int = 8, queue_size: int = 64,
                 request_timeout_s: float = 120.0,
                 reload_interval_s: float = 5.0, workers: int = 1,
                 coalesce_window_s: float = 0.0, promote: str = "immediate",
                 canary_config=None, log=print):
        self.registry = registry
        self.engine = SamplingEngine(registry.get())
        self.metrics = ServiceMetrics()
        self._log = log
        # "immediate" adopts any loadable new generation; "canary" scores
        # it in shadow first and adopts only a promoted one
        self.promote_mode = str(promote)
        self.gate = None
        if self.promote_mode == "canary":
            from fed_tgan_torch.serve.canary import CanaryGate

            self.gate = CanaryGate(registry, self.engine,
                                   config=canary_config, log=log)
        self._host, self._port = host, port
        self._init_queues(queue_size, workers, max_batch, coalesce_window_s,
                          request_timeout_s, reload_interval_s)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._serve_thread: Optional[threading.Thread] = None

    # ----------------------------------------------------------- lifecycle

    def start(self) -> "SamplingService":
        self._httpd = ThreadingHTTPServer((self._host, self._port),
                                          _make_handler(self))
        self._httpd.daemon_threads = True
        self.start_workers()
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

    def shutdown(self, drain: bool = True) -> None:
        """Stop accepting, answer (or fail) everything queued, stop."""
        def fail(req):
            req.error, req.status = "server shutting down", 503
            req.done.set()

        self._stop_workers(drain, fail)
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        if self._serve_thread is not None:
            self._serve_thread.join(timeout=10)

    # -------------------------------------------------------- request path

    def submit(self, req: _Request) -> bool:
        """Enqueue; False = shed (queue full or draining)."""
        if self._draining.is_set():
            return False
        if self._enqueue(req):
            return True
        self.metrics.record_shed()
        return False

    def _process(self, batch: list, wid: int = 0) -> None:
        if not batch:
            return
        self.metrics.record_batch(len(batch))
        self.metrics.set_queue_depth(self.queue_depth())
        snap = self.engine.snapshot()  # one model for the whole batch
        for req in batch:
            stamp_wait(req, time.time())
            try:
                req.result = self.engine.sample_csv_bytes(
                    req.n, seed=req.seed, offset=req.offset,
                    condition=req.condition, header=req.header, snap=snap,
                    stages=req.stages)
                req.status = 200
                self.metrics.record_request(
                    time.time() - req.enqueued_at, req.n)
                self.metrics.record_stages(req.stages)
            except Exception as exc:  # noqa: BLE001 — becomes the 500 body
                req.error, req.status = repr(exc), 500
                self.metrics.record_error()
            finally:
                req.done.set()
        self._drain_rate.note(len(batch))

    def _maybe_reload(self) -> None:
        """The reload poll: an immediate reload, or under the canary only
        a promoted model is adopted."""
        try:
            if (self.gate.poll(self.metrics.quality) if self.gate is not None
                    else self.registry.maybe_reload()):
                kept = self.engine.adopt(self.registry.get())
                self.metrics.record_reload()
                _emit_event("serve_reload",
                            model_id=self.registry.get().model_id,
                            programs_kept=bool(kept))
                self._log(f"service: now serving model "
                          f"{self.registry.get().model_id} (layout "
                          f"{'kept' if kept else 'changed'})")
        except Exception as exc:  # noqa: BLE001 — reload never kills serving
            self._log(f"service: reload check failed ({exc!r})")

    def _stage_snapshots(self) -> dict:
        stages = self.metrics.stage_snapshot()
        return {None: stages} if stages else {}

    def health(self) -> dict:
        model = self.registry.get()
        return {
            "status": "draining" if self._draining.is_set() else "ok",
            "model_id": model.model_id,
            "model_name": model.artifact.name,
            "device": str(self.engine.device),
            **self.metrics.snapshot(self.queue_depth()),
            "stages": self.metrics.stage_snapshot(),
            "promotion": (self.gate.status() if self.gate is not None
                          else {"mode": self.promote_mode}),
        }


def parse_sample_params(params: dict) -> tuple:
    """(rows, seed, offset, header) of a sampling request; raises
    ``ValueError`` / ``TypeError`` on a bad value."""
    n = int(params.get("rows", params.get("n", 0)))
    seed = int(params.get("seed", 0))
    offset = int(params.get("offset", 0))
    header = str(params.get("header", "1")) not in ("0", "false")
    if n <= 0:
        raise ValueError(f"rows={n}: need a positive row count")
    if offset < 0:
        raise ValueError(f"offset={offset}: must be >= 0")
    return n, seed, offset, header


def read_json_body(handler: BaseHTTPRequestHandler) -> dict:
    length = int(handler.headers.get("Content-Length", "0"))
    params = json.loads(handler.rfile.read(length) or b"{}")
    if not isinstance(params, dict):
        raise ValueError("body must be a JSON object")
    return params


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
            elif parsed.path == "/metrics":
                text = service.metrics.render_prometheus(
                    service.queue_depth())
                self._send(200, text.encode(), "text/plain; version=0.0.4")
            elif parsed.path == "/sample":
                params = {k: v[-1] for k, v in
                          urllib.parse.parse_qs(parsed.query).items()}
                self._handle_sample(params)
            else:
                self._send_json(404, {"error": f"no route {parsed.path}"})

        def do_POST(self):
            parsed = urllib.parse.urlsplit(self.path)
            if parsed.path != "/sample":
                self._send_json(404, {"error": f"no route {parsed.path}"})
                return
            try:
                params = read_json_body(self)
            except ValueError as exc:
                self._send_json(400, {"error": f"bad JSON body: {exc}"})
                return
            self._handle_sample(params)

        def _handle_sample(self, params: dict) -> None:
            try:
                n, seed, offset, header = parse_sample_params(params)
            except (TypeError, ValueError) as exc:
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
                self._send_json(
                    503, {"error": "draining" if service._draining.is_set()
                          else "queue full"},
                    extra={"Retry-After":
                           f"{service.capacity_retry_after():.2f}"})
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


def start_sanitizers(args) -> None:
    """``--sanitize``: the sanitizers on before the first model loads
    (``fed_tgan_tpu/serve/service.py:527-530``)."""
    if args.sanitize:
        from fed_tgan_torch.analysis import sanitizers

        # before any CUDA work: cuBLAS reads its workspace setting once
        sanitizers.prepare_process()
        sanitizers.enable_sanitizers()


def finish_sanitizers(args, problems) -> int:
    """``--sanitize`` after the drain: the builds and syncs, then each of
    ``problems()`` (the budget's violations) as a ``SANITIZE:`` line; 4
    when there is one."""
    if not args.sanitize:
        return 0
    from fed_tgan_torch.analysis import sanitizers

    try:
        return sanitizers.report_and_check(problems())
    finally:
        sanitizers.disable_sanitizers()


def add_serving_flags(ap, max_batch: int, queue_size: int) -> None:
    """The flags ``serve`` and ``fleet`` share, with the JAX defaults."""
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7799,
                    help="0 = ephemeral (printed at startup)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--max-batch", type=int, default=max_batch,
                    help="max requests coalesced per worker cycle")
    ap.add_argument("--queue-size", type=int, default=queue_size,
                    help="bounded request queue; full = shed with 503")
    ap.add_argument("--workers", type=int, default=1,
                    help="batch workers draining a sharded queue")
    ap.add_argument("--coalesce-window", type=float, default=0.0,
                    help="seconds a worker holds a forming batch for more "
                         "traffic (0 = dispatch immediately)")
    ap.add_argument("--request-timeout", type=float, default=120.0,
                    help="seconds a request may wait before 504")
    ap.add_argument("--reload-interval", type=float, default=5.0,
                    help="seconds between hot-reload polls (0 = never)")
    ap.add_argument("--promote", choices=("canary", "immediate"),
                    default="immediate",
                    help="new-generation policy: immediate hot-swaps any "
                         "loadable generation (default); canary scores it "
                         "in shadow against the tenant's reference "
                         "statistics and promotes it only inside the "
                         "quality budgets of obs/budgets.json")
    ap.add_argument("--allow-meta-mismatch", action="store_true",
                    help="serve even when the meta JSON postdates the "
                         "synthesizer")
    ap.add_argument("--sanitize", action="store_true",
                    help="runtime sanitizers: the sync guard on the "
                         "steady sampling dispatch, deterministic "
                         "algorithms and a one-build-per-chunk-size "
                         "budget (exit 4 on violation)")
    ap.add_argument("--quiet", action="store_true")


def wait_for_interrupt(name: str, service) -> None:
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        print(f"{name}: draining...", flush=True)
        service.shutdown(drain=True)


def serve_main(argv=None) -> int:
    """``python -m fed_tgan_torch serve <artifact> [flags]``."""
    import argparse

    from fed_tgan_torch.serve.registry import ArtifactError

    ap = argparse.ArgumentParser(
        prog="python -m fed_tgan_torch serve",
        description="serve synthetic rows from a port artifact over HTTP")
    ap.add_argument("artifact", help="run out-dir / models dir / "
                    "synthesizer dir")
    add_serving_flags(ap, max_batch=8, queue_size=64)
    args = ap.parse_args(argv)
    start_sanitizers(args)
    log = (lambda *a, **k: None) if args.quiet else print
    try:
        registry = ModelRegistry(args.artifact, device=args.device,
                                 allow_meta_mismatch=args.allow_meta_mismatch,
                                 log=log)
        service = SamplingService(
            registry, host=args.host, port=args.port,
            max_batch=args.max_batch, queue_size=args.queue_size,
            request_timeout_s=args.request_timeout,
            reload_interval_s=args.reload_interval, workers=args.workers,
            coalesce_window_s=args.coalesce_window, promote=args.promote,
            log=log)
    except ArtifactError as exc:
        print(f"serve: {exc}")
        return 2
    service.start()
    model = registry.get()
    print(f"serving model {model.model_id} ({model.artifact.name}) on "
          f"{service.url} [{service.engine.device}] (endpoints: /sample "
          "/healthz /metrics; Ctrl-C drains and exits)", flush=True)
    wait_for_interrupt("serve", service)
    from fed_tgan_torch.analysis import sanitizers

    return finish_sanitizers(
        args, lambda: sanitizers.check_serving_budget(service.engine))


def client_main(argv=None) -> int:
    """``python -m fed_tgan_torch sample-client --url ... --rows N
    [--chunks K]``: offset-contiguous chunks concatenate to one N-row
    request's bytes (the engine's determinism contract), so K only sizes
    the transfers."""
    import argparse
    import sys

    ap = argparse.ArgumentParser(
        prog="python -m fed_tgan_torch sample-client",
        description="fetch synthetic rows from a running serve instance")
    ap.add_argument("--url", default="http://127.0.0.1:7799",
                    help="server base URL")
    ap.add_argument("--rows", type=int, required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--offset", type=int, default=0,
                    help="starting row of the deterministic stream")
    ap.add_argument("--chunks", type=int, default=1,
                    help="split the fetch into K contiguous requests")
    ap.add_argument("--column", default=None,
                    help="conditional sampling: discrete column to fix")
    ap.add_argument("--value", default=None,
                    help="conditional sampling: the option to fix it to")
    ap.add_argument("--out", default=None,
                    help="output CSV path (default: stdout)")
    ap.add_argument("--timeout", type=float, default=300.0)
    args = ap.parse_args(argv)
    if args.rows <= 0:
        ap.error(f"--rows {args.rows}: must be positive")
    if not 1 <= args.chunks <= args.rows:
        ap.error(f"--chunks {args.chunks}: must be in [1, rows]")
    if (args.column is None) != (args.value is None):
        ap.error("--column and --value go together")

    base, done = args.rows // args.chunks, 0
    parts = []
    for i in range(args.chunks):
        n = base + (1 if i < args.rows % args.chunks else 0)
        q = {"rows": n, "seed": args.seed, "offset": args.offset + done,
             "header": int(i == 0)}
        if args.column is not None:
            q.update(column=args.column, value=args.value)
        url = f"{args.url}/sample?{urllib.parse.urlencode(q)}"
        try:
            with urllib.request.urlopen(url, timeout=args.timeout) as resp:
                parts.append(resp.read())
        except urllib.error.HTTPError as exc:
            print(f"sample-client: HTTP {exc.code}: "
                  f"{exc.read().decode(errors='replace')}", file=sys.stderr)
            return 1
        except OSError as exc:
            print(f"sample-client: {exc} (is a server running at "
                  f"{args.url}?)", file=sys.stderr)
            return 1
        done += n
    blob = b"".join(parts)
    if args.out:
        with open(args.out, "wb") as f:
            f.write(blob)
        print(f"wrote {args.rows} rows to {args.out}", file=sys.stderr)
    else:
        sys.stdout.buffer.write(blob)
    return 0
