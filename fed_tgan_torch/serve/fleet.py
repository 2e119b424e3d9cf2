"""Multi-tenant serving fleet: many hot models behind one HTTP server
(counterpart of ``fed_tgan_tpu/serve/fleet.py``).

**FleetRegistry**: an ordered map of tenant name -> (its
:class:`~.registry.ModelRegistry`, its :class:`~.engine.SamplingEngine`,
its admission :class:`TokenBucket`), all on one device.  Each tenant
keeps its own hot reload (content-hash identity, torn-write tolerance).

**ProgramCache**: an entry- and byte-budgeted LRU shared by every
tenant.  JAX keeps compiled programs there; the port compiles nothing,
so it holds what a lane group builds once (:class:`LaneGroup`: the
members' generators stacked for :class:`~fed_tgan_torch.models.ctgan.
StackedEvalGenerator` and their decode tables stacked on a lane axis),
keyed by the members' model ids and the lane count.  A reload brings a
new model id, so it misses the cache by construction.

**FleetService**: N batch workers over a sharded bounded queue.  A worker
binds each request of a batch to its tenant's
:class:`~.engine.EngineSnapshot` (a reload never swaps a model out from
under a formed batch) and groups single-chunk requests by ``(steps,
conditional, layout key)``.  A group of two or more rides one lane
dispatch (:meth:`FleetService._dispatch_lanes`) of at most ``max_lanes``
lanes, one per request (JAX pads the lanes to a power of two to bound its
recompiles; nothing is compiled here, so a padded lane would only repeat
a member's work); each lane draws its own stream exactly as the single
engine does; then one stacked generator
pass, ONE launch of the activation kernel (K1) over every lane's rows,
the decode through each lane's tables, one copy to the host and the CSV
per member.  Its bytes equal the single engine's for the same
``(tenant, rows, seed, offset, condition)``.  Other requests run through
their tenant's engine.  A failed lane dispatch answers each of its
requests with 500 (as JAX does); nothing is re-run one by one.

An optional :class:`~.pool.RowPool` answers requests whose rows are
cached as pre-serialized segments without touching the queue; the quota
token is charged first.  Admission is per tenant: a token bucket sheds
with 429 ``reason=quota`` before the queue, a per-tenant in-flight cap
(a share of the queue) and the bounded queue shed with 503
``reason=capacity``.

The HTTP layer is :mod:`~.frontdoor` (asyncio, the default) or the
stdlib threaded server; both adapt :meth:`FleetService.route`.  Routes:
``/t/<tenant>/sample``, ``/sample`` (the sole tenant), ``/fleet`` (GET;
POST ``{"action": "load" | "evict"}``), ``/healthz`` and ``/metrics``.
Under ``promote="canary"`` each tenant has its own
:class:`~.canary.CanaryGate` on the reload poll: a candidate is scored in
shadow through its tenant's engine (never through a lane group, so it
never enters the :class:`ProgramCache` before it is promoted), and only a
promoted one is adopted, its row-pool entries dropped as on an immediate
reload; ``/fleet`` shows each tenant's promotion state.  The process
journal gets ``fleet_load``, ``fleet_evict``, ``serve_reload`` and, rate
limited, ``tenant_shed`` (at most about one a second a tenant, carrying
counts) and per-tenant ``serve_stages``.  ``fleet --sanitize`` runs
every steady lane dispatch under the sanitizers' sync guard and checks
the lane groups' build budget after the drain; ``--lockwatch`` watches
every lock the fleet allocates (``fleet_adm``, ``row_pool`` by name) and
reports cycles, re-entry and each lock's hold p99 (exit 4 on a cycle or a
re-entry).
"""

from __future__ import annotations

import json
import threading
import time
import urllib.parse
from collections import OrderedDict
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, List, Optional, Tuple, Union

import torch

from fed_tgan_torch.analysis import lockwatch
from fed_tgan_torch.analysis.sanitizers import (
    building,
    hot_region,
    sanctioned_sync,
)
from fed_tgan_torch.data.decode import decode_cells
from fed_tgan_torch.models.ctgan import StackedEvalGenerator
from fed_tgan_torch.obs.journal import emit as _emit_event
from fed_tgan_torch.ops.activate_cuda import fused_apply_activate
from fed_tgan_torch.ops.decode import layout_decode, stack_tables
from fed_tgan_torch.runtime.precision import f32_island
from fed_tgan_torch.serve.engine import (
    ConditionError,
    EngineSnapshot,
    SamplingEngine,
)
from fed_tgan_torch.serve.metrics import FleetMetrics
from fed_tgan_torch.serve.registry import ArtifactError, ModelRegistry
from fed_tgan_torch.serve.service import (
    BatchWorkers,
    add_serving_flags,
    finish_sanitizers,
    parse_sample_params,
    read_json_body,
    stamp_wait,
    start_sanitizers,
    wait_for_interrupt,
)

# --------------------------------------------------------------- admission


class TokenBucket:
    """Per-tenant admission rate limiter: ``rate`` tokens/second refill up
    to ``burst``; ``allow()`` spends one.  ``rate <= 0`` disables the
    quota.  Thread-safe."""

    def __init__(self, rate: float, burst: Optional[float] = None):
        self.rate = float(rate)
        self.burst = float(burst if burst is not None else max(rate, 1.0))
        self._tokens = self.burst
        self._t = time.monotonic()
        self._lock = threading.Lock()

    def allow(self, amount: float = 1.0) -> bool:
        if self.rate <= 0:
            return True
        with self._lock:
            now = time.monotonic()
            self._tokens = min(self.burst,
                               self._tokens + (now - self._t) * self.rate)
            self._t = now
            if self._tokens >= amount:
                self._tokens -= amount
                return True
            return False

    def retry_after_s(self) -> float:
        """Seconds until one token exists: the 429 Retry-After hint."""
        if self.rate <= 0:
            return 0.0
        with self._lock:
            missing = max(0.0, 1.0 - self._tokens)
        return missing / self.rate


# ------------------------------------------------------------- lane LRU


class ProgramCache:
    """Entry- and byte-budgeted LRU of what lane groups build once.

    ``get_or_build(key, builder, est_bytes)``: a hit moves the entry to
    the most-recent end; a miss runs ``builder()`` outside the lock,
    inserts, then evicts from the least-recent end until both budgets
    hold.  The entry just inserted is never evicted.  Builds in flight
    are coordinated: the first thread to miss a key builds, any other
    thread missing the same key waits for it and then reads the cache,
    so N workers racing to one key build it once."""

    def __init__(self, max_entries: int = 64,
                 max_bytes: int = 256 * 1024 * 1024):
        self.max_entries = max(1, int(max_entries))
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        self._entries: OrderedDict = OrderedDict()  # key -> (value, bytes)
        self._building: dict = {}  # key -> threading.Event (build in flight)
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def get_or_build(self, key, builder: Callable, est_bytes: int = 0):
        while True:
            with self._lock:
                entry = self._entries.get(key)
                if entry is not None:
                    self._entries.move_to_end(key)
                    self.hits += 1
                    return entry[0]
                in_flight = self._building.get(key)
                if in_flight is None:
                    done = threading.Event()
                    self._building[key] = done
                    break
            # another worker builds this key right now: wait, then re-read
            # (if its build failed, the loop builds here)
            in_flight.wait()
        try:
            value = builder()
        except BaseException:
            with self._lock:
                del self._building[key]
            done.set()
            raise
        with self._lock:
            del self._building[key]
            self.misses += 1
            self._entries[key] = (value, int(est_bytes))
            self._bytes += int(est_bytes)
            while self._entries and len(self._entries) > 1 and (
                    len(self._entries) > self.max_entries
                    or self._bytes > self.max_bytes):
                _, (_, b) = self._entries.popitem(last=False)
                self._bytes -= b
                self.evictions += 1
        done.set()
        return value

    def keys(self) -> list:
        with self._lock:
            return list(self._entries)

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "bytes": self._bytes,
                "max_entries": self.max_entries,
                "max_bytes": self.max_bytes,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
            }


class LaneGroup:
    """The stacked weights and tables of one lane group's models (in lane
    order)."""

    def __init__(self, snaps: List[EngineSnapshot]):
        # one layout key, so one precision for every lane
        self.generator = StackedEvalGenerator(
            [s.model.synth.generator for s in snaps],
            snaps[0].model.synth.compute_dtype)
        self.tables = stack_tables([s.tables for s in snaps])

    @staticmethod
    def est_bytes(snaps: List[EngineSnapshot]) -> int:
        gen = snaps[0].model.synth.generator
        per_lane = sum(t.numel() * t.element_size()
                       for t in gen.state_dict().values())
        per_lane += sum(a.numel() * a.element_size()
                        for tab in snaps[0].tables for a in tab)
        return len(snaps) * per_lane


# ------------------------------------------------------------- fleet state


@dataclass
class TenantRuntime:
    """One hot tenant: its registry, its engine and its admission
    token bucket."""

    name: str
    root: str
    registry: ModelRegistry
    engine: SamplingEngine
    bucket: TokenBucket
    # the canary promotion gate (None under the default immediate policy)
    gate: object = None


class FleetRegistry:
    """Ordered map of hot tenants on ``device`` over one shared
    :class:`ProgramCache`.

    ``load`` builds the tenant's registry and engine (the model loads
    eagerly: a tenant is hot or absent, never half-loaded); ``evict``
    drops it.  Cache entries are not dropped on evict: they age out."""

    def __init__(self, program_cache: Optional[ProgramCache] = None,
                 quota_rps: float = 0.0, quota_burst: Optional[float] = None,
                 max_chunk_steps: int = 128,
                 allow_meta_mismatch: bool = False, device="cuda",
                 promote: str = "immediate", log=print):
        self.cache = program_cache if program_cache is not None \
            else ProgramCache()
        self.promote = str(promote)
        self.quota_rps = float(quota_rps)
        self.quota_burst = quota_burst
        self.max_chunk_steps = int(max_chunk_steps)
        self.allow_meta_mismatch = allow_meta_mismatch
        self.device = device
        self._log = log
        self._lock = threading.RLock()
        self._tenants: OrderedDict = OrderedDict()  # name -> TenantRuntime

    def load(self, name: str, root: str) -> TenantRuntime:
        """Load (or replace) tenant ``name`` from artifact ``root``.
        Raises :class:`ArtifactError` when nothing loadable exists; the
        fleet is then unchanged."""
        registry = ModelRegistry(root, device=self.device,
                                 allow_meta_mismatch=self.allow_meta_mismatch,
                                 log=self._log)
        model = registry.get()  # eager: fail here, not on first request
        engine = SamplingEngine(model, max_chunk_steps=self.max_chunk_steps)
        gate = None
        if self.promote == "canary":
            from fed_tgan_torch.serve.canary import CanaryGate

            gate = CanaryGate(registry, engine, tenant=name, log=self._log)
        rt = TenantRuntime(name=name, root=str(root), registry=registry,
                           engine=engine,
                           bucket=TokenBucket(self.quota_rps,
                                              self.quota_burst),
                           gate=gate)
        with self._lock:
            self._tenants[name] = rt
        _emit_event("fleet_load", tenant=name, model_id=model.model_id,
                    root=str(root))
        self._log(f"fleet: loaded tenant {name!r} (model {model.model_id})")
        return rt

    def evict(self, name: str) -> bool:
        with self._lock:
            rt = self._tenants.pop(name, None)
        if rt is None:
            return False
        _emit_event("fleet_evict", tenant=name,
                    model_id=rt.registry.get().model_id)
        self._log(f"fleet: evicted tenant {name!r}")
        return True

    def get(self, name: str) -> Optional[TenantRuntime]:
        with self._lock:
            return self._tenants.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return list(self._tenants)

    def items(self) -> List[Tuple[str, TenantRuntime]]:
        with self._lock:
            return list(self._tenants.items())

    def sole(self) -> Optional[TenantRuntime]:
        """The single hot tenant, when exactly one is (the ``/sample``
        alias routes only then)."""
        with self._lock:
            if len(self._tenants) == 1:
                return next(iter(self._tenants.values()))
            return None


# ----------------------------------------------------------- request path


@dataclass
class _FleetRequest:
    tenant: str
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
    popped_at: float = 0.0
    stages: dict = field(default_factory=dict)
    # completion callback, set before submit and called after done.set():
    # the asyncio front door bridges it onto its event loop
    on_done: Optional[Callable] = None


@dataclass
class Response:
    """One HTTP response from :meth:`FleetService.route`.  ``body`` is
    bytes or a list of byte segments (the asyncio front door writes a
    segment list without joining it)."""

    status: int
    body: Union[bytes, list]
    ctype: str = "application/json"
    headers: Optional[dict] = None

    def body_bytes(self) -> bytes:
        return self.body if isinstance(self.body, bytes) \
            else b"".join(self.body)

    def content_length(self) -> int:
        return len(self.body) if isinstance(self.body, bytes) \
            else sum(len(s) for s in self.body)


@dataclass
class Pending:
    """A routed request parked on a worker queue: the HTTP layer waits for
    ``req.done`` (or bridges ``req.on_done``), then renders
    :meth:`FleetService.response_for`."""

    req: _FleetRequest


def _json_response(status: int, obj: dict,
                   headers: Optional[dict] = None) -> Response:
    return Response(status, json.dumps(obj).encode(), "application/json",
                    headers)


@dataclass
class _Member:
    """One request bound to the tenant snapshot its batch formed under."""

    req: _FleetRequest
    rt: TenantRuntime
    snap: EngineSnapshot
    first_step: int
    skip: int


class FleetService(BatchWorkers):
    """N coalescing batch workers over a sharded bounded queue, serving
    every tenant of ``fleet`` (see the module docstring)."""

    def __init__(self, fleet: FleetRegistry, host: str = "127.0.0.1",
                 port: int = 0, max_batch: int = 16, queue_size: int = 128,
                 max_lanes: int = 8, queue_share: float = 0.5,
                 request_timeout_s: float = 120.0,
                 reload_interval_s: float = 5.0, workers: int = 1,
                 coalesce_window_s: float = 0.0, row_pool=None,
                 http_mode: str = "threaded", log=print):
        if http_mode not in ("threaded", "asyncio"):
            raise ValueError(f"http_mode={http_mode!r}: "
                             "want 'threaded' or 'asyncio'")
        self.fleet = fleet
        self.metrics = FleetMetrics()
        self.max_lanes = max(1, int(max_lanes))
        self.queue_share = min(1.0, max(0.0, float(queue_share)))
        self.row_pool = row_pool
        self.http_mode = http_mode
        self._log = log
        self._host, self._port = host, port
        self._init_queues(queue_size, workers, max_batch, coalesce_window_s,
                          request_timeout_s, reload_interval_s)
        # per-tenant in-flight counts (admission fairness)
        self._adm_lock = threading.Lock()
        lockwatch.set_name(self._adm_lock, "fleet_adm")
        self._shed_acc: dict = {}  # tenant -> shed counts since the event
        self._inflight: dict = {}
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._frontdoor = None
        self._serve_thread: Optional[threading.Thread] = None

    # ----------------------------------------------------------- lifecycle

    def start(self) -> "FleetService":
        self.start_workers()
        if self.row_pool is not None:
            self.row_pool.start()
        if self.http_mode == "asyncio":
            from fed_tgan_torch.serve.frontdoor import AsyncFrontDoor

            self._frontdoor = AsyncFrontDoor(
                self, host=self._host, port=self._port,
                request_timeout_s=self.request_timeout_s).start()
        else:
            self._httpd = ThreadingHTTPServer((self._host, self._port),
                                              _make_fleet_handler(self))
            self._httpd.daemon_threads = True
            self._serve_thread = threading.Thread(
                target=self._httpd.serve_forever,
                kwargs={"poll_interval": 0.05}, name="fleet-http",
                daemon=True)
            self._serve_thread.start()
        return self

    @property
    def port(self) -> int:
        if self._frontdoor is not None:
            return self._frontdoor.port
        assert self._httpd is not None, "start() first"
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self._host}:{self.port}"

    def shutdown(self, drain: bool = True) -> None:
        self._draining.set()
        if self.row_pool is not None:
            self.row_pool.stop()

        def fail(req):
            req.error, req.status = "server shutting down", 503
            self._finish(req)

        self._stop_workers(drain, fail)
        if self._frontdoor is not None:
            self._frontdoor.stop()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        if self._serve_thread is not None:
            self._serve_thread.join(timeout=10)

    # ----------------------------------------------------------- admission

    def tenant_cap(self) -> int:
        """Max in-flight requests of one tenant: its share of the queue."""
        return max(1, int(self._queue_size * self.queue_share))

    def submit(self, rt: TenantRuntime,
               req: _FleetRequest) -> Optional[str]:
        """Admit and enqueue; None on success, else the shed reason
        (``"quota"`` -> 429, ``"capacity"`` -> 503)."""
        if self._draining.is_set():
            return "capacity"
        if not rt.bucket.allow():
            self._shed(req.tenant, "quota")
            return "quota"
        return self.submit_admitted(req)

    def submit_admitted(self, req: _FleetRequest) -> Optional[str]:
        """Capacity-only admission (the route charged the quota token
        before the row-pool lookup)."""
        if self._draining.is_set():
            return "capacity"
        cap = self.tenant_cap()
        with self._adm_lock:
            over_cap = self._inflight.get(req.tenant, 0) >= cap
            if not over_cap:
                self._inflight[req.tenant] = \
                    self._inflight.get(req.tenant, 0) + 1
        if over_cap:
            self._shed(req.tenant, "capacity")
            return "capacity"
        if self._enqueue(req):
            return None
        with self._adm_lock:
            self._inflight[req.tenant] -= 1
        self._shed(req.tenant, "capacity")
        return "capacity"

    def _shed(self, tenant: str, reason: str) -> None:
        """Count a shed request; journal a ``tenant_shed`` summary at most
        about once a second a tenant, carrying the counts since the last
        one (a shed storm stays out of the journal's rate)."""
        self.metrics.record_shed(tenant, reason)
        with self._adm_lock:
            acc = self._shed_acc.setdefault(
                tenant, {"quota": 0, "capacity": 0, "last": 0.0})
            acc[reason] += 1
            now = time.monotonic()
            if now - acc["last"] < 1.0:
                return
            quota, capacity = acc["quota"], acc["capacity"]
            acc["quota"] = acc["capacity"] = 0
            acc["last"] = now
        _emit_event("tenant_shed", tenant=tenant, count=quota + capacity,
                    quota=quota, capacity=capacity)

    def _finish(self, req: _FleetRequest) -> None:
        with self._adm_lock:
            n = self._inflight.get(req.tenant, 0)
            if n > 0:
                self._inflight[req.tenant] = n - 1
        req.done.set()
        if req.on_done is not None:
            req.on_done(req)

    def _fail(self, req: _FleetRequest, status: int, msg: str) -> None:
        req.error, req.status = msg, status
        self.metrics.record_error(req.tenant)
        self._finish(req)

    def _answer(self, req: _FleetRequest, body: bytes) -> None:
        req.result, req.status = body, 200
        self.metrics.record_request(req.tenant,
                                    time.time() - req.enqueued_at, req.n)
        self.metrics.record_stages(req.tenant, req.stages)
        self._finish(req)

    # -------------------------------------------------------------- worker

    def _process(self, batch: list, wid: int = 0) -> None:
        if not batch:
            return
        self.metrics.record_batch(len(batch))
        self.metrics.set_queue_depth(self.queue_depth())
        self.metrics.set_lanes_occupied(0)
        # bind every request to ONE tenant snapshot for the whole batch,
        # then group single-chunk requests: same (steps, conditional,
        # layout key) => one lane dispatch
        groups: dict = {}
        singles: list = []
        for req in batch:
            rt = self.fleet.get(req.tenant)
            if rt is None:
                self._fail(req, 410, f"tenant {req.tenant!r} was evicted")
                continue
            snap = rt.engine.snapshot()
            B = snap.cfg.batch_size
            first_step, skip = divmod(req.offset, B)
            total_steps = -(-(skip + req.n) // B)
            plan = rt.engine._chunk_plan(first_step, total_steps)
            member = _Member(req, rt, snap, first_step, skip)
            if len(plan) == 1 and self.max_lanes > 1:
                key = (plan[0][1], req.condition is not None, snap.sig)
                groups.setdefault(key, []).append(member)
            else:
                singles.append(member)
        for (steps, _cond, _sig), members in groups.items():
            if len(members) == 1:
                singles.append(members[0])
                continue
            for i in range(0, len(members), self.max_lanes):
                part = members[i:i + self.max_lanes]
                if len(part) == 1:
                    singles.append(part[0])
                else:
                    self._dispatch_lanes(steps, part)
        for member in singles:
            self._run_single(member)
        self._drain_rate.note(len(batch))
        self.metrics.set_fleet_state(len(self.fleet.names()),
                                     self.fleet.cache.stats())

    def _run_single(self, m: _Member) -> None:
        req = m.req
        stamp_wait(req, time.time())
        try:
            body = m.rt.engine.sample_csv_bytes(
                req.n, seed=req.seed, offset=req.offset,
                condition=req.condition, header=req.header, snap=m.snap,
                stages=req.stages)
        except Exception as exc:  # noqa: BLE001 — becomes the 500 body
            self._fail(req, 500, repr(exc))
            return
        self._answer(req, body)

    # --------------------------------------------------------- lane engine

    def lane_group(self, snaps: List[EngineSnapshot]) -> LaneGroup:
        """The cached :class:`LaneGroup` of ``snaps`` (lane order)."""
        ids = tuple(s.model.model_id for s in snaps)
        key = ("lanes", ids, len(snaps), snaps[0].sig)

        def build() -> LaneGroup:
            with building(f"lanes[{len(snaps)}:{'+'.join(ids)}]"):
                return LaneGroup(snaps)

        return self.fleet.cache.get_or_build(
            key, build, est_bytes=LaneGroup.est_bytes(snaps))

    def lane_encoded(self, members: list, steps: int,
                     draws: Optional[list] = None,
                     tick: Optional[Callable] = None):
        """The device work of one lane dispatch up to the activation:
        ``(group, enc)``, ``enc`` the ``(lanes, steps * B, dim)`` activated
        rows on the device, one lane per member.  ``draws`` (tests only)
        gives each member's :data:`~.engine.Draws`; ``tick(stage)``, when
        given, is called after each stage (``lane_group``, ``draws``,
        ``generator``, ``K1``)."""
        tick = tick or (lambda stage: None)
        lanes = len(members)
        snap0 = members[0].snap
        spec, B = snap0.spec, snap0.cfg.batch_size
        group = self.lane_group([m.snap for m in members])
        tick("lane_group")
        drawn = [m.rt.engine.draw(m.snap,
                                  m.req.seed + m.snap.model.synth.key_offset,
                                  m.first_step, steps, m.req.condition,
                                  None if draws is None else draws[i])
                 for i, m in enumerate(members)]
        z, c, u = (None if parts[0] is None else torch.stack(parts)
                   for parts in zip(*drawn))
        x = z if c is None else torch.cat([z, c], dim=2)
        tick("draws")
        raw = group.generator(x, block_rows=B)
        tick("generator")
        rows = steps * B
        # one launch of the activation kernel over every lane's rows, in
        # the lanes' compute dtype; the rows float32 for the decode
        enc = f32_island(fused_apply_activate(
            raw.view(lanes * rows, spec.dim), spec,
            u.view(lanes * rows, spec.dim)))
        tick("K1")
        return group, enc.view(lanes, rows, spec.dim)

    def lane_pass(self, members: list, steps: int,
                  draws: Optional[list] = None,
                  tick: Optional[Callable] = None):
        """:meth:`lane_encoded`, then the decode through each lane's tables
        and one copy: ``(lanes, steps * B, n_columns)`` decoded rows on the
        host (``tick`` also sees ``decode`` and ``copy``)."""
        tick = tick or (lambda stage: None)
        # the lane dispatch is a sanitizer hot region; its one copy to the
        # host is the sanctioned sync
        with hot_region(f"serve.fleet[{steps}x{len(members)}]"):
            group, enc = self.lane_encoded(members, steps, draws, tick)
            dec = layout_decode(enc, group.tables)
            tick("decode")
            with sanctioned_sync():
                host = dec.cpu().numpy()
        tick("copy")
        return host

    def _dispatch_lanes(self, steps: int, members: list) -> None:
        """One lane dispatch answering every member (see the module
        docstring); on failure every member gets 500."""
        t_start = time.time()
        for m in members:
            stamp_wait(m.req, t_start)
        t0 = time.perf_counter()
        try:
            host = self.lane_pass(members, steps)
        except Exception as exc:  # noqa: BLE001 — fail the whole group
            for m in members:
                self._fail(m.req, 500, repr(exc))
            return
        dispatch_s = time.perf_counter() - t0
        self.metrics.record_lane_dispatch(len(members))
        self.metrics.set_lanes_occupied(len(members))
        for i, m in enumerate(members):
            req = m.req
            req.stages["dispatch"] = dispatch_s
            try:
                t1 = time.perf_counter()
                cells = decode_cells(host[i, m.skip:m.skip + req.n],
                                     m.snap.model.meta, m.snap.model.encoders)
                t2 = time.perf_counter()
                body = m.snap.csv_plan.csv_bytes(cells, header=req.header)
                req.stages["decode"] = t2 - t1
                req.stages["serialize"] = time.perf_counter() - t2
            except Exception as exc:  # noqa: BLE001
                self._fail(req, 500, repr(exc))
                continue
            self._answer(req, body)

    # -------------------------------------------------------------- reload

    def _maybe_reload(self) -> None:
        for name, rt in self.fleet.items():
            try:
                # under the canary a rejected candidate leaves the old
                # model serving untouched
                if (rt.gate.poll(self.metrics.quality) if rt.gate is not None
                        else rt.registry.maybe_reload()):
                    kept = rt.engine.adopt(rt.registry.get())
                    if self.row_pool is not None:
                        # pooled rows belong to the old model
                        self.row_pool.invalidate(name)
                    self.metrics.record_reload(name)
                    _emit_event("serve_reload", tenant=name,
                                model_id=rt.registry.get().model_id,
                                programs_kept=bool(kept))
                    self._log(f"fleet: tenant {name!r} now serving model "
                              f"{rt.registry.get().model_id} (layout "
                              f"{'kept' if kept else 'changed'})")
            except Exception as exc:  # noqa: BLE001 — never kills serving
                self._log(f"fleet: reload check failed for {name!r} "
                          f"({exc!r})")

    def _stage_snapshots(self) -> dict:
        return self.metrics.stage_snapshots()

    # -------------------------------------------------------------- status

    def fleet_status(self) -> dict:
        tenants = []
        for name, rt in self.fleet.items():
            model = rt.registry.get()
            with self._adm_lock:
                inflight = self._inflight.get(name, 0)
            entry = {
                "name": name, "root": rt.root, "model_id": model.model_id,
                "model_name": model.artifact.name, "inflight": inflight,
                **self.metrics.tenant_snapshot(name)}
            if rt.gate is not None:
                entry["promotion"] = rt.gate.status()
            tenants.append(entry)
        return {
            "status": "draining" if self._draining.is_set() else "ok",
            "tenants": tenants,
            "cache": self.fleet.cache.stats(),
            "queue_depth": self.queue_depth(),
            "tenant_cap": self.tenant_cap(),
            "workers": self.workers,
            "coalesce_window_s": self.coalesce_window_s,
            "row_pool": (self.row_pool.stats()
                         if self.row_pool is not None else None),
            "device": str(self.fleet.device),
        }

    # ------------------------------------------------------------- routing

    @staticmethod
    def _tenant_for(path: str) -> Optional[str]:
        """``/t/<tenant>/sample`` -> tenant name, else None."""
        parts = path.split("/")
        if len(parts) == 4 and parts[1] == "t" and parts[3] == "sample":
            return urllib.parse.unquote(parts[2])
        return None

    def _push_gauges(self) -> None:
        self.metrics.set_fleet_state(len(self.fleet.names()),
                                     self.fleet.cache.stats())
        self.metrics.set_pool_state(
            self.row_pool.stats() if self.row_pool is not None else None)

    def route(self, method: str, path: str, params: dict,
              on_done: Optional[Callable] = None
              ) -> Union[Response, Pending]:
        """The route table both front doors adapt.  ``params`` is the
        merged query / JSON-body dict; ``on_done`` is attached to a
        sampling request before it is enqueued."""
        if method == "GET":
            if path == "/healthz":
                self._push_gauges()
                return _json_response(200, {
                    "status": "draining" if self._draining.is_set()
                    else "ok",
                    "tenants": self.fleet.names(),
                    **self.metrics.snapshot(self.queue_depth())})
            if path == "/metrics":
                self._push_gauges()
                text = self.metrics.render_prometheus(self.queue_depth())
                return Response(200, text.encode(),
                                "text/plain; version=0.0.4")
            if path == "/fleet":
                return _json_response(200, self.fleet_status())
        elif method == "POST" and path == "/fleet":
            return self._route_admin(params)
        tenant = self._tenant_for(path)
        if tenant is None and path == "/sample":
            rt = self.fleet.sole()
            if rt is None:
                return _json_response(400, {
                    "error": "/sample needs exactly one hot tenant; "
                             "use /t/<tenant>/sample",
                    "tenants": self.fleet.names()})
            tenant = rt.name
        if tenant is None:
            return _json_response(404, {"error": f"no route {path}"})
        return self._route_sample(tenant, params, on_done)

    def _route_admin(self, params: dict) -> Response:
        action = params.get("action")
        name = params.get("tenant")
        if action == "load":
            if not name or not params.get("root"):
                return _json_response(400,
                                      {"error": "load needs {tenant, root}"})
            try:
                rt = self.fleet.load(str(name), str(params["root"]))
            except ArtifactError as exc:
                return _json_response(400, {"error": str(exc)})
            return _json_response(200, {
                "loaded": name, "model_id": rt.registry.get().model_id})
        if action == "evict":
            if not name:
                return _json_response(400, {"error": "evict needs {tenant}"})
            if self.fleet.evict(str(name)):
                if self.row_pool is not None:
                    self.row_pool.invalidate(str(name))
                return _json_response(200, {"evicted": name})
            return _json_response(404, {"error": f"no tenant {name!r}",
                                        "tenants": self.fleet.names()})
        return _json_response(400, {
            "error": f"unknown action {action!r} (want load or evict)"})

    def _route_sample(self, tenant: str, params: dict,
                      on_done: Optional[Callable]
                      ) -> Union[Response, Pending]:
        rt = self.fleet.get(tenant)
        if rt is None:
            return _json_response(404, {"error": f"no tenant {tenant!r}",
                                        "tenants": self.fleet.names()})
        try:
            n, seed, offset, header = parse_sample_params(params)
        except (TypeError, ValueError) as exc:
            return _json_response(400, {"error": str(exc)})
        condition = None
        column = params.get("column")
        if column:
            try:
                condition = rt.engine.resolve_condition(
                    column, params.get("value"))
            except ConditionError as exc:
                return _json_response(400, {"error": str(exc)})
        if self._draining.is_set():
            return _json_response(503, {"error": "draining"},
                                  headers={"Retry-After": "1"})
        # quota first: a pool hit still spends the tenant's token
        t_admit = time.time()
        if not rt.bucket.allow():
            self._shed(tenant, "quota")
            retry = max(rt.bucket.retry_after_s(), 0.05)
            return _json_response(
                429, {"error": f"tenant {tenant!r} over quota"},
                headers={"Retry-After": f"{retry:.2f}"})
        if self.row_pool is not None:
            segments = self.row_pool.get(tenant, seed, offset, n,
                                         condition, header)
            if segments is not None:
                self.metrics.record_pool_hit(tenant,
                                             time.time() - t_admit, n)
                return Response(200, segments, "text/csv")
        req = _FleetRequest(tenant=tenant, n=n, seed=seed, offset=offset,
                            condition=condition, header=header)
        req.on_done = on_done
        if self.submit_admitted(req) is not None:
            return _json_response(
                503, {"error": "draining" if self._draining.is_set()
                      else "at capacity"},
                headers={"Retry-After":
                         f"{self.capacity_retry_after():.2f}"})
        return Pending(req)

    @staticmethod
    def response_for(req: _FleetRequest) -> Response:
        """Render a finished (or timed-out) sampling request."""
        if not req.done.is_set():
            return _json_response(504,
                                  {"error": "request timed out in queue"})
        if req.status == 200 and req.result is not None:
            return Response(200, req.result, "text/csv")
        return _json_response(req.status, {"error": req.error or "failed"})


# ----------------------------------------------------------------- HTTP


def _make_fleet_handler(service: FleetService):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        disable_nagle_algorithm = True

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _send_response(self, r: Response) -> None:
            self.send_response(r.status)
            self.send_header("Content-Type", r.ctype)
            self.send_header("Content-Length", str(r.content_length()))
            for k, v in (r.headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(r.body_bytes())

        def _dispatch(self, method: str, params: dict) -> None:
            parsed = urllib.parse.urlsplit(self.path)
            routed = service.route(method, parsed.path, params)
            if isinstance(routed, Pending):
                routed.req.done.wait(timeout=service.request_timeout_s)
                routed = service.response_for(routed.req)
            self._send_response(routed)

        def do_GET(self):
            parsed = urllib.parse.urlsplit(self.path)
            self._dispatch("GET", {k: v[-1] for k, v in
                                   urllib.parse.parse_qs(parsed.query)
                                   .items()})

        def do_POST(self):
            try:
                params = read_json_body(self)
            except ValueError as exc:
                self._send_response(_json_response(
                    400, {"error": f"bad JSON body: {exc}"}))
                return
            self._dispatch("POST", params)

    return Handler


# ------------------------------------------------------------------- CLI


def fleet_main(argv=None) -> int:
    """``python -m fed_tgan_torch fleet NAME=DIR [NAME=DIR ...] [flags]``."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m fed_tgan_torch fleet",
        description="serve many port artifacts over one HTTP server, "
                    "same-layout tenants sharing lane dispatches, with "
                    "per-tenant quotas")
    ap.add_argument("tenants", nargs="+", metavar="NAME=DIR",
                    help="tenant name and its artifact root")
    add_serving_flags(ap, max_batch=16, queue_size=128)
    ap.add_argument("--max-lanes", type=int, default=8,
                    help="max tenants coalesced into one lane dispatch "
                         "(1 disables cross-tenant coalescing)")
    ap.add_argument("--queue-share", type=float, default=0.5,
                    help="fraction of the queue one tenant may hold "
                         "in flight before 503")
    ap.add_argument("--quota-rps", type=float, default=0.0,
                    help="per-tenant admission quota in requests/second "
                         "(0 = unlimited); over quota gets 429")
    ap.add_argument("--quota-burst", type=float, default=None,
                    help="per-tenant token-bucket burst (default: "
                         "max(quota-rps, 1))")
    ap.add_argument("--cache-entries", type=int, default=64,
                    help="lane-group LRU entry budget")
    ap.add_argument("--cache-mb", type=float, default=256.0,
                    help="lane-group LRU byte budget")
    ap.add_argument("--http", choices=("asyncio", "threaded"),
                    default="asyncio",
                    help="front door: asyncio event loop with segment "
                         "streaming, or the threaded stdlib server")
    ap.add_argument("--row-pool-chunks", type=int, default=8,
                    help="pre-generated row-pool chunks kept per hot "
                         "(tenant, seed, condition) stream (0 disables "
                         "the pool)")
    ap.add_argument("--row-pool-chunk-rows", type=int, default=2048,
                    help="rows per pre-generated pool chunk")
    ap.add_argument("--lockwatch", action="store_true",
                    help="deadlock sanitizer: watch every lock the fleet "
                         "allocates for order cycles and re-entry, print "
                         "each lock's hold p99 at shutdown (exit 4 on a "
                         "cycle or re-entry)")
    args = ap.parse_args(argv)
    pairs = []
    for spec in args.tenants:
        name, sep, root = spec.partition("=")
        if not sep or not name or not root:
            ap.error(f"tenant spec {spec!r}: want NAME=DIR")
        pairs.append((name, root))
    start_sanitizers(args)
    if args.lockwatch:
        # installed before the registry and the service are built, so
        # every lock they allocate is watched
        lockwatch.clear()
        lockwatch.install(on_deadlock="record")
    log = (lambda *a, **k: None) if args.quiet else print
    fleet = FleetRegistry(
        program_cache=ProgramCache(max_entries=args.cache_entries,
                                   max_bytes=int(args.cache_mb * 2**20)),
        quota_rps=args.quota_rps, quota_burst=args.quota_burst,
        allow_meta_mismatch=args.allow_meta_mismatch, device=args.device,
        promote=args.promote, log=log)
    for name, root in pairs:
        try:
            fleet.load(name, root)
        except ArtifactError as exc:
            print(f"fleet: tenant {name!r}: {exc}")
            return 2
    row_pool = None
    if args.row_pool_chunks > 0:
        from fed_tgan_torch.serve.pool import RowPool

        row_pool = RowPool(fleet, chunk_rows=args.row_pool_chunk_rows,
                           max_chunks_per_key=args.row_pool_chunks)
    service = FleetService(
        fleet, host=args.host, port=args.port, max_batch=args.max_batch,
        queue_size=args.queue_size, max_lanes=args.max_lanes,
        queue_share=args.queue_share,
        request_timeout_s=args.request_timeout,
        reload_interval_s=args.reload_interval, workers=args.workers,
        coalesce_window_s=args.coalesce_window, row_pool=row_pool,
        http_mode=args.http, log=log).start()
    print(f"serving {len(pairs)} tenant(s) on {service.url} "
          f"[{fleet.device}] (endpoints: /t/<tenant>/sample /fleet /healthz "
          "/metrics; Ctrl-C drains and exits)", flush=True)
    wait_for_interrupt("fleet", service)
    from fed_tgan_torch.analysis import sanitizers

    rc = finish_sanitizers(
        args, lambda: sanitizers.check_fleet_budget(fleet.cache))
    if args.lockwatch:
        rc = max(rc, _lockwatch_report())
    return rc


def _lockwatch_report() -> int:
    """``fleet --lockwatch`` after the drain
    (``fed_tgan_tpu/serve/fleet.py:1369-1378``): each lock's acquisitions,
    contentions and hold p99, exported to the process registry as
    ``fed_tgan_lock_hold_seconds{lock=...}``; a cycle or a re-entry as a
    ``LOCKWATCH:`` line and exit 4."""
    lockwatch.uninstall()
    lockwatch.export_to_registry()
    for lname, st in sorted(lockwatch.summary().items()):
        print(f"lockwatch: {lname}: {st['acquisitions']} acq "
              f"({st['contentions']} contended), hold p99 "
              f"{st['hold_p99_ms']:.3f} ms")
    problems = lockwatch.reports("cycle") + lockwatch.reports("reentry")
    for rep in problems:
        print(f"LOCKWATCH: {rep.detail}")
    return 4 if problems else 0
