"""The host transport of the multi-process federation: Python bindings
for ``fed_tgan_torch/csrc/transport.cpp`` (counterpart of
``fed_tgan_tpu/runtime/transport.py``).

The role PyTorch RPC over Gloo/TensorPipe plays in the reference
(reference Server/dtds/distributed.py:849-857): a TCP rendezvous of one
server and N clients carrying pickled control-plane objects (metadata,
encoders, mixture models, rank 1's round reports and snapshots, the final
parameters).  The per-round aggregation never touches it: it is a
``torch.distributed`` all-gather among the participants
(:mod:`fed_tgan_torch.parallel.multihost`).

Fault tolerance (this layer, not the native one):

- Every message is framed with a per-direction sequence number; a retried
  send after a reconnect is IDEMPOTENT because the receiver drops frames
  whose sequence it has already accepted.
- Clients reconnect with exponential backoff (bounded tries) when the
  connection drops mid-protocol, then run a RESYNC handshake that resends
  whichever single in-flight message the cut may have eaten (the protocol
  is strictly alternating per rank, so the gap is at most one frame each
  way).
- Clients emit a lightweight heartbeat so the server can distinguish a
  SLOW peer (heartbeats flowing, no data yet — keep waiting until the
  phase deadline) from a DEAD one (heartbeat lapse — raise PeerDeadError
  early instead of burning the whole deadline).
- Per-phase deadlines (``Deadlines``) can be overridden per field via
  ``FED_TGAN_TORCH_TRANSPORT_*`` env vars.
- The fault plan's ``delay_msg`` sleeps before every send and
  ``sever_conn`` cuts a client's own connection after its N-th send
  (:mod:`fed_tgan_torch.testing.faults`).

The shared library is compiled with ``g++ -O2 -fPIC -std=c++17 -shared``
at first use into ``fed_tgan_torch/_build/libfed_tgan_transport_<hash>.so``
(a per-process temporary file, then ``os.replace``: the N + 1 processes of
a world may build it at once) and bound with ``ctypes``.  Its counters
live in the port's process-wide metrics registry
(:data:`fed_tgan_torch.obs.registry.DEFAULT`), and it journals the JAX
package's ``transport_drop``, ``transport_reconnect`` and
``heartbeat_lapse`` events.

SECURITY: payloads are deserialized with ``pickle`` — the SAME trust model
as the reference's torch RPC (arbitrary code execution if the peer is
hostile).  Only run the init protocol between mutually trusted hosts on a
trusted network, exactly as the reference assumes for its TCP rendezvous.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import logging
import os
import pickle
import struct
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Any, Optional

from fed_tgan_torch.obs.journal import emit as _emit_event
from fed_tgan_torch.obs.registry import counter as _metric_counter

log = logging.getLogger("fed_tgan_torch.transport")

_RECONNECTS = _metric_counter(
    "fed_tgan_transport_reconnects_total",
    "transport connections re-established after a drop")
_DROPS = _metric_counter(
    "fed_tgan_transport_drops_total",
    "peers marked dead by the server")
_LAPSES = _metric_counter(
    "fed_tgan_transport_heartbeat_lapses_total",
    "heartbeat liveness deadlines exceeded")

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "transport.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O2", "-Wall", "-fPIC", "-std=c++17", "-shared")
ENV_PREFIX = "FED_TGAN_TORCH_TRANSPORT_"

# frame header: u64 LE sequence number + one type byte
_HEADER = struct.Struct("<QB")
_DATA, _HEARTBEAT, _RESYNC, _RESYNC_ACK = 0, 1, 2, 3


def _last_errno_suffix(lib) -> str:
    """' (strerror)' for the native layer's last create failure, or ''."""
    try:
        e = int(lib.ft_last_errno())
        return f" ({os.strerror(e)})" if e else ""
    except Exception:
        return ""


@functools.lru_cache(maxsize=None)
def build() -> str:
    """Compile the transport (once per source content and flags) and
    return the library's path."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    lib = BUILD_DIR / f"libfed_tgan_transport_{tag}.so"
    if lib.exists():
        return str(lib)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f"{lib.stem}.{os.getpid()}.",
                               suffix=".tmp", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {SOURCE}:\n{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return str(lib)


@functools.lru_cache(maxsize=None)
def _load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build())
    lib.ft_last_errno.restype = ctypes.c_int
    lib.ft_last_errno.argtypes = []
    lib.ft_server_create.restype = ctypes.c_void_p
    lib.ft_server_create.argtypes = [ctypes.c_int]
    lib.ft_server_accept.restype = ctypes.c_int
    lib.ft_server_accept.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_int]
    lib.ft_server_poll_accept.restype = ctypes.c_int
    lib.ft_server_poll_accept.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ft_peer_close.restype = ctypes.c_int
    lib.ft_peer_close.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ft_poll.restype = ctypes.c_int
    lib.ft_poll.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.ft_client_create.restype = ctypes.c_void_p
    lib.ft_client_create.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.ft_send.restype = ctypes.c_int
    lib.ft_send.argtypes = [
        ctypes.c_void_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64, ctypes.c_int,
    ]
    lib.ft_recv.restype = ctypes.c_int
    lib.ft_recv.argtypes = [
        ctypes.c_void_p, ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_int,
    ]
    lib.ft_free.restype = None
    lib.ft_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
    lib.ft_close.restype = None
    lib.ft_close.argtypes = [ctypes.c_void_p]
    return lib


class TransportError(RuntimeError):
    pass


class DeadlineError(TransportError):
    """The phase deadline passed while the peer was still alive (slow)."""


class PeerDeadError(TransportError):
    """The peer's heartbeat lapsed or it exhausted its reconnect budget."""


_ERRORS = {-1: "socket error", -2: "timeout", -3: "peer closed", -4: "bad argument"}
_TIMEOUT, _CLOSED = -2, -3


def _check(rc: int, what: str) -> None:
    if rc < 0:
        cls = DeadlineError if rc == _TIMEOUT else TransportError
        raise cls(f"{what}: {_ERRORS.get(rc, rc)}")


@dataclasses.dataclass(frozen=True)
class Deadlines:
    """Per-phase transport deadlines and retry policy (all times in ms).

    The rendezvous, the object-valued init phase, and the (much longer)
    training-loop waits each get their own budget; ``train_ms`` is also
    the timeout of the participants' process group
    (:func:`fed_tgan_torch.parallel.multihost.initialize_multihost`), so
    a collective with a dead peer fails instead of hanging.  Every field
    can be overridden with an env var named
    ``FED_TGAN_TORCH_TRANSPORT_<FIELD>`` (upper-cased), e.g.
    ``FED_TGAN_TORCH_TRANSPORT_HEARTBEAT_TIMEOUT_MS=5000``.
    """

    connect_ms: int = 600_000        # initial rendezvous / accept
    init_ms: int = 600_000           # init-protocol sends/recvs
    train_ms: int = 3_600_000        # training-loop recvs (rounds are slow)
    heartbeat_interval_ms: int = 2_000
    heartbeat_timeout_ms: int = 30_000
    reconnect_max_tries: int = 5
    reconnect_base_ms: int = 100     # backoff: base * 2^attempt, capped
    reconnect_cap_ms: int = 5_000

    @classmethod
    def from_env(cls, **overrides) -> "Deadlines":
        vals = dict(overrides)
        for f in dataclasses.fields(cls):
            env = os.environ.get(f"{ENV_PREFIX}{f.name.upper()}")
            if env is not None and f.name not in vals:
                vals[f.name] = int(env)
        return cls(**vals)


class _Endpoint:
    def __init__(self, handle: int):
        self._lib = _load_library()
        self._handle = handle

    def _send_bytes(self, peer: int, payload: bytes, timeout_ms: int) -> None:
        buf = (ctypes.c_uint8 * len(payload)).from_buffer_copy(payload)
        _check(
            self._lib.ft_send(self._handle, peer, buf, len(payload), timeout_ms),
            "send",
        )

    def _recv_bytes(self, peer: int, timeout_ms: int) -> bytes:
        out = ctypes.POINTER(ctypes.c_uint8)()
        out_len = ctypes.c_uint64()
        _check(
            self._lib.ft_recv(
                self._handle, peer, ctypes.byref(out), ctypes.byref(out_len), timeout_ms
            ),
            "recv",
        )
        try:
            return ctypes.string_at(out, out_len.value)
        finally:
            self._lib.ft_free(out)

    def close(self) -> None:
        if self._handle:
            self._lib.ft_close(self._handle)
            self._handle = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _frame(seq: int, mtype: int, payload: bytes = b"") -> bytes:
    return _HEADER.pack(seq, mtype) + payload


def _unframe(raw: bytes) -> tuple[int, int, bytes]:
    if len(raw) < _HEADER.size:
        raise TransportError(f"short frame ({len(raw)} bytes)")
    seq, mtype = _HEADER.unpack_from(raw)
    return seq, mtype, raw[_HEADER.size:]


def _fault_plan():
    """The process-wide fault-injection plan, or None (lazy import: the
    testing package must not be a hard dependency of the wire path)."""
    try:
        from fed_tgan_torch.testing.faults import active_plan

        return active_plan()
    except Exception:
        return None


class ServerTransport(_Endpoint):
    """Rank-0 endpoint: accepts n clients, then object send/recv per rank.

    Tracks per-rank liveness from heartbeats, services mid-protocol
    reconnections (a lost rank re-appears through the listening socket and
    resyncs), and exposes ``dropped``/``mark_dropped`` so the federation
    layer can degrade gracefully instead of hanging on a dead peer.
    """

    _SLICE_MS = 200  # recv granularity: heartbeat/reconnect service cadence

    def __init__(self, port: int, n_clients: int, timeout_ms: int | None = None,
                 deadlines: Deadlines | None = None):
        self.deadlines = deadlines or Deadlines.from_env()
        if timeout_ms is None:
            timeout_ms = self.deadlines.connect_ms
        lib = _load_library()
        handle = lib.ft_server_create(port)
        if not handle:
            raise TransportError(
                f"cannot listen on port {port}{_last_errno_suffix(lib)}"
            )
        super().__init__(handle)
        self.n_clients = n_clients
        self.dropped: set[int] = set()
        # guards membership + per-rank sequence/liveness maps: the maps are
        # read on the protocol thread but every mutation rides under one
        # lock, so a multi-threaded server stays consistent
        self._state_lock = threading.Lock()
        now = time.monotonic()
        self._send_seq = {r: 0 for r in range(1, n_clients + 1)}
        self._recv_seq = {r: 0 for r in range(1, n_clients + 1)}
        self._last_sent: dict[int, bytes] = {}
        self._last_alive = {r: now for r in range(1, n_clients + 1)}
        rc = lib.ft_server_accept(handle, n_clients, timeout_ms)
        if rc < 0:
            self.close()
            _check(rc, "accept")
        now = time.monotonic()
        for r in self._last_alive:
            self._last_alive[r] = now

    # -- liveness / membership ------------------------------------------------

    def live_ranks(self) -> list[int]:
        return [r for r in range(1, self.n_clients + 1) if r not in self.dropped]

    def mark_dropped(self, rank: int, reason: str = "") -> None:
        if rank in self.dropped:
            return
        with self._state_lock:
            self.dropped.add(rank)
        self._lib.ft_peer_close(self._handle, rank)
        _DROPS.inc()
        _emit_event("transport_drop", rank=rank, reason=reason)
        log.warning("transport: dropped client rank %d%s", rank,
                    f" ({reason})" if reason else "")

    def _service_reconnects(self, budget_ms: int = 0) -> Optional[int]:
        """Absorb at most one pending reconnection; returns its rank."""
        rank = self._lib.ft_server_poll_accept(self._handle, budget_ms)
        if rank <= 0:
            return None
        if rank in self.dropped:
            # membership is final once weights were renormalized
            self._lib.ft_peer_close(self._handle, rank)
            log.warning("transport: refused reconnect from dropped rank %d", rank)
            return None
        self._resync(rank)
        with self._state_lock:
            self._last_alive[rank] = time.monotonic()
        _RECONNECTS.inc()
        _emit_event("transport_reconnect", role="server", rank=rank)
        log.warning("transport: client rank %d reconnected", rank)
        return rank

    def _resync(self, rank: int) -> None:
        """Server half of the reconnect handshake: learn what the client saw,
        acknowledge what we saw, and resend the one frame the cut may have
        eaten in our direction."""
        raw = self._recv_bytes(rank, 10_000)
        seq, mtype, payload = _unframe(raw)
        if mtype != _RESYNC:
            raise TransportError(
                f"rank {rank}: expected RESYNC after reconnect, got type {mtype}"
            )
        cl_recv, cl_send = pickle.loads(payload)
        ack = pickle.dumps((self._recv_seq[rank], self._send_seq[rank]),
                           protocol=pickle.HIGHEST_PROTOCOL)
        self._send_bytes(rank, _frame(0, _RESYNC_ACK, ack), 10_000)
        if cl_recv < self._send_seq[rank]:
            if self._send_seq[rank] - cl_recv != 1 or rank not in self._last_sent:
                raise TransportError(
                    f"rank {rank}: unrecoverable sequence gap "
                    f"(peer saw {cl_recv}, we sent {self._send_seq[rank]})"
                )
            self._send_bytes(rank, self._last_sent[rank], 10_000)
        # if cl_send > self._recv_seq[rank] the client resends after the ack;
        # the sequence check in recv_obj dedups anything duplicated

    def _check_liveness(self, rank: int) -> None:
        lapse_s = self.deadlines.heartbeat_timeout_ms / 1000.0
        if time.monotonic() - self._last_alive[rank] > lapse_s:
            _LAPSES.inc()
            _emit_event("heartbeat_lapse", rank=rank,
                        timeout_ms=self.deadlines.heartbeat_timeout_ms)
            raise PeerDeadError(
                f"rank {rank}: heartbeat lapsed "
                f"(> {self.deadlines.heartbeat_timeout_ms} ms without a frame)"
            )

    # -- object API -----------------------------------------------------------

    def send_obj(self, rank: int, obj: Any, timeout_ms: int | None = None) -> None:
        if rank in self.dropped:
            raise PeerDeadError(f"rank {rank} was dropped")
        budget = timeout_ms if timeout_ms is not None else self.deadlines.init_ms
        deadline = time.monotonic() + budget / 1000.0
        plan = _fault_plan()
        if plan is not None:
            plan.maybe_delay()
        seq = self._send_seq[rank] + 1
        frame = _frame(seq, _DATA,
                       pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL))
        while True:
            remaining = int((deadline - time.monotonic()) * 1000)
            if remaining <= 0:
                raise DeadlineError(f"send to rank {rank}: deadline passed")
            try:
                self._send_bytes(rank, frame, remaining)
                break
            except DeadlineError:
                raise
            except TransportError:
                # connection gone: wait for the client to reconnect, resync,
                # then retry (the sequence number makes the retry idempotent)
                self._await_reconnect(rank, deadline)
        with self._state_lock:
            self._send_seq[rank] = seq
            self._last_sent[rank] = frame

    def recv_obj(self, rank: int, timeout_ms: int | None = None) -> Any:
        if rank in self.dropped:
            raise PeerDeadError(f"rank {rank} was dropped")
        budget = timeout_ms if timeout_ms is not None else self.deadlines.init_ms
        deadline = time.monotonic() + budget / 1000.0
        while True:
            remaining = int((deadline - time.monotonic()) * 1000)
            if remaining <= 0:
                raise DeadlineError(f"recv from rank {rank}: deadline passed")
            # poll first (no bytes consumed): a slice timeout mid-frame must
            # not corrupt the stream; the real recv below gets the full
            # remaining budget once a frame has started arriving
            ready = self._lib.ft_poll(self._handle, rank,
                                      min(self._SLICE_MS, remaining))
            if ready == 0:
                self._service_reconnects(0)
                self._check_liveness(rank)
                continue
            if ready < 0:
                self._await_reconnect(rank, deadline)
                continue
            try:
                raw = self._recv_bytes(rank, remaining)
            except DeadlineError:
                raise
            except TransportError:
                self._await_reconnect(rank, deadline)
                continue
            with self._state_lock:
                self._last_alive[rank] = time.monotonic()
            seq, mtype, payload = _unframe(raw)
            if mtype == _HEARTBEAT:
                continue
            if mtype == _RESYNC:
                # fd survived but the CLIENT saw a cut and reconnected races
                # are absorbed in _service_reconnects; a stray RESYNC on the
                # live fd means our previous fd died and poll_accept already
                # swapped it — run the same handshake minus the recv
                raise TransportError(
                    f"rank {rank}: unexpected RESYNC on live connection"
                )
            if mtype != _DATA:
                raise TransportError(f"rank {rank}: unknown frame type {mtype}")
            if seq <= self._recv_seq[rank]:
                continue  # duplicate of an already-accepted frame
            if seq != self._recv_seq[rank] + 1:
                raise TransportError(
                    f"rank {rank}: sequence gap (got {seq}, "
                    f"expected {self._recv_seq[rank] + 1})"
                )
            with self._state_lock:
                self._recv_seq[rank] = seq
            return pickle.loads(payload)

    def _await_reconnect(self, rank: int, deadline: float) -> None:
        """Block until ``rank`` re-appears through the listening socket (its
        connection died under us), bounded by heartbeat lapse and the phase
        deadline."""
        lapse_s = self.deadlines.heartbeat_timeout_ms / 1000.0
        lost_at = time.monotonic()
        log.warning("transport: lost connection to rank %d; awaiting reconnect",
                    rank)
        while True:
            now = time.monotonic()
            if now >= deadline:
                raise DeadlineError(
                    f"rank {rank}: deadline passed awaiting reconnect"
                )
            if now - lost_at > lapse_s:
                raise PeerDeadError(
                    f"rank {rank}: no reconnect within "
                    f"{self.deadlines.heartbeat_timeout_ms} ms"
                )
            if self._service_reconnects(self._SLICE_MS) == rank:
                return

    def broadcast(self, obj: Any, timeout_ms: int | None = None) -> None:
        for rank in self.live_ranks():
            self.send_obj(rank, obj, timeout_ms)

    def gather(self, timeout_ms: int | None = None) -> list:
        return [self.recv_obj(rank, timeout_ms) for rank in self.live_ranks()]

    def broadcast_surviving(
        self, obj: Any, timeout_ms: int | None = None
    ) -> list[int]:
        """Broadcast to every live rank, DROPPING any that is unreachable
        instead of failing the whole phase.  Returns the ranks dropped in
        this call."""
        newly_dropped: list[int] = []
        for rank in self.live_ranks():
            try:
                self.send_obj(rank, obj, timeout_ms)
            except TransportError as exc:
                self.mark_dropped(rank, str(exc))
                newly_dropped.append(rank)
        return newly_dropped

    def gather_surviving(
        self, timeout_ms: int | None = None
    ) -> tuple[dict[int, Any], list[int]]:
        """Gather from every live rank, DROPPING any that dies or misses the
        deadline instead of failing the whole phase.  Returns ``(results by
        rank, ranks dropped in this call)``."""
        results: dict[int, Any] = {}
        newly_dropped: list[int] = []
        for rank in self.live_ranks():
            try:
                results[rank] = self.recv_obj(rank, timeout_ms)
            except TransportError as exc:
                self.mark_dropped(rank, str(exc))
                newly_dropped.append(rank)
        return results, newly_dropped


class ClientTransport(_Endpoint):
    """Rank >= 1 endpoint; retries the rendezvous until the server is up.

    On a mid-protocol connection loss, reconnects with exponential backoff
    (bounded tries), resyncs sequence numbers with the server, and resends
    the one frame that may have been lost — so callers see a slow call, not
    a dead run.  A daemon heartbeat thread keeps the server's liveness view
    fresh between protocol messages.
    """

    def __init__(self, host: str, port: int, rank: int,
                 timeout_ms: int | None = None,
                 deadlines: Deadlines | None = None,
                 heartbeat: bool = True):
        self.deadlines = deadlines or Deadlines.from_env()
        if timeout_ms is None:
            timeout_ms = self.deadlines.connect_ms
        self._host, self._port = host, port
        lib = _load_library()
        handle = lib.ft_client_create(host.encode(), port, rank, timeout_ms)
        if not handle:
            raise TransportError(
                f"cannot reach server at {host}:{port}{_last_errno_suffix(lib)}"
            )
        super().__init__(handle)
        self.rank = rank
        self._send_seq = 0
        self._recv_seq = 0
        self._last_sent: Optional[bytes] = None
        self._sent_count = 0
        # serializes sends and the handle swap between the caller thread(s)
        # and the heartbeat thread (recv shares the socket full-duplex and
        # only ever runs in the thread that also reconnects)
        self._io_lock = threading.RLock()
        self._hb_stop = threading.Event()
        if heartbeat and self.deadlines.heartbeat_interval_ms > 0:
            t = threading.Thread(target=self._heartbeat_loop, daemon=True,
                                 name=f"ft-heartbeat-r{rank}")
            t.start()

    def _heartbeat_loop(self) -> None:
        interval = self.deadlines.heartbeat_interval_ms / 1000.0
        beat = _frame(0, _HEARTBEAT)
        while not self._hb_stop.wait(interval):
            try:
                with self._io_lock:
                    if not self._handle:
                        return
                    self._send_bytes(0, beat, 1_000)
            except TransportError:
                pass  # the protocol path owns reconnecting

    def close(self) -> None:
        self._hb_stop.set()
        with self._io_lock:
            super().close()

    # -- reconnect ------------------------------------------------------------

    def _reconnect(self) -> None:
        """Re-establish the connection with exponential backoff, then resync
        sequence numbers with the server (bounded tries -> PeerDeadError)."""
        dl = self.deadlines
        last_exc: Optional[Exception] = None
        for attempt in range(dl.reconnect_max_tries):
            if attempt:
                backoff = min(dl.reconnect_cap_ms,
                              dl.reconnect_base_ms * (2 ** (attempt - 1)))
                log.warning(
                    "transport: rank %d reconnect attempt %d/%d in %d ms",
                    self.rank, attempt + 1, dl.reconnect_max_tries, backoff)
                time.sleep(backoff / 1000.0)
            lib = self._lib
            handle = lib.ft_client_create(
                self._host.encode(), self._port, self.rank,
                max(dl.reconnect_base_ms, 1_000))
            if not handle:
                last_exc = TransportError(
                    f"reconnect to {self._host}:{self._port} failed"
                    f"{_last_errno_suffix(lib)}")
                continue
            with self._io_lock:
                if self._handle:
                    lib.ft_close(self._handle)
                self._handle = handle
            try:
                self._resync()
                _RECONNECTS.inc()
                _emit_event("transport_reconnect", role="client",
                            rank=self.rank, attempts=attempt + 1)
                log.warning("transport: rank %d reconnected and resynced",
                            self.rank)
                return
            except TransportError as exc:
                last_exc = exc
                continue
        raise PeerDeadError(
            f"rank {self.rank}: gave up after {dl.reconnect_max_tries} "
            f"reconnect attempts: {last_exc}")

    def _resync(self) -> None:
        state = pickle.dumps((self._recv_seq, self._send_seq),
                             protocol=pickle.HIGHEST_PROTOCOL)
        with self._io_lock:
            self._send_bytes(0, _frame(0, _RESYNC, state), 10_000)
        raw = self._recv_bytes(0, 10_000)
        seq, mtype, payload = _unframe(raw)
        if mtype != _RESYNC_ACK:
            raise TransportError(f"expected RESYNC_ACK, got type {mtype}")
        srv_recv, _srv_send = pickle.loads(payload)
        if srv_recv < self._send_seq:
            if self._send_seq - srv_recv != 1 or self._last_sent is None:
                raise TransportError(
                    f"unrecoverable sequence gap (server saw {srv_recv}, "
                    f"we sent {self._send_seq})")
            with self._io_lock:
                self._send_bytes(0, self._last_sent, 10_000)
        # any frame the SERVER resends is deduped by recv_obj's seq check

    # -- object API -----------------------------------------------------------

    def send_obj(self, obj: Any, timeout_ms: int | None = None) -> None:
        budget = timeout_ms if timeout_ms is not None else self.deadlines.init_ms
        deadline = time.monotonic() + budget / 1000.0
        plan = _fault_plan()
        if plan is not None:
            plan.maybe_delay()
        seq = self._send_seq + 1
        frame = _frame(seq, _DATA,
                       pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL))
        while True:
            remaining = int((deadline - time.monotonic()) * 1000)
            if remaining <= 0:
                raise DeadlineError("send: deadline passed")
            try:
                with self._io_lock:
                    self._send_bytes(0, frame, remaining)
                    # bookkeeping rides inside the same lock as the send so
                    # a concurrent reader never sees a frame on the wire
                    # with stale seq/replay state
                    self._send_seq = seq
                    self._last_sent = frame
                    self._sent_count += 1
                break
            except DeadlineError:
                raise
            except TransportError:
                self._reconnect()
        if plan is not None and plan.should_sever(self.rank, self._sent_count):
            # fault injection: sever our own live connection AFTER a
            # successful send so the next op exercises reconnect+resync
            log.warning("transport: FAULT severing rank %d connection",
                        self.rank)
            self._lib.ft_peer_close(self._handle, 0)

    def recv_obj(self, timeout_ms: int | None = None) -> Any:
        budget = timeout_ms if timeout_ms is not None else self.deadlines.init_ms
        deadline = time.monotonic() + budget / 1000.0
        while True:
            remaining = int((deadline - time.monotonic()) * 1000)
            if remaining <= 0:
                raise DeadlineError("recv: deadline passed")
            try:
                raw = self._recv_bytes(0, remaining)
            except DeadlineError:
                raise
            except TransportError:
                self._reconnect()
                continue
            seq, mtype, payload = _unframe(raw)
            if mtype in (_HEARTBEAT, _RESYNC_ACK):
                continue  # stale handshake leftovers are harmless
            if mtype != _DATA:
                raise TransportError(f"unknown frame type {mtype}")
            if seq <= self._recv_seq:
                continue  # duplicate after a resync resend
            if seq != self._recv_seq + 1:
                raise TransportError(
                    f"sequence gap (got {seq}, expected {self._recv_seq + 1})")
            self._recv_seq = seq
            return pickle.loads(payload)
