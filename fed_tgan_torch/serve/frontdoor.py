"""Asyncio HTTP front door of the fleet (counterpart of
``fed_tgan_tpu/serve/frontdoor.py``).

One event loop on one thread replaces the stdlib's thread per
connection.  Minimal HTTP/1.1: request line and headers,
``Content-Length`` bodies, keep-alive by default; any other shape gets a
clean 400 and a close.  All routing is
:meth:`~.fleet.FleetService.route`: this module parses bytes and renders
:class:`~.fleet.Response` objects, so the asyncio and threaded front
doors cannot disagree.  A response whose body is a list of byte segments
(a row-pool hit) is written with ``writelines``, without joining it; a
routed :class:`~.fleet.Pending` parks an ``asyncio`` future that the
batch worker's completion callback resolves with
``call_soon_threadsafe``, so no thread blocks per request.
"""

from __future__ import annotations

import asyncio
import json
import socket
import threading
import urllib.parse
from typing import Optional

from fed_tgan_torch.serve.fleet import Pending, Response, _json_response

#: request-line / header-block size guard (one line, all headers)
_MAX_HEADER_BYTES = 32 * 1024
_MAX_BODY_BYTES = 4 * 1024 * 1024

_REASONS = {
    200: "OK", 400: "Bad Request", 404: "Not Found", 410: "Gone",
    429: "Too Many Requests", 500: "Internal Server Error",
    503: "Service Unavailable", 504: "Gateway Timeout",
}


class AsyncFrontDoor:
    """Event-loop HTTP server adapting ``service.route``.

    Runs the loop on a dedicated thread so the blocking
    :class:`~.fleet.FleetService` lifecycle (start/shutdown from
    synchronous code, batch workers on their own threads) stays
    unchanged.  ``start()`` blocks until the socket is bound, so
    ``port`` is always readable afterwards.
    """

    def __init__(self, service, host: str = "127.0.0.1", port: int = 0,
                 request_timeout_s: float = 120.0):
        self.service = service
        self.host = host
        self.request_timeout_s = request_timeout_s
        self._requested_port = port
        self._port: Optional[int] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._thread: Optional[threading.Thread] = None
        self._ready = threading.Event()
        self._startup_error: Optional[BaseException] = None

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "AsyncFrontDoor":
        self._thread = threading.Thread(target=self._run,
                                        name="fleet-frontdoor", daemon=True)
        self._thread.start()
        self._ready.wait(timeout=30)
        if self._startup_error is not None:
            raise self._startup_error
        if self._port is None:
            raise RuntimeError("front door failed to bind within 30 s")
        return self

    @property
    def port(self) -> int:
        assert self._port is not None, "start() first"
        return self._port

    def stop(self) -> None:
        loop = self._loop
        if loop is not None and loop.is_running():
            loop.call_soon_threadsafe(self._shutdown)
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def _shutdown(self) -> None:
        if self._server is not None:
            self._server.close()
        for task in asyncio.all_tasks(self._loop):
            task.cancel()

    def _run(self) -> None:
        loop = asyncio.new_event_loop()
        self._loop = loop
        asyncio.set_event_loop(loop)
        try:
            loop.run_until_complete(self._serve())
        except asyncio.CancelledError:
            pass
        except BaseException as exc:  # noqa: BLE001 — surface via start()
            self._startup_error = exc
            self._ready.set()
        finally:
            try:
                loop.run_until_complete(loop.shutdown_asyncgens())
            except (RuntimeError, asyncio.CancelledError):
                pass
            loop.close()

    async def _serve(self) -> None:
        self._server = await asyncio.start_server(
            self._handle_connection, self.host, self._requested_port)
        sock = self._server.sockets[0]
        self._port = sock.getsockname()[1]
        self._ready.set()
        try:
            await self._server.serve_forever()
        except asyncio.CancelledError:
            pass
        finally:
            self._server.close()
            try:
                await self._server.wait_closed()
            except asyncio.CancelledError:
                pass

    # ----------------------------------------------------------- connection

    async def _handle_connection(self, reader: asyncio.StreamReader,
                                 writer: asyncio.StreamWriter) -> None:
        sock = writer.get_extra_info("socket")
        if sock is not None:
            # without NODELAY every small response eats a Nagle/delayed-ACK
            # round trip (~40 ms) — the exact artifact this door removes
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            while True:
                keep_alive = await self._handle_one(reader, writer)
                if not keep_alive:
                    break
        except (ConnectionResetError, BrokenPipeError,
                asyncio.IncompleteReadError, asyncio.CancelledError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError, OSError,
                    asyncio.CancelledError):
                pass

    async def _handle_one(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> bool:
        """Serve one request; returns False when the connection must
        close (EOF, parse error, or an explicit Connection: close)."""
        try:
            head = await reader.readuntil(b"\r\n\r\n")
        except asyncio.IncompleteReadError as exc:
            if exc.partial:
                await self._write(writer, _json_response(
                    400, {"error": "truncated request"}), close=True)
            return False
        except asyncio.LimitOverrunError:
            await self._write(writer, _json_response(
                400, {"error": "header block too large"}), close=True)
            return False
        if len(head) > _MAX_HEADER_BYTES:
            await self._write(writer, _json_response(
                400, {"error": "header block too large"}), close=True)
            return False
        try:
            request_line, headers = self._parse_head(head)
            method, target, _version = request_line
        except ValueError as exc:
            await self._write(writer, _json_response(
                400, {"error": str(exc)}), close=True)
            return False
        want_close = headers.get("connection", "").lower() == "close"
        body = b""
        length = headers.get("content-length")
        if length is not None:
            try:
                n = int(length)
                if n < 0 or n > _MAX_BODY_BYTES:
                    raise ValueError
            except ValueError:
                await self._write(writer, _json_response(
                    400, {"error": f"bad Content-Length {length!r}"}),
                    close=True)
                return False
            body = await reader.readexactly(n)

        parsed = urllib.parse.urlsplit(target)
        params = {k: v[-1] for k, v in
                  urllib.parse.parse_qs(parsed.query).items()}
        if method == "POST" and body:
            try:
                extra = json.loads(body)
                if not isinstance(extra, dict):
                    raise ValueError("body must be a JSON object")
                params.update(extra)
            except (ValueError, json.JSONDecodeError) as exc:
                await self._write(writer, _json_response(
                    400, {"error": f"bad JSON body: {exc}"}),
                    close=want_close)
                return not want_close
        if method not in ("GET", "POST"):
            await self._write(writer, _json_response(
                404, {"error": f"unsupported method {method}"}),
                close=want_close)
            return not want_close

        resp = await self._route(method, parsed.path, params)
        await self._write(writer, resp, close=want_close)
        return not want_close

    @staticmethod
    def _parse_head(head: bytes):
        lines = head.decode("latin-1").split("\r\n")
        parts = lines[0].split(" ")
        if len(parts) != 3:
            raise ValueError(f"malformed request line {lines[0]!r}")
        headers = {}
        for line in lines[1:]:
            if not line:
                continue
            name, sep, value = line.partition(":")
            if not sep:
                raise ValueError(f"malformed header {line!r}")
            headers[name.strip().lower()] = value.strip()
        return (parts[0], parts[1], parts[2]), headers

    async def _route(self, method: str, path: str,
                     params: dict) -> Response:
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()

        def on_done(req) -> None:
            # worker thread -> event loop; the future may already be
            # cancelled by the timeout below, so guard the set
            def flip() -> None:
                if not fut.done():
                    fut.set_result(req)
            loop.call_soon_threadsafe(flip)

        routed = self.service.route(method, path, params, on_done=on_done)
        if isinstance(routed, Response):
            return routed
        assert isinstance(routed, Pending)
        try:
            await asyncio.wait_for(fut, timeout=self.request_timeout_s)
        except asyncio.TimeoutError:
            pass
        return self.service.response_for(routed.req)

    async def _write(self, writer: asyncio.StreamWriter, resp: Response,
                     close: bool = False) -> None:
        reason = _REASONS.get(resp.status, "Unknown")
        head = [f"HTTP/1.1 {resp.status} {reason}",
                f"Content-Type: {resp.ctype}",
                f"Content-Length: {resp.content_length()}",
                f"Connection: {'close' if close else 'keep-alive'}"]
        for k, v in (resp.headers or {}).items():
            head.append(f"{k}: {v}")
        writer.write(("\r\n".join(head) + "\r\n\r\n").encode("latin-1"))
        if isinstance(resp.body, bytes):
            writer.write(resp.body)
        else:
            # the zero-copy path: pre-serialized segments (row-pool CSV
            # lines) go straight to the transport, no intermediate join
            writer.writelines(resp.body)
        await writer.drain()
