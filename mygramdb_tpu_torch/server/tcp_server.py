"""TCP text-protocol server (asyncio event loop).

The reference pairs an epoll/kqueue reactor (server/io_reactor.h) with a
fixed thread pool (server/thread_pool.h) and one drain-task per connection
(reactor_connection.cpp:332). The asyncio translation: the event loop IS
the reactor; each connection task drains its own frame queue sequentially
(at most one in-flight command per connection, preserving per-connection
ordering) while command execution runs on a bounded executor so device
calls never block the loop.

Parity features: CRLF framing, CIDR allow-list (fail-closed when empty),
max_connections cap, idle reaper + first-frame timeout, slow-reader
write cap, per-IP rate limiting, Unix-domain socket listener, SERVER_BUSY
backpressure when the executor queue is full.

Each command's wait for an executor thread is counted
(``ServerStats.executor_wait_s``). With ``utils.trace`` on, a command gets
a request id where its line is read, and the spans ``server.handoff_in``
(from the hand-off on the loop to the worker starting it),
``server.handoff_out`` (from the worker's return to the connection task
resuming) and ``server.write`` (the answer's write and drain).
"""

from __future__ import annotations

import asyncio
import ipaddress
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

from ..utils import trace
from ..utils.structured_log import StructuredLog
from .core import ConnState, ServerCore

MAX_FRAME = 1 << 20          # 1 MiB per request line
WRITE_QUEUE_CAP = 16 << 20   # slow-reader force-close (config.h:339-346)
IDLE_TIMEOUT = 300.0         # idle reaper (io_reactor.h:66-80)
FIRST_FRAME_TIMEOUT = 60.0


def _auto_workers() -> int:
    return max(4 * (os.cpu_count() or 1), 64)


class CidrAcl:
    """Fail-closed CIDR allow list (reference connection_acceptor ACL)."""

    def __init__(self, cidrs: List[str]):
        self._nets = [ipaddress.ip_network(c, strict=False) for c in cidrs]

    def allowed(self, ip: str) -> bool:
        if not self._nets:
            return False
        try:
            addr = ipaddress.ip_address(ip)
        except ValueError:
            return False
        return any(addr in n for n in self._nets)


class TcpServer:
    def __init__(self, core: ServerCore, config,
                 executor: Optional[ThreadPoolExecutor] = None):
        self.core = core
        self.config = config
        self.acl = CidrAcl(config.network.allow_cidrs)
        workers = _auto_workers()
        self.executor = executor or ThreadPoolExecutor(
            max_workers=min(workers, 64), thread_name_prefix="mygram-worker")
        # bounded in-flight commands: SERVER_BUSY past this (thread_pool
        # bounded queue analog, config.h:334-337)
        self._inflight = asyncio.Semaphore(1000)
        self._server: Optional[asyncio.AbstractServer] = None
        self._unix_server: Optional[asyncio.AbstractServer] = None
        self._conn_tasks: set = set()
        self.port: Optional[int] = None

    # ------------------------------------------------------------------
    async def start(self) -> None:
        tcp = self.config.api.tcp
        self._server = await asyncio.start_server(
            self._on_connect, host=tcp.bind, port=tcp.port,
            limit=MAX_FRAME)
        self.port = self._server.sockets[0].getsockname()[1]
        StructuredLog().event("tcp_server_started").field(
            "bind", tcp.bind).field("port", self.port).info()
        usock = self.config.api.unix_socket.path
        if usock:
            self._unix_server = await asyncio.start_unix_server(
                self._on_connect_unix, path=usock, limit=MAX_FRAME)
            StructuredLog().event("unix_server_started").field(
                "path", usock).info()

    async def stop(self) -> None:
        # order matters: stop accepting, CANCEL handlers, then wait.
        # On Python >= 3.12 Server.wait_closed() blocks until every
        # connection handler returns — waiting before cancelling hangs
        # stop() behind idle connections (up to IDLE_TIMEOUT).
        for srv in (self._server, self._unix_server):
            if srv is not None:
                srv.close()
        tasks = list(self._conn_tasks)
        for t in tasks:
            t.cancel()
        if tasks:
            await asyncio.gather(*tasks, return_exceptions=True)
        for srv in (self._server, self._unix_server):
            if srv is not None:
                await srv.wait_closed()
        self.executor.shutdown(wait=False)

    # ------------------------------------------------------------------
    async def _on_connect(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        peer = writer.get_extra_info("peername")
        ip = peer[0] if peer else "0.0.0.0"
        if not self.acl.allowed(ip):
            self.core.stats.record_rejected()
            writer.close()
            return
        await self._serve(reader, writer, ip)

    async def _on_connect_unix(self, reader: asyncio.StreamReader,
                               writer: asyncio.StreamWriter) -> None:
        await self._serve(reader, writer, "unix")

    async def _serve(self, reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter, ip: str) -> None:
        stats = self.core.stats
        if stats.current_connections >= self.config.api.tcp.max_connections:
            stats.record_rejected()
            writer.close()
            return
        stats.record_connection(True)
        conn = ConnState(client_ip=ip)
        task = asyncio.current_task()
        self._conn_tasks.add(task)
        loop = asyncio.get_running_loop()
        limiter = self.core.rate_limiter
        try:
            first = True
            while True:
                timeout = FIRST_FRAME_TIMEOUT if first else IDLE_TIMEOUT
                try:
                    raw = await asyncio.wait_for(reader.readline(), timeout)
                except asyncio.TimeoutError:
                    break
                except (ConnectionResetError, BrokenPipeError):
                    break
                if not raw:
                    break
                first = False
                line = raw.decode("utf-8", errors="replace").rstrip("\r\n")
                if not line:
                    continue
                if line in ("QUIT", "quit", "exit"):
                    break
                if ip != "unix" and not limiter.allow(ip):
                    stats.record_rate_limited()
                    writer.write(b"ERROR rate limit exceeded\r\n")
                    await writer.drain()
                    continue
                if self._inflight.locked():
                    writer.write(b"ERROR SERVER_BUSY\r\n")
                    await writer.drain()
                    continue
                rid = trace.new_request() if trace.enabled else None
                async with self._inflight:
                    resp, t_ret = await loop.run_in_executor(
                        self.executor, self._on_worker, line, conn,
                        trace.clock(), rid)
                if rid is not None:
                    t_write = trace.clock()
                    trace.record("server.handoff_out", t_ret, t_write, rid)
                data = resp.encode("utf-8") + b"\r\n"
                if writer.transport.get_write_buffer_size() + len(data) > \
                        WRITE_QUEUE_CAP:
                    StructuredLog().event("slow_reader_closed").field(
                        "ip", ip).warn()
                    break
                writer.write(data)
                try:
                    await writer.drain()
                except (ConnectionResetError, BrokenPipeError):
                    break
                if rid is not None:
                    trace.record("server.write", t_write, trace.clock(), rid)
        finally:
            stats.record_connection(False)
            self._conn_tasks.discard(task)
            try:
                writer.close()
            except Exception:
                pass

    def _on_worker(self, line: str, conn: ConnState, t_submit: float,
                   rid):
        """``handle_line`` on an executor thread, its wait since
        ``t_submit`` (the loop's hand-off) counted. -> (the answer, the
        trace clock at its return where rid is a request id, else 0)."""
        t_start = trace.clock()
        if rid is None:
            return self.core.handle_line(line, conn, t_start - t_submit), 0.0
        trace.record("server.handoff_in", t_submit, t_start, rid)
        with trace.request(rid):
            resp = self.core.handle_line(line, conn, t_start - t_submit)
        return resp, trace.clock()
