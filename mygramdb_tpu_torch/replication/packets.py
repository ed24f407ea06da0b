"""MySQL client/server wire protocol (raw, no libmysqlclient).

The reference wraps libmysqlclient (mysql/connection.h:69); this framework
speaks the protocol directly: packet framing, handshake v10,
mysql_native_password and caching_sha2_password (fast path) auth, COM_QUERY
text resultsets, COM_REGISTER_SLAVE, COM_BINLOG_DUMP_GTID (MySQL) and
COM_BINLOG_DUMP after @slave_connect_state (MariaDB).
"""

from __future__ import annotations

import hashlib
import socket
import ssl as ssl_mod
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..utils.errors import ProtocolError, ErrorCode
from .rows import ByteReader

# capability flags
CLIENT_LONG_PASSWORD = 1
CLIENT_LONG_FLAG = 1 << 2
CLIENT_CONNECT_WITH_DB = 1 << 3
CLIENT_PROTOCOL_41 = 1 << 9
CLIENT_SSL = 1 << 11
CLIENT_TRANSACTIONS = 1 << 13
CLIENT_SECURE_CONNECTION = 1 << 15
CLIENT_MULTI_RESULTS = 1 << 17
CLIENT_PLUGIN_AUTH = 1 << 19
CLIENT_PLUGIN_AUTH_LENENC = 1 << 21
CLIENT_DEPRECATE_EOF = 1 << 24

COM_QUIT = 0x01
COM_QUERY = 0x03
COM_PING = 0x0E
COM_BINLOG_DUMP = 0x12
COM_REGISTER_SLAVE = 0x15
COM_BINLOG_DUMP_GTID = 0x1E

BINLOG_DUMP_NON_BLOCK = 0x01
BINLOG_THROUGH_GTID = 0x04


def _err(msg: str, code=ErrorCode.MYSQL_PROTOCOL) -> ProtocolError:
    return ProtocolError(msg, code)


@dataclass
class Handshake:
    protocol_version: int
    server_version: str
    thread_id: int
    auth_data: bytes
    capabilities: int
    charset: int
    status: int
    auth_plugin: str

    @property
    def is_mariadb(self) -> bool:
        return "mariadb" in self.server_version.lower()


@dataclass
class OkPacket:
    affected_rows: int = 0
    last_insert_id: int = 0
    status: int = 0
    warnings: int = 0
    info: str = ""


@dataclass
class ErrPacket:
    code: int
    sql_state: str
    message: str


def parse_handshake(payload: bytes) -> Handshake:
    r = ByteReader(payload)
    proto = r.u8()
    if proto != 10:
        raise _err(f"unsupported handshake protocol {proto}")
    end = payload.index(b"\x00", r.pos)
    server_version = payload[r.pos:end].decode("utf-8", "replace")
    r.pos = end + 1
    thread_id = r.u32()
    auth1 = r.read(8)
    r.read(1)  # filler
    cap_low = r.u16()
    charset = r.u8()
    status = r.u16()
    cap_high = r.u16()
    caps = cap_low | (cap_high << 16)
    auth_len = r.u8()
    r.read(10)  # reserved
    auth2 = b""
    if caps & CLIENT_SECURE_CONNECTION:
        n = max(13, auth_len - 8)
        auth2 = r.read(n)
        auth2 = auth2.rstrip(b"\x00")
    plugin = ""
    if caps & CLIENT_PLUGIN_AUTH:
        rest = payload[r.pos:]
        plugin = rest.split(b"\x00", 1)[0].decode("ascii", "replace")
    return Handshake(proto, server_version, thread_id, auth1 + auth2,
                     caps, charset, status, plugin)


def scramble_native(password: str, nonce: bytes) -> bytes:
    """mysql_native_password: SHA1(p) XOR SHA1(nonce + SHA1(SHA1(p)))."""
    if not password:
        return b""
    p1 = hashlib.sha1(password.encode("utf-8")).digest()
    p2 = hashlib.sha1(p1).digest()
    p3 = hashlib.sha1(nonce + p2).digest()
    return bytes(a ^ b for a, b in zip(p1, p3))


def scramble_sha2(password: str, nonce: bytes) -> bytes:
    """caching_sha2_password fast-auth scramble:
    XOR(SHA256(p), SHA256(SHA256(SHA256(p)) + nonce))."""
    if not password:
        return b""
    p1 = hashlib.sha256(password.encode("utf-8")).digest()
    p2 = hashlib.sha256(p1).digest()
    p3 = hashlib.sha256(p2 + nonce).digest()
    return bytes(a ^ b for a, b in zip(p1, p3))


def _lenc_int(n: int) -> bytes:
    if n < 0xFB:
        return bytes([n])
    if n <= 0xFFFF:
        return b"\xfc" + struct.pack("<H", n)
    if n <= 0xFFFFFF:
        return b"\xfd" + struct.pack("<I", n)[:3]
    return b"\xfe" + struct.pack("<Q", n)


def build_handshake_response(user: str, password: str, database: str,
                             handshake: Handshake,
                             plugin_override: str = "") -> Tuple[bytes, str]:
    """-> (payload, plugin_used)."""
    caps = (CLIENT_LONG_PASSWORD | CLIENT_LONG_FLAG | CLIENT_PROTOCOL_41 |
            CLIENT_TRANSACTIONS | CLIENT_SECURE_CONNECTION |
            CLIENT_MULTI_RESULTS | CLIENT_PLUGIN_AUTH)
    if database:
        caps |= CLIENT_CONNECT_WITH_DB
    plugin = plugin_override or handshake.auth_plugin or \
        "mysql_native_password"
    nonce = handshake.auth_data[:20]
    if plugin == "caching_sha2_password":
        auth = scramble_sha2(password, nonce)
    else:
        plugin = "mysql_native_password"
        auth = scramble_native(password, nonce)
    payload = struct.pack("<IIB23x", caps, 1 << 24, 45)  # utf8mb4
    payload += user.encode("utf-8") + b"\x00"
    payload += bytes([len(auth)]) + auth
    if database:
        payload += database.encode("utf-8") + b"\x00"
    payload += plugin.encode("ascii") + b"\x00"
    return payload, plugin


def parse_ok(payload: bytes) -> OkPacket:
    r = ByteReader(payload)
    r.u8()  # 0x00 header
    affected = r.lenc() or 0
    last_id = r.lenc() or 0
    status = r.u16() if r.remaining() >= 2 else 0
    warnings = r.u16() if r.remaining() >= 2 else 0
    info = payload[r.pos:].decode("utf-8", "replace") if r.remaining() else ""
    return OkPacket(affected, last_id, status, warnings, info)


def parse_err(payload: bytes) -> ErrPacket:
    r = ByteReader(payload)
    r.u8()  # 0xFF
    code = r.u16()
    rest = payload[r.pos:]
    sql_state = ""
    if rest[:1] == b"#":
        sql_state = rest[1:6].decode("ascii", "replace")
        rest = rest[6:]
    return ErrPacket(code, sql_state, rest.decode("utf-8", "replace"))


def read_lenc_str(r: ByteReader) -> Optional[str]:
    n = r.lenc()
    if n is None:
        return None
    return r.read(n).decode("utf-8", "replace")


class PacketStream:
    """Framed packet I/O over a blocking socket."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.seq = 0

    def _recv_exact(self, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise _err("connection closed by server",
                           ErrorCode.MYSQL_CONNECTION)
            buf.extend(chunk)
        return bytes(buf)

    def read_packet(self) -> bytes:
        """One logical packet (handles 16MB continuation)."""
        payload = bytearray()
        while True:
            header = self._recv_exact(4)
            length = header[0] | (header[1] << 8) | (header[2] << 16)
            self.seq = (header[3] + 1) & 0xFF
            payload.extend(self._recv_exact(length))
            if length < 0xFFFFFF:
                break
        return bytes(payload)

    def write_packet(self, payload: bytes, reset_seq: bool = False) -> None:
        if reset_seq:
            self.seq = 0
        pos = 0
        while True:
            chunk = payload[pos:pos + 0xFFFFFF]
            header = struct.pack("<I", len(chunk))[:3] + bytes([self.seq])
            self.sock.sendall(header + chunk)
            self.seq = (self.seq + 1) & 0xFF
            pos += len(chunk)
            if len(chunk) < 0xFFFFFF:
                break

    def close(self) -> None:
        # shutdown BEFORE close: close() alone does not wake a reader
        # thread blocked in recv() (the fd stays pinned by the syscall),
        # which would make BinlogReader.stop() hang past its join
        # timeout (reference stop contract:
        # binlog_reader_stop_contract_test.cpp
        # StopJoinsWorkerThreadSynchronously)
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass
