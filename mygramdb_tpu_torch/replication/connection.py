"""MySQL connection: connect/auth/query/binlog-dump over raw sockets.

Reference mysql/connection.{h,cpp} + connection_validator.cpp: connect with
timeouts and optional TLS, execute queries (text protocol), validate
replication prerequisites (GTID mode, binlog format ROW, row image FULL),
fetch table column metadata from INFORMATION_SCHEMA, and open the binlog
stream (COM_BINLOG_DUMP_GTID / MariaDB dialect).
"""

from __future__ import annotations

import socket
import ssl as ssl_mod
import struct
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from ..utils.errors import ProtocolError, ErrorCode
from ..utils.structured_log import StructuredLog
from . import packets as pk
from .gtid import GtidSet
from .rows import ByteReader


def _err(msg: str, code=ErrorCode.MYSQL_PROTOCOL) -> ProtocolError:
    return ProtocolError(msg, code)


@dataclass
class ResultSet:
    columns: List[str]
    rows: List[List[Optional[str]]]

    def scalar(self) -> Optional[str]:
        return self.rows[0][0] if self.rows and self.rows[0] else None

    def dict_rows(self) -> List[Dict[str, Optional[str]]]:
        return [dict(zip(self.columns, r)) for r in self.rows]


class MysqlConnection:
    """Blocking MySQL client connection (one per purpose, like the
    reference's main/binlog/metadata connection split)."""

    def __init__(self, host: str, port: int, user: str, password: str,
                 database: str = "", connect_timeout: float = 3.0,
                 ssl_enable: bool = False, ssl_ca: str = "",
                 ssl_verify: bool = True):
        self.host = host
        self.port = port
        self.user = user
        self.password = password
        self.database = database
        self.connect_timeout = connect_timeout
        self.ssl_enable = ssl_enable
        self.ssl_ca = ssl_ca
        self.ssl_verify = ssl_verify
        self.stream: Optional[pk.PacketStream] = None
        self.handshake: Optional[pk.Handshake] = None
        self.server_uuid: str = ""
        self._lock = threading.Lock()

    # ------------------------------------------------------------------
    @property
    def connected(self) -> bool:
        return self.stream is not None

    @property
    def is_mariadb(self) -> bool:
        return bool(self.handshake and self.handshake.is_mariadb)

    def connect(self) -> None:
        sock = socket.create_connection((self.host, self.port),
                                        timeout=self.connect_timeout)
        sock.settimeout(None)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        stream = pk.PacketStream(sock)
        payload = stream.read_packet()
        if payload[:1] == b"\xff":
            e = pk.parse_err(payload)
            raise _err(f"server refused connection: {e.message}",
                       ErrorCode.MYSQL_CONNECTION)
        hs = pk.parse_handshake(payload)
        self.handshake = hs
        if self.ssl_enable:
            if not hs.capabilities & pk.CLIENT_SSL:
                raise _err("server does not support TLS",
                           ErrorCode.MYSQL_CONNECTION)
            ssl_req = struct.pack("<IIB23x",
                                  pk.CLIENT_SSL | pk.CLIENT_PROTOCOL_41 |
                                  pk.CLIENT_SECURE_CONNECTION,
                                  1 << 24, 45)
            stream.write_packet(ssl_req)
            ctx = ssl_mod.create_default_context(
                cafile=self.ssl_ca or None)
            if not self.ssl_verify:
                ctx.check_hostname = False
                ctx.verify_mode = ssl_mod.CERT_NONE
            stream.sock = ctx.wrap_socket(sock, server_hostname=self.host)
        resp, plugin = pk.build_handshake_response(
            self.user, self.password, self.database, hs)
        stream.write_packet(resp)
        self._finish_auth(stream, plugin)
        self.stream = stream

    def _finish_auth(self, stream: pk.PacketStream, plugin: str) -> None:
        while True:
            payload = stream.read_packet()
            first = payload[0]
            if first == 0x00:
                return  # OK
            if first == 0xFF:
                e = pk.parse_err(payload)
                raise _err(f"authentication failed: {e.message}",
                           ErrorCode.MYSQL_CONNECTION)
            if first == 0xFE:
                # auth switch request
                rest = payload[1:]
                new_plugin = rest.split(b"\x00", 1)[0].decode("ascii")
                nonce = rest.split(b"\x00", 1)[1].rstrip(b"\x00")
                if new_plugin == "mysql_native_password":
                    stream.write_packet(
                        pk.scramble_native(self.password, nonce))
                elif new_plugin == "caching_sha2_password":
                    stream.write_packet(
                        pk.scramble_sha2(self.password, nonce))
                else:
                    raise _err(f"unsupported auth plugin {new_plugin}",
                               ErrorCode.MYSQL_CONNECTION)
                plugin = new_plugin
                continue
            if first == 0x01:
                # caching_sha2 continuation: 0x03 fast-auth ok, 0x04 full
                if len(payload) >= 2 and payload[1] == 0x03:
                    continue  # OK packet follows
                if len(payload) >= 2 and payload[1] == 0x04:
                    if isinstance(stream.sock, ssl_mod.SSLSocket):
                        stream.write_packet(
                            self.password.encode("utf-8") + b"\x00")
                        continue
                    raise _err(
                        "caching_sha2_password full authentication requires "
                        "TLS (enable mysql.ssl_enable) or a cached server-"
                        "side entry", ErrorCode.MYSQL_CONNECTION)
            else:
                raise _err(f"unexpected auth packet {first:#x}",
                           ErrorCode.MYSQL_CONNECTION)

    def close(self) -> None:
        if self.stream is not None:
            try:
                self.stream.write_packet(bytes([pk.COM_QUIT]),
                                         reset_seq=True)
            except Exception:
                pass
            self.stream.close()
            self.stream = None

    def ping(self) -> bool:
        if self.stream is None:
            return False
        try:
            with self._lock:
                self.stream.write_packet(bytes([pk.COM_PING]),
                                         reset_seq=True)
                payload = self.stream.read_packet()
            return payload[:1] == b"\x00"
        except Exception:
            return False

    # ------------------------------------------------------------------
    def query(self, sql: str) -> ResultSet:
        if self.stream is None:
            raise _err("not connected", ErrorCode.MYSQL_CONNECTION)
        with self._lock:
            self.stream.write_packet(
                bytes([pk.COM_QUERY]) + sql.encode("utf-8"), reset_seq=True)
            payload = self.stream.read_packet()
            if payload[0] == 0xFF:
                e = pk.parse_err(payload)
                raise _err(f"query failed ({e.code}): {e.message}")
            if payload[0] == 0x00:
                return ResultSet(columns=[], rows=[])
            r = ByteReader(payload)
            n_cols = r.lenc() or 0
            columns: List[str] = []
            for _ in range(n_cols):
                col = self.stream.read_packet()
                columns.append(self._column_name(col))
            # EOF (unless DEPRECATE_EOF, in which case rows start directly)
            peek = self.stream.read_packet()
            rows: List[List[Optional[str]]] = []
            if not (len(peek) < 9 and peek[:1] == b"\xfe"):
                rows.append(self._text_row(peek, n_cols))
            while True:
                payload = self.stream.read_packet()
                if payload[:1] == b"\xfe" and len(payload) < 9:
                    break
                if payload[:1] == b"\xff":
                    e = pk.parse_err(payload)
                    raise _err(f"query failed ({e.code}): {e.message}")
                rows.append(self._text_row(payload, n_cols))
            return ResultSet(columns=columns, rows=rows)

    @staticmethod
    def _column_name(payload: bytes) -> str:
        r = ByteReader(payload)
        pk.read_lenc_str(r)  # catalog
        pk.read_lenc_str(r)  # schema
        pk.read_lenc_str(r)  # table
        pk.read_lenc_str(r)  # org_table
        name = pk.read_lenc_str(r)
        return name or ""

    @staticmethod
    def _text_row(payload: bytes, n_cols: int) -> List[Optional[str]]:
        r = ByteReader(payload)
        return [pk.read_lenc_str(r) for _ in range(n_cols)]

    def execute(self, sql: str) -> None:
        self.query(sql)

    # ------------------------------------------------------------------
    # validation (reference connection_validator.cpp)
    # ------------------------------------------------------------------
    def fetch_server_uuid(self) -> str:
        if self.is_mariadb:
            rs = self.query("SELECT @@server_id")
            self.server_uuid = rs.scalar() or ""
        else:
            rs = self.query("SELECT @@server_uuid")
            self.server_uuid = rs.scalar() or ""
        return self.server_uuid

    def validate_replication_prereqs(self) -> List[str]:
        """-> list of problems (empty = OK)."""
        problems = []
        try:
            if not self.is_mariadb:
                mode = self.query("SELECT @@gtid_mode").scalar()
                if (mode or "").upper() != "ON":
                    problems.append(f"gtid_mode is {mode}, must be ON")
            fmt = self.query("SELECT @@binlog_format").scalar()
            if (fmt or "").upper() != "ROW":
                problems.append(f"binlog_format is {fmt}, must be ROW")
            img = self.query("SELECT @@binlog_row_image").scalar()
            if img and img.upper() not in ("FULL",):
                problems.append(f"binlog_row_image is {img}, must be FULL")
        except ProtocolError as e:
            problems.append(str(e))
        return problems

    def fetch_executed_gtid(self) -> str:
        if self.is_mariadb:
            return self.query("SELECT @@gtid_current_pos").scalar() or ""
        return self.query("SELECT @@global.gtid_executed").scalar() or ""

    def fetch_table_columns(self, database: str,
                            table: str) -> List[Dict[str, str]]:
        rs = self.query(
            "SELECT COLUMN_NAME, DATA_TYPE, COLUMN_TYPE, COLUMN_KEY "
            "FROM INFORMATION_SCHEMA.COLUMNS "
            f"WHERE TABLE_SCHEMA='{database}' AND TABLE_NAME='{table}' "
            "ORDER BY ORDINAL_POSITION")
        return [
            {"name": r[0] or "", "data_type": r[1] or "",
             "column_type": r[2] or "", "key": r[3] or ""}
            for r in rs.rows]

    # ------------------------------------------------------------------
    # binlog streaming
    # ------------------------------------------------------------------
    def register_slave(self, server_id: int) -> None:
        payload = bytes([pk.COM_REGISTER_SLAVE])
        payload += struct.pack("<I", server_id)
        payload += b"\x00" * 3          # hostname/user/password (empty)
        payload += struct.pack("<H", 0)  # port
        payload += struct.pack("<I", 0)  # rank
        payload += struct.pack("<I", 0)  # master id
        with self._lock:
            self.stream.write_packet(payload, reset_seq=True)
            resp = self.stream.read_packet()
            if resp[:1] == b"\xff":
                e = pk.parse_err(resp)
                raise _err(f"REGISTER_SLAVE failed: {e.message}")

    def start_binlog_dump_gtid(self, server_id: int,
                               gtid_set: GtidSet) -> None:
        """MySQL: COM_BINLOG_DUMP_GTID with the executed-set payload."""
        self.execute("SET @master_binlog_checksum = @@global.binlog_checksum")
        self.execute("SET @master_heartbeat_period = 30000000000")
        self.register_slave(server_id)
        encoded = gtid_set.encode()
        payload = bytes([pk.COM_BINLOG_DUMP_GTID])
        payload += struct.pack("<H", pk.BINLOG_THROUGH_GTID)
        payload += struct.pack("<I", server_id)
        payload += struct.pack("<I", 0)       # name length (auto position)
        payload += struct.pack("<Q", 4)       # position
        payload += struct.pack("<I", len(encoded))
        payload += encoded
        with self._lock:
            self.stream.write_packet(payload, reset_seq=True)

    def start_binlog_dump_mariadb(self, server_id: int,
                                  gtid_pos: str) -> None:
        """MariaDB: session vars + COM_BINLOG_DUMP
        (reference mariadb_binlog_stream.h:5-14)."""
        self.execute("SET @master_binlog_checksum = @@global.binlog_checksum")
        self.execute(f"SET @slave_connect_state = '{gtid_pos}'")
        self.execute("SET @slave_gtid_strict_mode = 0")
        self.execute("SET @slave_gtid_ignore_duplicates = 0")
        self.register_slave(server_id)
        payload = bytes([pk.COM_BINLOG_DUMP])
        payload += struct.pack("<I", 4)        # position
        payload += struct.pack("<H", 0)        # flags
        payload += struct.pack("<I", server_id)
        # empty filename => start per GTID state
        with self._lock:
            self.stream.write_packet(payload, reset_seq=True)

    def read_binlog_event(self) -> Optional[bytes]:
        """Next raw event bytes (header+body+checksum), None on EOF."""
        payload = self.stream.read_packet()
        if not payload:
            return None
        marker = payload[0]
        if marker == 0x00:
            return payload[1:]
        if marker == 0xFF:
            e = pk.parse_err(payload)
            raise _err(f"binlog stream error ({e.code}): {e.message}",
                       ErrorCode.BINLOG_PARSE if e.code == 1236
                       else ErrorCode.MYSQL_PROTOCOL)
        if marker == 0xFE:
            return None
        raise _err(f"unexpected binlog packet marker {marker:#x}")
