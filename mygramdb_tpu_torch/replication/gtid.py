"""GTID parsing, set algebra and binary encoding.

Reference mysql/gtid_encoder.{h,cpp} + mariadb_gtid.cpp:
- MySQL GTID: ``server_uuid:txn`` / sets ``uuid:1-5:7,uuid2:1-3``
- single-GTID -> range normalization ``uuid:N`` == seen 1..N
  (binlog_reader.h:489-499)
- binary SID-block encoding for COM_BINLOG_DUMP_GTID
- MariaDB GTID: ``domain-server-seq`` (one position, not a set)
"""

from __future__ import annotations

import re
import struct
import uuid as uuid_mod
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..utils.errors import MygramError, ErrorCode

_UUID_RE = re.compile(
    r"^[0-9a-fA-F]{8}-[0-9a-fA-F]{4}-[0-9a-fA-F]{4}-"
    r"[0-9a-fA-F]{4}-[0-9a-fA-F]{12}$")


def _err(msg: str) -> MygramError:
    return MygramError(ErrorCode.GTID_PARSE, msg)


@dataclass(frozen=True)
class Gtid:
    """One transaction id: uuid + sequence number."""
    uuid: str
    txn: int

    def __str__(self) -> str:
        return f"{self.uuid}:{self.txn}"

    @classmethod
    def parse(cls, text: str) -> "Gtid":
        parts = text.strip().split(":")
        if len(parts) != 2 or not _UUID_RE.match(parts[0]):
            raise _err(f"invalid GTID: {text}")
        try:
            txn = int(parts[1])
        except ValueError:
            raise _err(f"invalid GTID sequence: {text}")
        return cls(parts[0].lower(), txn)


@dataclass(frozen=True)
class MariadbGtid:
    """MariaDB domain-server-seq GTID (a position, not a set)."""
    domain: int
    server_id: int
    seq: int

    def __str__(self) -> str:
        return f"{self.domain}-{self.server_id}-{self.seq}"

    @classmethod
    def parse(cls, text: str) -> "MariadbGtid":
        parts = text.strip().split("-")
        if len(parts) != 3:
            raise _err(f"invalid MariaDB GTID: {text}")
        try:
            return cls(int(parts[0]), int(parts[1]), int(parts[2]))
        except ValueError:
            raise _err(f"invalid MariaDB GTID: {text}")


class GtidSet:
    """Set of executed transaction ranges per server UUID."""

    def __init__(self) -> None:
        # uuid -> sorted list of inclusive (start, end)
        self._ranges: Dict[str, List[Tuple[int, int]]] = {}

    # ------------------------------------------------------------------
    @classmethod
    def parse(cls, text: str) -> "GtidSet":
        s = cls()
        text = text.strip()
        if not text:
            return s
        for part in re.split(r"[,\n]", text):
            part = part.strip()
            if not part:
                continue
            fields = part.split(":")
            if len(fields) < 2 or not _UUID_RE.match(fields[0]):
                raise _err(f"invalid GTID set element: {part}")
            u = fields[0].lower()
            for rng in fields[1:]:
                if "-" in rng:
                    a, b = rng.split("-", 1)
                    try:
                        s.add_range(u, int(a), int(b))
                    except ValueError:
                        raise _err(f"invalid GTID range: {rng}")
                else:
                    try:
                        n = int(rng)
                    except ValueError:
                        raise _err(f"invalid GTID sequence: {rng}")
                    s.add_range(u, n, n)
        return s

    def __str__(self) -> str:
        parts = []
        for u in sorted(self._ranges):
            rngs = ":".join(
                f"{a}-{b}" if a != b else str(a)
                for a, b in self._ranges[u])
            parts.append(f"{u}:{rngs}")
        return ",".join(parts)

    def __bool__(self) -> bool:
        return bool(self._ranges)

    def __eq__(self, other) -> bool:
        return isinstance(other, GtidSet) and self._ranges == other._ranges

    # ------------------------------------------------------------------
    def add_range(self, uuid: str, start: int, end: int) -> None:
        if start > end or start < 1:
            raise _err(f"invalid GTID range {start}-{end}")
        u = uuid.lower()
        ranges = self._ranges.setdefault(u, [])
        ranges.append((start, end))
        ranges.sort()
        merged: List[Tuple[int, int]] = []
        for a, b in ranges:
            if merged and a <= merged[-1][1] + 1:
                merged[-1] = (merged[-1][0], max(merged[-1][1], b))
            else:
                merged.append((a, b))
        self._ranges[u] = merged

    def add(self, gtid: Gtid) -> None:
        self.add_range(gtid.uuid, gtid.txn, gtid.txn)

    def add_gtid_normalized(self, gtid: Gtid) -> None:
        """uuid:N means "executed through N": store as 1-N
        (reference single-GTID -> range conversion)."""
        self.add_range(gtid.uuid, 1, gtid.txn)

    def contains(self, gtid: Gtid) -> bool:
        for a, b in self._ranges.get(gtid.uuid, ()):
            if a <= gtid.txn <= b:
                return True
        return False

    def merge(self, other: "GtidSet") -> None:
        for u, rngs in other._ranges.items():
            for a, b in rngs:
                self.add_range(u, a, b)

    def uuids(self) -> List[str]:
        return sorted(self._ranges)

    # ------------------------------------------------------------------
    # Binary encoding for COM_BINLOG_DUMP_GTID (mysql/gtid_encoder.cpp):
    # n_sids u64 | per sid: 16B uuid | n_intervals u64 |
    #   per interval: start u64, end+1 u64
    # ------------------------------------------------------------------
    def encode(self) -> bytes:
        out = [struct.pack("<Q", len(self._ranges))]
        for u in sorted(self._ranges):
            out.append(uuid_mod.UUID(u).bytes)
            rngs = self._ranges[u]
            out.append(struct.pack("<Q", len(rngs)))
            for a, b in rngs:
                out.append(struct.pack("<QQ", a, b + 1))
        return b"".join(out)

    @classmethod
    def decode(cls, data: bytes) -> "GtidSet":
        s = cls()
        if len(data) < 8:
            raise _err("truncated GTID set payload")
        (n_sids,) = struct.unpack_from("<Q", data, 0)
        pos = 8
        for _ in range(n_sids):
            if pos + 24 > len(data):
                raise _err("truncated GTID SID block")
            sid = str(uuid_mod.UUID(bytes=data[pos:pos + 16]))
            (n_int,) = struct.unpack_from("<Q", data, pos + 16)
            pos += 24
            for _ in range(n_int):
                if pos + 16 > len(data):
                    raise _err("truncated GTID interval")
                a, b1 = struct.unpack_from("<QQ", data, pos)
                pos += 16
                s.add_range(sid, a, b1 - 1)
        return s


def parse_gtid_set(text: str) -> GtidSet:
    return GtidSet.parse(text)
