"""MySQL binlog row-image field decoding.

Python reimplementation of the reference's RowsParser field decoder
(mysql/rows_parser_field_decoder.cpp, 847 LoC): every wire type that can
appear in ROW images — integers, floats, VARCHAR/STRING/BLOB, temporal
types incl. DATETIME2/TIMESTAMP2/TIME2 with fractional seconds, NEWDECIMAL
(packed BCD), ENUM/SET/BIT/YEAR, and binary JSON.

Datetime-ish values decode to epoch seconds (UTC for TIMESTAMP; DATETIME
interpreted in the configured timezone offset, reference
utils/datetime_converter.h) so filter comparisons are numeric.
"""

from __future__ import annotations

import calendar
import datetime as dt
import json
import struct
from typing import Any, List, Optional, Tuple

from ..utils.errors import ProtocolError, ErrorCode

# column type codes
T_DECIMAL = 0
T_TINY = 1
T_SHORT = 2
T_LONG = 3
T_FLOAT = 4
T_DOUBLE = 5
T_NULL = 6
T_TIMESTAMP = 7
T_LONGLONG = 8
T_INT24 = 9
T_DATE = 10
T_TIME = 11
T_DATETIME = 12
T_YEAR = 13
T_VARCHAR = 15
T_BIT = 16
T_TIMESTAMP2 = 17
T_DATETIME2 = 18
T_TIME2 = 19
T_VECTOR = 242
T_JSON = 245
T_NEWDECIMAL = 246
T_ENUM = 247
T_SET = 248
T_TINY_BLOB = 249
T_MEDIUM_BLOB = 250
T_LONG_BLOB = 251
T_BLOB = 252
T_VAR_STRING = 253
T_STRING = 254
T_GEOMETRY = 255


def _err(msg: str) -> ProtocolError:
    return ProtocolError(msg, ErrorCode.BINLOG_PARSE)


class ByteReader:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos

    def remaining(self) -> int:
        return len(self.data) - self.pos

    def read(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise _err(f"truncated row data (need {n}, have {self.remaining()})")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.read(1)[0]

    def u16(self) -> int:
        return struct.unpack("<H", self.read(2))[0]

    def u24(self) -> int:
        b = self.read(3)
        return b[0] | (b[1] << 8) | (b[2] << 16)

    def u32(self) -> int:
        return struct.unpack("<I", self.read(4))[0]

    def u48(self) -> int:
        b = self.read(6)
        return (b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24)
                | (b[4] << 32) | (b[5] << 40))

    def u64(self) -> int:
        return struct.unpack("<Q", self.read(8))[0]

    def be(self, n: int) -> int:
        out = 0
        for b in self.read(n):
            out = (out << 8) | b
        return out

    def lenc(self) -> Optional[int]:
        """Length-encoded integer; None for NULL (0xFB)."""
        first = self.u8()
        if first < 0xFB:
            return first
        if first == 0xFB:
            return None
        if first == 0xFC:
            return self.u16()
        if first == 0xFD:
            return self.u24()
        if first == 0xFE:
            return self.u64()
        raise _err(f"invalid length-encoded integer prefix {first:#x}")


def _signed(value: int, bits: int) -> int:
    sign = 1 << (bits - 1)
    return value - (1 << bits) if value & sign else value


# ---------------------------------------------------------------------------
# temporal decoding
# ---------------------------------------------------------------------------

def _read_frac(r: ByteReader, fsp: int) -> int:
    """fractional seconds -> microseconds."""
    n = (fsp + 1) // 2
    if n == 0:
        return 0
    frac = r.be(n)
    return frac * (10 ** (6 - 2 * n))


def decode_datetime2(r: ByteReader, fsp: int, tz_offset_sec: int = 0):
    """5-byte big-endian packed datetime + fraction -> epoch seconds."""
    packed = r.be(5)
    frac = _read_frac(r, fsp)
    # layout: 1 sign bit | 17 yearmonth | 5 day | 5 hour | 6 min | 6 sec
    packed &= (1 << 39) - 1  # drop sign bit
    sec = packed & 0x3F
    minute = (packed >> 6) & 0x3F
    hour = (packed >> 12) & 0x1F
    day = (packed >> 17) & 0x1F
    yearmonth = (packed >> 22) & 0x1FFFF
    year, month = divmod(yearmonth, 13)
    if year == 0 and month == 0 and day == 0:
        return 0
    try:
        ts = calendar.timegm(
            (year, month, day, hour, minute, sec, 0, 0, 0))
    except (ValueError, OverflowError):
        return 0
    return ts - tz_offset_sec + (1 if frac >= 500000 else 0) * 0


def decode_timestamp2(r: ByteReader, fsp: int) -> int:
    ts = r.be(4)
    _read_frac(r, fsp)
    return ts


def decode_time2(r: ByteReader, fsp: int) -> int:
    """3-byte big-endian packed time -> seconds (negative allowed)."""
    packed = r.be(3)
    _read_frac(r, fsp)
    sign = packed & 0x800000
    if not sign:
        packed = 0x1000000 - packed
        neg = True
    else:
        neg = False
    sec = packed & 0x3F
    minute = (packed >> 6) & 0x3F
    hour = (packed >> 12) & 0x3FF
    total = hour * 3600 + minute * 60 + sec
    return -total if neg else total


def decode_date(r: ByteReader) -> int:
    """3-byte date -> epoch seconds at midnight UTC."""
    val = r.u24()
    day = val & 0x1F
    month = (val >> 5) & 0x0F
    year = val >> 9
    if year == 0:
        return 0
    try:
        return calendar.timegm((year, month, day, 0, 0, 0, 0, 0, 0))
    except (ValueError, OverflowError):
        return 0


# ---------------------------------------------------------------------------
# NEWDECIMAL (packed BCD)
# ---------------------------------------------------------------------------

_DIG2BYTES = [0, 1, 1, 2, 2, 3, 3, 4, 4, 4]


def decode_newdecimal(r: ByteReader, precision: int, scale: int) -> str:
    intg = precision - scale
    intg_full, intg_rem = divmod(intg, 9)
    frac_full, frac_rem = divmod(scale, 9)
    size = (intg_full * 4 + _DIG2BYTES[intg_rem]
            + frac_full * 4 + _DIG2BYTES[frac_rem])
    raw = bytearray(r.read(size))
    negative = not (raw[0] & 0x80)
    raw[0] ^= 0x80
    if negative:
        for i in range(len(raw)):
            raw[i] = (~raw[i]) & 0xFF
    rr = ByteReader(bytes(raw))
    int_part = ""
    if intg_rem:
        int_part += str(rr.be(_DIG2BYTES[intg_rem]))
    for _ in range(intg_full):
        int_part += f"{rr.be(4):09d}"
    int_part = int_part.lstrip("0") or "0"
    frac_part = ""
    for _ in range(frac_full):
        frac_part += f"{rr.be(4):09d}"
    if frac_rem:
        frac_part += str(rr.be(_DIG2BYTES[frac_rem])).zfill(frac_rem)
    out = int_part
    if frac_part:
        out += "." + frac_part
    return ("-" + out) if negative and out.strip("0.") else out


# ---------------------------------------------------------------------------
# binary JSON (minimal but structurally complete)
# ---------------------------------------------------------------------------

def decode_json(data: bytes) -> str:
    if not data:
        return "null"
    try:
        val = _json_value(data[0], data[1:])
        return json.dumps(val, ensure_ascii=False)
    except Exception:
        return data.hex()


def _json_value(jtype: int, data: bytes):
    if jtype in (0x00, 0x01):  # small/large object
        return _json_obj(data, large=jtype == 0x01, is_array=False)
    if jtype in (0x02, 0x03):  # small/large array
        return _json_obj(data, large=jtype == 0x03, is_array=True)
    if jtype == 0x04:  # literal
        return {0x00: None, 0x01: True, 0x02: False}.get(data[0])
    if jtype == 0x05:
        return _signed(struct.unpack("<H", data[:2])[0], 16)
    if jtype == 0x06:
        return struct.unpack("<H", data[:2])[0]
    if jtype == 0x07:
        return _signed(struct.unpack("<I", data[:4])[0], 32)
    if jtype == 0x08:
        return struct.unpack("<I", data[:4])[0]
    if jtype == 0x09:
        return _signed(struct.unpack("<Q", data[:8])[0], 64)
    if jtype == 0x0A:
        return struct.unpack("<Q", data[:8])[0]
    if jtype == 0x0B:
        return struct.unpack("<d", data[:8])[0]
    if jtype == 0x0C:  # string
        r = ByteReader(data)
        length = 0
        shift = 0
        while True:
            b = r.u8()
            length |= (b & 0x7F) << shift
            if not (b & 0x80):
                break
            shift += 7
        return r.read(length).decode("utf-8", errors="replace")
    return None


def _json_obj(data: bytes, large: bool, is_array: bool):
    r = ByteReader(data)
    if large:
        count, size = r.u32(), r.u32()
        off_size = 4
    else:
        count, size = r.u16(), r.u16()
        off_size = 2
    keys = []
    if not is_array:
        for _ in range(count):
            key_off = r.u32() if large else r.u16()
            key_len = r.u16()
            keys.append((key_off, key_len))
    entries = []
    for _ in range(count):
        vtype = r.u8()
        if vtype in (0x04, 0x05, 0x06) and not large:
            inline = r.read(off_size)
            entries.append(("inline", vtype, inline))
        elif vtype in (0x04, 0x05, 0x06, 0x07, 0x08) and large:
            inline = r.read(off_size)
            entries.append(("inline", vtype, inline))
        else:
            off = r.u32() if large else r.u16()
            entries.append(("offset", vtype, off))
    values = []
    for kind, vtype, loc in entries:
        if kind == "inline":
            values.append(_json_value(vtype, loc))
        else:
            values.append(_json_value(vtype, data[loc:]))
    if is_array:
        return values
    out = {}
    for (key_off, key_len), v in zip(keys, values):
        key = data[key_off:key_off + key_len].decode("utf-8", "replace")
        out[key] = v
    return out


# ---------------------------------------------------------------------------
# top-level column decode
# ---------------------------------------------------------------------------

def decode_value(r: ByteReader, col_type: int, meta: int,
                 unsigned: bool = False, tz_offset_sec: int = 0) -> Any:
    t = col_type
    if t == T_TINY:
        v = r.u8()
        return v if unsigned else _signed(v, 8)
    if t == T_SHORT:
        v = r.u16()
        return v if unsigned else _signed(v, 16)
    if t == T_INT24:
        v = r.u24()
        return v if unsigned else _signed(v, 24)
    if t == T_LONG:
        v = r.u32()
        return v if unsigned else _signed(v, 32)
    if t == T_LONGLONG:
        v = r.u64()
        return v if unsigned else _signed(v, 64)
    if t == T_FLOAT:
        return struct.unpack("<f", r.read(4))[0]
    if t == T_DOUBLE:
        return struct.unpack("<d", r.read(8))[0]
    if t == T_YEAR:
        v = r.u8()
        return 1900 + v if v else 0
    if t == T_DATE:
        return decode_date(r)
    if t == T_DATETIME2:
        return decode_datetime2(r, meta, tz_offset_sec)
    if t == T_TIMESTAMP2:
        return decode_timestamp2(r, meta)
    if t == T_TIME2:
        return decode_time2(r, meta)
    if t == T_VARCHAR or t == T_VAR_STRING:
        length = r.u16() if meta > 255 else r.u8()
        return r.read(length).decode("utf-8", errors="replace")
    if t == T_STRING:
        # metadata packs real type + length
        real_type = meta >> 8
        real_len = meta & 0xFF
        if real_type == T_ENUM:
            n = 1 if real_len < 256 else 2
            return r.be(n) if n == 1 else r.u16()
        if real_type == T_SET:
            return r.u64() if real_len > 4 else int.from_bytes(
                r.read(max(real_len, 1)), "little")
        if (real_type & 0x30) != 0x30:
            # long CHAR: 10-bit length
            real_len |= ((real_type & 0x30) ^ 0x30) << 4
        length = r.u16() if real_len > 255 else r.u8()
        return r.read(length).decode("utf-8", errors="replace")
    if t == T_VECTOR:
        # MySQL 9.0+ VECTOR: BLOB wire encoding (metadata = length-prefix
        # bytes), payload is packed little-endian float32s. Not indexed —
        # surfaced as a hex string so replication of vector-bearing tables
        # never breaks (reference rows_parser_field_decoder.cpp:690-740).
        n = meta if meta in (1, 2, 3, 4) else 4
        length = int.from_bytes(r.read(n), "little")
        return r.read(length).hex()
    if t in (T_BLOB, T_TINY_BLOB, T_MEDIUM_BLOB, T_LONG_BLOB, T_GEOMETRY):
        n = meta if meta else 2
        length = int.from_bytes(r.read(n), "little")
        raw = r.read(length)
        try:
            return raw.decode("utf-8")
        except UnicodeDecodeError:
            return raw
    if t == T_JSON:
        n = meta if meta else 4
        length = int.from_bytes(r.read(n), "little")
        return decode_json(r.read(length))
    if t == T_NEWDECIMAL:
        precision = meta >> 8
        scale = meta & 0xFF
        return decode_newdecimal(r, precision, scale)
    if t == T_BIT:
        bits = ((meta >> 8) * 8) + (meta & 0xFF)
        n = (bits + 7) // 8
        return int.from_bytes(r.read(n), "big")
    if t == T_ENUM:
        return r.u8() if meta == 1 else r.u16()
    if t == T_NULL:
        return None
    raise _err(f"unsupported column type {t}")


def metadata_length(col_type: int) -> int:
    """Bytes of per-column metadata in TABLE_MAP."""
    if col_type in (T_VARCHAR, T_VAR_STRING, T_STRING, T_NEWDECIMAL,
                    T_BIT, T_ENUM, T_SET):
        return 2
    if col_type in (T_BLOB, T_TINY_BLOB, T_MEDIUM_BLOB, T_LONG_BLOB,
                    T_GEOMETRY, T_JSON, T_VECTOR, T_FLOAT, T_DOUBLE,
                    T_TIMESTAMP2, T_DATETIME2, T_TIME2):
        return 1
    return 0


def parse_column_metadata(col_types: List[int], meta_blob: bytes) -> List[int]:
    """Expand the packed metadata blob into one int per column."""
    out = []
    r = ByteReader(meta_blob)
    for t in col_types:
        n = metadata_length(t)
        if n == 0:
            out.append(0)
        elif n == 1:
            out.append(r.u8())
        else:
            if t in (T_STRING, T_ENUM, T_SET):
                b0, b1 = r.u8(), r.u8()
                out.append((b0 << 8) | b1)
            elif t == T_NEWDECIMAL:
                b0, b1 = r.u8(), r.u8()
                out.append((b0 << 8) | b1)
            elif t == T_BIT:
                b0, b1 = r.u8(), r.u8()
                out.append((b1 << 8) | b0)
            else:  # VARCHAR: little-endian u16 max length
                out.append(r.u16())
    return out


def read_row_values(r: ByteReader, col_types: List[int], metas: List[int],
                    present: List[bool], unsigned: List[bool],
                    tz_offset_sec: int = 0) -> List[Any]:
    """One row image: null bitmap over present columns, then values.
    Absent columns yield None placeholders (binlog_row_image=minimal)."""
    n_present = sum(present)
    null_bitmap = r.read((n_present + 7) // 8)
    values: List[Any] = []
    bit = 0
    for i, t in enumerate(col_types):
        if not present[i]:
            values.append(None)
            continue
        is_null = bool(null_bitmap[bit // 8] & (1 << (bit % 8)))
        bit += 1
        if is_null:
            values.append(None)
        else:
            values.append(decode_value(r, t, metas[i], unsigned[i],
                                       tz_offset_sec))
    return values
