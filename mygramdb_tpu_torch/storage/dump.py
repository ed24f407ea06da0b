"""Checkpoint (dump) format: full DB state + replication GTID.

TPU-native analog of the reference dump V2 (storage/dump_format.h:33-58,
dump_format_v2.h:113): magic ``MGTP`` + u32 version, then a sequence of
section envelopes [type u8 | crc32 u32 | length u64 | payload] so each
section is independently verifiable; msgpack for structured state and raw
little-endian buffers for the CSR posting arrays. The trailing END section
carries a whole-file CRC chain. Writes go through tmp+rename
(AtomicFileWriter analog).

Contents: config fingerprint, per-table (term dict, CSR postings, document
store, filter index, BM25 doc lengths), replication GTID — enough to
restore and resume binlog streaming from the stored position
(reference §3.4 DUMP SAVE/LOAD).
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import struct
import tempfile
import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import msgpack
import numpy as np

from ..utils.errors import DumpError, ErrorCode

MAGIC = b"MGTP"
VERSION = 1

SEC_CONFIG = 1
SEC_TABLE = 2
SEC_REPLICATION = 3
SEC_STATS = 4
SEC_END = 255

_HDR = struct.Struct("<BIQ")  # type, crc32, length


def config_fingerprint(config_dict: Dict[str, Any]) -> str:
    blob = json.dumps(config_dict, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _pack_array(arr: np.ndarray) -> Dict[str, Any]:
    return {"dtype": str(arr.dtype), "shape": list(arr.shape),
            "data": arr.tobytes()}


def _unpack_array(d: Dict[str, Any]) -> np.ndarray:
    return np.frombuffer(d["data"], dtype=np.dtype(d["dtype"])).reshape(
        d["shape"]).copy()


def _write_section(f, sec_type: int, payload: bytes) -> int:
    crc = zlib.crc32(payload) & 0xFFFFFFFF
    f.write(_HDR.pack(sec_type, crc, len(payload)))
    f.write(payload)
    return crc


def _read_section(f, file_size: Optional[int] = None):
    hdr = f.read(_HDR.size)
    if len(hdr) < _HDR.size:
        raise DumpError("truncated dump file", ErrorCode.DUMP_CORRUPT)
    sec_type, crc, length = _HDR.unpack(hdr)
    # bound the declared length by the actual file size BEFORE allocating:
    # a corrupted length field must fail as DumpError, not MemoryError
    if file_size is not None and length > file_size:
        raise DumpError(
            f"section length {length} exceeds file size {file_size}",
            ErrorCode.DUMP_CORRUPT)
    payload = f.read(length)
    if len(payload) != length:
        raise DumpError("truncated dump section", ErrorCode.DUMP_CORRUPT)
    if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
        raise DumpError(f"section CRC mismatch (type {sec_type})",
                        ErrorCode.DUMP_CORRUPT)
    return sec_type, payload


@dataclass
class TableState:
    """In-memory form of one table's dump section."""
    name: str
    terms: List[str]
    offsets: np.ndarray
    lengths: np.ndarray
    postings: np.ndarray
    max_doc_id: int
    n_docs: int
    doc_store_state: Dict[str, Any]
    filter_state: Dict[str, Any]
    bm25_state: Dict[str, Any]
    # optional positional occurrence index (index/positional.py): packed
    # occ_cnt/occ_pos/occ_base/occ_len arrays + overflow doc list. Absent
    # in dumps written without device.positional_verify (loads as None —
    # the restored table serves through the text verify path until the
    # next SYNC rebuilds positions)
    positional_state: Optional[Dict[str, Any]] = None
    # gram-emission signature the index was built with; restores ADOPT
    # the dump's kanji_extra_ngram (a query-side gram absent from the
    # restored term dict would read as an empty term). -1 = legacy dump
    # written before the field existed -> restore assumes no extra grams.
    kanji_extra_ngram: int = -1


@dataclass
class DumpInfo:
    version: int = VERSION
    config_fingerprint: str = ""
    tables: List[Dict[str, Any]] = field(default_factory=list)
    gtid: str = ""
    stats: Dict[str, Any] = field(default_factory=dict)
    file_size: int = 0


def save_dump(path: str, config_dict: Dict[str, Any],
              table_states: List[TableState], gtid: str = "",
              stats: Optional[Dict[str, Any]] = None) -> int:
    """Atomic write; returns bytes written."""
    dirname = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(dirname, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=dirname, prefix=".mgtp_tmp_")
    crcs: List[int] = []
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(MAGIC)
            f.write(struct.pack("<I", VERSION))
            cfg_payload = msgpack.packb(
                {"fingerprint": config_fingerprint(config_dict),
                 "n_tables": len(table_states)}, use_bin_type=True)
            crcs.append(_write_section(f, SEC_CONFIG, cfg_payload))
            for ts in table_states:
                payload = msgpack.packb({
                    "name": ts.name,
                    "terms": ts.terms,
                    "offsets": _pack_array(ts.offsets),
                    "lengths": _pack_array(ts.lengths),
                    "postings": _pack_array(ts.postings),
                    "max_doc_id": ts.max_doc_id,
                    "n_docs": ts.n_docs,
                    "kanji_extra_ngram": ts.kanji_extra_ngram,
                    "doc_store": ts.doc_store_state,
                    "filters": ts.filter_state,
                    "bm25": ts.bm25_state,
                    **({"positional": ts.positional_state}
                       if ts.positional_state is not None else {}),
                }, use_bin_type=True)
                crcs.append(_write_section(f, SEC_TABLE, payload))
            repl = msgpack.packb({"gtid": gtid}, use_bin_type=True)
            crcs.append(_write_section(f, SEC_REPLICATION, repl))
            if stats:
                crcs.append(_write_section(
                    f, SEC_STATS, msgpack.packb(stats, use_bin_type=True,
                                                default=str)))
            chain = zlib.crc32(struct.pack(f"<{len(crcs)}I", *crcs)) \
                & 0xFFFFFFFF
            _write_section(f, SEC_END, struct.pack("<I", chain))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except OSError as e:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise DumpError(f"dump write failed: {e}")
    return os.path.getsize(path)


def _iter_sections(path: str):
    fsize = os.path.getsize(path)
    with open(path, "rb") as f:
        magic = f.read(4)
        if magic != MAGIC:
            raise DumpError("not a MygramDB-TPU dump file (bad magic)",
                            ErrorCode.DUMP_VERSION)
        (version,) = struct.unpack("<I", f.read(4))
        if version != VERSION:
            raise DumpError(f"unsupported dump version {version}",
                            ErrorCode.DUMP_VERSION)
        while True:
            sec_type, payload = _read_section(f, fsize)
            yield sec_type, payload
            if sec_type == SEC_END:
                return


def load_dump(path: str):
    """-> (DumpInfo, List[TableState])."""
    info = DumpInfo()
    tables: List[TableState] = []
    crcs: List[int] = []
    end_chain: Optional[int] = None
    fsize = os.path.getsize(path)
    with open(path, "rb") as f:
        magic = f.read(4)
        if magic != MAGIC:
            raise DumpError("not a MygramDB-TPU dump file (bad magic)",
                            ErrorCode.DUMP_VERSION)
        (version,) = struct.unpack("<I", f.read(4))
        if version != VERSION:
            raise DumpError(f"unsupported dump version {version}",
                            ErrorCode.DUMP_VERSION)
        info.version = version
        while True:
            sec_type, payload = _read_section(f, fsize)
            if sec_type != SEC_END:
                crcs.append(zlib.crc32(payload) & 0xFFFFFFFF)
            if sec_type == SEC_CONFIG:
                d = msgpack.unpackb(payload, raw=False)
                info.config_fingerprint = d.get("fingerprint", "")
            elif sec_type == SEC_TABLE:
                d = msgpack.unpackb(payload, raw=False, strict_map_key=False)
                ts = TableState(
                    name=d["name"], terms=d["terms"],
                    offsets=_unpack_array(d["offsets"]),
                    lengths=_unpack_array(d["lengths"]),
                    postings=_unpack_array(d["postings"]),
                    max_doc_id=d["max_doc_id"], n_docs=d["n_docs"],
                    kanji_extra_ngram=int(d.get("kanji_extra_ngram", -1)),
                    doc_store_state=d["doc_store"],
                    filter_state=d["filters"], bm25_state=d["bm25"],
                    positional_state=d.get("positional"))
                tables.append(ts)
                info.tables.append({"name": ts.name, "docs": ts.n_docs,
                                    "terms": len(ts.terms),
                                    "postings": int(ts.postings.size)})
            elif sec_type == SEC_REPLICATION:
                d = msgpack.unpackb(payload, raw=False)
                info.gtid = d.get("gtid", "")
            elif sec_type == SEC_STATS:
                info.stats = msgpack.unpackb(payload, raw=False)
            elif sec_type == SEC_END:
                (end_chain,) = struct.unpack("<I", payload)
                break
    if end_chain is not None:
        chain = zlib.crc32(struct.pack(f"<{len(crcs)}I", *crcs)) & 0xFFFFFFFF
        if chain != end_chain:
            raise DumpError("dump file CRC chain mismatch",
                            ErrorCode.DUMP_CORRUPT)
    info.file_size = os.path.getsize(path)
    return info, tables


def verify_dump(path: str) -> DumpInfo:
    """Validate every section CRC + chain without applying
    (reference VerifyDumpIntegrity, dump_format_v2.h:254)."""
    info, _ = load_dump(path)
    return info


def dump_info(path: str) -> DumpInfo:
    info, _ = load_dump(path)
    return info
