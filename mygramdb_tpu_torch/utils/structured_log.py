"""Structured JSON/text logging (reference utils/structured_log.h:46).

Event-oriented logs: ``StructuredLog().event("name").field("k", v).info()``.
Output format (json|text), level filtering, optional file target, and query
truncation at 200 bytes mirror the reference behavior.
"""

from __future__ import annotations

import json
import sys
import threading
import time
from typing import Any, Optional, TextIO

_LEVELS = {"debug": 10, "info": 20, "warn": 30, "error": 40}

_lock = threading.Lock()
_config = {"level": 20, "format": "json", "stream": sys.stderr, "file": None}

MAX_QUERY_LOG_BYTES = 200


def configure_logging(level: str = "info", fmt: str = "json",
                      file: str = "") -> None:
    with _lock:
        _config["level"] = _LEVELS.get(level, 20)
        _config["format"] = fmt if fmt in ("json", "text") else "json"
        if _config["file"] is not None:
            try:
                _config["file"].close()
            except Exception:
                pass
            _config["file"] = None
        if file:
            _config["file"] = open(file, "a", buffering=1, encoding="utf-8")


def set_log_level(level: str) -> None:
    """Runtime `SET logging.level` — changes only the threshold, leaving
    format/file untouched (configure_logging would reopen the file)."""
    with _lock:
        _config["level"] = _LEVELS.get(level, _config["level"])


def _target() -> TextIO:
    return _config["file"] or _config["stream"]


def truncate_query(query: str) -> str:
    encoded = query.encode("utf-8", errors="replace")
    if len(encoded) <= MAX_QUERY_LOG_BYTES:
        return query
    return encoded[:MAX_QUERY_LOG_BYTES].decode("utf-8", errors="ignore") + "..."


class StructuredLog:
    def __init__(self) -> None:
        self._fields: dict = {}
        self._event = ""

    def event(self, name: str) -> "StructuredLog":
        self._event = name
        return self

    def field(self, key: str, value: Any) -> "StructuredLog":
        self._fields[key] = value
        return self

    def _emit(self, level: str) -> None:
        if _LEVELS[level] < _config["level"]:
            return
        record = {"ts": round(time.time(), 3), "level": level, "event": self._event}
        record.update(self._fields)
        with _lock:
            out = _target()
            if _config["format"] == "json":
                out.write(json.dumps(record, ensure_ascii=False, default=str) + "\n")
            else:
                kv = " ".join(f"{k}={v}" for k, v in record.items())
                out.write(kv + "\n")

    def debug(self) -> None:
        self._emit("debug")

    def info(self) -> None:
        self._emit("info")

    def warn(self) -> None:
        self._emit("warn")

    def error(self) -> None:
        self._emit("error")
