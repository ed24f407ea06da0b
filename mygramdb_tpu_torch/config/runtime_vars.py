"""Runtime variable manager: MySQL-style SET / SHOW VARIABLES.

Reference config/runtime_variable_manager.h:71. A safe subset of config is
mutable at runtime; the rest is read-only ("restart required"). Variables use
dotted paths (e.g. ``cache.enabled``); SHOW VARIABLES supports LIKE patterns
with ``%`` and ``_`` wildcards.
"""

from __future__ import annotations

import fnmatch
import re
import threading
from typing import Any, Dict, List, Optional, Tuple

from .schema import Config
from ..utils.errors import MygramError, ErrorCode

# Variables that can be changed at runtime without restart.
MUTABLE_VARIABLES = {
    "cache.enabled": bool,
    "cache.max_memory_mb": int,
    "cache.min_query_cost_ms": float,
    "cache.ttl_seconds": int,
    "api.default_limit": int,
    "api.max_query_length": int,
    "api.rate_limiting.enable": bool,
    "api.rate_limiting.capacity": int,
    "api.rate_limiting.refill_rate": int,
    "logging.level": str,
    "memory.verify_text": str,
    "dump.interval_sec": int,
    "dump.retain": int,
}

# Read-only variables surfaced in SHOW VARIABLES (restart required to change).
READONLY_VARIABLES = [
    "mysql.host", "mysql.port", "mysql.database",
    "replication.enable", "replication.server_id", "replication.start_from",
    "api.tcp.bind", "api.tcp.port", "api.tcp.max_connections",
    "api.http.enable", "api.http.port",
    "memory.roaring_threshold", "memory.normalize.nfkc",
    "memory.normalize.width", "memory.normalize.lower",
    "cache.invalidation_strategy", "cache.compression_enabled",
    "bm25.k1", "bm25.b",
    "device.dense_df_ratio", "device.doc_block", "device.max_query_terms",
    # compiled into per-table micro-batchers at index construction; a
    # runtime SET would silently not apply, so: restart required
    "device.microbatch_size", "device.microbatch_window_us",
]


def _get_path(cfg: Config, path: str) -> Any:
    obj: Any = cfg
    for part in path.split("."):
        obj = getattr(obj, part)
    return obj


def _set_path(cfg: Config, path: str, value: Any) -> None:
    parts = path.split(".")
    obj: Any = cfg
    for part in parts[:-1]:
        obj = getattr(obj, part)
    setattr(obj, parts[-1], value)


def _parse_value(raw: str, typ: type) -> Any:
    raw = raw.strip().strip("'\"")
    if typ is bool:
        low = raw.lower()
        if low in ("1", "true", "on", "yes"):
            return True
        if low in ("0", "false", "off", "no"):
            return False
        raise MygramError(ErrorCode.INVALID_ARGUMENT, f"invalid bool: {raw}")
    if typ is int:
        try:
            return int(raw)
        except ValueError:
            raise MygramError(ErrorCode.INVALID_ARGUMENT, f"invalid int: {raw}")
    if typ is float:
        try:
            return float(raw)
        except ValueError:
            raise MygramError(ErrorCode.INVALID_ARGUMENT, f"invalid float: {raw}")
    return raw


class RuntimeVariableManager:
    def __init__(self, cfg: Config):
        self._cfg = cfg
        self._lock = threading.Lock()
        self._listeners: List = []

    def add_listener(self, fn) -> None:
        """fn(name, value) called after a successful SET."""
        self._listeners.append(fn)

    def set_variable(self, name: str, raw_value: str) -> None:
        name = name.strip().lower()
        if name not in MUTABLE_VARIABLES:
            if name in READONLY_VARIABLES or self._exists(name):
                raise MygramError(ErrorCode.INVALID_ARGUMENT,
                                  f"variable '{name}' is read-only (restart required)")
            raise MygramError(ErrorCode.NOT_FOUND, f"unknown variable '{name}'")
        value = _parse_value(raw_value, MUTABLE_VARIABLES[name])
        extra_checks = {
            "api.default_limit": lambda v: 5 <= v <= 1000,
            "logging.level": lambda v: v in ("debug", "info", "warn", "error"),
            "memory.verify_text": lambda v: v in ("off", "ascii", "all"),
        }
        check = extra_checks.get(name)
        if check and not check(value):
            raise MygramError(ErrorCode.INVALID_ARGUMENT,
                              f"invalid value for '{name}': {raw_value}")
        with self._lock:
            _set_path(self._cfg, name, value)
        for fn in self._listeners:
            try:
                fn(name, value)
            except Exception:
                pass

    def _exists(self, name: str) -> bool:
        try:
            _get_path(self._cfg, name)
            return True
        except AttributeError:
            return False

    def get_variable(self, name: str) -> Any:
        return _get_path(self._cfg, name.strip().lower())

    def show_variables(self, like: Optional[str] = None) -> List[Tuple[str, str]]:
        names = sorted(set(MUTABLE_VARIABLES) | set(READONLY_VARIABLES))
        if like:
            # MySQL LIKE: % = any run, _ = single char
            pat = "^" + re.escape(like).replace("%", ".*").replace("_", ".") + "$"
            rx = re.compile(pat, re.IGNORECASE)
            names = [n for n in names if rx.match(n)]
        out = []
        with self._lock:
            for n in names:
                try:
                    v = _get_path(self._cfg, n)
                except AttributeError:
                    continue
                if isinstance(v, bool):
                    sv = "ON" if v else "OFF"
                else:
                    sv = str(v)
                out.append((n, sv))
        return out

    def is_mutable(self, name: str) -> bool:
        return name.strip().lower() in MUTABLE_VARIABLES
