"""Error codes and result types.

Mirrors the role of the reference's ``utils/expected.h`` / ``utils/error.h``
(Expected<T, Error> + error code taxonomy). In Python we use exceptions for
control-plane errors and an explicit ``Result`` for protocol-level handler
returns, which keeps handler code branch-free and serializable.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Generic, Optional, TypeVar

T = TypeVar("T")


class ErrorCode(enum.Enum):
    # General
    OK = "ok"
    UNKNOWN = "unknown"
    INVALID_ARGUMENT = "invalid_argument"
    NOT_FOUND = "not_found"
    ALREADY_EXISTS = "already_exists"
    OUT_OF_RANGE = "out_of_range"
    UNAVAILABLE = "unavailable"
    INTERNAL = "internal"
    # Config
    CONFIG_PARSE = "config_parse"
    CONFIG_VALIDATION = "config_validation"
    # Query
    QUERY_PARSE = "query_parse"
    QUERY_TOO_LONG = "query_too_long"
    INVALID_UTF8 = "invalid_utf8"
    TABLE_NOT_FOUND = "table_not_found"
    # Server
    SERVER_BUSY = "server_busy"
    RATE_LIMITED = "rate_limited"
    ACCESS_DENIED = "access_denied"
    # Replication / MySQL
    MYSQL_CONNECTION = "mysql_connection"
    MYSQL_PROTOCOL = "mysql_protocol"
    BINLOG_PARSE = "binlog_parse"
    GTID_PARSE = "gtid_parse"
    REPLICATION_STATE = "replication_state"
    # Storage / dump
    DUMP_IO = "dump_io"
    DUMP_CORRUPT = "dump_corrupt"
    DUMP_VERSION = "dump_version"
    DUMP_IN_PROGRESS = "dump_in_progress"
    SYNC_IN_PROGRESS = "sync_in_progress"


class MygramError(Exception):
    """Base exception carrying an ErrorCode."""

    def __init__(self, code: ErrorCode, message: str = ""):
        super().__init__(message or code.value)
        self.code = code
        self.message = message or code.value


class ConfigError(MygramError):
    def __init__(self, message: str, code: ErrorCode = ErrorCode.CONFIG_VALIDATION):
        super().__init__(code, message)


class QueryParseError(MygramError):
    def __init__(self, message: str):
        super().__init__(ErrorCode.QUERY_PARSE, message)


class ProtocolError(MygramError):
    def __init__(self, message: str, code: ErrorCode = ErrorCode.MYSQL_PROTOCOL):
        super().__init__(code, message)


class DumpError(MygramError):
    def __init__(self, message: str, code: ErrorCode = ErrorCode.DUMP_IO):
        super().__init__(code, message)


@dataclass
class Result(Generic[T]):
    """Lightweight Expected<T, Error> analog for handler returns."""

    value: Optional[T] = None
    error: Optional[MygramError] = None

    @property
    def ok(self) -> bool:
        return self.error is None

    @staticmethod
    def of(value: T) -> "Result[T]":
        return Result(value=value)

    @staticmethod
    def err(code: ErrorCode, message: str = "") -> "Result[T]":
        return Result(error=MygramError(code, message))

    def unwrap(self) -> T:
        if self.error is not None:
            raise self.error
        return self.value  # type: ignore[return-value]
