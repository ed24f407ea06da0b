"""Python client library for the TCP text protocol.

Reference client/mygramclient.{h,cpp} (C++ sync client + C ABI): connect,
Search/Count/Get/Info/Facet, SearchWithHighlights, admin commands, with
multi-line response handling and timeouts.

Response framing: single-line responses end with CRLF; multi-line
responses (INFO, CONFIG, VARIABLES, CACHE_STATS, REPLICATION, DUMP_INFO)
terminate with an ``END`` line; FACET and highlighted SEARCH terminate
with a blank line.
"""

from __future__ import annotations

import socket
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

_MULTILINE_END = ("OK INFO", "OK CONFIG", "OK VARIABLES", "OK CACHE_STATS",
                  "OK REPLICATION", "OK DUMP_INFO", "OK CONFIG_HELP")
_MULTILINE_BLANK = ("OK FACET",)


class MygramClientError(Exception):
    pass


@dataclass
class SearchResult:
    total: int = 0
    ids: List[str] = field(default_factory=list)
    snippets: Dict[str, str] = field(default_factory=dict)
    raw: str = ""


class MygramClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 11016,
                 timeout: float = 30.0, unix_socket: str = ""):
        self.host = host
        self.port = port
        self.timeout = timeout
        self.unix_socket = unix_socket
        self._sock: Optional[socket.socket] = None
        self._file = None

    # ------------------------------------------------------------------
    def connect(self) -> None:
        if self.unix_socket:
            s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            s.settimeout(self.timeout)
            s.connect(self.unix_socket)
        else:
            s = socket.create_connection((self.host, self.port),
                                         timeout=self.timeout)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1) \
            if not self.unix_socket else None
        self._sock = s
        self._file = s.makefile("rwb")

    def close(self) -> None:
        if self._file is not None:
            try:
                self._file.write(b"QUIT\r\n")
                self._file.flush()
            except OSError:
                pass
        if self._sock is not None:
            self._sock.close()
        self._sock = None
        self._file = None

    def __enter__(self) -> "MygramClient":
        self.connect()
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------
    def command(self, line: str, expect_multiline: bool = False) -> str:
        """Send one command, return the full (possibly multi-line) response."""
        if self._file is None:
            self.connect()
        f = self._file
        f.write(line.encode("utf-8") + b"\r\n")
        f.flush()
        first = f.readline()
        if not first:
            raise MygramClientError("connection closed by server")
        first_s = first.decode("utf-8", "replace").rstrip("\r\n")
        lines = [first_s]
        if any(first_s.startswith(p) for p in _MULTILINE_END):
            while True:
                nxt = f.readline()
                if not nxt:
                    break
                s = nxt.decode("utf-8", "replace").rstrip("\r\n")
                lines.append(s)
                if s == "END" or s.endswith("END"):
                    break
        elif any(first_s.startswith(p) for p in _MULTILINE_BLANK) or \
                expect_multiline:
            # blank-line framing; a LEADING blank is the head/body
            # separator (debug blocks: 'OK RESULTS ...' + blank +
            # '# DEBUG' body + blank terminator) — terminating on it
            # would leave the body unread and desync the connection
            saw_content = False
            while True:
                nxt = f.readline()
                if not nxt:
                    break
                s = nxt.decode("utf-8", "replace").rstrip("\r\n")
                if s == "":
                    if saw_content:
                        break
                    lines.append(s)
                    continue
                saw_content = True
                lines.append(s)
        return "\n".join(lines)

    def _check(self, resp: str) -> str:
        if resp.startswith("ERROR "):
            raise MygramClientError(resp[6:])
        return resp

    # ------------------------------------------------------------------
    def search(self, table: str, query: str, and_terms: List[str] = (),
               not_terms: List[str] = (), filters: List[str] = (),
               sort: str = "", limit: Optional[int] = None,
               offset: Optional[int] = None,
               fuzzy: Optional[int] = None) -> SearchResult:
        parts = [f'SEARCH {table} "{query}"']
        for t in and_terms:
            parts.append(f'AND "{t}"')
        for t in not_terms:
            parts.append(f'NOT "{t}"')
        for flt in filters:
            parts.append(f"FILTER {flt}")
        if sort:
            parts.append(f"SORT {sort}")
        if limit is not None:
            parts.append(f"LIMIT {limit}")
        if offset is not None:
            parts.append(f"OFFSET {offset}")
        if fuzzy is not None:
            parts.append(f"FUZZY {fuzzy}")
        resp = self._check(self.command(" ".join(parts)))
        return self._parse_results(resp)

    def search_with_highlights(self, table: str, query: str,
                               open_tag: str = "<em>",
                               close_tag: str = "</em>",
                               limit: Optional[int] = None) -> SearchResult:
        line = f'SEARCH {table} "{query}" HIGHLIGHT TAG "{open_tag}" ' \
               f'"{close_tag}"'
        if limit is not None:
            line += f" LIMIT {limit}"
        resp = self._check(self.command(line, expect_multiline=True))
        lines = resp.split("\n")
        head = lines[0].split()
        out = SearchResult(total=int(head[2]), raw=resp)
        for row in lines[1:]:
            if "\t" in row:
                pk, snippet = row.split("\t", 1)
                out.ids.append(pk)
                out.snippets[pk] = snippet
        return out

    @staticmethod
    def _parse_results(resp: str) -> SearchResult:
        head = resp.split("\n")[0].split()
        if len(head) < 3 or head[0] != "OK" or head[1] != "RESULTS":
            raise MygramClientError(f"unexpected response: {resp[:120]}")
        return SearchResult(total=int(head[2]), ids=head[3:], raw=resp)

    def count(self, table: str, query: str, filters: List[str] = ()) -> int:
        parts = [f'COUNT {table} "{query}"']
        for flt in filters:
            parts.append(f"FILTER {flt}")
        resp = self._check(self.command(" ".join(parts)))
        return int(resp.split()[2])

    def get(self, table: str, primary_key: str) -> Dict[str, str]:
        resp = self._check(self.command(f"GET {table} {primary_key}"))
        parts = resp.split()
        out = {"_pk": parts[2]} if len(parts) > 2 else {}
        for kv in parts[3:]:
            if "=" in kv:
                k, v = kv.split("=", 1)
                out[k] = v.strip('"')
        return out

    def facet(self, table: str, column: str,
              query: str = "") -> Dict[str, int]:
        line = f"FACET {table} {column}"
        if query:
            line += f' "{query}"'
        resp = self._check(self.command(line))
        out = {}
        for row in resp.split("\n")[1:]:
            if "\t" in row:
                k, v = row.rsplit("\t", 1)
                out[k] = int(v)
        return out

    def info(self) -> Dict[str, str]:
        resp = self._check(self.command("INFO"))
        out = {}
        for row in resp.split("\n"):
            if ": " in row and not row.startswith("#"):
                k, v = row.split(": ", 1)
                out[k] = v
        return out

    def ping(self) -> bool:
        try:
            self.info()
            return True
        except (MygramClientError, OSError):
            return False

    # admin passthroughs
    def dump_save(self, path: str = "") -> str:
        return self._check(self.command(f"DUMP SAVE {path}".strip()))

    def dump_load(self, path: str) -> str:
        return self._check(self.command(f"DUMP LOAD {path}"))

    def dump_status(self) -> str:
        return self._check(self.command("DUMP STATUS"))

    def optimize(self, table: str = "") -> str:
        return self._check(self.command(f"OPTIMIZE {table}".strip()))

    def set_variable(self, name: str, value: str) -> str:
        return self._check(self.command(f"SET {name} = {value}"))

    def show_variables(self, like: str = "") -> Dict[str, str]:
        line = "SHOW VARIABLES" + (f" LIKE '{like}'" if like else "")
        resp = self._check(self.command(line))
        out = {}
        for row in resp.split("\n")[1:]:
            if "\t" in row:
                k, v = row.split("\t", 1)
                out[k] = v
        return out
