"""Text-protocol response formatting.

Response shapes follow the reference protocol (server/protocol_constants.h,
server/response_formatter.cpp):

    OK RESULTS <total> <pk> <pk> ...
    OK RESULTS <total>\r\npk\tsnippet\r\n...      (highlights)
    OK COUNT <n>
    OK DOC <pk> col=value ...
    OK FACET <n>\r\nvalue\tcount\r\n...
    OK INFO\r\n\r\n# Section\r\nkey: value\r\n...END
    ERROR <message>

Values embedding whitespace/control bytes are quoted/escaped; PKs have
whitespace collapsed to '_' (SanitizePrimaryKeyForResponse analog).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

OK = "OK"
ERROR_PREFIX = "ERROR "

_CTRL = set(range(0x00, 0x20)) | {0x7F}


def sanitize_pk(pk: str) -> str:
    return "".join("_" if (c.isspace() or ord(c) in _CTRL) else c for c in pk)


def sanitize_field(value: str) -> str:
    return "".join(" " if c in "\r\n\t" else c for c in value)


def _needs_quote(value: str) -> bool:
    if value == "":
        return True
    return any(c.isspace() or c in '"\\' or ord(c) in _CTRL for c in value)


def escape_value(value: str) -> str:
    if not _needs_quote(value):
        return value
    out = ['"']
    for c in value:
        if c == "\\":
            out.append("\\\\")
        elif c == '"':
            out.append('\\"')
        elif c == "\r":
            out.append("\\r")
        elif c == "\n":
            out.append("\\n")
        elif c == "\t":
            out.append("\\t")
        elif ord(c) in _CTRL:
            out.append(f"\\x{ord(c):02X}")
        else:
            out.append(c)
    out.append('"')
    return "".join(out)


def format_value(v) -> str:
    if v is None:
        return "NULL"
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, float):
        if v == int(v):
            return str(int(v))
        return f"{v:.6g}"
    return str(v)


def format_error(message: str) -> str:
    return ERROR_PREFIX + message


def format_search(total: int, pks: Sequence[Optional[str]],
                  debug_block: str = "") -> str:
    parts = [f"OK RESULTS {total}"]
    for pk in pks:
        if pk:
            parts.append(" " + sanitize_pk(pk))
    return "".join(parts) + debug_block


def format_search_highlights(total: int, pks: Sequence[Optional[str]],
                             snippets: Sequence[str],
                             debug_block: str = "") -> str:
    lines = [f"OK RESULTS {total}"]
    for i, pk in enumerate(pks):
        if not pk:
            continue
        snip = sanitize_field(snippets[i]) if i < len(snippets) else ""
        lines.append(f"{sanitize_pk(pk)}\t{snip}")
    return "\r\n".join(lines) + debug_block + "\r\n"


def format_count(count: int, debug_block: str = "") -> str:
    return f"OK COUNT {count}" + debug_block


def format_doc(pk: str, filters: Dict[str, object],
               text: Optional[str] = None) -> str:
    parts = [f"OK DOC {sanitize_pk(pk)}"]
    for name, value in filters.items():
        parts.append(f" {name}={escape_value(format_value(value))}")
    if text is not None:
        parts.append(f" _text={escape_value(text)}")
    return "".join(parts)


def format_facet(value_counts: Sequence[Tuple[str, int]],
                 debug_lines: Sequence[str] = ()) -> str:
    lines = [f"OK FACET {len(value_counts)}"]
    for value, count in value_counts:
        lines.append(f"{sanitize_field(value)}\t{count}")
    for d in debug_lines:
        lines.append(f"# {d}")
    return "\r\n".join(lines) + "\r\n"


def format_sections(header: str, sections: Sequence[Tuple[str, Sequence[Tuple[str, object]]]],
                    end: bool = True) -> str:
    """Multi-section key/value response (INFO, REPLICATION STATUS...)."""
    lines = [header, ""]
    for title, kvs in sections:
        lines.append(f"# {title}")
        for k, v in kvs:
            lines.append(f"{k}: {format_value(v)}")
        lines.append("")
    out = "\r\n".join(lines)
    if end:
        out += "END"
    return out


def format_variables(rows: Sequence[Tuple[str, str]]) -> str:
    lines = ["OK VARIABLES"]
    for name, value in rows:
        lines.append(f"{name}\t{value}")
    lines.append("END")
    return "\r\n".join(lines)


def format_debug_block(dbg, detailed: bool = True,
                       highlight: bool = False) -> str:
    """# DEBUG block appended to SEARCH/COUNT responses
    (response_formatter.cpp AppendDebugBlock)."""
    lines = ["", "", "# DEBUG",
             f"query_time: {dbg.query_time_ms:.3f}ms",
             f"index_time: {dbg.index_time_ms:.3f}ms"]
    if dbg.filter_time_ms > 0:
        lines.append(f"filter_time: {dbg.filter_time_ms:.3f}ms")
    if dbg.verify_time_ms > 0:
        lines.append(f"verify_time: {dbg.verify_time_ms:.3f}ms")
    if dbg.sort_time_ms > 0:
        lines.append(f"sort_time: {dbg.sort_time_ms:.3f}ms")
    lines.append(f"device_dispatches: {dbg.device_dispatches}")
    lines.append(f"terms: {len(dbg.search_terms)}")
    lines.append(f"ngrams: {len(dbg.ngrams_used)}")
    if detailed:
        lines.append(f"candidates: {dbg.total_candidates}")
        lines.append(f"after_intersection: {dbg.after_intersection}")
        if dbg.after_not > 0:
            lines.append(f"after_not: {dbg.after_not}")
        if dbg.after_filters > 0:
            lines.append(f"after_filters: {dbg.after_filters}")
    lines.append(f"final: {dbg.final_results}")
    if dbg.optimization_used:
        lines.append(f"optimization: {dbg.optimization_used}")
    if dbg.order_by_applied:
        lines.append(f"sort: {dbg.order_by_applied}")
    limit_line = f"limit: {dbg.limit_applied}"
    if not dbg.limit_explicit:
        limit_line += " (default)"
    lines.append(limit_line)
    if dbg.offset_applied > 0:
        off = f"offset: {dbg.offset_applied}"
        if not dbg.offset_explicit:
            off += " (default)"
        lines.append(off)
    if highlight:
        lines.append("highlight: on")
    lines.append(f"cache: {dbg.cache_status}")
    if dbg.cache_status == "hit":
        lines.append(f"cache_age: {dbg.cache_age_ms:.3f}ms")
        lines.append(f"cache_saved: {dbg.cache_saved_ms:.3f}ms")
    elif dbg.query_cost_ms > 0:
        lines.append(f"cache_cost_ms: {dbg.query_cost_ms:.3f}")
    if dbg.cache_key:
        lines.append(f"cache_key: {dbg.cache_key}")
    return "\r\n".join(lines) + "\r\n"
