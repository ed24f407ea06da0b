"""Server core: request dispatch + command handlers (transport-agnostic).

The reference splits this across RequestDispatcher (request_dispatcher.h:39)
and ten handler classes (server/handlers/); here ``ServerCore.handle_line``
is the pure command plane shared by the TCP reactor, the HTTP API and tests
— no sockets, no threads. Per-connection state (DEBUG ON) is passed in.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from .. import __version__
from ..catalog import TableCatalog, TableContext
from ..config import config_to_dict
from ..config.runtime_vars import RuntimeVariableManager
from ..query import QueryParser, QueryType
from ..query.highlighter import Highlighter
from ..query.parser import Query
from ..query.pipeline import SearchPipeline
from ..utils import trace
from ..utils.errors import MygramError, QueryParseError, DumpError
from ..utils.structured_log import StructuredLog, truncate_query
from ..utils.textproc import format_bytes
from . import response_formatter as fmt
from .dump_manager import DumpManager
from .rate_limiter import RateLimiter
from .stats import ServerStats
from .sync_manager import SyncOperationManager


@dataclass
class ConnState:
    """Per-connection flags (reference per-connection DEBUG mode)."""
    debug: bool = False
    client_ip: str = ""


class NullBinlogReader:
    """No-op replication backend (reference mysql/null_binlog_reader.h:18)."""

    enabled = False

    def status(self) -> Dict[str, object]:
        return {"enabled": 0, "running": 0, "state": "disabled"}

    def stop(self) -> bool:
        return False

    def start(self) -> bool:
        return False

    def pause(self) -> None:
        pass

    def resume(self) -> None:
        pass

    @property
    def current_gtid(self) -> str:
        return ""

    def set_start_gtid(self, gtid: str) -> None:
        pass


class ServerCore:
    def __init__(self, config, catalog: Optional[TableCatalog] = None,
                 cache_manager=None, binlog_reader=None,
                 sync_loader_factory=None):
        self.config = config
        self.catalog = catalog or TableCatalog(config)
        self.stats = ServerStats()
        self.vars = RuntimeVariableManager(config)
        self.parser = QueryParser(default_limit=config.api.default_limit,
                                  max_query_length=config.api.max_query_length)
        self.binlog = binlog_reader or NullBinlogReader()
        rl = config.api.rate_limiting
        self.rate_limiter = RateLimiter(rl.capacity, rl.refill_rate,
                                        rl.max_clients, rl.enable)
        if cache_manager is None:
            from ..cache import CacheManager
            ctxs = self.catalog.contexts()
            norm = ctxs[0].normalize if ctxs else (lambda s: s)
            cache_manager = CacheManager(config.cache, normalize_term=norm)
        self.cache = cache_manager
        self.dump_manager = DumpManager(
            self.catalog, config, config_to_dict(config),
            pause_replication=self.binlog.pause,
            resume_replication=self.binlog.resume,
            current_gtid=lambda: self.binlog.current_gtid,
            on_loaded_gtid=self.binlog.set_start_gtid,
            on_tables_replaced=self._on_tables_replaced)
        self.sync_manager = SyncOperationManager(
            self.catalog, loader_factory=sync_loader_factory,
            pause_replication=self.binlog.pause,
            resume_replication=self.binlog.resume,
            dump_busy=lambda: self.dump_manager.busy,
            on_table_synced=lambda name: self.cache.clear_table(name))
        self._pipelines: Dict[str, SearchPipeline] = {}
        self.vars.add_listener(self._on_var_change)
        self.replication_user_stopped = False

    # ------------------------------------------------------------------
    def pipeline_for(self, ctx: TableContext) -> SearchPipeline:
        p = self._pipelines.get(ctx.name)
        if p is None or p.ctx is not ctx:
            p = SearchPipeline(ctx, self.config, self.cache)
            self._pipelines[ctx.name] = p
        return p

    def _on_tables_replaced(self, names) -> None:
        """Dump load / SYNC swapped table state: drop dependent cache."""
        for name in names:
            self.cache.clear_table(name)

    def _on_var_change(self, name: str, value) -> None:
        if name == "cache.enabled":
            self.cache.set_enabled(bool(value))
        elif name.startswith("api.rate_limiting."):
            rl = self.config.api.rate_limiting
            self.rate_limiter.configure(rl.capacity, rl.refill_rate,
                                        rl.enable)
        elif name == "api.default_limit":
            self.parser.default_limit = int(value)
        elif name == "api.max_query_length":
            self.parser.max_query_length = int(value)
        elif name.startswith("cache."):
            self.cache.apply_setting(name, value)
        elif name == "logging.level":
            from ..utils.structured_log import set_log_level
            set_log_level(str(value))

    # ------------------------------------------------------------------
    @trace.traced("server.command")
    def handle_line(self, line: str, conn: Optional[ConnState] = None,
                    waited_s: float = 0.0) -> str:
        """waited_s: how long the command waited for the thread running
        this call (the TCP server's executor), counted in the stats."""
        conn = conn or ConnState()
        t0 = time.perf_counter()
        try:
            query = self.parser.parse(line)
        except (QueryParseError, MygramError) as e:
            self.stats.record_protocol_error(waited_s)
            return fmt.format_error(str(e))
        try:
            resp = self._dispatch(query, conn)
        except MygramError as e:
            resp = fmt.format_error(e.message)
        except Exception as e:  # noqa: BLE001 — protocol boundary
            StructuredLog().event("handler_error").field(
                "query", truncate_query(line)).field("error", repr(e)).error()
            resp = fmt.format_error(f"internal error: {e}")
        self.stats.record_command(query.type.value,
                                  (time.perf_counter() - t0) * 1000,
                                  waited_s)
        return resp

    # ------------------------------------------------------------------
    def _dispatch(self, q: Query, conn: ConnState) -> str:
        t = q.type
        if t in (QueryType.SEARCH, QueryType.COUNT):
            return self._handle_search(q, conn)
        if t == QueryType.GET:
            return self._handle_get(q)
        if t == QueryType.FACET:
            return self._handle_facet(q, conn)
        if t == QueryType.INFO:
            return self._handle_info()
        if t in (QueryType.DUMP_SAVE, QueryType.SAVE):
            return self._handle_dump_save(q)
        if t in (QueryType.DUMP_LOAD, QueryType.LOAD):
            return self._handle_dump_load(q)
        if t == QueryType.DUMP_VERIFY:
            return self._handle_dump_verify(q)
        if t == QueryType.DUMP_INFO:
            return self._handle_dump_info(q)
        if t == QueryType.DUMP_STATUS:
            return self._handle_dump_status()
        if t == QueryType.REPLICATION_STATUS:
            return self._handle_replication_status()
        if t == QueryType.REPLICATION_STOP:
            self.replication_user_stopped = True
            return "OK REPLICATION_STOPPED" if self.binlog.stop() \
                else fmt.format_error("replication is not running")
        if t == QueryType.REPLICATION_START:
            self.replication_user_stopped = False
            return "OK REPLICATION_STARTED" if self.binlog.start() \
                else fmt.format_error("replication is not configured")
        if t == QueryType.SYNC:
            return self._handle_sync(q)
        if t == QueryType.SYNC_STATUS:
            return self._handle_sync_status()
        if t == QueryType.SYNC_STOP:
            out = self.sync_manager.stop_sync(q.table)
            body = ", ".join(f"{k}={v}" for k, v in out.items())
            return f"OK SYNC_STATUS {body}"
        if t == QueryType.CONFIG_SHOW:
            return self._handle_config_show(q)
        if t == QueryType.CONFIG_HELP:
            return self._handle_config_help(q)
        if t == QueryType.CONFIG_VERIFY:
            return self._handle_config_verify(q)
        if t == QueryType.OPTIMIZE:
            return self._handle_optimize(q)
        if t == QueryType.DEBUG_ON:
            conn.debug = True
            return "OK DEBUG_ON"
        if t == QueryType.DEBUG_OFF:
            conn.debug = False
            return "OK DEBUG_OFF"
        if t == QueryType.CACHE_CLEAR:
            n = self.cache.clear_table(q.table) if q.table \
                else self.cache.clear_all()
            return f"OK CACHE_CLEARED {n}"
        if t == QueryType.CACHE_STATS:
            return self._handle_cache_stats()
        if t == QueryType.CACHE_ENABLE:
            self.cache.set_enabled(True)
            self.config.cache.enabled = True
            return "OK CACHE_ENABLED"
        if t == QueryType.CACHE_DISABLE:
            self.cache.set_enabled(False)
            self.config.cache.enabled = False
            return "OK CACHE_DISABLED"
        if t == QueryType.SET:
            for name, value in q.variable_assignments:
                self.vars.set_variable(name, value)
            return "OK"
        if t == QueryType.SHOW_VARIABLES:
            rows = self.vars.show_variables(
                q.variable_like_pattern or None)
            return fmt.format_variables(rows)
        return fmt.format_error(f"unhandled command: {t.value}")

    # ------------------------------------------------------------------
    def _resolve_table(self, name: str) -> TableContext:
        ctx = self.catalog.resolve(name)
        if ctx is None:
            raise _table_error(name)
        return ctx

    # ------------------------------------------------------------------
    def _handle_search(self, q: Query, conn: ConnState) -> str:
        ctx = self._resolve_table(q.table)
        pipe = self.pipeline_for(ctx)
        out = pipe.execute(q, want_debug=conn.debug)
        if not out.success:
            return fmt.format_error(out.error)
        if q.type == QueryType.COUNT:
            dbg = fmt.format_debug_block(out.debug, detailed=False) \
                if conn.debug else ""
            return fmt.format_count(out.total, dbg)
        store = out.sn.doc_store if out.sn is not None else ctx.doc_store
        pks = store.primary_keys_batch(out.results.tolist())
        if q.highlight is not None:
            hl = Highlighter(q.highlight)
            texts = store.texts_batch(out.results.tolist())
            snippets = hl.snippets([t or "" for t in texts],
                                   out.all_search_terms)
            dbg = fmt.format_debug_block(out.debug, detailed=False,
                                         highlight=True) if conn.debug else ""
            return fmt.format_search_highlights(out.total, pks, snippets, dbg)
        dbg = fmt.format_debug_block(out.debug, detailed=True) \
            if conn.debug else ""
        return fmt.format_search(out.total, pks, dbg)

    def _handle_get(self, q: Query) -> str:
        ctx = self._resolve_table(q.table)
        # seqlock snapshot: a SYNC/DUMP-LOAD swap renumbers doc ids, so
        # resolving through the live ctx mid-swap could pair the old PK map
        # with the new filter store (reference holds the component
        # shared_mutex across the read, document_store.h:108)
        from ..query.pipeline import _CtxSnapshot
        sn = _CtxSnapshot(ctx)
        doc = sn.doc_store.get_document(q.primary_key)
        if doc is None:
            return fmt.format_error("Document not found")
        return fmt.format_doc(doc.primary_key, doc.filters)

    def _handle_facet(self, q: Query, conn: ConnState) -> str:
        ctx = self._resolve_table(q.table)
        from ..query.pipeline import _CtxSnapshot
        sn = _CtxSnapshot(ctx)
        if not sn.filter_index.has_column(q.facet_column):
            return fmt.format_error(
                f"unknown facet column: {q.facet_column}")
        if q.search_text or q.and_terms or q.not_terms or q.filters:
            pipe = self.pipeline_for(ctx)
            out = pipe.execute(q, collect_all=True)
            if not out.success:
                return fmt.format_error(out.error)
            ids = out.results.astype(np.int64)
            fi = out.sn.filter_index if out.sn is not None \
                else sn.filter_index
            counts = fi.value_counts(q.facet_column, ids)
        else:
            # unrestricted FACET counts against the snapshot too — racing
            # a staging swap must yield old-or-new state, never mixed
            counts = sn.filter_index.value_counts(q.facet_column, None)
        counts.sort(key=lambda kv: (-kv[1], kv[0]))
        if q.limit:
            counts = counts[:q.limit]
        return fmt.format_facet(counts)

    # ------------------------------------------------------------------
    def batcher_counters(self) -> Optional[Dict[str, float]]:
        """The micro-batchers' counters summed over the tables (each
        table's device segment has its own batcher, and a new segment,
        after an optimize or a load, starts from zero); None where no
        table batches."""
        out: Optional[Dict[str, float]] = None
        for ctx in self.catalog.contexts():
            b = getattr(ctx.index.device, "batcher", None)
            if b is None:
                continue
            got = b.counters()
            out = got if out is None else {k: out[k] + got[k] for k in out}
        return out

    def verify_counters(self) -> Dict[str, int]:
        """The fused verified path's overflow counters (process-wide) and
        the gauge ``text_store_bytes``, this catalog's text stores' device
        bytes."""
        from ..ops import runtime
        out = dict(runtime.overflow)
        out["text_store_bytes"] = sum(
            runtime.text_store_bytes.get(ctx.name, 0)
            for ctx in self.catalog.contexts())
        return out

    def _handle_info(self) -> str:
        s = self.stats
        sections = []
        sections.append(("Server", [
            ("version", __version__),
            ("engine", "mygramdb-tpu"),
            ("uptime_seconds", s.uptime_seconds),
        ]))
        sections.append(("Stats", [
            ("total_commands_processed", s.total_commands),
            ("total_connections_received", s.total_connections_received),
            ("current_connections", s.current_connections),
            ("rejected_connections", s.rejected_connections),
            ("protocol_errors", s.protocol_errors),
            ("executor_wait_seconds", f"{s.executor_wait_s:.6f}"),
        ]))
        batcher = self.batcher_counters()
        if batcher is not None:
            sections.append(("Batcher", [
                (f"batcher_{k}", f"{v:.6f}" if isinstance(v, float) else v)
                for k, v in batcher.items()]))
        sections.append(("Verify", list(self.verify_counters().items())))
        cmds = [(f"cmd_{k}", v) for k, v in sorted(
            s.command_counts().items()) if v > 0]
        if cmds:
            sections.append(("Commandstats", cmds))
        table_rows = []
        total_mem = 0
        for ctx in self.catalog.contexts():
            mem = ctx.memory_usage()
            total_mem += mem
            table_rows.append((f"table_{ctx.name}_documents", ctx.doc_count))
            table_rows.append((f"table_{ctx.name}_terms", ctx.index.n_terms))
            table_rows.append((f"table_{ctx.name}_memory",
                               format_bytes(mem)))
        sections.append(("Tables", table_rows))
        self.stats.observe_memory(total_mem)
        sections.append(("Memory", [
            ("used_memory", format_bytes(total_mem)),
            ("used_memory_peak", format_bytes(s.memory_peak_bytes)),
        ]))
        repl = self.binlog.status()
        sections.append(("Replication",
                         [(k, v) for k, v in sorted(repl.items())]))
        cs = self.cache.stats
        sections.append(("Cache", [
            ("cache_enabled", 1 if self.cache.enabled else 0),
            ("cache_entries", cs.entry_count),
            ("cache_memory", format_bytes(cs.memory_bytes)),
            ("cache_hits", cs.hits),
            ("cache_misses", cs.misses),
            ("cache_hit_rate", f"{cs.hit_rate:.4f}"),
        ]))
        return fmt.format_sections("OK INFO", sections)

    # ------------------------------------------------------------------
    def _handle_dump_save(self, q: Query) -> str:
        if self.sync_manager.any_running:
            return fmt.format_error("SYNC operation in progress")
        try:
            stats = self.stats.snapshot() if q.dump_with_stats else None
            path = self.dump_manager.start_save(q.filepath, stats=stats)
        except DumpError as e:
            return fmt.format_error(e.message)
        return f"OK DUMP_STARTED {path}"

    def _handle_dump_load(self, q: Query) -> str:
        try:
            path = self.dump_manager.start_load(q.filepath)
        except DumpError as e:
            return fmt.format_error(e.message)
        return f"OK DUMP_STARTED {path}"

    def _handle_dump_verify(self, q: Query) -> str:
        try:
            info = self.dump_manager.verify(q.filepath)
        except DumpError as e:
            return fmt.format_error(e.message)
        tables = " ".join(f"{t['name']}:{t['docs']}" for t in info.tables)
        return f"OK DUMP_VERIFIED tables={len(info.tables)} " \
               f"gtid={info.gtid or '(none)'} {tables}"

    def _handle_dump_info(self, q: Query) -> str:
        try:
            info = self.dump_manager.info(q.filepath)
        except DumpError as e:
            return fmt.format_error(e.message)
        rows = [("version", info.version),
                ("size", format_bytes(info.file_size)),
                ("config_fingerprint", info.config_fingerprint),
                ("gtid", info.gtid or "(none)")]
        for t in info.tables:
            rows.append((f"table_{t['name']}",
                         f"docs={t['docs']} terms={t['terms']} "
                         f"postings={t['postings']}"))
        return fmt.format_sections("OK DUMP_INFO", [("Dump", rows)])

    def _handle_dump_status(self) -> str:
        p = self.dump_manager.progress.snapshot()
        body = " ".join(f"{k}={v}" for k, v in p.items())
        return f"OK DUMP_STATUS {body}"

    # ------------------------------------------------------------------
    def _handle_replication_status(self) -> str:
        st = self.binlog.status()
        rows = [(k, v) for k, v in sorted(st.items())]
        return fmt.format_sections("OK REPLICATION", [("Replication", rows)])

    def _handle_sync(self, q: Query) -> str:
        try:
            out = self.sync_manager.start_sync(q.table)
        except RuntimeError as e:
            return fmt.format_error(str(e))
        body = ", ".join(f"{k}={v}" for k, v in out.items())
        return f"OK SYNC {body}"

    def _handle_sync_status(self) -> str:
        st = self.sync_manager.status()
        if not st:
            return "OK SYNC_STATUS idle"
        parts = []
        for name, s in st.items():
            parts.append(f"{name}:{s['state']}:{s['rows_loaded']}")
        return "OK SYNC_STATUS " + " ".join(parts)

    # ------------------------------------------------------------------
    def _handle_config_show(self, q: Query) -> str:
        d = config_to_dict(self.config)
        node = d
        if q.filepath:
            for part in q.filepath.split("."):
                if isinstance(node, dict) and part in node:
                    node = node[part]
                else:
                    return fmt.format_error(
                        f"unknown config path: {q.filepath}")
        d = _redact(node)
        import json
        return "OK CONFIG\r\n" + json.dumps(d, indent=2, default=str) \
            + "\r\nEND"

    def _handle_config_help(self, q: Query) -> str:
        from ..config.runtime_vars import MUTABLE_VARIABLES, \
            READONLY_VARIABLES
        lines = ["OK CONFIG_HELP", "",
                 "# Runtime-mutable variables (SET <name> = <value>)"]
        for name in sorted(MUTABLE_VARIABLES):
            if not q.filepath or name.startswith(q.filepath):
                lines.append(f"{name} ({MUTABLE_VARIABLES[name].__name__})")
        lines.append("")
        lines.append("# Read-only variables (restart required)")
        for name in sorted(READONLY_VARIABLES):
            if not q.filepath or name.startswith(q.filepath):
                lines.append(name)
        lines.append("END")
        return "\r\n".join(lines)

    def _handle_config_verify(self, q: Query) -> str:
        """CONFIG VERIFY <file>: relative .yaml/.yml under the CWD only —
        absolute paths, traversal and symlinks rejected (network-supplied
        path; reference admin_handler.cpp:126-170)."""
        import os
        from ..config import load_config
        from ..utils.errors import ConfigError, MygramError
        from ..utils.safe_path import resolve_safe_path
        path = q.filepath or ""
        if path.startswith("/"):
            return fmt.format_error(
                "CONFIG VERIFY: absolute paths not allowed")
        if ".." in path:
            return fmt.format_error(
                "CONFIG VERIFY: path traversal (..) not allowed")
        try:
            resolved = resolve_safe_path(path, os.getcwd(),
                                         allowed_extensions=(".yaml",
                                                             ".yml"))
        except MygramError as e:
            return fmt.format_error(f"CONFIG VERIFY: {e.message}")
        if os.path.islink(os.path.join(os.getcwd(), path)):
            return fmt.format_error(
                "CONFIG VERIFY: symbolic links are not allowed")
        try:
            load_config(resolved)
        except ConfigError as e:
            return fmt.format_error(f"config invalid: {e.message}")
        return "OK CONFIG_VERIFIED"

    def _handle_optimize(self, q: Query) -> str:
        if self.dump_manager.busy:
            return fmt.format_error("dump operation in progress")
        targets = [q.table] if q.table else self.catalog.names()
        done = []
        for name in targets:
            ctx = self.catalog.resolve(name)
            if ctx is None:
                return fmt.format_error(f"Table not found: {name}")
            ctx.optimize()
            self.cache.clear_table(ctx.name)
            done.append(name)
        return "OK OPTIMIZED " + " ".join(done)

    def _handle_cache_stats(self) -> str:
        cs = self.cache.stats
        rows = [("enabled", 1 if self.cache.enabled else 0),
                ("entries", cs.entry_count),
                ("memory_bytes", cs.memory_bytes),
                ("hits", cs.hits), ("misses", cs.misses),
                ("hit_rate", f"{cs.hit_rate:.4f}"),
                ("inserts", cs.inserts), ("evictions", cs.evictions),
                ("invalidations", cs.invalidations),
                ("expired", cs.expired),
                ("rejected_low_cost", cs.rejected_low_cost),
                ("total_saved_ms", f"{cs.total_saved_ms:.3f}")]
        return fmt.format_sections("OK CACHE_STATS", [("Cache", rows)])


def _table_error(name: str) -> MygramError:
    from ..utils.errors import ErrorCode
    return MygramError(ErrorCode.TABLE_NOT_FOUND, f"Table not found: {name}")


def _redact(node):
    if isinstance(node, dict):
        return {k: ("***" if k in ("password", "ssl_key") and v else
                    _redact(v)) for k, v in node.items()}
    if isinstance(node, list):
        return [_redact(v) for v in node]
    return node
