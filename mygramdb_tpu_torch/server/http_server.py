"""HTTP/JSON API (reference server/http_server.{h,cpp}).

Read-path endpoints sharing the same ServerCore/pipeline as TCP
(ops commands are TCP-only by design, reference README.md:196-198):

    POST /tables/{table}/search   {"q", "and", "not", "filters", "sort",
                                   "limit", "offset", "highlight", "fuzzy"}
    POST /tables/{table}/count
    POST /tables/{table}/facet    {"column", "q"?, ...}
    GET  /tables/{table}/{pk}
    GET  /info | /config | /replication/status
    GET  /health[/live|/ready|/detail]
    GET  /metrics                 (Prometheus exposition)

Filters accept {"col": value} or {"col": {"op": "GTE", "value": v}}.
CORS, body-size cap (413) and the shared CIDR ACL + rate limiter apply.
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, Optional

from aiohttp import web

from ..ops import runtime
from ..query.highlighter import Highlighter
from ..query.parser import (FilterCondition, FilterOp, HighlightOptions,
                            OrderByClause, Query, QueryType, SortOrder,
                            parse_search_expression)
from ..utils.errors import QueryParseError
from ..utils.structured_log import StructuredLog
from .core import ServerCore
from .tcp_server import CidrAcl

_OP_NAMES = {
    "EQ": FilterOp.EQ, "NE": FilterOp.NE, "GT": FilterOp.GT,
    "GTE": FilterOp.GTE, "LT": FilterOp.LT, "LTE": FilterOp.LTE,
    "=": FilterOp.EQ, "!=": FilterOp.NE, ">": FilterOp.GT,
    ">=": FilterOp.GTE, "<": FilterOp.LT, "<=": FilterOp.LTE,
}


class HttpError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


def _parse_filters(body: Dict[str, Any], q: Query) -> None:
    filters = body.get("filters")
    if filters is None:
        return
    if not isinstance(filters, dict):
        raise HttpError(400, "filters must be an object")
    for col, val in filters.items():
        f = FilterCondition(column=str(col))
        if isinstance(val, dict) and "value" in val:
            op = _OP_NAMES.get(str(val.get("op", "EQ")).upper())
            if op is None:
                raise HttpError(400, f"Invalid filter operator: {val.get('op')}")
            f.op = op
            f.value = _value_str(val["value"], col)
        else:
            f.op = FilterOp.EQ
            f.value = _value_str(val, col)
        q.filters.append(f)


def _value_str(v: Any, col: str) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, (int, float, str)):
        if isinstance(v, float) and v == int(v):
            return str(int(v))
        return str(v)
    raise HttpError(400, f"Invalid filter value type for column: {col}")


def _parse_body_query(body: Dict[str, Any], table: str, qtype: QueryType,
                      default_limit: int) -> Query:
    q = Query(type=qtype, table=table, limit=default_limit)
    text = body.get("q", "")
    if not isinstance(text, str):
        raise HttpError(400, "q must be a string")
    # q is a full search EXPRESSION exactly like the TCP operand: quoted
    # phrases, boolean AND/OR/NOT, grouping (reference parses both
    # planes identically; http_server_search_test.cpp:1604-1639). Clause
    # keywords outside quotes are parameter pollution -> 400.
    try:
        q.search_text, q.search_text_quoted = parse_search_expression(text)
    except QueryParseError as e:
        raise HttpError(400, e.message)
    for key, target in (("and", q.and_terms), ("not", q.not_terms)):
        terms = body.get(key)
        if terms is None:
            continue
        if not isinstance(terms, list) or \
                not all(isinstance(t, str) for t in terms):
            raise HttpError(400, f"{key} must be a list of strings")
        target.extend(terms)
    if "limit" in body:
        if not isinstance(body["limit"], int) or isinstance(body["limit"], bool):
            raise HttpError(400, "limit must be an integer")
        q.limit = max(0, min(body["limit"], 10000))
        q.limit_explicit = True
    if "offset" in body:
        if not isinstance(body["offset"], int):
            raise HttpError(400, "offset must be an integer")
        q.offset = max(0, body["offset"])
        q.offset_explicit = True
    _parse_filters(body, q)
    sort = body.get("sort")
    if sort is not None:
        if not isinstance(sort, dict) or "column" not in sort:
            raise HttpError(400, "sort must be {column, order}")
        order = str(sort.get("order", "DESC")).upper()
        if order not in ("ASC", "DESC"):
            raise HttpError(400, f"invalid sort order: {sort.get('order')}")
        q.order_by = OrderByClause(column=str(sort["column"]),
                                   order=SortOrder[order])
    hl = body.get("highlight")
    if hl is not None:
        opts = HighlightOptions()
        if isinstance(hl, dict):
            opts.open_tag = str(hl.get("open_tag", opts.open_tag))
            opts.close_tag = str(hl.get("close_tag", opts.close_tag))
            if "snippet_length" in hl:
                opts.snippet_length = int(hl["snippet_length"])
            if "max_fragments" in hl:
                opts.max_fragments = int(hl["max_fragments"])
        q.highlight = opts
    fz = body.get("fuzzy")
    if fz is not None:
        if isinstance(fz, bool):
            dist = 1 if fz else None
        elif isinstance(fz, int):
            dist = fz
        elif isinstance(fz, dict):
            dist = int(fz.get("max_distance", 1))
        else:
            raise HttpError(400, "fuzzy must be int or object")
        if dist is not None:
            if dist < 1 or dist > 2:
                raise HttpError(400, "fuzzy distance must be 1 or 2")
            q.fuzzy_max_distance = dist
    if qtype == QueryType.COUNT:
        q.limit = 0
    return q


class HttpServer:
    def __init__(self, core: ServerCore, config):
        self.core = core
        self.config = config
        self.acl = CidrAcl(config.network.allow_cidrs)
        self._runner: Optional[web.AppRunner] = None
        self.port: Optional[int] = None

    # ------------------------------------------------------------------
    async def start(self) -> None:
        http = self.config.api.http
        app = web.Application(
            client_max_size=http.max_body_bytes,
            middlewares=[self._middleware])
        app.router.add_post("/tables/{table}/search", self._search)
        app.router.add_post("/tables/{table}/count", self._count)
        app.router.add_post("/tables/{table}/facet", self._facet)
        app.router.add_get("/info", self._info)
        app.router.add_get("/health", self._health)
        app.router.add_get("/health/live", self._health_live)
        app.router.add_get("/health/ready", self._health_ready)
        app.router.add_get("/health/detail", self._health_detail)
        app.router.add_get("/config", self._config)
        app.router.add_get("/replication/status", self._replication)
        app.router.add_get("/metrics", self._metrics)
        app.router.add_get("/tables/{table}/{pk}", self._get_doc)
        if http.enable_cors:
            app.router.add_route("OPTIONS", "/{tail:.*}", self._preflight)
        self._runner = web.AppRunner(app, access_log=None)
        await self._runner.setup()
        site = web.TCPSite(self._runner, http.bind, http.port)
        await site.start()
        self.port = site._server.sockets[0].getsockname()[1] \
            if site._server and site._server.sockets else http.port
        StructuredLog().event("http_server_started").field(
            "bind", http.bind).field("port", self.port).info()

    async def stop(self) -> None:
        if self._runner is not None:
            await self._runner.cleanup()

    # ------------------------------------------------------------------
    @web.middleware
    async def _middleware(self, request: web.Request, handler):
        peer = request.remote or ""
        if peer and not self.acl.allowed(peer):
            return web.json_response({"error": "forbidden"}, status=403)
        if request.method == "OPTIONS" and self.config.api.http.enable_cors:
            # answer preflight BEFORE routing: aiohttp's resource matching
            # otherwise 405s OPTIONS on every registered POST/GET path and
            # the catch-all OPTIONS route never fires for them
            return await self._preflight(request)
        if request.method == "POST" and peer and \
                not self.core.rate_limiter.allow(peer):
            self.core.stats.record_rate_limited()
            return web.json_response({"error": "rate limit exceeded"},
                                     status=429)
        try:
            resp = await handler(request)
        except HttpError as e:
            resp = web.json_response({"error": e.message}, status=e.status)
        except web.HTTPException:
            raise
        except Exception as e:  # noqa: BLE001 — HTTP boundary
            StructuredLog().event("http_error").field("path",
                                                      request.path).field(
                "error", repr(e)).error()
            resp = web.json_response({"error": "internal error"}, status=500)
        http = self.config.api.http
        if http.enable_cors:
            resp.headers["Access-Control-Allow-Origin"] = \
                http.cors_allow_origin or "*"
        return resp

    async def _preflight(self, request: web.Request) -> web.Response:
        http = self.config.api.http
        return web.Response(status=204, headers={
            "Access-Control-Allow-Origin": http.cors_allow_origin or "*",
            "Access-Control-Allow-Methods": "GET, POST, OPTIONS",
            "Access-Control-Allow-Headers": "Content-Type",
            "Access-Control-Max-Age": "600",
        })

    async def _json_body(self, request: web.Request) -> Dict[str, Any]:
        try:
            body = await request.json()
        except web.HTTPRequestEntityTooLarge:
            raise HttpError(413, "request body too large")
        except Exception:
            raise HttpError(400, "invalid JSON body")
        if not isinstance(body, dict):
            raise HttpError(400, "body must be a JSON object")
        return body

    def _ctx(self, request: web.Request):
        table = request.match_info["table"]
        ctx = self.core.catalog.resolve(table)
        if ctx is None:
            raise HttpError(404, f"Table not found: {table}")
        return ctx

    # ------------------------------------------------------------------
    async def _search(self, request: web.Request) -> web.Response:
        import asyncio
        ctx = self._ctx(request)
        body = await self._json_body(request)
        if "q" not in body:
            raise HttpError(400, "q is required")
        q = _parse_body_query(body, ctx.name, QueryType.SEARCH,
                              self.config.api.default_limit)
        t0 = time.perf_counter()
        pipe = self.core.pipeline_for(ctx)
        out = await asyncio.get_running_loop().run_in_executor(
            None, pipe.execute, q)
        if not out.success:
            raise HttpError(400, out.error)
        store = out.sn.doc_store if out.sn is not None else ctx.doc_store
        pks = store.primary_keys_batch(out.results.tolist())
        resp: Dict[str, Any] = {
            "total": out.total,
            "results": [p for p in pks if p],
            "took_ms": round((time.perf_counter() - t0) * 1000, 3),
        }
        if q.highlight is not None:
            hl = Highlighter(q.highlight)
            texts = store.texts_batch(out.results.tolist())
            resp["hits"] = [
                {"id": p, "snippet": hl.snippet(t or "",
                                                out.all_search_terms)}
                for p, t in zip(pks, texts) if p]
        if out.scores is not None:
            resp["scores"] = [round(float(s), 6) for s in out.scores]
        self.core.stats.record_command("search")
        return web.json_response(resp)

    async def _count(self, request: web.Request) -> web.Response:
        import asyncio
        ctx = self._ctx(request)
        body = await self._json_body(request)
        if "q" not in body:
            raise HttpError(400, "q is required")
        q = _parse_body_query(body, ctx.name, QueryType.COUNT,
                              self.config.api.default_limit)
        pipe = self.core.pipeline_for(ctx)
        out = await asyncio.get_running_loop().run_in_executor(
            None, pipe.execute, q)
        if not out.success:
            raise HttpError(400, out.error)
        self.core.stats.record_command("count")
        return web.json_response({"count": out.total})

    async def _facet(self, request: web.Request) -> web.Response:
        import asyncio
        import numpy as np
        ctx = self._ctx(request)
        body = await self._json_body(request)
        column = body.get("column")
        if not column:
            raise HttpError(400, "column is required")
        if not ctx.filter_index.has_column(column):
            raise HttpError(400, f"unknown facet column: {column}")
        if body.get("q") or body.get("and") or body.get("filters"):
            q = _parse_body_query(body, ctx.name, QueryType.FACET,
                                  self.config.api.default_limit)
            q.facet_column = column
            pipe = self.core.pipeline_for(ctx)
            out = await asyncio.get_running_loop().run_in_executor(
                None, lambda: pipe.execute(q, collect_all=True))
            if not out.success:
                raise HttpError(400, out.error)
            fi = out.sn.filter_index if out.sn is not None \
                else ctx.filter_index
            counts = fi.value_counts(column, out.results.astype(np.int64))
        else:
            counts = ctx.filter_index.value_counts(column, None)
        counts.sort(key=lambda kv: (-kv[1], kv[0]))
        limit = body.get("limit", 100)
        self.core.stats.record_command("facet")
        return web.json_response(
            {"facets": {k: v for k, v in counts[:limit]}})

    async def _get_doc(self, request: web.Request) -> web.Response:
        ctx = self._ctx(request)
        pk = request.match_info["pk"]
        doc = ctx.doc_store.get_document(pk)
        if doc is None:
            raise HttpError(404, "Document not found")
        self.core.stats.record_command("get")
        return web.json_response({"id": doc.primary_key,
                                  "filters": doc.filters})

    # ------------------------------------------------------------------
    async def _info(self, request: web.Request) -> web.Response:
        s = self.core.stats
        tables = {}
        for ctx in self.core.catalog.contexts():
            tables[ctx.name] = {
                "documents": ctx.doc_count,
                "terms": ctx.index.n_terms,
                "memory_bytes": ctx.memory_usage(),
            }
        return web.json_response({
            "version": __import__("mygramdb_tpu_torch").__version__,
            "engine": "mygramdb-tpu",
            "uptime_seconds": s.uptime_seconds,
            "stats": s.snapshot(),
            "tables": tables,
            "replication": self.core.binlog.status(),
        })

    def _ready_state(self):
        dm = self.core.dump_manager
        loading = dm.busy and dm.progress.operation == "load"
        syncing = self.core.sync_manager.any_running
        return not (loading or syncing), {"dump_loading": loading,
                                          "syncing": syncing}

    async def _health(self, request: web.Request) -> web.Response:
        ready, _ = self._ready_state()
        return web.json_response({"status": "ok" if ready else "degraded"})

    async def _health_live(self, request: web.Request) -> web.Response:
        return web.json_response({"status": "ok"})

    async def _health_ready(self, request: web.Request) -> web.Response:
        ready, detail = self._ready_state()
        return web.json_response({"status": "ok" if ready else "degraded",
                                  **detail},
                                 status=200 if ready else 503)

    async def _health_detail(self, request: web.Request) -> web.Response:
        ready, detail = self._ready_state()
        repl = self.core.binlog.status()
        return web.json_response({
            "status": "ok" if ready else "degraded",
            "components": {
                "dump": self.core.dump_manager.progress.snapshot(),
                "sync": self.core.sync_manager.status(),
                "replication": repl,
                "cache": {"enabled": self.core.cache.enabled,
                          "entries": self.core.cache.stats.entry_count},
            }, **detail})

    async def _config(self, request: web.Request) -> web.Response:
        from ..config import config_to_dict
        from .core import _redact
        return web.json_response(_redact(config_to_dict(self.config)))

    async def _replication(self, request: web.Request) -> web.Response:
        return web.json_response(self.core.binlog.status())

    async def _metrics(self, request: web.Request) -> web.Response:
        return web.Response(text=self._prometheus(),
                            content_type="text/plain")

    def _prometheus(self) -> str:
        """Prometheus exposition (reference response_formatter.h:156)."""
        s = self.core.stats
        lines = []

        def gauge(name, value, help_text="", labels=""):
            if help_text:
                lines.append(f"# HELP {name} {help_text}")
                lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name}{labels} {value}")

        gauge("mygramdb_uptime_seconds", s.uptime_seconds, "Server uptime")
        gauge("mygramdb_connections_current", s.current_connections,
              "Open TCP connections")
        gauge("mygramdb_connections_total", s.total_connections_received,
              "Total connections accepted")
        gauge("mygramdb_commands_total", s.total_commands,
              "Total commands processed")
        for cmd, n in sorted(s.command_counts().items()):
            lines.append(
                f'mygramdb_command_total{{command="{cmd}"}} {n}')
        gauge("mygramdb_executor_wait_seconds_total", s.executor_wait_s,
              "Seconds commands waited for an executor thread")
        b = self.core.batcher_counters()
        if b is not None:
            gauge("mygramdb_batcher_batches_total", b["batches_executed"],
                  "Micro-batches executed")
            gauge("mygramdb_batcher_queries_total", b["queries_batched"],
                  "Queries in micro-batches")
            lines.append("# HELP mygramdb_batcher_flushes_total "
                         "Micro-batches by what flushed them")
            lines.append("# TYPE mygramdb_batcher_flushes_total gauge")
            for cause in ("full", "window", "late"):
                lines.append(f'mygramdb_batcher_flushes_total'
                             f'{{cause="{cause}"}} {b["flushes_" + cause]}')
            gauge("mygramdb_batcher_queue_wait_seconds_total",
                  b["queue_wait_s"],
                  "Seconds queries waited in the micro-batch queue")
            gauge("mygramdb_batcher_wake_seconds_total", b["wake_s"],
                  "Seconds from a query's answer to its thread running")
        gauge("mygramdb_kernel_builds_total", runtime.kernel_builds,
              "CUDA kernel library builds by nvcc in this process")
        v = self.core.verify_counters()
        gauge("mygramdb_verify_overflow_queries_total",
              v["verify_overflow_queries"],
              "Fused verified queries with candidates the text store "
              "does not pack")
        gauge("mygramdb_verify_overflow_candidates_total",
              v["verify_overflow_candidates"],
              "Those candidates, verified or scored on the host")
        gauge("mygramdb_text_store_bytes", v["text_store_bytes"],
              "Device bytes of the tables' text stores")
        cs = self.core.cache.stats
        gauge("mygramdb_cache_hits_total", cs.hits, "Cache hits")
        gauge("mygramdb_cache_misses_total", cs.misses, "Cache misses")
        gauge("mygramdb_cache_memory_bytes", cs.memory_bytes,
              "Cache memory usage")
        for ctx in self.core.catalog.contexts():
            lbl = f'{{table="{ctx.name}"}}'
            lines.append(f"mygramdb_documents{lbl} {ctx.doc_count}")
            lines.append(f"mygramdb_terms{lbl} {ctx.index.n_terms}")
            lines.append(
                f"mygramdb_index_memory_bytes{lbl} {ctx.memory_usage()}")
        repl = self.core.binlog.status()
        gauge("mygramdb_replication_running",
              1 if repl.get("running") else 0, "Replication running")
        if "events_applied" in repl:
            gauge("mygramdb_replication_events_applied",
                  repl["events_applied"], "Binlog events applied")
        return "\n".join(lines) + "\n"
