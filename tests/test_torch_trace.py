"""The port's own spans and counters (``mygramdb_tpu_torch.utils.trace``):
off, a SEARCH through ``TcpServer`` records and makes no span; on, a
command's spans share one request id and nest from the server down to the
micro-batch queue, a batch's ``batcher.execute`` names its members and
parents its ``ops.*`` spans, the queue's, the batch's and the wake-up's
intervals follow each other; the flush-cause counters add up to the
batches; the counters are on ``INFO`` and ``/metrics``; the build stages
are timed whatever the flag."""

import asyncio
import random
import socket
import threading
import time

import pytest

from mygramdb_tpu_torch.catalog import TableCatalog
from mygramdb_tpu_torch.config import load_config_from_dict
from mygramdb_tpu_torch.server.core import ServerCore
from mygramdb_tpu_torch.server.tcp_server import TcpServer
from mygramdb_tpu_torch.utils import trace

from torch_parity import torch_cpu  # noqa: F401

WORDS = ["".join(random.Random(i).choice("abcdefghijklmnopqrstuvwxyz")
                 for _ in range(5)) for i in range(300)]


def cfg_dict(max_batch=64, window_us=200):
    return {"tables": [{"name": "t", "text_source": {"column": "content"},
                        "filters": [{"name": "status", "type": "int",
                                     "bitmap_index": True}]}],
            "cache": {"enabled": False},
            "device": {"microbatch_size": max_batch,
                       "microbatch_window_us": window_us},
            "api": {"tcp": {"bind": "127.0.0.1", "port": 0}},
            "network": {"allow_cidrs": ["127.0.0.0/8"]}}


def make_core(max_batch=64, window_us=200, docs=1500):
    cfg = load_config_from_dict(cfg_dict(max_batch, window_us))
    cat = TableCatalog(cfg)
    rng = random.Random(5)
    bulk = cat.resolve("t").begin_bulk_load()
    bulk.add_batch([(str(i), " ".join(rng.choices(WORDS, k=30)),
                     {"status": i % 3}) for i in range(1, docs + 1)])
    bulk.finish()
    return cfg, ServerCore(cfg, cat)


class Served:
    """A TcpServer on an event loop of its own thread."""

    def __init__(self, cfg, core):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()
        self.tcp = TcpServer(core, cfg)
        asyncio.run_coroutine_threadsafe(self.tcp.start(),
                                         self.loop).result(30)

    def ask(self, lines):
        with socket.create_connection(("127.0.0.1", self.tcp.port),
                                      timeout=30) as s:
            f = s.makefile("rwb")
            out = []
            for line in lines:
                f.write(line.encode() + b"\r\n")
                f.flush()
                out.append(f.readline().decode().rstrip("\r\n"))
            return out

    def ask_concurrently(self, per_thread):
        out = [None] * len(per_thread)

        def run(i):
            out[i] = self.ask(per_thread[i])
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(per_thread))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
            assert not t.is_alive()
        return out

    def stop(self):
        asyncio.run_coroutine_threadsafe(self.tcp.stop(),
                                         self.loop).result(30)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(30)
        self.loop.close()


@pytest.fixture(scope="module")
def served():
    cfg, core = make_core()
    srv = Served(cfg, core)
    yield core, srv
    srv.stop()


@pytest.fixture
def tracing():
    trace.clear()
    trace.enable()
    try:
        yield
    finally:
        trace.disable()
        trace.clear()


def by_id(spans):
    return {s.id: s for s in spans}


def test_trace_clock_is_the_device_trace_clock():
    assert trace.clock is time.monotonic


def test_trace_off_search_records_and_makes_no_span(served, monkeypatch):
    core, srv = served
    made = []

    class Counting(trace.Span):
        __slots__ = ()

        def __init__(self, *a, **kw):
            made.append(a[0])
            super().__init__(*a, **kw)

    class CountingOpen(trace._Open):
        __slots__ = ()

        def __init__(self, *a, **kw):
            made.append(a[0])
            super().__init__(*a, **kw)

    monkeypatch.setattr(trace, "Span", Counting)
    monkeypatch.setattr(trace, "_Open", CountingOpen)
    trace.disable()
    trace.clear()
    got = srv.ask([f"SEARCH t {WORDS[1]} LIMIT 10", f"COUNT t {WORDS[2]}"])
    assert got[0].startswith("OK RESULTS") and got[1].startswith("OK COUNT")
    assert made == []
    assert trace.spans() == []


def test_trace_on_one_search_nests_under_one_request(served, tracing):
    core, srv = served
    t0 = trace.clock()
    got = srv.ask([f"SEARCH t {WORDS[3]} LIMIT 10"])
    assert got[0].startswith("OK RESULTS")
    spans = trace.spans_between(t0, trace.clock())
    rids = {s.rid for s in spans}
    assert len(rids) == 1 and None not in rids
    names = {s.name for s in spans}
    assert {"server.handoff_in", "server.command", "query.execute",
            "index.search_and", "batcher.queue", "batcher.wake",
            "batcher.execute", "server.handoff_out",
            "server.write"} <= names
    ids = by_id(spans)
    one = {s.name: s for s in spans}
    chain = ["batcher.queue", "index.search_and", "query.execute",
             "server.command"]
    for child, parent in zip(chain, chain[1:]):
        c, p = one[child], one[parent]
        assert ids[c.parent] is p, (child, parent)
        assert p.start <= c.start and c.end <= p.end
    assert one["server.command"].parent is None
    assert one["server.command"].cpu is not None
    # the thread CPU clock is read on a thread's outermost span alone
    assert one["query.execute"].cpu is None
    assert one["batcher.execute"].cpu is None
    assert one["batcher.queue"].cpu is None  # its ends on two threads
    assert one["batcher.queue"].attrs["family"] in ("dense", "sparse")
    hin, cmd = one["server.handoff_in"], one["server.command"]
    hout, write = one["server.handoff_out"], one["server.write"]
    assert hin.end <= cmd.start and cmd.end <= hout.start
    assert hout.end <= write.start


def test_trace_batch_lists_members_and_parents_its_ops(tracing):
    # a wide window so that the threads' queries share batches
    cfg, core = make_core(max_batch=64, window_us=50_000, docs=800)
    srv = Served(cfg, core)
    try:
        t0 = trace.clock()
        srv.ask_concurrently([[f"SEARCH t {WORDS[10 + i]} LIMIT 5"]
                              for i in range(6)])
        spans = trace.spans_between(t0, trace.clock())
    finally:
        srv.stop()
    execs = [s for s in spans if s.name == "batcher.execute"]
    assert execs and max(s.attrs["b"] for s in execs) >= 2
    queues = {s.rid: s for s in spans if s.name == "batcher.queue"}
    wakes = {s.rid: s for s in spans if s.name == "batcher.wake"}
    commands = {s.rid for s in spans if s.name == "server.command"}
    members = [r for s in execs for r in s.attrs["rids"]]
    assert sorted(members) == sorted(commands)
    for ex in execs:
        assert len(ex.attrs["rids"]) == ex.attrs["b"]
        kids = sorted((s for s in spans if s.parent == ex.id),
                      key=lambda k: k.start)
        # the dense wrapper pulls inside its launch; the sparse one not
        want = {"dense": ["batcher.pack", "ops.upload", "ops.launch"],
                "sparse": ["batcher.pack", "ops.upload", "ops.launch",
                           "ops.pull"]}[ex.attrs["family"]]
        assert [k.name for k in kids] == want
        assert (kids[2].attrs.get("pull") == "inside") == (len(want) == 3)
        assert all(a.end <= b.start for a, b in zip(kids, kids[1:]))
        assert ex.start <= kids[0].start and kids[-1].end <= ex.end
        for rid in ex.attrs["rids"]:
            q, w = queues[rid], wakes[rid]
            assert q.attrs["b"] == ex.attrs["b"]
            assert q.end <= ex.start
            assert w.start >= q.end
            assert w.end >= w.start


@pytest.mark.parametrize("max_batch", [2, 64])
def test_trace_flush_causes_add_up_to_batches(max_batch):
    cfg, core = make_core(max_batch=max_batch, window_us=20_000, docs=800)
    srv = Served(cfg, core)
    try:
        srv.ask_concurrently([[f"SEARCH t {WORDS[j]} LIMIT 5"
                               for j in range(i, 60, 6)] for i in range(6)])
        got = core.batcher_counters()
    finally:
        srv.stop()
    flushes = sum(got[f"flushes_{c}"] for c in ("full", "window", "late"))
    assert got["batches_executed"] > 0
    assert flushes == got["batches_executed"]
    assert got["queries_batched"] >= 60
    if max_batch == 2:
        assert got["flushes_full"] > 0
    assert got["queue_wait_s"] > 0 and got["wake_s"] > 0
    assert core.stats.executor_wait_s > 0


@pytest.mark.parametrize("where", ["info", "metrics"])
def test_trace_counters_exported(served, where):
    core, srv = served
    srv.ask([f"SEARCH t {WORDS[4]} LIMIT 10"])
    if where == "info":
        text = core.handle_line("INFO")
        want = ["executor_wait_seconds: ", "# Batcher",
                "batcher_batches_executed: ", "batcher_queries_batched: ",
                "batcher_flushes_full: ", "batcher_flushes_window: ",
                "batcher_flushes_late: ", "batcher_queue_wait_s: ",
                "batcher_wake_s: "]
    else:
        from mygramdb_tpu_torch.server.http_server import HttpServer
        text = HttpServer(core, core.config)._prometheus()
        want = ["mygramdb_executor_wait_seconds_total ",
                "mygramdb_batcher_batches_total ",
                "mygramdb_batcher_queries_total ",
                'mygramdb_batcher_flushes_total{cause="full"} ',
                'mygramdb_batcher_flushes_total{cause="window"} ',
                'mygramdb_batcher_flushes_total{cause="late"} ',
                "mygramdb_batcher_queue_wait_seconds_total ",
                "mygramdb_batcher_wake_seconds_total ",
                "mygramdb_kernel_builds_total "]
    for w in want:
        assert w in text, w


def test_trace_ring_keeps_at_most_its_bound(tracing):
    for i in range(trace.RING + 10):
        trace.record("x", float(i), float(i), i)
    spans = trace.spans()
    assert len(spans) == trace.RING
    assert spans[0].rid == 10 and spans[-1].rid == trace.RING + 9


@pytest.mark.parametrize("on", [False, True])
def test_trace_build_stages_timed_whatever_the_flag(on, tmp_path):
    import json
    from mygramdb_tpu_torch.app.application import Application
    seed = tmp_path / "seed.jsonl"
    rng = random.Random(3)
    with open(seed, "w") as fh:
        for i in range(1, 501):
            fh.write(json.dumps({"id": i, "status": i % 3, "content":
                                 " ".join(rng.choices(WORDS, k=20))}) + "\n")
    d = cfg_dict()
    d["dump"] = {"dir": str(tmp_path / "dumps")}
    trace.clear()
    (trace.enable if on else trace.disable)()
    try:
        app = Application(load_config_from_dict(d), seed_path=str(seed))
        t = time.monotonic()
        app.initialize()
        took = time.monotonic() - t
        stages = trace.build_stages()
        ring = trace.spans()
    finally:
        trace.disable()
        trace.clear()
    names = [s.name for s in stages]
    assert names[-1] == "build.initialize"
    assert {"build.load", "build.device", "build.warmup"} <= set(names)
    init = stages[-1]
    assert init.seconds <= took
    load = next(s for s in stages if s.name == "build.load")
    inside = [s for s in stages if s.name == "build.device"
              and s.parent == load.id]
    assert inside  # the bulk load's device build is nested in it
    assert load.own == pytest.approx(
        load.seconds - sum(s.seconds for s in inside))
    parts = load.own + sum(s.seconds for s in stages
                           if s.name in ("build.device", "build.warmup"))
    assert 0.5 * init.seconds < parts <= init.seconds
    assert (len(ring) > 0) == on


def test_trace_request_context_and_phases(tracing):
    with trace.request(7):
        assert trace.context() == (7, None)
        with trace.span("outer", k=1) as outer:
            ph = trace.phases()
            ph.end("a")
            ph.end("b", kernel="x")
            outer.set(done=True)
    assert trace.context() == (None, None)
    spans = {s.name: s for s in trace.spans()}
    assert spans["outer"].attrs == {"k": 1, "done": True}
    assert spans["a"].parent == spans["outer"].id == spans["b"].parent
    assert spans["a"].end <= spans["b"].start
    assert spans["b"].attrs == {"kernel": "x"}
    assert {s.rid for s in spans.values()} == {7}
    assert spans["outer"].cpu is not None
    assert spans["a"].cpu is None and spans["b"].cpu is None
