"""What the program's spans and counters cost the host (``utils.trace``).

    python -m mygramdb_tpu_torch.tools.trace_cost [--docs N] [--queries N]

Prints one JSON line:

- ``site_ns``: each kind of instrumented site timed alone with ``timeit``,
  tracing off and on: a flag test (``if trace.enabled``), a no-op
  ``with trace.span(...)`` (on: a thread's outermost span, which reads
  the thread CPU clock twice, and ``span_nested``, one inside it, which
  does not), a ``@trace.traced`` method against the same method
  undecorated, a ``trace.record`` call; and the always-on counters'
  parts, a clock read, a deque append and an uncontended lock;
- ``sites_per_query``: the sites a SEARCH crosses, counted from the spans
  one traced pass over the query list records (``SITES`` says which site
  kind each span name stands for), plus the flag tests and counter parts
  no span shows (``GUARDS_PER_QUERY`` and ``COUNTER_PARTS``);
- ``off_ns_per_query`` and ``counters_ns_per_query``: their sums (tracing
  on, a span costs ``site_ns["on"]["span"]`` outermost on its thread,
  ``["span_nested"]`` inside another and ``["record"]`` across threads);
- ``query_us``: the host time of ``ServerCore.handle_line`` a query on a
  small table (the micro-batcher on, one caller, so each query also waits
  the batcher's 0.5 ms window), off and on in alternating passes, and
  ``on_ns_per_query``, their difference.

It runs on ``MYGRAM_TORCH_DEVICE`` (the CPU is enough: the sites are host
code); the line names the host's CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import random
import statistics
import threading
import time
import timeit
from collections import deque

from ..utils import trace

# site kind of each span name (a span is one crossing of its site)
SITES = {"server.command": "traced", "query.execute": "traced",
         "index.*": "traced", "batcher.execute": "guard",
         "batcher.queue": "guard", "batcher.wake": "guard"}
# flag tests a query crosses that record no span of their own with
# ServerCore.handle_line alone: the TCP server's four (the request id, the
# worker's, the hand-off back, the write); and a batch's (the phases'
# five: made, packed, uploaded, launched, pulled)
GUARDS_PER_QUERY = 4
GUARDS_PER_BATCH = 5
# the always-on counters: clock reads (the hand-off, the worker's start,
# the append, the answer, the wake-up) and the wake-up's deque append a
# query (the executor's wait rides on the stats lock a command takes
# anyway); a clock read and a lock more a batch
COUNTER_PARTS = {"clock": 5, "append": 1, "lock": 0}
COUNTER_PARTS_PER_BATCH = {"clock": 1, "append": 0, "lock": 1}


class _Probe:
    def plain(self, x):
        return x

    @trace.traced("probe.traced")
    def traced(self, x):
        return x


def _ns(stmt, n: int = 200_000, repeat: int = 7) -> float:
    return min(timeit.repeat(stmt, number=n, repeat=repeat)) / n * 1e9


def site_ns() -> dict:
    """ns of one crossing of each site kind, tracing off and on."""
    probe = _Probe()
    lock = threading.Lock()

    def guard():
        if trace.enabled:
            pass

    def span():
        with trace.span("probe.span"):
            pass

    def span_nested():
        with trace.span("probe.nested"):
            pass

    def record():
        trace.record("probe.record", 0.0, 1.0, 1, None, None)

    def empty():
        pass

    def locked():
        with lock:
            pass

    out = {}
    for on in (False, True):
        (trace.enable if on else trace.disable)()
        try:
            base = _ns(empty)
            out["on" if on else "off"] = {
                "guard": _ns(guard) - base,
                "span": _ns(span) - base,
                "traced": _ns(lambda: probe.traced(1))
                - _ns(lambda: probe.plain(1)),
                "record": _ns(record) - base}
            if on:
                with trace.span("probe.outer"):
                    out["on"]["span_nested"] = _ns(span_nested) - base
        finally:
            trace.disable()
            trace.clear()
    base = _ns(empty)
    woke = deque()
    out["counters"] = {"clock": _ns(lambda: trace.clock()) - base,
                       "append": _ns(lambda: woke.append(0.0)) - base,
                       "lock": _ns(locked) - base}
    # a thread's outermost span reads it twice
    out["on"]["cpu_clock"] = _ns(lambda: trace.cpu_clock()) - base
    return out


def _threads() -> int:
    """This process's threads, native ones included."""
    try:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith("Threads:"):
                    return int(line.split()[1])
    except OSError:
        pass
    return threading.active_count()


def _cpu_name() -> str:
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.machine()


def _table(docs: int, seed: int):
    """A small table on MYGRAM_TORCH_DEVICE behind a ServerCore, and the
    words of its texts."""
    from ..catalog import TableCatalog
    from ..config import load_config_from_dict
    from ..server.core import ServerCore
    rng = random.Random(seed)
    words = ["".join(rng.choice("abcdefghijklmnopqrstuvwxyz")
                     for _ in range(rng.randint(3, 8))) for _ in range(3000)]
    cfg = load_config_from_dict({
        "tables": [{"name": "t", "text_source": {"column": "content"}}],
        "cache": {"enabled": False},
        "api": {"tcp": {"bind": "127.0.0.1", "port": 0}},
        "network": {"allow_cidrs": ["127.0.0.0/8"]}})
    cat = TableCatalog(cfg)
    bulk = cat.resolve("t").begin_bulk_load()
    bulk.add_batch([(str(i), " ".join(rng.choices(words, k=40)), None)
                    for i in range(1, docs + 1)])
    bulk.finish()
    return ServerCore(cfg, cat), words


def per_query(core, lines, passes: int) -> dict:
    """Host us of handle_line a query, off and on in alternating passes
    (medians), and the spans of one traced pass."""
    got = {"off": [], "on": []}
    for _ in range(passes):
        for on in (False, True):
            (trace.enable if on else trace.disable)()
            t = time.perf_counter()
            for line in lines:
                core.handle_line(line)
            got["on" if on else "off"].append(
                (time.perf_counter() - t) / len(lines) * 1e6)
            trace.disable()
    trace.clear()
    trace.enable()
    for line in lines:
        core.handle_line(line)
    trace.disable()
    spans = trace.spans()
    trace.clear()
    return {"off": statistics.median(got["off"]),
            "on": statistics.median(got["on"]), "passes": passes,
            "queries": len(lines)}, spans


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="trace_cost")
    ap.add_argument("--docs", type=int, default=20_000)
    ap.add_argument("--queries", type=int, default=400)
    ap.add_argument("--passes", type=int, default=5)
    ap.add_argument("--seed", type=int, default=7)
    a = ap.parse_args(argv)
    sites = site_ns()
    core, words = _table(a.docs, a.seed)
    rng = random.Random(a.seed + 1)
    lines = [f"SEARCH t {' '.join(rng.sample(words, rng.choice((1, 2))))}"
             f" LIMIT 100" for _ in range(a.queries)]
    for line in lines[:20]:  # first calls, out of the timing
        core.handle_line(line)
    times, spans = per_query(core, lines, a.passes)
    # the thread CPU clock again, now that the table's threads run
    sites["on"]["cpu_clock_loaded"] = (_ns(lambda: trace.cpu_clock())
                                       - _ns(lambda: None))
    per = {}
    for s in spans:
        name = "index.*" if s.name.startswith("index.") else s.name
        kind = SITES.get(name)
        if kind is not None:
            per[kind] = per.get(kind, 0) + 1 / len(lines)
    batches = sum(1 for s in spans if s.name == "batcher.execute") \
        / len(lines)
    per["guard"] = (per.get("guard", 0) + GUARDS_PER_QUERY
                    + GUARDS_PER_BATCH * batches)
    parts = {k: COUNTER_PARTS[k] + COUNTER_PARTS_PER_BATCH[k] * batches
             for k in COUNTER_PARTS}
    print(json.dumps({
        "step": "trace_cost", "host": _cpu_name(), "cpus": os.cpu_count(),
        "threads": _threads(),
        "python": platform.python_version(),
        "device": os.environ.get("MYGRAM_TORCH_DEVICE", "cuda"),
        "site_ns": sites, "sites_per_query": per,
        "batches_per_query": batches,
        "off_ns_per_query": sum(sites["off"][k] * n for k, n in per.items()),
        "counter_parts_per_query": parts,
        "counters_ns_per_query": sum(sites["counters"][k] * n
                                     for k, n in parts.items()),
        "query_us": times,
        "on_ns_per_query": (times["on"] - times["off"]) * 1e3,
        "spans_per_query": len(spans) / len(lines)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
