"""The program's own spans in the benchmark, on the CPU: the ``build.*_s``
metrics in a traced run (and None where the program has no tracer, as an
older tree), the ``--trace 0`` line's keys unchanged, and
``programtrace.py``'s notes and idle-gap naming.

    MYGRAM_TORCH_DEVICE=cpu python -m pytest portbench/tests -q
"""

import sys
import time

import pytest

from portbench import harness, programtrace

from test_portbench_harness import _cpu, run, tiny  # noqa: F401

BUILD = ("build.load_s", "build.device_s", "build.warmup_s")


def test_portbench_traced_run_reads_the_build_stages():
    out = run(tiny(), trace=True)
    m = out["result"]["metrics"]
    assert set(BUILD) <= set(m)
    total = sum(m[k]["value"] for k in BUILD)
    init = out["notes"]["initialize_s"]
    assert 0.5 * init < total <= init
    assert all(m[k]["unit"] == "s" for k in BUILD)


def test_portbench_build_metrics_none_without_the_tracer(monkeypatch):
    # the program's modules hold the tracer already; the readers then find
    # no module, as in a tree that has none
    import mygramdb_tpu_torch.app.application  # noqa: F401
    import mygramdb_tpu_torch.server.microbatch  # noqa: F401
    import mygramdb_tpu_torch.server.tcp_server  # noqa: F401
    import mygramdb_tpu_torch.utils as utils
    monkeypatch.delattr(utils, "trace")
    monkeypatch.setitem(sys.modules, "mygramdb_tpu_torch.utils.trace", None)
    for name in BUILD:
        assert harness.metric_reader(name).read({"build": None}) is None
    out = run(tiny(), trace=True)
    assert out["result"]["correct"]
    assert not set(BUILD) & set(out["result"]["metrics"])
    assert "build.docs_per_s" in out["result"]["metrics"]


def test_portbench_untraced_line_keeps_its_keys():
    out = run(tiny(), trace=False)
    r = out["result"]
    assert set(r) == {"correct", "attempted", "failed", "metrics", "device"}
    assert set(r["metrics"]) == {"setup_s"}  # device_gb needs a card
    assert out["notes"]["trace"] == 0  # the flag, not a span summary
    assert "trace_by_second" not in out["notes"]


def test_portbench_programtrace_notes():
    c = tiny()
    out = programtrace.traced_run(c, 2**31 + 77, 3.0, time.monotonic(),
                                  device="cpu")
    assert out["result"]["correct"]
    n = out["notes"]
    assert {"server.command", "query.execute", "batcher.queue",
            "batcher.wake", "batcher.execute", "ops.pull",
            "server.handoff_in", "server.handoff_out",
            "server.write"} <= set(n["trace"])
    for v in n["trace"].values():
        assert v["count"] > 0 and v["wall_s"] >= 0 and v["p95_ms"] >= 0
    assert n["trace"]["server.command"]["cpu_s"] > 0
    assert n["trace"]["batcher.queue"]["cpu_s"] is None
    assert set(n["trace_by_second"]) == set(programtrace.PER_SECOND)
    assert all(len(v) == 3 for v in n["trace_by_second"].values())
    cnt = n["trace_counters"]
    assert cnt["batches_executed"] == sum(
        cnt[f"flushes_{k}"] for k in ("full", "window", "late"))
    assert n["avg_batch"] == pytest.approx(
        cnt["queries_batched"] / cnt["batches_executed"])
    assert 0 < n["cpu_in_spans_share"] <= 1.5
    assert set(BUILD) <= set(out["result"]["metrics"])


class S:
    def __init__(self, name, start, end, parent=None, cpu=None):
        self.name, self.start, self.end = name, start, end
        self.parent, self.cpu = parent, cpu


def test_portbench_idle_gaps_named_nearest_the_device():
    spans = [S("server.command", 0.0, 10.0), S("batcher.queue", 1.0, 2.0),
             S("ops.pull", 1.5, 1.8), S("index.search_and", 0.5, 9.0),
             S("server.handoff_in", 11.0, 12.0)]
    layers = [("batcher", 1, 12.5, 13.5, 1.0)]
    idle = [(1.6, 1.7), (1.1, 1.2), (5.0, 6.0), (11.4, 11.6), (12.9, 13.0),
            (20.0, 21.0)]
    got = programtrace.idle_by_program_span(idle, spans, layers)
    assert got == pytest.approx({"ops.pull": 0.1, "batcher.queue": 0.1,
                                 "index.*": 1.0, "server.handoff_in": 0.2,
                                 "batcher": 0.1, "none": 1.0})


def test_portbench_trace_summaries():
    spans = [S("a", 0.1, 0.2, cpu=0.05), S("a", 1.1, 1.4, cpu=0.1),
             S("b", 0.0, 0.5, parent=3)]
    s = programtrace.summary(spans)
    assert s["a"]["count"] == 2
    assert s["a"]["wall_s"] == pytest.approx(0.4)
    assert s["a"]["cpu_s"] == pytest.approx(0.15)
    assert s["b"]["cpu_s"] is None
    per = programtrace.by_second(spans, 0.0, 3, ["a"])["a"]
    assert per[0] == pytest.approx(100.0)
    assert per[1] == pytest.approx(300.0)
    assert per[2] is None
    assert programtrace.cpu_in_spans(spans) == pytest.approx(0.15)
    f = programtrace.follows({"w": [1.0, 2.0, 3.0, None]}, [30, 20, 10, 5])
    assert f["w"] == pytest.approx(-1.0)


@pytest.mark.parametrize("name", ["counters", "metric_reader"])
def test_portbench_programtrace_patches_what_run_cell_calls(name):
    # traced_run swaps these module globals of the harness for the run:
    # renamed or no longer called by run_cell, the swap would see nothing
    assert callable(getattr(harness, name))
    assert name in harness.run_cell.__code__.co_names
