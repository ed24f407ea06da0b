"""The harness on the CPU, at a size a test run holds: cells found by name,
one tiny cell driven end to end through the harness's functions (the
command itself refuses to run without a card), and the run's check coming
out false when the timed path is broken underneath.

    MYGRAM_TORCH_DEVICE=cpu python -m pytest portbench/tests -q
"""

import ast
import copy
import itertools
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from portbench import harness

ROOT = harness.ROOT
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
BANNED = {"jax", "jaxlib", "flax", "mygramdb_tpu"}
# the reference and what it is built from: nothing of the program
REFERENCE = ("reference.py", "textrules.py", "gramindex.py", "check.py",
             "corpus.py")


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("MYGRAM_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("MYGRAM_ALLOW_ROOT", "1")


CELL = BENCH["workloads"][0]["name"]


def tiny(workload: str = CELL) -> dict:
    """The cell at 3,000 documents, 256 queries, at most 8 callers."""
    c = copy.deepcopy(harness.cell(workload))
    c["config"]["corpus"]["docs"] = 3000
    t = c["traffic"]
    t.update(queries=256, warmup_s=1, connections=min(t["connections"], 8),
             client_processes=min(t["client_processes"], 2),
             dense_min_df=0.1)
    t["dense"] = {k: (None if v == 1.0 else v) for k, v in t["dense"].items()}
    return c


def tiny_verified() -> dict:
    """The tiny cell on a table that verifies text, asked for score pages:
    the check's BM25 comparison, which no cell of BENCHMARK.json uses yet
    (PERF.md, Open questions)."""
    c = tiny()
    c["config"]["server"]["memory"]["verify_text"] = "all"
    c["config"].update(control="bf16_bm25",
                       limits={"wrong": 0, "bm25_gap": 1e-05})
    c["traffic"].update(commands={"search_score": 0.6, "search_id_desc": 0.25,
                                  "count": 0.15},
                        dense={"en": None, "ja": None}, max_rarest_df=None,
                        ja_run=[2, 4])
    return c


def run(c, trace=False, seconds=3.0):
    return harness.run_cell(c, 2**31 + 12345, seconds, trace,
                            time.monotonic(), device="cpu")


@pytest.mark.parametrize("w", [w["name"] for w in BENCH["workloads"]])
def test_portbench_cell_found_by_name(w):
    c = harness.cell(w)
    assert c["config"]["name"] == c["workload"]["config"]
    assert {"connections", "client_processes", "queries"} <= set(c["traffic"])
    assert {m["name"] for m in c["end_to_end"]} >= {"device_gb", "setup_s"}
    for m in c["per_layer"]:
        reader = harness.metric_reader(m["name"])
        assert (reader.NAME, reader.UNIT, reader.LAYER, reader.MOVES,
                reader.SOURCE, reader.BETTER) == (
            m["name"], m["unit"], m["layer"], m["moves"], m["source"],
            m["better"])


def test_portbench_configs_state_their_cut():
    for c in BENCH["configs"]:
        conf = json.load(open(os.path.join(ROOT, c["file"])))
        assert conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"]
        assert conf["assumed"]
        assert all(k in conf["corpus"] for k in conf["reduced"])
        assert conf["reduced"] == [] or conf["cut"]


def test_portbench_command_refuses_without_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         BENCH["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert "correct" not in out.stdout


@pytest.mark.parametrize("trace", [False, True])
def test_portbench_tiny_cell_end_to_end(trace):
    c = tiny()
    out = run(c, trace)
    r = out["result"]
    assert out["banned"] == []
    assert r["attempted"] > 0 and r["failed"] == 0
    assert out["compared"]["wrong"]["value"] == 0, out["notes"]
    assert r["correct"]
    if trace:
        assert "build.docs_per_s" in r["metrics"]
        assert out["notes"]["spans_installed"]
    else:
        assert "setup_s" in r["metrics"]
    assert out["notes"]["qps"] > 0 and out["notes"]["latency_ms"]["p95"] > 0
    assert 0 < out["notes"]["warm_queries"] < 256


# ---------------------------------------------------------------------------
# The timed path broken underneath: correct must come out false
# ---------------------------------------------------------------------------

def drop_an_id(monkeypatch):
    """An answer altered where it is produced: the pipeline's page loses
    its last id."""
    from mygramdb_tpu_torch.query.pipeline import SearchPipeline
    orig = SearchPipeline.execute

    def execute(self, *a, **kw):
        out = orig(self, *a, **kw)
        if out.results is not None and len(out.results) >= 2:
            out.results = out.results[:-1]
        return out
    monkeypatch.setattr(SearchPipeline, "execute", execute)


def swap_scores(monkeypatch):
    """Two places of a score page swapped where the page is produced."""
    from mygramdb_tpu_torch.query.pipeline import SearchPipeline
    orig = SearchPipeline.execute

    def execute(self, *a, **kw):
        out = orig(self, *a, **kw)
        if out.scores is not None and len(out.results) >= 2:
            page = np.asarray(out.results).copy()
            page[[0, -1]] = page[[-1, 0]]
            out.results = page
        return out
    monkeypatch.setattr(SearchPipeline, "execute", execute)


def half_the_batch(monkeypatch):
    """Half of the micro-batches' queries left out: every second query a
    batch program takes is answered as matching nothing."""
    from mygramdb_tpu_torch.server import microbatch
    seq = itertools.count()
    for name in ("_execute_dense", "_execute_sparse",
                 "_execute_fused_verify", "_execute_fused_sparse_verify"):
        orig = getattr(microbatch.MicroBatcher, name)

        def run_half(self, q, *a, _orig=orig):
            kept = [r for r in q if next(seq) % 2 == 0]
            if kept:
                _orig(self, kept, *a)
            for r in q:
                if r not in kept:
                    r.total, r.pre, r.clipped = 0, 0, False
                    r.ids = np.full(1, -1, dtype=np.int64)
                    r.scores = np.zeros(1, dtype=np.float32)
                    r.event.set()
        monkeypatch.setattr(microbatch.MicroBatcher, name, run_half)


@pytest.mark.parametrize("fault", [drop_an_id, half_the_batch])
def test_portbench_broken_path_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    out = run(tiny())
    assert out["result"]["attempted"] > 0
    assert out["compared"]["wrong"]["value"] > 0
    assert not out["result"]["correct"]


def test_portbench_swapped_score_page_is_not_correct(monkeypatch):
    swap_scores(monkeypatch)
    out = run(tiny_verified(), seconds=6.0)
    gap = out["compared"]["bm25_gap"]
    assert gap["value"] > gap["limit"]
    assert not out["result"]["correct"]


def test_portbench_control_is_not_correct():
    from portbench.control import control_readings
    search = tiny()
    search["config"]["corpus"]["docs"] = 8000  # counts past 2,048
    for c in (search, tiny_verified()):
        for out in control_readings(c, [7, 8]):
            assert not out["correct"], out


def test_portbench_cpu_layout_parts_the_cores():
    layout = harness.cpu_layout(1)
    if layout is None:
        pytest.skip("this machine has one core to give")
    server, (client,) = layout
    assert server and client and not set(server) & set(client)


# ---------------------------------------------------------------------------
# What the benchmark imports
# ---------------------------------------------------------------------------

def imported(path):
    tree = ast.parse(open(path, encoding="utf-8").read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
    for node in ast.walk(tree):  # importlib / __import__ by a literal name
        if isinstance(node, ast.Call) and node.args and isinstance(
                node.args[0], ast.Constant) and isinstance(
                node.args[0].value, str) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__"):
            yield node.args[0].value


def test_portbench_imports_no_jax():
    here = os.path.join(ROOT, "portbench")
    for dirpath, _, files in os.walk(here):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                tops = {m.split(".")[0] for m in imported(path) if m}
                assert not tops & BANNED, (path, tops & BANNED)
                if f in REFERENCE and dirpath == here:
                    assert "mygramdb_tpu_torch" not in tops, path
