"""The verified, BM25-ranked cell ``ja-verified.bm25-c4`` on the CPU, at a
size a test run holds: 3,000 articles of a third of the configuration's
mean length (the CPU runs the kernels' plain versions over whole rows),
driven end to end through the harness's functions, must come out
correct with ``bm25_gap`` under its limit; the text store it serves from
has articles longer than its row, and the fused program serves the
verified and scored queries.

    MYGRAM_TORCH_DEVICE=cpu python -m pytest portbench/tests -q
"""

import copy
import time

import pytest

from portbench import harness

CELL = "ja-verified.bm25-c4"


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("MYGRAM_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("MYGRAM_ALLOW_ROOT", "1")


def tiny() -> dict:
    """The cell at 3,000 articles of mean 250 characters, 256 queries."""
    c = copy.deepcopy(harness.cell(CELL))
    corpus = c["config"]["corpus"]
    corpus["docs"] = 3000
    corpus["ja_chars"]["mean"] = 250
    c["traffic"].update(queries=256, warmup_s=1, warmup_per_class=1)
    return c


def test_portbench_bm25_cell_is_correct_on_the_cpu():
    from mygramdb_tpu_torch.ops import runtime
    r0 = dict(runtime.routes)
    o0 = dict(getattr(runtime, "overflow", {}))
    out = harness.run_cell(tiny(), 2**31 + 4242, 3.0, False,
                           time.monotonic(), device="cpu")
    r = out["result"]
    assert out["banned"] == []
    assert r["attempted"] > 0 and r["failed"] == 0
    assert out["compared"]["wrong"]["value"] == 0, out["notes"]
    gap = out["compared"]["bm25_gap"]
    assert gap["limit"] == 1e-4 and gap["value"] < gap["limit"]
    assert r["correct"]
    assert {"device_gb", "setup_s"} & set(r["metrics"]) == {"setup_s"}
    fused = sum(runtime.routes[k] - r0[k]
                for k in ("fused_dense", "fused_sparse"))
    assert fused > 0
    assert runtime.routes["verify_exact"] == r0["verify_exact"]
    assert runtime.overflow["verify_overflow_candidates"] > \
        o0.get("verify_overflow_candidates", 0)


def test_portbench_bm25_text_metrics_read_the_build():
    """The traced run's two text metrics: the text store's build seconds
    and its device bytes."""
    out = harness.run_cell(tiny(), 2**31 + 4343, 2.0, True,
                           time.monotonic(), device="cpu")
    m = out["result"]["metrics"]
    assert m["text.build_s"]["value"] > 0
    assert 0 < m["text.device_gb"]["value"] < 1


def test_portbench_bm25_control_is_not_correct():
    from portbench.control import control_readings
    for out in control_readings(tiny(), [11, 12]):
        assert not out["correct"], out
