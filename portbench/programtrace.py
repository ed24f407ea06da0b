#!/usr/bin/env python3
"""The traced run of a cell with the program's own spans on:

    python3 portbench/programtrace.py --workload NAME --seed N --seconds S

from the root of a checkout. It is ``run.py --trace 1`` (the same inputs,
server, clients, window, device trace, check and result line) with
``mygramdb_tpu_torch.utils.trace`` enabled before ``initialize()``, and
adds to the notes line what the spans of the window say:

- ``trace``: for each span name, the count, wall and CPU seconds, mean and
  p95 in ms (``summary``);
- ``trace_by_second``: the mean ms of the spans in ``PER_SECOND`` (the
  waits, then a batch's steps) in each second of the window, beside
  ``answered_by_second``, and ``trace_follows``: each one's correlation
  with the answers a second;
- ``trace_counters``: the program's counters' differences across the
  window (the batcher's flushes by cause, queue wait and wake seconds,
  the executor's wait, kernel builds), and ``avg_batch``;
- ``cpu_in_spans_s`` and ``cpu_in_spans_share``: the CPU seconds of the
  outermost spans (the only ones that read the thread CPU clock),
  against ``process_cpu_s``;
- ``build_stages``: the set-up's stages;
- ``idle_by_layer``: the device's idle gaps named by the spans of
  ``spans.py`` (the harness's ``breakdown.idle_gaps``), while the result
  line's ``breakdown.idle_gaps`` names each gap by the program span open
  at its middle that lies nearest the device (``NEAREST``), else by the
  layer of ``spans.py``, else ``none``.

On a program without the tracer module it exits 2 with a message.
"""

from __future__ import annotations

import fnmatch
import json
import os
import sys
import time
from typing import Dict, List, Optional

T_START = float(os.environ.get("PORTBENCH_T_START", time.monotonic()))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

# nearest the device first: a gap is named by the first of these with a
# span open at its middle
NEAREST = ["ops.pull", "ops.launch", "ops.upload", "batcher.pack",
           "batcher.execute", "batcher.wake", "batcher.queue", "index.*",
           "query.execute", "server.command", "server.handoff_out",
           "server.handoff_in", "server.write"]
# the waits, then the batch's own steps
PER_SECOND = ["batcher.queue", "batcher.wake", "server.handoff_in",
              "server.handoff_out", "batcher.execute", "ops.upload",
              "ops.launch", "ops.pull", "server.command"]


def summary(spans) -> Dict[str, dict]:
    """{span name: count, wall_s, cpu_s (None where the spans cross
    threads), mean_ms, p95_ms}."""
    by: Dict[str, List] = {}
    for s in spans:
        by.setdefault(s.name, []).append(s)
    out = {}
    for name, ss in sorted(by.items()):
        sec = np.array([s.end - s.start for s in ss])
        cpu = [s.cpu for s in ss if s.cpu is not None]
        out[name] = {"count": len(ss), "wall_s": float(sec.sum()),
                     "cpu_s": float(sum(cpu)) if cpu else None,
                     "mean_ms": float(sec.mean() * 1e3),
                     "p95_ms": float(np.percentile(sec, 95) * 1e3)}
    return out


def by_second(spans, t0: float, seconds: int, names) -> Dict[str, list]:
    """{name: mean ms of its spans ending in each second of the window
    (None in a second with none)}."""
    out = {}
    for name in names:
        sums = np.zeros(seconds)
        counts = np.zeros(seconds)
        for s in spans:
            if s.name == name:
                i = int(s.end - t0)
                if 0 <= i < seconds:
                    sums[i] += s.end - s.start
                    counts[i] += 1
        out[name] = [float(a / n * 1e3) if n else None
                     for a, n in zip(sums, counts)]
    return out


def follows(per_second: Dict[str, list], answered: List[int]
            ) -> Dict[str, Optional[float]]:
    """Each wait's correlation, over the seconds, with the answers a
    second (strongly negative: the wait grows in the slow seconds)."""
    out = {}
    for name, means in per_second.items():
        pairs = [(m, a) for m, a in zip(means, answered) if m is not None]
        if len(pairs) < 3:
            out[name] = None
            continue
        m, a = np.array(pairs, dtype=float).T
        out[name] = (float(np.corrcoef(m, a)[0, 1])
                     if m.std() > 0 and a.std() > 0 else None)
    return out


def cpu_in_spans(spans) -> float:
    """CPU seconds of the outermost spans that ran on one thread."""
    return float(sum(s.cpu for s in spans
                     if s.parent is None and s.cpu is not None))


def _stabber(intervals):
    """-> open(t): whether one of the (start, end) intervals holds t."""
    if not intervals:
        return lambda t: False
    iv = sorted(intervals)
    st = np.array([a for a, _ in iv])
    en = np.maximum.accumulate(np.array([b for _, b in iv]))

    def open_at(t):
        j = np.searchsorted(st, t, side="right") - 1
        return j >= 0 and en[j] >= t
    return open_at


def idle_by_program_span(idle, spans, layer_spans=()) -> Dict[str, float]:
    """Idle seconds by the program span open at each gap's middle that
    lies nearest the device (``NEAREST``), else by the deepest layer of
    ``spans.py`` (layer_spans: its (layer, thread, start, end, self)
    tuples), else ``none``."""
    from portbench.spans import DEPTH
    groups = []
    for pat in NEAREST:
        groups.append((pat, _stabber([(s.start, s.end) for s in spans
                                      if fnmatch.fnmatchcase(s.name, pat)])))
    for layer in sorted(DEPTH, key=DEPTH.get, reverse=True):
        groups.append((layer, _stabber([(s[2], s[3]) for s in layer_spans
                                        if s[0] == layer])))
    out: Dict[str, float] = {}
    for a, b in idle:
        mid = (a + b) / 2
        name = next((g for g, open_at in groups if open_at(mid)), "none")
        out[name] = out.get(name, 0.0) + (b - a)
    return out


def program_counters(app) -> dict:
    """The program's counters the notes line reads (summed over tables)."""
    from mygramdb_tpu_torch.ops import runtime
    out = dict(app.core.batcher_counters() or {})
    out["executor_wait_s"] = app.core.stats.executor_wait_s
    out["kernel_builds"] = runtime.kernel_builds
    return out


def traced_run(c: dict, seed: int, seconds: float, t_start: float,
               device: str = "cuda", layout=None) -> dict:
    """``harness.run_cell`` traced, with the program's tracer on from
    before ``initialize()``; the notes and the result's breakdown get what
    the window's spans say (the module's docstring)."""
    from mygramdb_tpu_torch.utils import trace
    from portbench import harness
    # the window's instants and the counters there: the harness reads its
    # own counters once at each end of the window
    marks = []
    obs_seen = {}
    counters, metric_reader = harness.counters, harness.metric_reader

    def counters_at(app):
        marks.append((trace.clock(), program_counters(app)))
        return counters(app)

    def reader_seeing(name):
        mod = metric_reader(name)

        class Reader:
            @staticmethod
            def read(obs):
                obs_seen.setdefault("obs", obs)
                return mod.read(obs)
        return Reader

    harness.counters, harness.metric_reader = counters_at, reader_seeing
    trace.clear()
    trace.enable()
    try:
        out = harness.run_cell(c, seed, seconds, True, t_start,
                               device=device, layout=layout)
    finally:
        trace.disable()
        harness.counters, harness.metric_reader = counters, metric_reader
    (t0, k0), (t1, k1) = marks[0], marks[-1]
    window = trace.spans_between(t0, t1)
    notes = out["notes"]
    per_second = by_second(window, t0, int(seconds), PER_SECOND)
    diff = {k: k1[k] - k0.get(k, 0) for k in k1}
    cpu = cpu_in_spans(window)
    notes.update({
        "trace": summary(window),
        "trace_by_second": per_second,
        "trace_follows": follows(per_second, notes["answered_by_second"]),
        "trace_counters": diff,
        "avg_batch": (diff["queries_batched"] / diff["batches_executed"]
                      if diff.get("batches_executed") else None),
        "cpu_in_spans_s": cpu,
        "cpu_in_spans_share": (cpu / notes["process_cpu_s"]
                               if notes["process_cpu_s"] else None),
        "trace_window": [t0, t1],
        "spans_in_window": len(window),
        "build_stages": [{"name": s.name, "s": s.seconds, "own_s": s.own,
                          "attrs": s.attrs} for s in trace.build_stages()]})
    obs = obs_seen.get("obs")
    d = obs and obs["device"]
    breakdown = out["result"].get("breakdown")
    if d and d["idle"] is not None and breakdown is not None:
        notes["idle_by_layer"] = breakdown["idle_gaps"]
        gaps = sorted(idle_by_program_span(d["idle"], window,
                                           obs["spans"]).items(),
                      key=lambda kv: -kv[1])
        breakdown["idle_gaps"] = [[k, v] for k, v in gaps]
    return out


def main(argv, t_start: float) -> int:
    import argparse
    from portbench import harness
    ap = argparse.ArgumentParser(prog="portbench/programtrace.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    a = ap.parse_args(argv)
    try:
        from mygramdb_tpu_torch.utils import trace  # noqa: F401
    except ImportError:
        print("portbench: this program has no utils.trace", file=sys.stderr)
        return 2
    c = harness.cell(a.workload)
    for var, sub in harness.CACHES.items():
        os.environ[var] = os.path.join(ROOT, "build", "portbench", sub)
    layout = harness.cpu_layout(c["traffic"]["client_processes"])
    if layout:
        harness.pin_threads(layout[0])
    import torch
    chips = c["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell asks for {chips} CUDA device(s)",
              file=sys.stderr)
        return 2
    out = traced_run(c, a.seed, a.seconds, t_start, layout=layout)
    harness.log(out["notes"])
    if out["banned"]:
        print("portbench: modules of JAX or of the JAX package are loaded: "
              + ", ".join(out["banned"]), file=sys.stderr)
        return 3
    result = dict(out["result"])
    result["compared"] = out["compared"]
    for name, v in out["compared"].items():
        print(f"compared {name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    if os.environ.get("PYTHONHASHSEED") != "0":
        env = dict(os.environ, PYTHONHASHSEED="0",
                   PORTBENCH_T_START=repr(T_START))
        os.execve(sys.executable, [sys.executable] + sys.argv, env)
    sys.exit(main(sys.argv[1:], T_START))
