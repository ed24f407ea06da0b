"""One run of one cell: make the inputs from the seed, load them into the
port's server, drive it from client processes for the window, check every
answer against the reference, and print the result line.

Everything a cell needs is found by name: ``BENCHMARK.json`` names the
cell's configuration (its ``file``), its traffic (``portbench/traffic/
<traffic>.json``) and its metrics (``portbench/metrics/<name>.py`` for a
per-layer metric).
"""

from __future__ import annotations

import asyncio
import gc
import importlib.util
import json
import os
import resource
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from typing import List

import numpy as np

from . import check, gramindex, spans, textrules, traffic
from .corpus import CorpusGenerator
from .devtrace import DeviceTrace, idle_by_span
from .reference import Reference

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BANNED = ("jax", "jaxlib", "flax", "mygramdb_tpu")
# distinct queries of the window held against the reference, drawn from
# the seed (the rest are held to giving one answer)
CHECKED = 1024
# the CUDA driver's kernel cache, inside the checkout (the port builds its
# kernels into build/torch_kernels/ of the checkout itself)
CACHES = {"CUDA_CACHE_PATH": "nv"}


def log(obj) -> None:
    print(json.dumps(obj), flush=True)


# ---------------------------------------------------------------------------
# The cell, by name
# ---------------------------------------------------------------------------

def load_json(path: str):
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


def cell(workload: str, root: str = ROOT) -> dict:
    """The cell's entries and files, found by the names in
    ``BENCHMARK.json``."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    w = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if w is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    c = next(c for c in bench["configs"] if c["name"] == w["config"])

    def mine(m):
        return m.get("workloads") is None or w["name"] in m["workloads"]

    return {"workload": w, "config": load_json(os.path.join(root, c["file"])),
            "traffic": load_json(os.path.join(
                HERE, "traffic", w["traffic"] + ".json")),
            "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
            "per_layer": [m for m in bench["per_layer"] if mine(m)]}


def metric_reader(name: str):
    """The reader of a per-layer metric, ``portbench/metrics/<name>.py``."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------

def make_corpus(conf: dict, tmp: str):
    """Generate the corpus, write it as the loader's JSONL seed file ->
    (texts, docs 1..N with texts[0] unused; is_ja; status; seed path)."""
    c, table = conf["corpus"], conf["table"]
    gen = CorpusGenerator(c["docs"], ja_ratio=c["ja_ratio"],
                          vocab_size=c["vocab_size"], n_kanji=c["n_kanji"],
                          seed=c["seed"], en_words=c["en_words"],
                          ja_chars=c["ja_chars"])
    texts = [""]
    path = os.path.join(tmp, "seed.jsonl")
    mod = table["status_modulus"]
    with open(path, "w", encoding="utf-8") as fh:
        for batch in gen.batches(50_000):
            ids = [i for i, _ in batch]
            got = [t for _, t in batch]
            joined = "".join(got)
            if '"' in joined or "\\" in joined or not joined.isprintable():
                got = [json.dumps(t, ensure_ascii=False)[1:-1] for t in got]
            fh.write("".join('{"id": %d, "content": "%s", "status": %d}\n'
                             % (i, t, i % mod) for i, t in zip(ids, got)))
            texts.extend(t for _, t in batch)
    is_ja = np.fromiter((not t.isascii() for t in texts), dtype=bool,
                        count=len(texts))
    is_ja[0] = False
    status = np.arange(len(texts), dtype=np.int64) % mod
    return texts, is_ja, status, path


def server_config(conf: dict, tmp: str) -> str:
    """The port's configuration file for the cell."""
    t = conf["table"]
    cfg = {"tables": [{
        "name": t["name"], "text_source": {"column": "content"},
        "ngram_size": t["ngram_size"],
        "kanji_ngram_size": t["kanji_ngram_size"],
        "kanji_extra_ngram": t["kanji_extra_ngram"],
        "filters": [{"name": "status", "type": "int",
                     "bitmap_index": True}]}],
        "api": {"tcp": {"bind": "127.0.0.1", "port": 0}},
        "network": {"allow_cidrs": ["127.0.0.0/8"]},
        "dump": {"dir": os.path.join(tmp, "dumps")},
        "logging": {"level": "warn"}}
    cfg.update(conf["server"])
    path = os.path.join(tmp, "config.json")
    with open(path, "w") as fh:
        json.dump(cfg, fh)
    return path


# ---------------------------------------------------------------------------
# The server and its callers
# ---------------------------------------------------------------------------

class Server:
    """The port's ``TcpServer`` over an initialized ``Application`` (the
    pair ``app.main`` runs), its event loop on a thread of this process."""

    def __init__(self, app):
        from mygramdb_tpu_torch.server.tcp_server import TcpServer
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       name="portbench-loop", daemon=True)
        self.thread.start()
        self.tcp = TcpServer(app.core, app.config)
        asyncio.run_coroutine_threadsafe(self.tcp.start(),
                                         self.loop).result(60)
        self.port = self.tcp.port

    def stop(self) -> None:
        asyncio.run_coroutine_threadsafe(self.tcp.stop(),
                                         self.loop).result(120)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(60)
        self.loop.close()


class Clients:
    """The closed loop's client processes (``client.py``, each a new
    interpreter)."""

    def __init__(self, spec: dict, port: int, lines: List[str],
                 order: np.ndarray, warm: List[int], tmp: str, layout):
        conns, procs = spec["connections"], spec["client_processes"]
        qpath = os.path.join(tmp, "queries.json")
        with open(qpath, "w", encoding="utf-8") as fh:
            json.dump(lines, fh, ensure_ascii=False)
        n = len(order)
        starts = [c * n // conns for c in range(conns)]
        self.procs, self.outs = [], []
        for p in range(procs):
            out = os.path.join(tmp, f"client{p}.json")
            args = os.path.join(tmp, f"client{p}.args.json")
            with open(args, "w") as fh:
                json.dump({"port": port, "queries": qpath,
                           "order": order.tolist(),
                           "starts": starts[p::procs],
                           "warm": warm[p::procs],
                           "cpus": layout[1][p] if layout else None,
                           "timeout_s": spec["timeout_s"], "out": out}, fh)
            self.procs.append(subprocess.Popen(
                [sys.executable, os.path.join(HERE, "client.py"), args],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
                cwd=ROOT))
            self.outs.append(out)
        self.timeout = spec["timeout_s"]

    def tell(self, line: str) -> None:
        for p in self.procs:
            p.stdin.write(line + "\n")
            p.stdin.flush()

    def wait_for(self, word: str) -> None:
        for p in self.procs:
            if p.stdout.readline().strip() != word:
                raise RuntimeError(f"a client process did not say {word}")

    def collect(self, t1: float) -> dict:
        merged = {"lat": [], "at": [], "qi": [], "answers": {}, "failed": [],
                  "banned_modules": []}
        for p, out in zip(self.procs, self.outs):
            p.wait(max(t1 - time.monotonic(), 0) + self.timeout + 30)
            if p.returncode != 0:
                raise RuntimeError(f"a client process exited {p.returncode}")
            got = load_json(out)
            merged["lat"] += got["lat"]
            merged["at"] += got["at"]
            merged["qi"] += got["qi"]
            merged["failed"] += got["failed"]
            merged["banned_modules"] += got["banned_modules"]
            for k, v in got["answers"].items():
                merged["answers"].setdefault(int(k), set()).update(v)
        return merged

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait()


def cpu_layout(client_procs: int):
    """(the server's CPUs, each client process's CPUs): the last physical
    cores this process may use go one to a client process, the rest to the
    server (this process), so that the two never share a core. None where
    there are too few cores to part."""
    cores = {}
    for cpu in sorted(os.sched_getaffinity(0)):
        try:
            with open(f"/sys/devices/system/cpu/cpu{cpu}/topology/"
                      "thread_siblings_list") as fh:
                key = fh.read().strip()
        except OSError:
            key = str(cpu)
        cores.setdefault(key, []).append(cpu)
    groups = sorted(cores.values())
    if len(groups) < client_procs + 1:
        return None
    clients = [groups[-1 - p] for p in range(client_procs)]
    server = [c for g in groups[:len(groups) - client_procs] for c in g]
    return server, clients


def pin_threads(cpus) -> None:
    """Every thread of this process, and every thread it starts later, on
    cpus."""
    for tid in os.listdir("/proc/self/task"):
        os.sched_setaffinity(int(tid), cpus)


def counters(app) -> dict:
    """The program's counters that per-layer metrics read (None where a
    counter is no longer there)."""
    out = {}
    stats = getattr(app.core, "stats", None)
    try:
        out["server"] = {"commands": stats.total_commands,
                         "total_query_time_ms": stats.total_query_time_ms}
    except AttributeError:
        out["server"] = None
    batchers = [getattr(ctx.index.device, "batcher", None)
                for ctx in app.catalog.contexts()]
    try:
        out["batcher"] = {k: sum(getattr(b, k) for b in batchers if b)
                          for k in ("batches_executed", "queries_batched")}
    except AttributeError:
        out["batcher"] = None
    from mygramdb_tpu_torch.ops import runtime
    for name in ("launches", "routes"):
        got = getattr(runtime, name, None)
        out[name] = dict(got) if isinstance(got, dict) else None
    return out


def difference(a: dict, b: dict) -> dict:
    out = {}
    for k in a:
        if a[k] is None or b.get(k) is None:
            out[k] = None
        else:
            out[k] = {n: b[k][n] - a[k][n] for n in a[k] if n in b[k]}
    return out


def process_cpu_s() -> float:
    """This process's CPU seconds, user and system."""
    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_utime + r.ru_stime


def sleep_until(t: float) -> None:
    while True:
        left = t - time.monotonic()
        if left <= 0:
            return
        time.sleep(min(left, 0.5))


# ---------------------------------------------------------------------------
# A run
# ---------------------------------------------------------------------------

def warm_list(queries: List[dict], per_class: int) -> List[int]:
    """The warm-up's queries: the first per_class of each class of the
    list (command, terms, lead, filter, dense or sparse), so that every
    route and shape of the window has run before it."""
    seen, out = {}, []
    for i, q in enumerate(queries):
        if seen.get(q["cls"], 0) < per_class:
            seen[q["cls"]] = seen.get(q["cls"], 0) + 1
            out.append(i)
    return out


def run_cell(c: dict, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda", layout=None) -> dict:
    """One run of cell c -> {"result": the result line's object,
    "compared": the numbers compared, "notes": an earlier line, "banned":
    modules of JAX found loaded}. layout: the CPUs of the server (this
    process, already pinned) and of each client process, or None."""
    os.environ["MYGRAM_TORCH_DEVICE"] = device
    conf, spec = c["config"], c["traffic"]
    tmp = tempfile.mkdtemp(prefix="portbench-")
    clients = server = app = recorder = None
    try:
        t = time.monotonic()
        texts, is_ja, status, seed_path = make_corpus(conf, tmp)
        queries = traffic.Generator(spec, conf["table"], texts,
                                    is_ja).queries()
        t_gen = time.monotonic() - t

        import torch
        from mygramdb_tpu_torch.app.application import Application
        from mygramdb_tpu_torch.config import load_config
        cuda = device == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        app = Application(load_config(server_config(conf, tmp)),
                          seed_path=seed_path)
        t = time.monotonic()
        app.initialize()
        t_init = time.monotonic() - t
        os.remove(seed_path)
        server = Server(app)
        order = traffic.replay_order(len(queries), seed)
        warm = warm_list(queries, spec["warmup_per_class"])
        clients = Clients(spec, server.port, [q["line"] for q in queries],
                          order, warm, tmp, layout)
        clients.wait_for("ready")
        if trace:
            recorder = spans.Recorder()
            recorder.install()
        dtrace = None
        t_prof = 0.0
        if trace and cuda:  # the profiler starts slowly: before the load
            t = time.monotonic()
            dtrace = DeviceTrace()
            dtrace.start()
            t_prof = time.monotonic() - t
        # warm-up: the warm list at the cell's load, then warmup_s more of
        # the replay
        t_go = time.monotonic()
        clients.tell("go")
        clients.wait_for("warm")
        t_pass = time.monotonic() - t_go
        t0 = time.monotonic() + spec["warmup_s"]
        t1 = t0 + seconds
        clients.tell(f"window {t0!r} {t1!r}")
        sleep_until(t0)
        cpu0 = process_cpu_s()
        c0 = counters(app)
        if dtrace is not None:
            dtrace.mark()
        setup_s = time.monotonic() - t_start
        sleep_until(t1)
        if dtrace is not None:
            dtrace.mark()
        c1 = counters(app)
        cpu1 = process_cpu_s()
        got = clients.collect(t1)
        clients = None
        if dtrace is not None:
            dtrace.stop()
        peak = torch.cuda.max_memory_allocated() if cuda else None
        window_spans = recorder.window(t0, t1) if recorder else []
        if recorder:
            recorder.uninstall()
        server.stop()
        server = None
        n_docs = app.catalog.contexts()[0].doc_count
        app = None
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        banned = sorted(m for m in sys.modules
                        if m.split(".")[0] in BANNED) + got["banned_modules"]

        # the check, after the window, outside set-up
        t = time.monotonic()
        corpus = gramindex.Corpus(textrules.normalize_all(texts))
        del texts
        verify = conf["server"]["memory"]["verify_text"] != "off"
        answered_q = sorted(got["answers"])
        rng = np.random.default_rng(seed)
        sample = sorted(rng.choice(answered_q, min(CHECKED, len(answered_q)),
                                   replace=False).tolist()) if answered_q \
            else []
        ref = Reference.for_queries(corpus, status, conf["table"], verify,
                                    [queries[i] for i in sample])
        # a query answered two ways in the window is wrong at least once
        chosen = set(sample)
        failures = len(got["failed"]) + sum(
            len(v) - 1 for i, v in got["answers"].items() if i not in chosen)
        examples = []
        compared = check.compare(ref, queries,
                                 {i: got["answers"][i] for i in sample},
                                 failures, conf["limits"], examples)
        t_check = time.monotonic() - t
        correct = (all(v["value"] <= v["limit"] for v in compared.values())
                   and n_docs == conf["corpus"]["docs"])

        answered = len(got["lat"])
        lat_ms = np.asarray(got["lat"]) * 1e3
        metrics = {}
        result = {"correct": bool(correct),
                  "attempted": answered + len(got["failed"]),
                  "failed": len(got["failed"])}
        dev = {"platform": "gpu" if cuda else "cpu",
               "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
               "count": c["workload"]["chips"] if cuda else 0,
               "memory_peak_bytes": peak}
        notes = {"step": "run", "workload": c["workload"]["name"],
                 "seed": seed, "seconds": seconds, "trace": int(trace),
                 "generate_s": t_gen, "initialize_s": t_init,
                 "warmup_pass_s": t_pass, "warmup_s": spec["warmup_s"],
                 "setup_s": setup_s,
                 "check_s": t_check, "answered": answered,
                 "distinct_answered": len(answered_q),
                 "answered_by_second": np.bincount(
                     np.asarray(got["at"], dtype=np.int64),
                     minlength=int(seconds)).tolist(),
                 "process_cpu_s": cpu1 - cpu0,
                 "warm_queries": len(warm), "cpu_layout": layout,
                 "qps": answered / seconds,
                 "latency_ms": {f"p{q}": float(np.percentile(lat_ms, q))
                                for q in (50, 90, 95, 99, 99.9)}
                 if answered else None,
                 "distinct_checked": len(sample),
                 "failed_examples": got["failed"][:5],
                 "wrong_examples": examples,
                 "banned_modules_loaded": banned, "docs": n_docs}
        if not trace:
            # the end-to-end metrics the harness takes; BENCHMARK.json
            # names those a cell reports
            e2e = {"qps": (answered / seconds, "queries/s"),
                   "p95_ms": (float(np.percentile(lat_ms, 95))
                              if answered else None, "ms"),
                   "device_gb": (peak / 1e9 if peak else None, "GB"),
                   "setup_s": (setup_s, "s")}
            for m in c["end_to_end"]:
                value, unit = e2e[m["name"]]
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": unit}
        else:
            obs = {"window_s": seconds, "answered": answered,
                   "counters": difference(c0, c1), "spans": window_spans,
                   "device": dtrace.read() if dtrace else None,
                   "verify_text": verify,
                   "build": {"docs": n_docs, "initialize_s": t_init}}
            for m in c["per_layer"]:
                value = metric_reader(m["name"]).read(obs)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            d = obs["device"]
            if d is not None:
                dev["busy_s"] = d["busy_s"]
                dev["window_s"] = d["window_s"]
                ops = sorted(d["ops"].items(), key=lambda kv: -kv[1])[:10]
                gaps = ([] if d["idle"] is None else sorted(
                    idle_by_span(d["idle"], window_spans).items(),
                    key=lambda kv: -kv[1])[:10])
                result["breakdown"] = {
                    "device_ops": [[k[:64], v] for k, v in ops],
                    "idle_gaps": [[k, v] for k, v in gaps]}
                notes["device_marked"] = d["marked"]
                notes["profiler_start_s"] = t_prof
                notes["profiler_events"] = dtrace.seen
            notes["spans_installed"] = sorted(
                recorder.installed) if recorder else []
        result["metrics"] = metrics
        result["device"] = dev
        return {"result": result, "compared": compared, "notes": notes,
                "banned": banned}
    finally:
        if clients is not None:
            clients.kill()
        if server is not None:
            server.stop()
        if recorder is not None:
            recorder.uninstall()
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# The command
# ---------------------------------------------------------------------------

def main(argv, t_start: float) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    c = cell(a.workload)
    for var, sub in CACHES.items():
        os.environ[var] = os.path.join(ROOT, "build", "portbench", sub)
    # before torch starts a thread: the server's threads all inherit it
    layout = cpu_layout(c["traffic"]["client_processes"])
    if layout:
        pin_threads(layout[0])
    import torch
    chips = c["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell asks for {chips} CUDA device(s); torch "
              f"finds {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    import mygramdb_tpu_torch.app.application  # noqa: F401  the program
    out = run_cell(c, a.seed, a.seconds, bool(a.trace), t_start,
                   layout=layout)
    log(out["notes"])
    if out["banned"]:
        print("portbench: modules of JAX or of the JAX package are loaded: "
              + ", ".join(out["banned"]), file=sys.stderr)
        return 3
    log({"step": "modules", "jax_free": True,
         "checked": "the run's process and every client process"})
    result = dict(out["result"])
    result["compared"] = out["compared"]  # the last key
    for name, v in out["compared"].items():
        print(f"compared {name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
