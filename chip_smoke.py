#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``mygramdb_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--docs N] [--seed S] [--profile PATH]

Phases, each printing one JSON line:

1. device: the card (``nvidia-smi`` name and power limit), torch and CUDA.
2. build: the CUDA kernels built from ``mygramdb_tpu_torch/csrc`` (nvcc).
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the serving path gives it, exact equality (integer work),
   and both timed with CUDA events.
4. serve: the server's own entry points (``Application`` with a seed file,
   ``TcpServer``) at --docs documents of the synthetic EN+JA corpus; many
   SEARCH and COUNT queries from concurrent connections, every answer held
   against a numpy reference computed from the host CSR; then rows are
   removed and the affected queries checked again. The kernels' launch
   counters, the K1 launches by form and the queries per device route are
   reset just before the queries and read just after.
5. profile (only with --profile): on the same server, each query class
   alone at 1 and 64 connections, then ``torch.profiler`` over a window of
   mixed queries: QPS, latency, average batch, the device's busy share and
   the top device and host operations (all lines also written to PATH).

The last two lines are the kernel summary and ``{"ok": true, "device":
...}``. Any failure exits non-zero before them. Without a CUDA device, or
without the repository beside it, the script exits non-zero.
"""

import sys

sys.modules["jax"] = None  # any path that still reaches JAX fails here

import argparse  # noqa: E402
import asyncio  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import threading  # noqa: E402
import time  # noqa: E402
from functools import reduce  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
K1_SOURCE = "mygramdb_tpu_torch/csrc/dense_and.cu"
K3_SOURCE = "mygramdb_tpu_torch/csrc/slice_gather.cu"
K1_REPLACES = "mygramdb_tpu/ops/bitmap_ops.py:184"
K3_REPLACES = "mygramdb_tpu/ops/posting_ops.py:69"
KEYWORDS = {"and", "or", "not", "filter", "sort", "limit", "offset",
            "highlight", "fuzzy", "asc", "desc", "tag", "snippet_len",
            "max_fragments"}


class SmokeFailure(Exception):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def cuda_ms(fn, reps: int = 25) -> float:
    """Median milliseconds of fn() over reps runs after two warmup runs,
    each timed with CUDA events."""
    import torch
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def kernel_phase(gen):
    """-> {kernel name: {"max_abs_err", "ms", "plain_ms"}}; raises on a
    mismatch. ms/plain_ms are at the serving path's batched shape."""
    import torch
    from mygramdb_tpu_torch.ops import bitmap_ops, posting_ops
    dev = torch.device("cuda")
    out = {}

    # K1: dense row-AND
    err = 0
    rows_out = []
    for W in (34816, 313344):  # 1.1M docs; 10M docs (not a 131072 multiple)
        V = 96
        bm = torch.randint(-2 ** 31, 2 ** 31 - 1, (V + 2, W),
                           dtype=torch.int32, generator=gen).to(dev)
        bm[V] = -1
        bm[V + 1] = 0
        deleted = torch.zeros(W, dtype=torch.int32)
        deleted[torch.randint(0, W, (W // 50,), generator=gen)] = \
            torch.randint(-2 ** 31, 2 ** 31 - 1, (W // 50,),
                          dtype=torch.int32, generator=gen)
        deleted = deleted.to(dev)
        for B in (8, 64):
            for K in (8, 32, 64):
                # low-index rows repeat so some ANDs keep bits set
                rows = torch.randint(0, 4, (B, K), dtype=torch.int32,
                                     generator=gen)
                rows[:, K // 2:] = V  # all-ones padding
                rows = rows.to(dev)
                nrows = torch.randint(4, V, (B, 4), dtype=torch.int32,
                                      generator=gen).to(dev)
                extra = torch.randint(-2 ** 31, 2 ** 31 - 1, (2, W),
                                      dtype=torch.int32,
                                      generator=gen).to(dev) | \
                    bm[0][None, :]
                for has_not in (False, True):
                    for has_extra in (False, True):
                        args = (bm, rows, nrows if has_not else None,
                                extra if has_extra else None, deleted)
                        c, r = bitmap_ops.dense_and(*args)
                        cp, rp = bitmap_ops._dense_query_plain(*args)
                        torch.cuda.synchronize()
                        check(torch.equal(c, cp) and torch.equal(r, rp),
                              f"K1 disagrees: W={W} B={B} K={K} "
                              f"not={has_not} extra={has_extra}")
                        err = max(err, int((c - cp).abs().max()))
                        rows_out.append((W, B, K, has_not, has_extra,
                                         int(c.sum())))
        if W == 34816:
            rows8 = torch.randint(0, V, (64, 8), dtype=torch.int32,
                                  generator=gen).to(dev)
            args = (bm, rows8, None, None, deleted)
            ms = cuda_ms(lambda: bitmap_ops.dense_and(*args))
            plain_ms = cuda_ms(lambda: bitmap_ops._dense_query_plain(*args))
    out["dense_and"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "shape": "B=64 K=8 W=34816"}
    emit({"phase": "kernels", "kernel": "dense_and", "configs":
          len(rows_out), "nonzero_counts":
          sum(1 for r in rows_out if r[-1] > 0)})

    # K3: CSR slice gather
    err = 0
    P = 50_000_000
    post = torch.randint(0, 2 ** 31 - 2, (P,), dtype=torch.int32,
                         generator=gen).to(dev)
    for bucket in (2048, 65536):
        Kn = 512
        offs = torch.randint(0, P, (Kn,), dtype=torch.int64, generator=gen)
        lens = torch.randint(0, bucket + bucket // 4, (Kn,),
                             dtype=torch.int64, generator=gen)
        lens[::7] = 0                       # zero lengths
        offs[1::7] = P                      # a dense term's offset
        lens[2::7] = bucket // 2
        offs[2::7] = P - bucket // 2        # slices ending at P
        offs[3::7] = P - 5                  # slices running past P
        offs, lens = offs.to(dev), lens.to(dev)
        g = posting_ops.gather_slices(post, offs, lens, bucket)
        gp = posting_ops._gather_slices_plain(post, offs, lens, bucket)
        torch.cuda.synchronize()
        check(torch.equal(g, gp), f"K3 disagrees: bucket={bucket}")
        err = max(err, int((g.to(torch.int64) - gp.to(torch.int64)
                            ).abs().max()))
    offs64 = torch.randint(0, P - 2048, (64,), dtype=torch.int64,
                           generator=gen).to(dev)
    lens64 = torch.randint(1, 2048, (64,), dtype=torch.int64,
                           generator=gen).to(dev)
    ms = cuda_ms(lambda: posting_ops.gather_slices(post, offs64, lens64,
                                                   2048))
    plain_ms = cuda_ms(lambda: posting_ops._gather_slices_plain(
        post, offs64, lens64, 2048))
    out["slice_gather"] = {"max_abs_err": err, "ms": ms,
                           "plain_ms": plain_ms,
                           "shape": "K=64 bucket=2048"}
    emit({"phase": "kernels", "kernel": "slice_gather", "buckets":
          [2048, 65536]})
    return out


# ---------------------------------------------------------------------------
# Phase 4: serve through the server's entry points
# ---------------------------------------------------------------------------

def write_inputs(docs: int, seed: int):
    """Seed JSONL of the synthetic corpus + a JSON config; -> paths."""
    import numpy as np
    from mygramdb_tpu_torch.utils.corpusgen import CorpusGenerator
    os.makedirs(WORK, exist_ok=True)
    gen = CorpusGenerator(docs, ja_ratio=0.45, seed=seed)
    seed_path = os.path.join(WORK, "seed.jsonl")
    with open(seed_path, "w", encoding="utf-8") as f:
        for batch in gen.batches(50_000):
            f.write("".join(
                json.dumps({"id": i, "content": t, "status": i % 3},
                           ensure_ascii=False) + "\n" for i, t in batch))
    cfg = {
        "tables": [{"name": "articles",
                    "text_source": {"column": "content"},
                    "filters": [{"name": "status", "type": "int",
                                 "bitmap_index": True}]}],
        "cache": {"enabled": False},
        "api": {"tcp": {"bind": "127.0.0.1", "port": 0}},
        "network": {"allow_cidrs": ["127.0.0.0/8"]},
        "dump": {"dir": os.path.join(WORK, "dumps")},
        "logging": {"level": "warn"},
    }
    cfg_path = os.path.join(WORK, "config.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    status = np.arange(docs + 1, dtype=np.int64) % 3
    return gen, seed_path, cfg_path, status


def query_grams(ctx, raw: str):
    """The n-grams a query term is indexed under (host text processing)."""
    from mygramdb_tpu_torch.utils import textproc
    t = ctx.table_cfg
    return set(textproc.generate_query_ngrams(
        ctx.normalize(raw), t.ngram_size, t.kanji_ngram_size,
        t.cross_boundary_ngrams, kanji_extra=ctx.kanji_extra_effective))


class Reference:
    """Expected answers from the host CSR with numpy boolean doc masks
    (no device code)."""

    def __init__(self, ctx, status):
        self.ctx = ctx
        self.built = ctx.index.built
        self.td = ctx.index.term_dict
        self.status = status
        self.removed = set()
        self._cache = {}

    def _mask(self, ids):
        import numpy as np
        m = np.zeros(self.status.size, dtype=bool)
        m[ids] = True
        return m

    def term_ids(self, raw: str):
        """Docs holding every gram of the term."""
        import numpy as np
        if raw not in self._cache:
            m = None
            for g in query_grams(self.ctx, raw):
                tid = self.td.get(g)
                if tid is None:
                    m = np.zeros(self.status.size, dtype=bool)
                    break
                mg = self._mask(self.built.postings_of(tid))
                m = mg if m is None else m & mg
            self._cache[raw] = np.flatnonzero(m)
        return self._cache[raw]

    def ids(self, q: dict):
        import numpy as np
        m = reduce(lambda a, b: a & b,
                   [self._mask(self.term_ids(t)) for t in q["terms"]])
        for t in q.get("not", ()):
            m &= ~self._mask(self.term_ids(t))
        if q.get("filter"):
            m &= self.status == 1
        m[list(self.removed)] = False
        return np.flatnonzero(m)

    def line(self, q: dict) -> str:
        ids = self.ids(q)
        if q["cmd"] == "COUNT":
            return f"OK COUNT {ids.size}"
        page = ids[::-1][:100] if q["desc"] else ids[:100]
        return " ".join([f"OK RESULTS {ids.size}"] + [str(int(d))
                                                      for d in page])


def make_queries(gen, ctx, n: int, seed: int):
    """Distinct SEARCH/COUNT queries over every path of the slice."""
    import numpy as np
    rng = np.random.default_rng(seed)
    dense_row = ctx.index.device.dense_row

    def kind(word: str):
        """None (a gram is unknown), "dense" (every gram is a bitmap row),
        "probed" (a sparse driver with more grams to probe) or "single"."""
        grams = query_grams(ctx, word)
        tids = [ctx.index.term_dict.get(g) for g in grams]
        if not grams or any(t is None for t in tids):
            return None
        if all(dense_row[t] >= 0 for t in tids):
            return "dense"
        return "probed" if len(grams) > 1 else "single"

    vocab = [w for w in gen.vocab[:60_000]
             if len(w) >= 2 and w not in KEYWORDS]
    dense_w, sparse_w = [], []
    for w in vocab[:3000]:
        if kind(w) == "dense":
            dense_w.append(w)
    for w in vocab[500:]:
        if kind(w) == "probed":
            sparse_w.append(w)
    ja = [t for t in (gen.sample_ja_terms(3000, term_len=2, rng=rng)
                      + gen.sample_ja_terms(300, term_len=1, rng=rng))
          if kind(t) is not None]
    # a small corpus makes every ASCII bigram dense: CJK terms drive then
    sparse_w = sparse_w or [t for t in ja if kind(t) != "dense"]
    check(len(dense_w) >= 50 and len(sparse_w) >= 50 and len(ja) >= 50,
          f"query pools too small: dense={len(dense_w)} "
          f"sparse={len(sparse_w)} ja={len(ja)}")

    def pick(pool):
        return pool[int(rng.integers(len(pool)))]

    def search(terms, desc=True, **kw):
        return dict(cmd="SEARCH", terms=terms, desc=desc, **kw)

    makers = [
        (0.22, lambda: search([pick(dense_w)], bool(rng.integers(2)))),
        (0.08, lambda: search([pick(dense_w), pick(dense_w)], True)),
        (0.20, lambda: search([pick(sparse_w)], bool(rng.integers(2)))),
        (0.16, lambda: search([pick(ja)], bool(rng.integers(2)))),
        (0.08, lambda: search([pick(dense_w)], True,
                              **{"not": [pick(dense_w)]})),
        (0.04, lambda: search([pick(sparse_w)], True,
                              **{"not": [pick(dense_w)]})),
        (0.08, lambda: search([pick(dense_w + sparse_w + ja)],
                              bool(rng.integers(2)), filter=True)),
        (0.10, lambda: dict(cmd="COUNT",
                            terms=[pick(dense_w + sparse_w + ja)],
                            filter=bool(rng.integers(2)))),
        (0.04, lambda: search([pick(sparse_w), pick(sparse_w)], True)),
    ]
    weights = np.asarray([w for w, _ in makers])
    out, seen = [], set()
    while len(out) < n:
        q = makers[int(rng.choice(len(makers), p=weights / weights.sum()))
                   ][1]()
        q["line"] = render(q)
        if q["line"] not in seen:
            seen.add(q["line"])
            out.append(q)
    for i in range(max(n // 50, 10)):  # grams that do not exist at all
        q = search([f"qzx{i}vj"], True)
        q["line"] = render(q)
        out.append(q)
    return out


def render(q: dict) -> str:
    parts = [q["cmd"], "articles", q["terms"][0]]
    for t in q["terms"][1:]:
        parts += ["AND", t]
    for t in q.get("not", ()):
        parts += ["NOT", t]
    if q.get("filter"):
        parts += ["FILTER", "status", "=", "1"]
    if q["cmd"] == "SEARCH":
        parts += ["SORT", "id", "DESC" if q["desc"] else "ASC",
                  "LIMIT", "100"]
    return " ".join(parts)


async def drive(port: int, queries, conns: int):
    """Send every query over `conns` connections; -> [(query, response,
    seconds)]."""
    todo = list(queries)
    results = []

    async def worker():
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        try:
            while todo:
                q = todo.pop()
                t0 = time.perf_counter()
                writer.write(q["line"].encode() + b"\r\n")
                await writer.drain()
                resp = await asyncio.wait_for(reader.readline(), 120)
                results.append((q, resp.decode().rstrip("\r\n"),
                                time.perf_counter() - t0))
        finally:
            writer.close()

    await asyncio.gather(*[worker() for _ in range(conns)])
    return results


def serve_phase(docs: int, seed: int, n_queries: int = 2400,
                conns: int = 64, profile_path: str = ""):
    import numpy as np
    from mygramdb_tpu_torch.app.application import Application
    from mygramdb_tpu_torch.config import load_config
    from mygramdb_tpu_torch.ops import runtime
    from mygramdb_tpu_torch.server.tcp_server import TcpServer

    t0 = time.time()
    gen, seed_path, cfg_path, status = write_inputs(docs, seed)
    t_corpus = time.time() - t0
    config = load_config(cfg_path)
    app = Application(config, seed_path=seed_path)
    t0 = time.time()
    app.initialize()
    t_init = time.time() - t0
    ctx = app.catalog.resolve("articles")
    check(ctx.doc_count == docs, f"loaded {ctx.doc_count} of {docs} docs")
    dev = ctx.index.device
    check(dev._device.type == runtime.device().type,
          f"index on {dev._device}")
    dev.warmup()  # must not raise
    emit({"phase": "load", "docs": ctx.doc_count, "corpus_s": t_corpus,
          "initialize_s": t_init, "n_words": dev.n_words,
          "dense_terms": dev.n_dense, "terms": int(dev.lengths.size),
          "device_postings": int(dev.postings.numel()),
          "device_bytes": dev.memory_usage()})

    queries = make_queries(gen, ctx, n_queries, seed)
    ref = Reference(ctx, status)
    loop = asyncio.new_event_loop()
    server_thread = threading.Thread(target=loop.run_forever, daemon=True)
    server_thread.start()
    srv = TcpServer(app.core, config)
    asyncio.run_coroutine_threadsafe(srv.start(), loop).result(60)
    try:
        batcher = dev.batcher
        b0 = (batcher.batches_executed, batcher.queries_batched)
        runtime.reset_launches()
        t0 = time.perf_counter()
        results = asyncio.run(drive(srv.port, queries, conns))
        wall = time.perf_counter() - t0
        # remove rows that answers contained; ask the queries whose
        # match sets held them again
        hit = sorted({int(p) for _, r, _ in results
                      if r.startswith("OK RESULTS") for p in r.split()[3:]})
        rng = np.random.default_rng(seed + 1)
        removed = set(int(x) for x in rng.choice(
            hit, size=min(100, len(hit)), replace=False))
        again = [q for q, _, _ in results
                 if removed.intersection(ref.ids(q).tolist())]
        for pk in removed:
            check(ctx.remove_row(str(pk)) is not None, f"remove {pk}")
        results2 = asyncio.run(drive(srv.port, again, conns))
        launches = dict(runtime.launches)
        forms = dict(runtime.launch_forms)
        routes = dict(runtime.routes)
        b1 = (batcher.batches_executed, batcher.queries_batched)
        bad = []
        for answered, gone in ((results, set()), (results2, removed)):
            ref.removed = gone
            for q, resp, _ in answered:
                want = ref.line(q)
                if resp != want:
                    bad.append((q["line"], resp[:200], want[:200]))
        errors = sum(1 for _, r, _ in results + results2
                     if not r.startswith("OK"))
        lat = sorted(s for _, _, s in results)
        avg_batch = (b1[1] - b0[1]) / max(b1[0] - b0[0], 1)
        classes = {}
        for q in queries:
            k = query_class(ctx, q)
            classes[k] = classes.get(k, 0) + 1
        summary = {
            "phase": "serve", "docs": docs, "queries": len(results),
            "requeried_after_remove": len(results2), "removed": len(removed),
            "mismatches": len(bad), "errors": errors, "connections": conns,
            "qps": len(results) / wall, "p50_ms": 1e3 * lat[len(lat) // 2],
            "p99_ms": 1e3 * lat[int(len(lat) * 0.99)],
            "batches": b1[0] - b0[0], "avg_batch": avg_batch,
            "launches": launches, "launch_forms": forms, "routes": routes,
            "query_classes": classes}
        emit(summary)
        check(not bad, f"{len(bad)} answers differ from the reference, "
                       f"first: {bad[:5]}")
        check(len(results) >= min(2000, n_queries),
              "too few queries answered")
        check(all(v > 0 for v in launches.values()),
              f"a kernel was not launched by the serving path: {launches}")
        # FILTER queries ride K1 as filter rows; SEARCH and COUNT take the
        # batched dense, unbatched dense (COUNT) and batched sparse routes
        check(forms["dense_and.extra_rows"] > 0,
              f"no K1 launch carried filter rows: {forms}")
        for r in ("dense_batched", "dense_unbatched", "sparse_batched"):
            check(routes[r] > 0, f"no query took the {r} route: {routes}")
        check(avg_batch > 1, f"micro-batcher average batch {avg_batch} <= 1")
        if profile_path:
            profile_phase(srv.port, ctx, queries, profile_path)
    finally:
        asyncio.run_coroutine_threadsafe(srv.stop(), loop).result(60)
        loop.call_soon_threadsafe(loop.stop)
        server_thread.join(30)
    return launches, summary


def query_class(ctx, q: dict) -> str:
    """The query's command and clauses, and the kind of each of its terms:
    "dense" (every gram a bitmap row), "sparse" (a sparse driver with more
    grams to probe), "covered" (one sparse gram: probe-free) or "nogram"."""
    dense_row = ctx.index.device.dense_row
    kinds = set()
    for t in q["terms"]:
        tids = [ctx.index.term_dict.get(g) for g in query_grams(ctx, t)]
        if not tids or None in tids:
            kinds.add("nogram")
        elif all(dense_row[x] >= 0 for x in tids):
            kinds.add("dense")
        else:
            kinds.add("covered" if len(tids) == 1 else "sparse")
    return (q["cmd"] + (" NOT" if q.get("not") else "")
            + (" FILTER" if q.get("filter") else "")
            + (" AND" if len(q["terms"]) > 1 else "")
            + " [" + ",".join(sorted(kinds)) + "]")


def profile_phase(port: int, ctx, queries, path: str,
                  per_class: int = 400) -> None:
    """Each query class with at least 30 queries alone (per_class of them
    at 64 connections, 60 at one), then torch.profiler over 1,500 mixed
    queries at 64 connections. Prints and writes one JSON line per row."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    batcher = ctx.index.device.batcher
    out = open(path, "w")

    def put(obj, show=True):
        out.write(json.dumps(obj) + "\n")
        if show:
            emit(obj)

    groups = {}
    for q in queries:
        groups.setdefault(query_class(ctx, q), []).append(q)
    for name, qs in sorted(groups.items(), key=lambda kv: -len(kv[1])):
        if len(qs) < 30:
            continue
        for conns, n in ((1, 60), (64, per_class)):
            b0 = (batcher.batches_executed, batcher.queries_batched)
            t0 = time.perf_counter()
            res = asyncio.run(drive(port, qs[:n], conns))
            wall = time.perf_counter() - t0
            lat = sorted(s for _, _, s in res)
            nb = batcher.batches_executed - b0[0]
            put({"phase": "profile", "class": name, "connections": conns,
                 "queries": len(res), "qps": len(res) / wall,
                 "p50_ms": 1e3 * lat[len(lat) // 2],
                 "p99_ms": 1e3 * lat[int(len(lat) * 0.99)],
                 "avg_batch": ((batcher.queries_batched - b0[1]) / nb
                               if nb else None),
                 "all_ok": all(r.startswith("OK") for _, r, _ in res)})
    mix = queries[:1500]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = asyncio.run(drive(port, mix, 64))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()

    def dev_us(e):
        return (getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0) or 0)

    busy = sum(dev_us(e) for e in events) / 1e6
    def calls(match):
        return sum(e.count for e in events if match(e.key))

    put({"phase": "profile", "class": "mix", "connections": 64,
         "queries": len(res), "window_s": wall, "qps": len(res) / wall,
         "device_busy_s": busy, "device_busy_share": busy / wall,
         "kernel_launches": calls(lambda k: k == "cudaLaunchKernel"),
         "copies": calls(lambda k: k == "cudaMemcpyAsync"),
         "syncs": calls(lambda k: k == "cudaStreamSynchronize")})
    for e in sorted(events, key=lambda e: -dev_us(e))[:25]:
        put({"device_op": e.key[:80], "calls": e.count,
             "device_ms": dev_us(e) / 1e3}, show=False)
    for e in sorted(events, key=lambda e: -e.self_cpu_time_total)[:25]:
        put({"host_op": e.key[:80], "calls": e.count,
             "cpu_ms": e.self_cpu_time_total / 1e3}, show=False)
    out.close()


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--docs", type=int, default=1_100_000)
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--profile", default="", metavar="PATH",
                    help="after the serve phase, profile each query class "
                         "and write the rows to PATH")
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is not importable: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from mygramdb_tpu_torch.ops import runtime
    except ImportError as e:
        print(f"chip_smoke: the port is not importable: {e}",
              file=sys.stderr)
        return 1
    os.environ["MYGRAM_TORCH_DEVICE"] = "cuda"
    os.environ.setdefault("MYGRAM_ALLOW_ROOT", "1")
    try:
        card = card_line()
        emit({"phase": "device", "card": card,
              "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count(), "torch": torch.__version__,
              "cuda": torch.version.cuda})
        t0 = time.time()
        runtime.kernels()
        emit({"phase": "build", "seconds": time.time() - t0,
              "ptxas": [ln.strip() for ln in runtime.build_log.splitlines()
                        if "registers" in ln or "Compiling entry" in ln]})
        gen = torch.Generator().manual_seed(args.seed)
        timings = kernel_phase(gen)
        launches, _ = serve_phase(args.docs, args.seed,
                                  profile_path=args.profile)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    print(card)
    emit({"kernels": [
        {"name": "dense_and", "route": "cuda", "source": K1_SOURCE,
         "replaces": K1_REPLACES, "launches": launches["dense_and"],
         "max_abs_err": timings["dense_and"]["max_abs_err"],
         "ms": timings["dense_and"]["ms"],
         "plain_ms": timings["dense_and"]["plain_ms"]},
        {"name": "slice_gather", "route": "cuda", "source": K3_SOURCE,
         "replaces": K3_REPLACES, "launches": launches["slice_gather"],
         "max_abs_err": timings["slice_gather"]["max_abs_err"],
         "ms": timings["slice_gather"]["ms"],
         "plain_ms": timings["slice_gather"]["plain_ms"]}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
