#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``mygramdb_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--docs N] [--seed S] [--profile PATH]
    python3 chip_smoke.py --kernel-timing

Phases, each printing one JSON line with its seconds:

1. device: the card (``nvidia-smi`` name and power limit), torch and CUDA.
2. build: the CUDA kernels built from ``mygramdb_tpu_torch/csrc`` (one
   nvcc per source, in parallel).
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the serving path gives it, exact equality (integer work),
   both timed with CUDA events, beside the least time the card could take
   (bytes over 3.35 TB/s or 32-bit operations over 67 T/s, whichever is
   larger). K1 row-AND with the top-n fused in (count only, the batcher's
   descending page, the fused program's ascending candidates, and the
   result words), then the dense program as the micro-batcher runs it at
   B=1 K=3 n=128 and B=64 K=8 n=1,024, and the words at B=64 K=8, each
   with its device time and its kernel count from torch.profiler; K2 row
   reduce (AND and OR), K3 slice gather; K4
   flat-pack, K5 live-prefix and K6 padded-matrix window TF, on u16 and
   u32 packs, both count modes, with and without the range mask, cap 4
   and 32, 2 and 4 needles; K6 over a matrix of the verified serve's row
   width at the fused program's shape and at the text store's own (whole
   rows of a 65,536-candidate chunk), each timed shape with its share of
   the bound; P1 row gather over a matrix of the verified serve's size,
   timed in ten alternating pairs with ``torch.index_select``, device
   times beside them. Then the probe
   ``mygramdb_tpu_torch.tools.profile_gather`` (P1's own path).
4. verified serve: the server's own entry points (``Application`` with a
   seed file, ``TcpServer``) at --docs documents of the synthetic EN+JA
   corpus with ``memory.verify_text: all`` and the auto text layout (the
   padded matrix, K6): SEARCH over CJK substrings and EN words, two-term
   AND, NOT (the exact path and the text store's verify), FILTER, COUNT
   and ``SORT _score DESC`` with one and two terms, every answer held
   against an independent reference (gram-AND candidates from the host
   CSR, then Python substring checks over the stored texts; BM25
   recomputed in numpy with ``str.count``); then boolean trees, terms
   with synonyms and ``FUZZY 1|2`` (K2 through ``ast_words``, the two
   threshold programs), held against set algebra over the host CSR,
   Python substring checks per tree or synonym group, and a numpy
   ``bincount`` with a Python edit distance; a direct ``search_or`` check
   (K2's OR form); then rows are removed and the affected queries asked
   again. The serve runs with ``device.positional_verify: true``: before
   its queries the positional engine's bytes, its refusals by bucket and
   its program alone (device ms and kernels a batch at B = 1-64, the
   occurrence bytes bound); after the SEARCH/COUNT mix, and again after
   the removals, 240 covered single terms in six forms (pages both ways,
   count, BM25, gram-AND probes, the status filter row) from 64 threads
   through ``search_verified_positional`` (the micro-batcher's
   positional program, K3 gathers), each answer held against substring
   containment over the stored texts and BM25 over every start
   position.
5. flat verified serve: the same at FLAT_DOCS documents with
   ``MYGRAM_TEXT_LAYOUT=flat`` (K4 and K5).
6. plain serve: PR 1's unverified SEARCH/COUNT serve at PLAIN_DOCS
   documents (K1, K3), answers held against the numpy reference.
7. profile (only with --profile): after the verified and the plain
   serve, on the same server, each query class alone at 1 and 64
   connections, then ``torch.profiler`` over mixed queries (all lines
   also appended to PATH, tagged with the serve).

With --kernel-timing the script only builds the kernels and times K1's
dense program and P1, through entry points that every tree of the port
has: a copy of it placed in an older tree's checkout times that tree, so
two trees are compared in one call (parent, change, change, parent).

Each serve phase sets the kernels' launch counters and the route counters
to 0 just before its queries and reads them just after. The last lines
are the card, the kernel summary and ``{"ok": true, "device": ...}``. Any
failure exits non-zero before them. Without a CUDA device, or without the
repository beside it, the script exits non-zero.
"""

import sys

sys.modules["jax"] = None  # any path that still reaches JAX fails here
sys.modules["mygramdb_tpu"] = None  # and so does the JAX package

import argparse  # noqa: E402
import asyncio  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import shutil  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import threading  # noqa: E402
import time  # noqa: E402
from functools import reduce  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "dense_and": ("mygramdb_tpu_torch/csrc/dense_and.cu",
                  "mygramdb_tpu/ops/bitmap_ops.py:184"),
    "reduce_rows": ("mygramdb_tpu_torch/csrc/dense_and.cu",
                    "mygramdb_tpu/ops/bitmap_ops.py:308"),
    "ast_words": ("mygramdb_tpu_torch/csrc/dense_and.cu",
                  "mygramdb_tpu/ops/bitmap_ops.py:308"),
    "slice_gather": ("mygramdb_tpu_torch/csrc/slice_gather.cu",
                     "mygramdb_tpu/ops/posting_ops.py:69"),
    "sparse_probe": ("mygramdb_tpu_torch/csrc/slice_gather.cu",
                     "mygramdb_tpu/ops/posting_ops.py:69"),
    "tf_rows_flat": ("mygramdb_tpu_torch/csrc/verify_tf.cu",
                     "mygramdb_tpu/ops/verify_ops.py:669"),
    "tf_rows_flat_global": ("mygramdb_tpu_torch/csrc/verify_tf.cu",
                            "mygramdb_tpu/ops/verify_ops.py:875"),
    "tf_rows_padded": ("mygramdb_tpu_torch/csrc/verify_tf.cu",
                       "mygramdb_tpu/ops/verify_ops.py:489"),
    "row_gather": ("mygramdb_tpu_torch/csrc/row_gather.cu",
                   "e2e/profile_gather.py:104"),
}
# the probe's matrix (e2e/profile_gather.py:94-98): the verified serve's
# own within a few rows
P1_ROWS, P1_ROW_CELLS, P1_GATHERED = 1_130_496, 1024, 131_072
FUZZY_CAP = 131_072    # the all-sparse threshold program returns no more
# FUZZY queries of the verified serve, EN words and rare-kanji terms (a
# host edit distance each: seconds a query under load)
FUZZY_EN, FUZZY_KANJI = 20, 15
FLAT_DOCS = 100_000    # documents of the flat-layout verified serve
SHARDED_QUERIES = 1500  # SEARCH/COUNT queries of the sharded serve
PLAIN_DOCS = 300_000   # documents of the unverified serve
# maxT of the verified serve's corpus (its p99 document passes 512 code
# points): the padded matrix's rows are TEXT_MAXT + NEEDLE_CAP cells
TEXT_MAXT = 1024
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
INT32_OPS_PER_S = 67e12     # H100 SXM 32-bit rate outside the tensor cores
KEYWORDS = {"and", "or", "not", "filter", "sort", "limit", "offset",
            "highlight", "fuzzy", "asc", "desc", "tag", "snippet_len",
            "max_fragments"}
K1_BM25, B_BM25 = 1.2, 0.75  # the config's bm25 defaults


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


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the 32-bit rate."""
    tb, to = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return {"bound_ms": 1e3 * max(tb, to),
            "bound_by": "bytes" if tb >= to else "operations"}


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


def dev_us(e) -> float:
    """Device microseconds of a profiler event (the attribute's name
    differs across torch versions)."""
    return (getattr(e, "self_device_time_total", None)
            or getattr(e, "self_cuda_time_total", 0) or 0)


def device_ms(fn, kernel: str, reps: int = 20):
    """Mean device milliseconds of the CUDA kernel whose name holds
    ``kernel``, over reps back-to-back calls of fn under torch.profiler:
    the kernel alone, without the wrapper's host path that ``cuda_ms``
    also times. The mean is over the launches the profiler recorded (it
    may drop some); None when it recorded none."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if kernel in e.key]
    seen = sum(e.count for e in hits)
    return sum(dev_us(e) for e in hits) / seen / 1e3 if seen else None


def device_profile(fn, reps: int = 20) -> dict:
    """The device work of one fn() call under torch.profiler, over reps
    back-to-back calls: "device_ms", the summed device time of its kernels;
    "kernels", kernels launched a call (copies and memsets not counted);
    "by_kernel", device ms a call by kernel name. device_ms is None when
    the profiler recorded no device time (then only the event-timed ms
    stands)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if dev_us(e) > 0
          and not e.key.startswith(("Memcpy", "Memset"))]
    return {"device_ms": (sum(dev_us(e) for e in ev) / reps / 1e3
                          if ev else None),
            "kernels": sum(e.count for e in ev) / reps,
            "by_kernel": {e.key[:60]: dev_us(e) / reps / 1e3 for e in ev}}


def kernel_phase(gen):
    """K1 and K3 -> {kernel name: {"max_abs_err", "ms", "plain_ms",
    "bound_ms", "bound_by", "shape"}}; raises on a mismatch. ms/plain_ms
    are at the serving path's batched shape."""
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
                        # the top-n forms: count only, the batcher's
                        # descending page, the fused candidates ascending
                        for n, desc in ((0, False), (128, True),
                                        (4096, False)):
                            o, _ = bitmap_ops.dense_and_topn(*args, n, desc)
                            op, _ = bitmap_ops._dense_and_topn_plain(
                                *args, n, desc)
                            torch.cuda.synchronize()
                            check(torch.equal(o, op),
                                  f"K1 top-n disagrees: W={W} B={B} K={K} "
                                  f"not={has_not} extra={has_extra} n={n} "
                                  f"desc={desc}")
                            err = max(err, int((o.long() - op.long())
                                               .abs().max()))
                        rows_out.append((W, B, K, has_not, has_extra,
                                         int(c.sum())))
    out["dense_and"] = {"max_abs_err": err}
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
    read = int(lens64.clamp(max=2048).sum())
    out["slice_gather"] = {"max_abs_err": err, "ms": ms,
                           "plain_ms": plain_ms,
                           "shape": "K=64 bucket=2048",
                           **bound(4 * read + 4 * 64 * 2048 + 16 * 64, 0)}
    emit({"phase": "kernels", "kernel": "slice_gather", "buckets":
          [2048, 65536]})
    return out


def dense_topn_phase(gen) -> dict:
    """K1 as the serving path calls it, at W = 34,816 (1.1M documents)
    over 96 random dense rows: the micro-batcher's dense program (host row
    ids to the card, ``dense_search_topn_packed``, numpy back) at B=1 K=3
    n=128 and B=64 K=8 n=1,024 descending, and the result words
    (``dense_and``) at B=64 K=8. For each: exact against the plain version
    (``_dense_query_plain`` then ``topn_words``), "ms" the device program
    event-timed (the wrapper's host path included), "device_ms" and
    "kernels" a call from torch.profiler, "call_ms" and "call_kernels" the
    whole packed call with its copies and its pull, and the bound: each
    distinct row and the tombstones read once, the answer written once.
    Only entry points that every tree of the port has are called, so the
    same function times an older tree's dense program.
    -> {shape name: numbers}."""
    import numpy as np
    import torch
    from mygramdb_tpu_torch.ops import bitmap_ops, runtime
    dev = torch.device("cuda")
    V, W = 96, 34816
    bm = words_on_card(gen, V, W)
    deleted = torch.zeros(W, dtype=torch.int32)
    deleted[torch.randint(0, W, (W // 50,), generator=gen)] = -1
    deleted = deleted.to(dev)
    ones = bm[V][None]  # DeviceIndex._pack_extra([]): the AND identity
    out = {}
    for B, K, n in ((1, 3, 128), (64, 8, 1024)):
        rows = torch.randint(0, V, (B, K), dtype=torch.int32,
                             generator=gen).numpy()
        nrows = np.full((B, 1), V + 1, dtype=np.int32)
        rows_t, nrows_t = (runtime.to_device(rows, dev),
                           runtime.to_device(nrows, dev))

        def call():  # MicroBatcher._execute_dense
            return bitmap_ops.dense_search_topn_packed(
                bm, runtime.to_device(rows, dev),
                runtime.to_device(nrows, dev), deleted, ones, False, False,
                n, True)

        def program():
            return bitmap_ops._dense_search_topn(
                bm, rows_t, nrows_t, deleted, ones, False, False, n, True)

        cnt, ids = call()
        c_p, res_p = bitmap_ops._dense_query_plain(bm, rows_t, None, None,
                                                   deleted)
        ids_p = bitmap_ops.topn_words(res_p, n, True)
        check(np.array_equal(cnt, c_p.cpu().numpy())
              and np.array_equal(ids, ids_p.cpu().numpy()),
              f"K1 top-n disagrees at B={B} K={K} n={n}")
        check(int(cnt.min()) > n, f"K1 top-n: a count below n={n}")
        distinct = len(np.unique(rows))
        prof = device_profile(program)
        whole = device_profile(call)
        out[f"topn B={B}"] = {
            "ms": cuda_ms(program), "call_ms": cuda_ms(call),
            "plain_ms": cuda_ms(lambda: bitmap_ops.topn_words(
                bitmap_ops._dense_query_plain(bm, rows_t, None, None,
                                              deleted)[1], n, True), reps=5),
            "device_ms": prof["device_ms"], "kernels": prof["kernels"],
            "by_kernel": prof["by_kernel"],
            "call_kernels": whole["kernels"],
            "shape": f"B={B} K={K} W={W} n={n} descending",
            **bound(4 * ((distinct + 1) * W + B * K + B * (n + 1)),
                    B * (K + 1) * W)}
    B, K = 64, 8
    rows_t = torch.randint(0, V, (B, K), dtype=torch.int32,
                           generator=gen).to(dev)
    c, r = bitmap_ops.dense_and(bm, rows_t, None, None, deleted)
    cp, rp = bitmap_ops._dense_query_plain(bm, rows_t, None, None, deleted)
    torch.cuda.synchronize()
    check(torch.equal(c, cp) and torch.equal(r, rp), "K1 words disagree")
    distinct = int(torch.unique(rows_t).numel())
    prof = device_profile(lambda: bitmap_ops.dense_and(bm, rows_t, None,
                                                       None, deleted))
    out["words B=64"] = {
        "ms": cuda_ms(lambda: bitmap_ops.dense_and(bm, rows_t, None, None,
                                                   deleted)),
        "plain_ms": cuda_ms(lambda: bitmap_ops._dense_query_plain(
            bm, rows_t, None, None, deleted), reps=5),
        "device_ms": prof["device_ms"], "kernels": prof["kernels"],
        "by_kernel": prof["by_kernel"],
        "shape": f"B={B} K={K} W={W} words",
        **bound(4 * ((distinct + 1) * W + B * K + B * W + B),
                B * (K + 1) * W)}
    for v in out.values():
        v["share_of_bound"] = v["bound_ms"] / v["ms"]
        v["device_share_of_bound"] = v["bound_ms"] / v["device_ms"]
    emit({"phase": "kernels", "kernel": "dense_and (K1)", "timed": out})
    return out


def words_on_card(gen, V: int, W: int):
    """(V + 2, W) random int32 words on the card, row V all-ones and row
    V + 1 all-zeros."""
    import torch
    bm = torch.randint(-2 ** 31, 2 ** 31 - 1, (V + 2, W), dtype=torch.int32,
                       generator=gen).cuda()
    bm[V] = -1
    bm[V + 1] = 0
    return bm


def reduce_rows_numbers(gen, op: str, B: int, K: int, W: int) -> dict:
    """K2 at one shape over random rows: exact against its plain
    version, both timed. The bound reads each distinct row once and
    writes (B, W)."""
    import torch
    from mygramdb_tpu_torch.ops import bitmap_ops
    V = 96
    bm = words_on_card(gen, V, W)
    rows = torch.randint(0, V, (B, K), dtype=torch.int32,
                         generator=gen).cuda()
    got = bitmap_ops.reduce_rows(bm, rows, op)
    want = bitmap_ops._reduce_rows_plain(bm, rows, op)
    torch.cuda.synchronize()
    check(torch.equal(got, want), f"K2 disagrees: op={op} B={B} K={K} W={W}")
    distinct = int(torch.unique(rows).numel())
    return {"max_abs_err": int((got.long() - want.long()).abs().max()),
            "ms": cuda_ms(lambda: bitmap_ops.reduce_rows(bm, rows, op)),
            "plain_ms": cuda_ms(
                lambda: bitmap_ops._reduce_rows_plain(bm, rows, op)),
            "shape": f"op={op} B={B} K={K} W={W}",
            **bound(4 * (distinct * W + B * K + B * W), B * K * W)}


def reduce_rows_phase(gen) -> dict:
    """K2, both operations, against its plain version over the widths of
    1.1M and 10M documents, rows padded with the operation's identity
    row; then timed at K1's shape. -> {op: numbers}."""
    import torch
    from mygramdb_tpu_torch.ops import bitmap_ops
    V, checks = 96, 0
    for W in (34816, 313344):
        bm = words_on_card(gen, V, W)
        for B in (1, 8, 64):
            for K in (1, 8, 32):
                for op in ("and", "or"):
                    # low-index rows repeat, so some ANDs keep bits set
                    rows = torch.randint(0, 4, (B, K), dtype=torch.int32,
                                         generator=gen)
                    rows[:, K // 2 + 1:] = V if op == "and" else V + 1
                    rows = rows.cuda()
                    got = bitmap_ops.reduce_rows(bm, rows, op)
                    want = bitmap_ops._reduce_rows_plain(bm, rows, op)
                    torch.cuda.synchronize()
                    check(torch.equal(got, want),
                          f"K2 disagrees: op={op} W={W} B={B} K={K}")
                    check(bool(got.any()) and not bool((got == -1).all()),
                          f"K2 degenerate result: op={op} W={W} B={B} K={K}")
                    checks += 1
        del bm
    out = {op: reduce_rows_numbers(gen, op, 64, 8, 34816)
           for op in ("and", "or")}
    emit({"phase": "kernels", "kernel": "reduce_rows (K2)", "checks": checks,
          "timed": out})
    return out


# ---------------------------------------------------------------------------
# K3's probe entry and K2's tree entry: the sparse and the boolean program
# ---------------------------------------------------------------------------

PROBE_V = 96  # dense rows of the synthetic matrices; V all-ones, V+1 zeros


def probe_inputs(rng, B: int, C: int, Ks: int, Kd: int, W: int) -> dict:
    """Host inputs of the sparse program over W words of documents: a CSR
    of sorted posting lists (drivers of up to C entries, one of C + 7, a
    driver at offset P and one running past it; probe lists holding most
    of their driver's ids, every third a NOT term holding few; query 0
    fills all Ks slots, an inverted empty slot pads the rest, query 6 has
    an empty term), dense rows with a NOT row among them padded with the
    all-ones row, two filter rows and tombstones among the postings.
    -> numpy arrays: postings, bitmaps (uint32), deleted, extra, args (the
    ``pack_sparse_args`` layout) and Cmax (a power of two)."""
    import numpy as np
    n_docs = W * 32
    lists, q_probes = [], []
    for b in range(B):
        dl = min(C + 7 if b % 5 == 2 else
                 (C if b % 5 == 1 else int(rng.integers(1, C + 1))),
                 n_docs // 2)
        drv = np.sort(rng.choice(n_docs, size=dl, replace=False))
        lists.append(drv)
        probes = []
        for k in range(Ks if b == 0 else int(rng.integers(0, min(Ks, 6) + 1))):
            inv = k % 3 == 2
            keep = drv[rng.random(dl) < (0.1 if inv else 0.9)]
            other = rng.choice(n_docs, replace=False, size=int(
                rng.integers(0, min(3 * C, 8192))))
            probes.append((len(lists), inv))
            lists.append(np.union1d(keep, other))
        q_probes.append(probes)
    lens = np.asarray([x.size for x in lists], dtype=np.int64)
    offs = np.zeros(len(lists), dtype=np.int64)
    np.cumsum(lens[:-1], out=offs[1:])
    post = np.concatenate(lists).astype(np.int32)
    P = post.size
    Q = 2 + 3 * Ks + 2 * Kd
    args = np.zeros((B, Q), dtype=np.int64)
    s = 2 + 3 * Ks
    drivers = np.cumsum([0] + [1 + len(p) for p in q_probes[:-1]])
    args[:, 0], args[:, 1] = offs[drivers], lens[drivers]
    if B > 3:
        args[3, :2] = (P, 40)           # a dense term's entry
    if B > 4:
        args[4, :2] = (P - 5, 60)       # a driver running past P
    args[:, 2 + 2 * Ks:s] = 1           # inverted empty padding
    for b, probes in enumerate(q_probes):
        for k, (li, inv) in enumerate(probes):
            args[b, 2 + k], args[b, 2 + Ks + k] = offs[li], lens[li]
            args[b, 2 + 2 * Ks + k] = inv
    if B > 6:
        args[6, s - 1] = 0              # an empty term: matches nothing
    args[:, s:s + Kd] = PROBE_V
    for b in range(B):
        for k in range(int(rng.integers(0, min(Kd, 4) + 1))):
            args[b, s + k] = rng.integers(0, PROBE_V)
            args[b, s + Kd + k] = k == 2
    def bits(rows):  # 7/8 of the bits set
        w = rng.integers(0, 2 ** 32, (rows, W), dtype=np.uint32)
        for _ in range(2):
            w |= rng.integers(0, 2 ** 32, (rows, W), dtype=np.uint32)
        return w
    bm = np.concatenate([bits(PROBE_V),
                         np.full((1, W), 0xFFFFFFFF, np.uint32),
                         np.zeros((1, W), np.uint32)])
    deleted = np.zeros(W, dtype=np.uint32)
    gone = rng.choice(post, size=max(P // 40, 1))
    np.bitwise_or.at(deleted, gone >> 5,
                     np.left_shift(np.uint32(1), (gone & 31).astype(np.uint32)))
    Cmax = 1
    while Cmax < max(int(args[:, 2 + Ks:2 + 2 * Ks].max(initial=1)), 1):
        Cmax <<= 1
    return {"postings": post, "bitmaps": bm, "deleted": deleted,
            "extra": bits(2), "args": args, "Cmax": Cmax}


def on_card(h: dict) -> dict:
    """probe_inputs' arrays as contiguous tensors on the card (uint32
    words as their int32 bits)."""
    import numpy as np
    import torch
    out = {}
    for k, v in h.items():
        if isinstance(v, np.ndarray):
            v = v.view(np.int32) if v.dtype == np.uint32 else v
            out[k] = torch.from_numpy(np.ascontiguousarray(v)).cuda()
    return out


def probe_bytes(h: dict, Ks: int, Kd: int, C: int, F: int, sparse: bool,
                dense: bool, out_ints: int) -> int:
    """Bytes the sparse program must move for these inputs: its arguments,
    each gathered driver entry, each probe slice's entries between its
    driver's first and last candidate, one word a candidate for the
    tombstones, each filter row and each dense row that is not padding,
    and its output."""
    import numpy as np
    post, args = h["postings"], h["args"]
    P = post.size
    s = 2 + 3 * Ks
    total = args.nbytes + 4 * out_ints
    for a in args:
        lo, hi = max(int(a[0]), 0), min(int(a[0]) + min(int(a[1]), C), P)
        if hi <= lo:
            continue
        nv = hi - lo
        words = 1 + F + (int((a[s:s + Kd] != PROBE_V).sum()) if dense else 0)
        total += 4 * nv * (1 + words)
        if sparse:
            first, last = int(post[lo]), int(post[hi - 1])
            for k in range(Ks):
                o, n = int(a[2 + k]), int(a[2 + Ks + k])
                e = min(o + n, P)
                if e > o:
                    sl = post[o:e]
                    total += 4 * int(np.searchsorted(sl, last, "right")
                                     - np.searchsorted(sl, first))
    return total


def probe_forms(C: int):
    """(form, width, descending) the serving path asks for at a C: the
    batcher's pages, count only, n past C, the fused program's
    compactions and the probeless candidate vector."""
    return [("topn", 128, False), ("topn", 1024, True), ("topn", 0, True),
            ("topn", 2 * C + 3, True), ("compact", min(4096, C), False),
            ("compact", C, False), ("masked", C, False)]


def sparse_probe_checks(gen) -> dict:
    """K3's probe entry exactly against its plain version at every C
    bucket of the serving path (candidate_buckets and the fused program's
    _VERIFY_CAND_BUCKETS), B = 1 and 64, Ks = Kd = 8 and 32, every output
    form, with all probes and filter rows, probe-free and the sparse
    probes alone."""
    import numpy as np
    import torch
    from mygramdb_tpu_torch.ops import posting_ops
    rng = np.random.default_rng(int(torch.randint(0, 2 ** 31 - 1, (1,),
                                                  generator=gen)))
    W, checks, err, survivors = 34816, 0, 0, 0
    for C in (512, 2048, 4096, 8192, 32768, 65536):
        for B in (1, 64):
            for Ks, Kd in ((8, 8), (32, 32)):
                h = probe_inputs(rng, B, C, Ks, Kd, W)
                t = on_card(h)
                for form, width, desc in probe_forms(C):
                    for sparse, dense, ext in ((True, True, t["extra"]),
                                               (False, False, None),
                                               (True, False, None)):
                        kw = dict(Ks=Ks, Kd=Kd, C=C, Cmax=h["Cmax"],
                                  n_words=W, form=form, width=width,
                                  descending=desc, sparse_probes=sparse,
                                  dense_probes=dense)
                        a = (t["postings"], t["bitmaps"], t["deleted"], ext,
                             t["args"])
                        got = posting_ops.sparse_probe(*a, **kw)
                        want = posting_ops._sparse_probe_plain(*a, **kw)
                        torch.cuda.synchronize()
                        check(torch.equal(got, want),
                              f"sparse probe disagrees: C={C} B={B} Ks={Ks} "
                              f"form={form} width={width} desc={desc} "
                              f"probes={sparse, dense}")
                        err = max(err, int((got.long() - want.long()).abs()
                                           .max()) if got.numel() else 0)
                        checks += 1
                        cnt = want[:B] if want.dim() == 1 else want[:, 0]
                        survivors += int(cnt.sum())
                del t
    check(survivors > 0, "sparse probe checks: no candidate survived")
    torch.cuda.empty_cache()
    return {"checks": checks, "max_abs_err": err, "survivors": survivors}


def sparse_probe_numbers(gen, form: str, B: int, C: int, Ks: int, Kd: int,
                         width: int, probes: int, W: int = 34816) -> dict:
    """K3's probe entry at one shape over synthetic inputs: exact against
    its plain version, "ms" event-timed (the wrapper's host path
    included), "device_ms" and "kernels" a call from torch.profiler, the
    plain version's time, and the bound (``probe_bytes``)."""
    import numpy as np
    import torch
    from mygramdb_tpu_torch.ops import posting_ops
    rng = np.random.default_rng(int(torch.randint(0, 2 ** 31 - 1, (1,),
                                                  generator=gen)))
    h = probe_inputs(rng, B, C, Ks, Kd, W)
    t = on_card(h)
    kw = dict(Ks=Ks, Kd=Kd, C=C, Cmax=h["Cmax"], n_words=W, form=form,
              width=width, descending=form == "topn",
              sparse_probes=bool(probes & 1), dense_probes=bool(probes & 2))
    a = (t["postings"], t["bitmaps"], t["deleted"], None, t["args"])
    got = posting_ops.sparse_probe(*a, **kw)
    want = posting_ops._sparse_probe_plain(*a, **kw)
    torch.cuda.synchronize()
    check(torch.equal(got, want), f"sparse probe disagrees at {form} B={B} "
                                  f"C={C} Ks={Ks} Kd={Kd} width={width}")
    prof = device_profile(lambda: posting_ops.sparse_probe(*a, **kw))
    out_ints = B * (width + 1)
    out = {"max_abs_err": 0, "ms": cuda_ms(
               lambda: posting_ops.sparse_probe(*a, **kw)),
           "plain_ms": cuda_ms(lambda: posting_ops._sparse_probe_plain(
               *a, **kw), reps=5),
           # a launch's mean over the launches the profiler recorded
           "device_ms": device_ms(lambda: posting_ops.sparse_probe(*a, **kw),
                                  "sparse_probe_kernel"),
           "kernels": prof["kernels"],
           "shape": f"{form} B={B} C={C} Ks={Ks} Kd={Kd} width={width} "
                    f"probes={probes} W={W}",
           **bound(probe_bytes(h, Ks, Kd, C, 0, bool(probes & 1),
                               bool(probes & 2), out_ints), 0)}
    out["device_share_of_bound"] = (out["bound_ms"] / out["device_ms"]
                                    if out["device_ms"] else None)
    return out


def tree_inputs(rng, W: int, T: int, K: int, S: int, pool: int = 30000,
                keep: float = 0.6) -> dict:
    """Host inputs of the boolean program: random rows (15/16 of their
    bits set; row V all-ones, V + 1 all-zeros), T * S posting lists that
    each keep about ``keep`` of one pool of documents (so ANDs of them hold
    documents), rows (T, K) padded with the all-ones row, leaf 4 the
    all-zeros row, padding slots, tombstones and a universe."""
    import numpy as np
    V, n_docs = PROBE_V, W * 32
    bm = rng.integers(0, 2 ** 32, size=(V + 2, W), dtype=np.uint32)
    for _ in range(3):
        bm[:V] |= rng.integers(0, 2 ** 32, size=(V, W), dtype=np.uint32)
    bm[V], bm[V + 1] = 0xFFFFFFFF, 0
    docs = rng.choice(n_docs, min(pool, n_docs), replace=False)
    lists = [np.sort(docs[rng.random(docs.size) < keep])
             for _ in range(max(T * S, 1))]
    lens_all = np.asarray([x.size for x in lists], dtype=np.int64)
    offs_all = np.zeros(len(lists), dtype=np.int64)
    np.cumsum(lens_all[:-1], out=offs_all[1:])
    rows = rng.integers(0, V, size=(T, K)).astype(np.int32)
    rows[:, K - 1] = V
    if T > 4:
        rows[4] = V + 1
    offs = offs_all[:T * S].reshape(T, S).copy()
    lens = lens_all[:T * S].reshape(T, S).copy()
    if S and T > 1:
        lens[1, -1] = 0
    deleted = np.zeros(W, dtype=np.uint32)
    deleted[rng.integers(0, W, W // 40)] = rng.integers(
        0, 2 ** 32, W // 40, dtype=np.uint32)
    return {"bitmaps": bm, "postings": np.concatenate(lists).astype(np.int32),
            "deleted": deleted,
            "universe": rng.integers(0, 2 ** 32, W, dtype=np.uint32) | deleted,
            "rows": rows, "offs": offs, "lens": lens,
            "real": rng.random((T, S)) < 0.5}


def chain_tree(depth: int, T: int) -> tuple:
    """A tree ``depth`` levels deep that cycles AND, OR and NOT, a leaf at
    every level."""
    node = ("t", 0)
    for i in range(depth - 1):
        tag = "&|!"[i % 3]
        node = ("!", node) if tag == "!" else (tag, ("t", (i + 1) % T), node)
    return node


def served_tree(T: int) -> tuple:
    """The verified serve's commonest tree shape over T leaves (an AND of
    an OR and a NOT, as make_kind_queries draws them)."""
    if T == 1:
        return ("t", 0)
    if T == 2:
        return ("&", ("t", 0), ("!", ("t", 1)))
    return ("&", ("|",) + tuple(("t", i) for i in range(T - 1)),
            ("!", ("t", T - 1)))


def tree_bytes(h: dict, sig: tuple, W: int) -> int:
    """Bytes the boolean program must move: each distinct dense row, each
    slice entry, the tombstones, the universe when a NOT needs it, the
    words out, and its arguments."""
    import numpy as np
    rows = np.unique(h["rows"])
    total = 4 * W * (rows.size + 2 + ("!" in str(sig)))
    total += 4 * int(h["lens"].sum()) + 8 * 4 * h["lens"].size
    return total + 8 * h["rows"].size


def ast_words_checks(gen) -> dict:
    """K2's tree entry exactly against its plain version at W of 1.1M
    documents: a leaf, NOT at the root, an unknown gram's leaf, no sparse
    slot, the parser's deepest tree (32 levels), a stack too deep for the
    widest span, more slices than a block caches windows for, a wide AND;
    with and without ``real``."""
    import numpy as np
    import torch
    from mygramdb_tpu_torch.ops import bitmap_ops
    rng = np.random.default_rng(int(torch.randint(0, 2 ** 31 - 1, (1,),
                                                  generator=gen)))
    W = 34816
    cases = {
        "leaf": (("t", 0), 1, 3, 2),
        "not_root": (("!", ("|", ("t", 0), ("&", ("t", 1), ("t", 2)))),
                     3, 4, 2),
        "zeros_leaf": (("&", ("|", ("t", 3), ("t", 4)), ("!", ("t", 1))),
                       5, 3, 2),
        "no_sparse": (("|", ("t", 0), ("!", ("t", 1))), 2, 8, 0),
        "max_depth": (chain_tree(32, 6), 6, 4, 3),
        "deep_stack": (chain_tree(400, 6), 6, 2, 1),
        "many_slices": (("|",) + tuple(("t", i) for i in range(40)), 40, 2,
                        30),
        "wide_and": (("&", ("t", 0), ("t", 1), ("t", 3), ("t", 0)), 4, 1, 2),
    }
    checks, nonzero = 0, 0
    for name, (sig, T, K, S) in cases.items():
        h = tree_inputs(rng, W, T, K, S, keep=0.97 if S > 10 else 0.6)
        t = on_card(h)
        bucket = int(max(h["lens"].max(initial=1), 1))
        for real in (None, h["real"]):
            args = (sig, t["bitmaps"], t["postings"], t["deleted"],
                    t["universe"], h["rows"], h["offs"], h["lens"])
            kw = dict(bucket=bucket, n_words=W, real=real)
            got = bitmap_ops.ast_words(*args, **kw)
            want = bitmap_ops._ast_words_plain(*args, **kw)
            torch.cuda.synchronize()
            check(torch.equal(got, want),
                  f"boolean program disagrees: {name} real={real is not None}")
            checks += 1
            nonzero += bool(got.any())
    check(nonzero >= checks // 2, f"boolean program checks: {nonzero} of "
                                  f"{checks} results hold documents")
    return {"checks": checks, "nonzero": nonzero, "max_abs_err": 0}


def ast_words_numbers(gen, T: int, K: int, S: int, W: int = 34816) -> dict:
    """K2's tree entry at one shape (T leaves of K dense rows and S
    slices, ``served_tree``): exact against its plain version, event and
    device ms, the plain version's ms, and the bound (``tree_bytes``)."""
    import numpy as np
    import torch
    from mygramdb_tpu_torch.ops import bitmap_ops
    rng = np.random.default_rng(int(torch.randint(0, 2 ** 31 - 1, (1,),
                                                  generator=gen)))
    h = tree_inputs(rng, W, T, K, S)
    t = on_card(h)
    sig = served_tree(T)
    args = (sig, t["bitmaps"], t["postings"], t["deleted"], t["universe"],
            h["rows"], h["offs"], h["lens"])
    kw = dict(bucket=int(max(h["lens"].max(initial=1), 1)), n_words=W)
    got = bitmap_ops.ast_words(*args, **kw)
    want = bitmap_ops._ast_words_plain(*args, **kw)
    torch.cuda.synchronize()
    check(torch.equal(got, want), f"boolean program disagrees at T={T} "
                                  f"K={K} S={S}")
    prof = device_profile(lambda: bitmap_ops.ast_words(*args, **kw))
    out = {"max_abs_err": 0,
           "ms": cuda_ms(lambda: bitmap_ops.ast_words(*args, **kw)),
           "plain_ms": cuda_ms(lambda: bitmap_ops._ast_words_plain(
               *args, **kw), reps=5),
           "device_ms": device_ms(lambda: bitmap_ops.ast_words(*args, **kw),
                                  "ast_words_kernel"),
           "kernels": prof["kernels"],
           "shape": f"T={T} K={K} S={S} W={W} tree={sig}",
           **bound(tree_bytes(h, sig, W), 0)}
    out["device_share_of_bound"] = (out["bound_ms"] / out["device_ms"]
                                    if out["device_ms"] else None)
    return out


def with_device_ms(numbers: dict, pre: dict) -> dict:
    """A timing taken after a serve, with the device time of the run
    before the serves at the same shape (other synthetic data) where there
    was one: after a serve torch.profiler records few of the launches, or
    none."""
    if numbers["shape"] in pre:
        numbers["device_ms_after_serve"] = numbers.get("device_ms")
        numbers["device_ms"] = pre[numbers["shape"]]["device_ms"]
        numbers["device_ms_from"] = "the run before the serves"
    return numbers


class _StubIndex:
    """What MicroBatcher._execute_sparse reads of a DeviceIndex."""

    def __init__(self, t: dict, W: int):
        import torch
        self.postings, self.bitmaps = t["postings"], t["bitmaps"]
        self.deleted = t["deleted"]
        self.ones_row, self.zeros_row, self.n_words = PROBE_V, PROBE_V + 1, W
        self._device = torch.device("cuda")
        self._ones = self.bitmaps[PROBE_V][None]

    def _pack_extra(self, rows):
        import torch
        return self._ones if not rows else torch.stack(list(rows))


def probe_reference(h: dict, Ks: int, Kd: int, C: int, Cmax: int, W: int):
    """Each query's surviving candidates, ascending, from numpy set
    operations over the host CSR (an independent reference)."""
    import numpy as np
    post, bm, deleted = h["postings"], h["bitmaps"], h["deleted"]
    P, s = post.size, 2 + 3 * Ks
    bit = lambda words, ids: (words[ids >> 5] >> (ids & 31).astype(
        np.uint32)) & 1
    out = []
    for a in h["args"]:
        lo, hi = max(int(a[0]), 0), min(int(a[0]) + min(int(a[1]), C), P)
        c = post[lo:max(hi, lo)].astype(np.int64)
        keep = bit(deleted, np.clip(c, 0, W * 32 - 1)) == 0
        for k in range(Ks):
            o = int(a[2 + k])
            sl = post[o:min(o + min(int(a[2 + Ks + k]), Cmax), P)]
            keep &= np.isin(c, sl) != bool(a[2 + 2 * Ks + k])
        for k in range(Kd):
            keep &= (bit(bm[int(a[s + k])], c) == 1) != bool(a[s + Kd + k])
        out.append(c[keep])
    return out


def program_numbers(gen, W: int = 34816) -> dict:
    """The sparse program, the fused sparse verify's mask and compaction,
    and the boolean program, each as the serving path runs it, through
    entry points of this tree or of an older one: the micro-batcher's
    ``_execute_sparse`` (its uploads, its device program, its pull) at
    B=64 C=2048 Ks=Kd=8 n=128 descending; the mask and compaction the
    fused sparse verify hands to its verify stage at B=64 C=8192 Kv=4,096
    (sparse probes on, dense off); ``bitmap_ops.ast_words`` (older trees:
    ``device_index._ast_words_program``) and its pull for a tree of 3
    leaves (K=4, S=2) at W = 34,816. Each: the kernels a call
    (torch.profiler, copies not counted), device ms, event ms, and answers
    checked against numpy. A copy of this script in an older tree's checkout
    times that tree. -> {program: numbers}."""
    import numpy as np
    import torch
    from mygramdb_tpu_torch.index import device_index
    from mygramdb_tpu_torch.ops import bitmap_ops, posting_ops, runtime
    from mygramdb_tpu_torch.server.microbatch import MicroBatcher, _Request
    rng = np.random.default_rng(int(torch.randint(0, 2 ** 31 - 1, (1,),
                                                  generator=gen)))
    out = {}
    fused_entry = hasattr(posting_ops, "sparse_probe")
    # the micro-batcher's sparse program
    B, C, Ks, Kd, n = 64, 2048, 8, 8, 128
    h = probe_inputs(rng, B, C, Ks, Kd, W)
    t = on_card(h)
    mb = MicroBatcher(_StubIndex(t, W))
    s = 2 + 3 * Ks
    reqs = [_Request(rows=[], sparse={
        "d_off": int(a[0]), "d_len": int(a[1]),
        "sp_off": a[2:2 + Ks].tolist(), "sp_len": a[2 + Ks:2 + 2 * Ks].tolist(),
        "sp_inv": (a[2 + 2 * Ks:s] != 0).tolist(),
        "dn_rows": a[s:s + Kd].tolist(), "dn_inv": (a[s + Kd:] != 0).tolist(),
        "extra": ()}) for a in h["args"]]
    key = ("sparse", C, h["Cmax"], Ks, Kd, n, True, False, ())

    def batch():
        mb._execute_sparse(reqs, key)

    batch()
    want = probe_reference(h, Ks, Kd, C, h["Cmax"], W)
    for r, w in zip(reqs, want):
        check(r.total == w.size and np.array_equal(
            r.ids, np.concatenate([w[::-1][:n], np.full(max(n - w.size, 0),
                                                        -1)])),
              "the sparse program's answer differs from numpy")
    prof = device_profile(batch)
    out["sparse program"] = {
        "call_ms": cuda_ms(batch), "device_ms": prof["device_ms"],
        "kernels": prof["kernels"], "by_kernel": prof["by_kernel"],
        "survivors": int(sum(w.size for w in want)),
        "shape": f"B={B} C={C} Ks={Ks} Kd={Kd} n={n} descending W={W}"}
    del t, mb
    # the fused sparse verify's mask and compaction
    B, C, Kv = 64, 8192, 4096
    h = probe_inputs(rng, B, C, Ks, Kd, W)
    t = on_card(h)
    a = t["args"]

    def selection():
        if fused_entry:
            args = runtime.to_device(h["args"], t["postings"].device)
            buf = posting_ops.sparse_probe(
                t["postings"], t["bitmaps"], t["deleted"], None, args, Ks=Ks,
                Kd=Kd, C=C, Cmax=h["Cmax"], n_words=W, form="compact",
                width=Kv, dense_probes=False)
            return posting_ops.split_selection(buf, B)
        from mygramdb_tpu_torch.ops.fused import compact_first_k
        cols = [runtime.to_device(np.ascontiguousarray(c), a.device)
                for c in (h["args"][:, 0], h["args"][:, 1],
                          h["args"][:, 2:2 + Ks], h["args"][:, 2 + Ks:2 + 2 * Ks],
                          h["args"][:, 2 + 2 * Ks:s] != 0,
                          h["args"][:, s:s + Kd].astype(np.int32),
                          h["args"][:, s + Kd:] != 0)]
        cands, mask = device_index._sparse_mask(
            t["postings"], t["bitmaps"], t["deleted"], None, *cols, C=C,
            Cmax=h["Cmax"], n_words=W, dense_probes=False)
        sel, pre = compact_first_k(cands, mask, Kv)
        return pre, sel

    pre, sel = selection()
    ref = probe_reference(h, Ks, 0, C, h["Cmax"], W)
    pre, sel = pre.cpu().numpy(), sel.cpu().numpy()
    for i, w in enumerate(ref):
        check(pre[i] == w.size and np.array_equal(
            sel[i, :min(w.size, Kv)], w[:Kv]),
              "the fused mask and compaction differ from numpy")
    prof = device_profile(selection)
    out["fused sparse selection"] = {
        "call_ms": cuda_ms(selection), "device_ms": prof["device_ms"],
        "kernels": prof["kernels"], "by_kernel": prof["by_kernel"],
        "clipped": int((pre > Kv).sum()),
        "shape": f"compact B={B} C={C} Kv={Kv} Ks={Ks} sparse probes W={W}"}
    del t
    # the boolean program
    T, K, S = 3, 4, 2
    h = tree_inputs(rng, W, T, K, S)
    t = on_card(h)
    sig = served_tree(T)
    bucket = int(h["lens"].max())

    def tree():
        if hasattr(bitmap_ops, "ast_words"):
            entry, rows, offs, lens = (bitmap_ops.ast_words, h["rows"],
                                       h["offs"], h["lens"])
        else:  # DeviceIndex.ast_words of older trees: three uploads
            dev = t["bitmaps"].device
            entry = device_index._ast_words_program
            rows, offs, lens = (runtime.to_device(h[k], dev)
                                for k in ("rows", "offs", "lens"))
        words = entry(sig, t["bitmaps"], t["postings"], t["deleted"],
                      t["universe"], rows, offs, lens, bucket=bucket,
                      n_words=W)
        return words.cpu().numpy().view(np.uint32)

    got = tree()
    leaves = []
    for i in range(T):
        w = np.bitwise_and.reduce(h["bitmaps"][h["rows"][i]], axis=0)
        for j in range(S):
            if h["lens"][i, j]:
                o = int(h["offs"][i, j])
                ids = h["postings"][o:o + int(h["lens"][i, j])]
                m = np.zeros(W, np.uint32)
                np.bitwise_or.at(m, ids >> 5, np.left_shift(
                    np.uint32(1), (ids & 31).astype(np.uint32)))
                w = w & m
        leaves.append(w)
    want = (leaves[0] | leaves[1]) & (h["universe"] & ~leaves[2])
    check(np.array_equal(got, want & ~h["deleted"]),
          "the boolean program's words differ from numpy")
    prof = device_profile(tree)
    out["boolean program"] = {
        "call_ms": cuda_ms(tree), "device_ms": prof["device_ms"],
        "kernels": prof["kernels"], "by_kernel": prof["by_kernel"],
        "docs": int(np.unpackbits(got.view(np.uint8)).sum()),
        "shape": f"T={T} K={K} S={S} W={W} tree={sig}"}
    del t
    torch.cuda.empty_cache()
    emit({"phase": "kernels", "programs": out,
          "tree": "probe entry" if fused_entry else "parent"})
    return out


def row_gather_phase(gen) -> dict:
    """P1 against its plain version and beside ``torch.index_select`` (the
    one PyTorch call for the same function) at the probe's shape: rows of
    P1_ROW_CELLS u16 cells out of a matrix of P1_ROWS, P1_GATHERED of them;
    the last rows start past 2^31 bytes. P1 and ``index_select`` are timed
    as ten alternating pairs; ms and library_ms are the medians."""
    import torch
    from mygramdb_tpu_torch.tools import profile_gather as pg
    N, rowT, R = P1_ROWS, P1_ROW_CELLS, P1_GATHERED
    g = torch.Generator(device="cuda").manual_seed(
        int(torch.randint(0, 2 ** 31 - 1, (1,), generator=gen)))
    padded = torch.randint(-2 ** 15, 2 ** 15, (N, rowT), dtype=torch.int16,
                           device="cuda", generator=g)
    ids = torch.randint(0, N, (R,), dtype=torch.int32, device="cuda",
                        generator=g)
    ids[:4] = torch.tensor([0, N - 1, N - 1, N - 2], dtype=torch.int32)
    got = pg.gather_rows(padded, ids)
    want = pg._gather_rows_plain(padded, ids)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "P1 disagrees with its plain version")
    check(torch.equal(got, torch.index_select(padded, 0, ids)),
          "P1 disagrees with index_select")
    err = int((got.long() - want.long()).abs().max())
    del got, want
    row_bytes = rowT * padded.element_size()
    distinct = int(torch.unique(ids).numel())
    pairs = [(cuda_ms(lambda: pg.gather_rows(padded, ids)),
              cuda_ms(lambda: torch.index_select(padded, 0, ids)))
             for _ in range(10)]
    dev_pairs = [(device_ms(lambda: pg.gather_rows(padded, ids),
                            "gather_rows"),
                  device_profile(lambda: torch.index_select(padded, 0, ids)
                                 )["device_ms"])
                 for _ in range(3)]
    out = {"max_abs_err": err,
           "ms": statistics.median(p for p, _ in pairs),
           "device_ms": statistics.median(p for p, _ in dev_pairs),
           "plain_ms": cuda_ms(lambda: pg._gather_rows_plain(padded, ids)),
           "library_ms": statistics.median(lib for _, lib in pairs),
           "library_device_ms": statistics.median(lib for _, lib in dev_pairs),
           "shape": f"N={N} rowT={rowT} u16 R={R}",
           **bound(row_bytes * (distinct + R) + 4 * R, 0)}
    out["share_of_bound"] = out["bound_ms"] / out["ms"]
    out["device_share_of_bound"] = out["bound_ms"] / out["device_ms"]
    emit({"phase": "kernels", "kernel": "row_gather (P1)", "timed": out,
          "pairs_ms": pairs, "device_pairs_ms": dev_pairs,
          "kernel_faster_in": sum(p < lib for p, lib in pairs),
          "kernel_faster_on_device_in": sum(p < lib for p, lib in dev_pairs)})
    return out


def probe_phase() -> int:
    """The probe of the row gather (P1's own path), through its entry
    point; its lines are the phase's record. -> P1 launches it made."""
    from mygramdb_tpu_torch.ops import runtime
    from mygramdb_tpu_torch.tools import profile_gather
    import torch
    t0 = time.time()
    lines = []
    runtime.reset_launches()
    records = profile_gather.main([], out=lines.append)
    torch.cuda.synchronize()
    launches = dict(runtime.launches)
    emit({"phase": "probe", "lines": lines, "records": records,
          "launches": launches, "seconds": time.time() - t0})
    check(launches["row_gather"] > 0 and launches["slice_gather"] > 0,
          f"the probe launched no row gather or slice gather: {launches}")
    torch.cuda.empty_cache()
    return launches["row_gather"]


def synthetic_pack(gen, n_docs: int, u32: bool):
    """A corpus-shaped pack on the card: lengths 30-500 (every 97th
    document empty), cells from a 48-code-point alphabet (kanji, or
    non-BMP code points for a u32 pack) so that needles match often.
    -> (flat cells int16/int32, offsets int64, lengths int32)."""
    import torch
    dev = torch.device("cuda")
    lens = torch.randint(30, 501, (n_docs,), generator=gen,
                         dtype=torch.int32)
    lens[::97] = 0
    offs = torch.zeros(n_docs, dtype=torch.int64)
    offs[1:] = torch.cumsum(lens[:-1].to(torch.int64), 0)
    P = int(lens.sum())
    base = 0x20000 if u32 else 0x4E00
    cells = base + torch.randint(0, 48, (P,), generator=gen,
                                 dtype=torch.int32)
    if not u32:  # u16 bit patterns in int16
        cells = torch.where(cells >= 0x8000, cells - 0x10000, cells)
        cells = cells.to(torch.int16)
    return cells.to(dev), offs.to(dev), lens.to(dev)


def needle_rows(gen, cells, offs, lens, B: int, Nn: int, cap: int, u32):
    """(B, Nn*cap) int32 needles in the compare domain cut from the pack
    (lengths 3..cap; every fifth needle empty) and their (B, Nn)
    lengths."""
    import torch
    from mygramdb_tpu_torch.ops import verify_ops
    dev = cells.device
    ndl = torch.zeros((B, Nn, cap), dtype=torch.int32)
    nlen = torch.zeros((B, Nn), dtype=torch.int32)
    docs = torch.nonzero(lens.cpu() >= cap).flatten()
    for b in range(B):
        for j in range(Nn):
            if (b + j) % 5 == 4:
                continue
            L = int(torch.randint(3, cap + 1, (1,), generator=gen))
            d = int(docs[int(torch.randint(0, docs.numel(), (1,),
                                           generator=gen))])
            p = int(offs[d]) + int(torch.randint(
                0, int(lens[d]) - L + 1, (1,), generator=gen))
            ndl[b, j, :L] = verify_ops.cells_i32(cells[p:p + L]).cpu()
            nlen[b, j] = L
    return ndl.reshape(B, Nn * cap).to(dev), nlen.to(dev)


def tf_bound(ids, row_lens, nlen, owner, Kv: int, itemsize: int,
             cap: int, extra_row_bytes: int, row_cells: int = 0) -> dict:
    """Bound of one window-TF call from its inputs: each live row's
    document read once (distinct documents; a padded row's whole
    ``row_cells`` prefix, whose non-sentinel cells are its doc_len), the
    row metadata, needles and the (M, Nn+1) output; operations = one
    compare for every start at which each present needle could fit in
    each live row."""
    import torch
    M = ids.numel()
    B, Nn = nlen.shape
    live = row_lens > 0
    docs = torch.unique(ids[live])
    doc_len = torch.zeros(int(ids.max()) + 1, dtype=torch.int64,
                          device=ids.device)
    doc_len[ids[live]] = row_lens[live].to(torch.int64)
    text = (docs.numel() * row_cells if row_cells
            else int(doc_len[docs].sum())) * itemsize
    own = owner.long() if owner is not None else \
        torch.arange(M, device=ids.device) // Kv
    nl = nlen[own].to(torch.int64)                          # (M, Nn)
    starts = (row_lens.to(torch.int64)[:, None] - nl + 1).clamp(min=0)
    ops = int((starts * ((nl > 0) & live[:, None])).sum())
    nbytes = (text + M * extra_row_bytes + 4 * M * (Nn + 1)
              + 4 * B * Nn * (cap + 1))
    return bound(nbytes, ops)


def verify_kernel_phase(gen, n_docs: int):
    """K4, K5, K6 against their plain versions at the serving shapes (64
    queries x 2048 candidate slots over an n_docs pack, 60% of the slots
    live, window 512), on u16 and u32 packs, cap 4 and 32, Nn 2 and 4,
    both count modes, with and without the range mask; K5 with a dead
    suffix. K6 reads a matrix of the verified serve's row width
    (TEXT_MAXT + NEEDLE_CAP) at the fused program's shape (the 512-cell
    prefix) and at the text store's own ("tf_rows_padded/store": one
    needle set over a chunk of sorted candidate ids, whole rows). Timed at
    u16, cap 4, Nn 2 (3-4 character CJK terms). -> {kernel: numbers}."""
    import torch
    from mygramdb_tpu_torch.ops import verify_ops as V
    from mygramdb_tpu_torch.storage.device_text import (_C_CHUNK,
                                                        _pad_on_device)
    dev = torch.device("cuda")
    B, Kv, maxT = 64, 2048, 512
    M = B * Kv
    rowT = TEXT_MAXT + V.NEEDLE_CAP
    names = ("tf_rows_flat", "tf_rows_flat_global", "tf_rows_padded",
             "tf_rows_padded/store")
    out = {k: {"max_abs_err": 0} for k in names}
    checks = 0
    for u32 in (False, True):
        cells, offs, lens = synthetic_pack(gen, n_docs, u32)
        # the sentinel's bits (0xFFFF or 0xFFFFFFFF) are -1 in both types
        padded = _pad_on_device(cells, offs, lens, rowT, -1)
        ids = torch.randint(1, n_docs, (M,), generator=gen).to(dev)
        alive = torch.rand(M, generator=gen).to(dev) < 0.6
        row_lens = torch.where(alive, lens[ids], 0).to(torch.int32)
        starts = offs[ids]
        owner = torch.randint(0, B, (M,), generator=gen,
                              dtype=torch.int32).to(dev)
        live = torch.tensor([int(0.6 * M)], dtype=torch.int32, device=dev)
        pk_lens = torch.where(torch.arange(M, device=dev) < live,
                              lens[ids], 0).to(torch.int32)
        # a text-store call: sorted distinct gram-match ids, all rows live
        s_ids = torch.sort(torch.randperm(n_docs - 1, generator=gen)
                           [:_C_CHUNK] + 1).values.to(dev)
        s_lens = lens[s_ids].to(torch.int32)
        for cap, Nn in ((4, 2), (32, 4)):
            ndl, nlen = needle_rows(gen, cells, offs, lens, B, Nn, cap, u32)
            # the store call's needle set: the one with the shortest needle
            q = int(torch.where(nlen > 0, nlen, 99).min(1).values.argmin())
            s_ndl, s_nlen = ndl[q:q + 1], nlen[q:q + 1]
            calls = {
                "tf_rows_flat": (
                    lambda kw: V.tf_rows_flat(cells, starts, row_lens, ndl,
                                              nlen, Kv=Kv, win=maxT, **kw),
                    lambda kw: V._tf_flat_plain(cells, starts, row_lens,
                                                ndl, nlen, Kv=Kv, win=maxT,
                                                **kw)),
                "tf_rows_flat_global": (
                    lambda kw: V.tf_rows_flat_global(
                        cells, starts, pk_lens, owner, live, ndl, nlen,
                        win=maxT, **kw),
                    lambda kw: V._tf_flat_global_plain(
                        cells, starts, pk_lens, owner, live, ndl, nlen,
                        win=maxT, **kw)),
                "tf_rows_padded": (
                    lambda kw: V.tf_rows_padded(padded, ids, row_lens, ndl,
                                                nlen, Kv=Kv,
                                                width=maxT + cap, **kw),
                    lambda kw: V._tf_padded_plain(padded, ids, row_lens,
                                                  ndl, nlen, Kv=Kv,
                                                  width=maxT + cap, **kw)),
                "tf_rows_padded/store": (
                    lambda kw: V.tf_rows_padded(padded, s_ids, s_lens,
                                                s_ndl, s_nlen, Kv=_C_CHUNK,
                                                width=rowT, **kw),
                    lambda kw: V._tf_padded_plain(padded, s_ids, s_lens,
                                                  s_ndl, s_nlen,
                                                  Kv=_C_CHUNK, width=rowT,
                                                  **kw)),
            }
            for name, (kern, plain) in calls.items():
                for use_range in (False, True):
                    for nonoverlap in (False, True):
                        kw = dict(cap=cap, use_range=use_range,
                                  nonoverlap=nonoverlap)
                        got, want = kern(kw), plain(kw)
                        torch.cuda.synchronize()
                        check(torch.equal(got, want),
                              f"{name} disagrees: u32={u32} cap={cap} "
                              f"Nn={Nn} use_range={use_range} "
                              f"nonoverlap={nonoverlap}")
                        check(int(got[:, :Nn].sum()) > 0,
                              f"{name}: no needle matched")
                        if name == "tf_rows_flat_global":
                            check(not got[int(live):].any(),
                                  f"{name}: dead suffix not zero")
                        checks += 1
                if u32 or cap != 4:
                    continue
                kw = dict(cap=cap, use_range=False, nonoverlap=False)
                o = out[name]
                o["ms"] = cuda_ms(lambda: kern(kw))
                o["device_ms"] = device_ms(lambda: kern(kw),
                                           "tf_rows_kernel")
                o["plain_ms"] = cuda_ms(lambda: plain(kw), reps=5)
                o["shape"] = (f"M={M} (B={B} x {Kv}) win={maxT} cap={cap} "
                              f"Nn={Nn} u16, {n_docs} docs")
                if name == "tf_rows_flat_global":
                    o.update(tf_bound(ids, pk_lens, nlen, owner, Kv, 2, cap,
                                      16))
                    o["shape"] += f", live {int(live)}"
                elif name == "tf_rows_flat":
                    o.update(tf_bound(ids, row_lens, nlen, None, Kv, 2,
                                      cap, 12))
                elif name == "tf_rows_padded":
                    o.update(tf_bound(ids, row_lens, nlen, None, Kv, 2,
                                      cap, 12, row_cells=maxT + cap))
                    o["shape"] += f", rowT {rowT}, width {maxT + cap}"
                else:
                    o.update(tf_bound(s_ids, s_lens, s_nlen, None, _C_CHUNK,
                                      2, cap, 12, row_cells=rowT))
                    o["shape"] = (f"M={_C_CHUNK} (one store call, sorted "
                                  f"ids) whole rows rowT={rowT} win="
                                  f"{rowT - cap} cap={cap} Nn={Nn} u16, "
                                  f"{n_docs} docs")
        del cells, padded
        torch.cuda.empty_cache()
    emit({"phase": "kernels", "kernel": "tf_rows (K4, K5, K6)",
          "checks": checks,
          "timed": {k: {**{f: v[f] for f in ("ms", "device_ms", "plain_ms",
                                             "bound_ms", "shape")},
                        "share_of_bound": v["bound_ms"] / v["ms"],
                        "device_share_of_bound":
                            v["bound_ms"] / v["device_ms"]
                            if v["device_ms"] else None}
                    for k, v in out.items()}})
    return out


# ---------------------------------------------------------------------------
# Serve phases
# ---------------------------------------------------------------------------

def synonym_groups(gen, seed: int):
    """Synonym groups over the corpus's vocabulary: EN words of several
    frequency ranks and 2-kanji terms, mixed in one group too."""
    import numpy as np
    ja = gen.sample_ja_terms(6, term_len=2,
                             rng=np.random.default_rng(seed + 7))
    used = set()

    def word(rank: int) -> str:
        w = next(w for w in gen.vocab[rank:] if len(w) >= 4
                 and w not in KEYWORDS and w not in used)
        used.add(w)
        return w

    return [[word(120), word(2500), word(15000)], [word(45), word(7000)],
            [ja[0], ja[1], word(3000)], [ja[2], ja[3]],
            [ja[4], word(600), ja[5]]]


def write_inputs(docs: int, seed: int, verified: bool,
                 synonyms: bool = False, mesh_shards: int = 1,
                 positional: bool = False):
    """Seed JSONL of the synthetic corpus (written once a run for each
    docs and seed: the sharded serve reads the verified serve's) + a JSON
    config (with a synonym file when asked, ``device.mesh_shards`` when
    above 1, ``device.positional_verify`` with positional); ->
    (generator, paths, status column, synonym groups)."""
    import numpy as np
    from mygramdb_tpu_torch.utils.corpusgen import CorpusGenerator
    work = os.path.join(WORK, f"{docs}_{int(verified)}_{mesh_shards}")
    os.makedirs(work, exist_ok=True)
    gen = CorpusGenerator(docs, ja_ratio=0.45, seed=seed)
    seed_path = os.path.join(WORK, f"seed_{docs}_{seed}.jsonl")
    if not os.path.exists(seed_path):
        with open(seed_path + ".tmp", "w", encoding="utf-8") as f:
            for batch in gen.batches(50_000):
                f.write("".join(
                    json.dumps({"id": i, "content": t, "status": i % 3},
                               ensure_ascii=False) + "\n" for i, t in batch))
        os.replace(seed_path + ".tmp", seed_path)
    cfg = {
        "tables": [{"name": "articles",
                    "text_source": {"column": "content"},
                    "filters": [{"name": "status", "type": "int",
                                 "bitmap_index": True}]}],
        "cache": {"enabled": False},
        "api": {"tcp": {"bind": "127.0.0.1", "port": 0}},
        "network": {"allow_cidrs": ["127.0.0.0/8"]},
        "dump": {"dir": os.path.join(work, "dumps")},
        "logging": {"level": "warn"},
    }
    if verified:
        cfg["memory"] = {"verify_text": "all"}
    if mesh_shards > 1:
        cfg["device"] = {"mesh_shards": mesh_shards}
    if positional:
        cfg["device"] = {"positional_verify": True}
    groups = synonym_groups(gen, seed) if synonyms else []
    if groups:
        syn_path = os.path.join(work, "synonyms.tsv")
        with open(syn_path, "w", encoding="utf-8") as f:
            f.write("".join("\t".join(g) + "\n" for g in groups))
        cfg["tables"][0]["synonyms"] = {"enable": True, "file": syn_path}
    cfg_path = os.path.join(work, "config.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    status = np.arange(docs + 1, dtype=np.int64) % 3
    return gen, seed_path, cfg_path, status, groups


def query_grams(ctx, raw: str):
    """The n-grams a query term is indexed under (host text processing)."""
    from mygramdb_tpu_torch.utils import textproc
    t = ctx.table_cfg
    return set(textproc.generate_query_ngrams(
        ctx.normalize(raw), t.ngram_size, t.kanji_ngram_size,
        t.cross_boundary_ngrams, kanji_extra=ctx.kanji_extra_effective))


class Reference:
    """Expected answers from the host CSR with numpy boolean doc masks,
    and, for a verified table, Python substring checks over the stored
    normalized texts and BM25 in numpy (no device code)."""

    def __init__(self, ctx, status, texts=None, synonyms=()):
        import numpy as np
        self.ctx = ctx
        # normalized term -> its synonym group, normalized
        self.synonyms = {}
        for group in synonyms:
            norm = [ctx.normalize(t) for t in group]
            for t in norm:
                self.synonyms[t] = norm
        self.built = ctx.index.built
        self.td = ctx.index.term_dict
        self.status = status
        self.removed = set()
        self._cache = {}
        self.texts = texts  # doc id -> normalized text (index 0 unused)
        if texts is not None:
            self.doc_len = np.asarray([len(t or "") for t in texts],
                                      dtype=np.float64)

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

    def term_text_ids(self, raw: str):
        """Docs holding every gram of the term whose stored text contains
        the normalized term (all of them when the table verifies no
        text)."""
        import numpy as np
        ids = self.term_ids(raw)
        if self.texts is None:
            return ids
        key = ("text", raw)
        if key not in self._cache:
            n = self.ctx.normalize(raw)
            self._cache[key] = np.asarray(
                [d for d in ids.tolist() if n in self.texts[d]],
                dtype=np.int64)
        return self._cache[key]

    def _in_text(self, raw: str, ids):
        """Which of ids hold the normalized term in their stored text."""
        import numpy as np
        n = self.ctx.normalize(raw)
        return np.fromiter((n in self.texts[d] for d in ids.tolist()),
                           dtype=bool, count=ids.size)

    def tree_ids(self, tree):
        """A boolean tree ('t', term) | ('!', child) | ('&', ...) |
        ('|', ...): set algebra over the terms' gram-AND masks, NOT taken
        within all documents; then the same tree over substring checks of
        the survivors' stored texts."""
        import numpy as np
        everything = np.ones(self.status.size, dtype=bool)
        everything[0] = False

        def walk(node, leaf, universe):
            if node[0] == "t":
                return leaf(node[1])
            if node[0] == "!":
                return universe & ~walk(node[1], leaf, universe)
            parts = [walk(c, leaf, universe) for c in node[1:]]
            return reduce((lambda a, b: a & b) if node[0] == "&"
                          else (lambda a, b: a | b), parts)

        ids = np.flatnonzero(walk(
            tree, lambda t: self._mask(self.term_ids(t)), everything))
        keep = walk(tree, lambda t: self._in_text(t, ids),
                    np.ones(ids.size, dtype=bool))
        return ids[keep]

    def synonym_ids(self, terms):
        """OR within each term's synonym group, AND across the terms:
        first over gram-AND masks, then over substring checks."""
        import numpy as np
        groups = [self.synonyms.get(self.ctx.normalize(t),
                                    [self.ctx.normalize(t)]) for t in terms]
        m = np.ones(self.status.size, dtype=bool)
        for group in groups:
            m &= reduce(lambda a, b: a | b,
                        [self._mask(self.term_ids(v)) for v in group])
        ids = np.flatnonzero(m)
        keep = np.ones(ids.size, dtype=bool)
        for group in groups:
            keep &= reduce(lambda a, b: a | b,
                           [self._in_text(v, ids) for v in group])
        return ids[keep]

    def fuzzy_candidates(self, raw: str, dist: int):
        """Docs holding at least max(1, |grams| - dist * ngram_size) of the
        term's base grams (the standard emission, without the extra kanji
        bigrams): a bincount over their postings."""
        import numpy as np
        from mygramdb_tpu_torch.utils import textproc
        key = ("fuzzy", raw, dist)
        if key not in self._cache:
            t = self.ctx.table_cfg
            base = sorted(set(textproc.generate_query_ngrams(
                self.ctx.normalize(raw), t.ngram_size, t.kanji_ngram_size,
                t.cross_boundary_ngrams)))
            need = max(1, len(base) - dist * max(t.ngram_size, 1))
            tids = [x for x in (self.td.get(g) for g in base)
                    if x is not None]
            cnt = np.zeros(self.status.size, dtype=np.int64)
            for x in tids:
                cnt[self.built.postings_of(x)] += 1
            self._cache[key] = np.flatnonzero(cnt >= need)
        return self._cache[key]

    def fuzzy_ids(self, raw: str, dist: int):
        """Candidates whose text holds the term, or a whitespace token
        within dist edits of it."""
        import numpy as np
        n = self.ctx.normalize(raw)
        ids = self.fuzzy_candidates(raw, dist)
        near = {}  # token -> within dist edits of the term

        def matches(text: str) -> bool:
            if n in text:
                return True
            for tok in text.split():
                if abs(len(tok) - len(n)) <= dist:
                    hit = near.get(tok)
                    if hit is None:
                        hit = near[tok] = edit_distance(tok, n) <= dist
                    if hit:
                        return True
            return False

        keep = np.fromiter((matches(self.texts[d]) for d in ids.tolist()),
                           dtype=bool, count=ids.size)
        return ids[keep]

    def ids(self, q: dict):
        import numpy as np
        kind = q.get("kind")
        if kind:
            # these depend on no removal: computed once for each query
            key = ("kind", q["line"])
            if key not in self._cache:
                self._cache[key] = (
                    self.tree_ids(q["tree"]) if kind == "bool" else
                    self.synonym_ids(q["terms"]) if kind == "syn" else
                    self.fuzzy_ids(q["terms"][0], q["dist"]))
            ids = self._cache[key]
            return ids[~np.isin(ids, list(self.removed))]
        m = reduce(lambda a, b: a & b,
                   [self._mask(self.term_text_ids(t)) for t in q["terms"]])
        for t in q.get("not", ()):
            m &= ~self._mask(self.term_ids(t))
        if q.get("filter"):
            m &= self.status == 1
        m[list(self.removed)] = False
        return np.flatnonzero(m)

    def bm25(self, q: dict, ids):
        """BM25 of ids (reference bm25_scorer.h:41, query/bm25.py): IDF
        from each term's gram-AND df over the live documents, TF by
        non-overlapping ``str.count``, doc length in code points."""
        import numpy as np
        live = np.ones(self.doc_len.size, dtype=bool)
        live[0] = False
        live[list(self.removed)] = False
        n_docs = int(live.sum())
        avgdl = float(self.doc_len[live].sum()) / n_docs
        score = np.zeros(ids.size, dtype=np.float64)
        dl = self.doc_len[ids]
        for t in q["terms"]:
            df = int(live[self.term_ids(t)].sum())
            idf = math.log((n_docs - df + 0.5) / (df + 0.5) + 1.0)
            n = self.ctx.normalize(t)
            tf = np.asarray([self.texts[d].count(n) for d in ids.tolist()],
                            dtype=np.float64)
            norm = K1_BM25 * (1.0 - B_BM25 + B_BM25 * dl / avgdl)
            score += idf * tf * (K1_BM25 + 1.0) / (tf + norm)
        return score

    def line(self, q: dict) -> str:
        ids = self.ids(q)
        if q["cmd"] == "COUNT":
            return f"OK COUNT {ids.size}"
        page = ids[::-1][:100] if q["desc"] else ids[:100]
        return " ".join([f"OK RESULTS {ids.size}"] + [str(int(d))
                                                      for d in page])

    def mismatch(self, q: dict, resp: str):
        """None when resp is right. A score-ordered page must hold the
        verified count and, at each position, an id whose reference score
        is within 1e-5 relative of the reference ranking's score there
        (float32 sums in another order), with no id twice."""
        import numpy as np
        if not q.get("score"):
            want = self.line(q)
            return None if resp == want else want
        ids = self.ids(q)
        sc = self.bm25(q, ids)
        order = np.lexsort((-ids, -sc))
        want_scores = sc[order][:100]
        parts = resp.split()
        if parts[:2] != ["OK", "RESULTS"] or int(parts[2]) != ids.size:
            return f"OK RESULTS {ids.size} ..."
        page = [int(x) for x in parts[3:]]
        pos = {int(d): i for i, d in enumerate(ids.tolist())}
        if len(page) != want_scores.size or len(set(page)) != len(page) \
                or any(d not in pos for d in page):
            return f"a page of {want_scores.size} verified ids"
        got = sc[[pos[d] for d in page]]
        tol = 1e-5 * np.maximum(np.abs(want_scores), 1e-9)
        if (np.abs(got - want_scores) > tol).any():
            return "ids ranked by " + " ".join(
                f"{d}:{s:.7g}" for d, s in zip(ids[order][:10].tolist(),
                                               want_scores[:10]))
        return None


def edit_distance(a: str, b: str) -> int:
    """Levenshtein distance between two strings, the full table row by
    row."""
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def term_kind(ctx, word: str):
    """None (a gram is unknown), "dense" (every gram is a bitmap row),
    "probed" (a sparse driver with more grams to probe) or "single"."""
    dense_row = ctx.index.device.dense_row
    grams = query_grams(ctx, word)
    tids = [ctx.index.term_dict.get(g) for g in grams]
    if not grams or any(t is None for t in tids):
        return None
    if all(dense_row[t] >= 0 for t in tids):
        return "dense"
    return "probed" if len(grams) > 1 else "single"


def pick_from(rng):
    return lambda pool: pool[int(rng.integers(len(pool)))]


def finish_queries(makers, rng, n: int, extra=()):
    """n distinct queries drawn from weighted makers, plus extra."""
    import numpy as np
    weights = np.asarray([w for w, _ in makers])
    out, seen = [], set()
    while len(out) < n:
        q = makers[int(rng.choice(len(makers), p=weights / weights.sum()))
                   ][1]()
        q["line"] = render(q)
        if q["line"] not in seen:
            seen.add(q["line"])
            out.append(q)
    for q in extra:
        q["line"] = render(q)
        out.append(q)
    return out


def search(terms, desc=True, **kw):
    return dict(cmd="SEARCH", terms=terms, desc=desc, **kw)


def make_queries(gen, ctx, n: int, seed: int):
    """Distinct SEARCH/COUNT queries over every path of the unverified
    slice."""
    import numpy as np
    rng = np.random.default_rng(seed)
    pick = pick_from(rng)
    vocab = [w for w in gen.vocab[:60_000]
             if len(w) >= 2 and w not in KEYWORDS]
    dense_w = [w for w in vocab[:3000] if term_kind(ctx, w) == "dense"]
    sparse_w = [w for w in vocab[500:] if term_kind(ctx, w) == "probed"]
    ja = [t for t in (gen.sample_ja_terms(3000, term_len=2, rng=rng)
                      + gen.sample_ja_terms(300, term_len=1, rng=rng))
          if term_kind(ctx, t) is not None]
    # a small corpus makes every ASCII bigram dense: CJK terms drive then
    sparse_w = sparse_w or [t for t in ja if term_kind(ctx, t) != "dense"]
    check(len(dense_w) >= 50 and len(sparse_w) >= 50 and len(ja) >= 50,
          f"query pools too small: dense={len(dense_w)} "
          f"sparse={len(sparse_w)} ja={len(ja)}")
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
    nogram = [search([f"qzx{i}vj"], True) for i in range(max(n // 50, 10))]
    return finish_queries(makers, rng, n, nogram)


def verified_pools(gen, ctx, texts, rng, skip=()):
    """Term pools of a verify_text table, none of them in skip: 3- and
    4-character CJK substrings cut from the stored texts (so that some
    verify and some only share grams), EN words whose grams are all dense
    rows, EN words with a sparse gram, the commonest words, and
    self-overlapping words. -> (cjk, dense_w, sparse_w, common, borders,
    ja_docs)."""
    from mygramdb_tpu_torch.ops.verify_ops import has_self_overlap
    ja_docs = [d for d in rng.integers(1, len(texts), 4000).tolist()
               if texts[d] and not texts[d].isascii()]
    cjk = []
    for d in ja_docs:
        t = texts[d]
        L = 3 + len(cjk) % 2
        p = int(rng.integers(0, len(t) - L))
        if term_kind(ctx, t[p:p + L]) is not None:
            cjk.append(t[p:p + L])
    vocab = [w for w in gen.vocab[:20_000]
             if len(w) >= 3 and w not in KEYWORDS and w not in skip]
    dense_w = [w for w in vocab[:3000] if term_kind(ctx, w) == "dense"]
    sparse_w = [w for w in vocab[200:6000] if term_kind(ctx, w) == "probed"]
    # a small corpus makes every ASCII bigram dense: CJK terms drive then
    sparse_w = sparse_w or [t for t in cjk if term_kind(ctx, t) != "dense"]
    common = vocab[:300]
    borders = [w for w in vocab[:2000] if has_self_overlap(w)
               and term_kind(ctx, w) is not None]
    check(min(len(cjk), len(dense_w), len(sparse_w), len(borders)) >= 20,
          f"verified query pools too small: cjk={len(cjk)} "
          f"dense={len(dense_w)} sparse={len(sparse_w)} "
          f"borders={len(borders)}")
    return cjk, dense_w, sparse_w, common, borders, ja_docs


def make_verified_queries(gen, ctx, texts, n: int, seed: int, skip=()):
    """Distinct queries for a verify_text table over ``verified_pools``:
    one term, two-term AND, NOT, FILTER, COUNT and SORT _score with one
    and two terms and with a self-overlapping term. No term is in skip
    (the synonym file's terms: these queries take no synonym path)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    pick = pick_from(rng)
    cjk, dense_w, sparse_w, common, borders, _ = verified_pools(
        gen, ctx, texts, rng, skip)
    en = dense_w + sparse_w

    def scored(terms):
        return search(terms, True, score=True)

    makers = [
        (0.18, lambda: search([pick(cjk)], bool(rng.integers(2)))),
        (0.10, lambda: search([pick(dense_w)], bool(rng.integers(2)))),
        (0.10, lambda: search([pick(sparse_w)], bool(rng.integers(2)))),
        (0.06, lambda: search([pick(en), pick(en)], True)),
        (0.04, lambda: search([pick(cjk), pick(common)], True)),
        (0.06, lambda: search([pick(common)], True,
                              **{"not": [pick(dense_w)]})),
        (0.08, lambda: search([pick(en + cjk)], bool(rng.integers(2)),
                              filter=True)),
        (0.10, lambda: dict(cmd="COUNT", terms=[pick(en + cjk)],
                            filter=bool(rng.integers(2)))),
        (0.10, lambda: scored([pick(en + cjk)])),
        (0.08, lambda: scored([pick(en), pick(en + cjk)])),
        (0.04, lambda: scored([pick(borders)])),
        (0.06, lambda: scored([pick(common)])),
    ]
    return finish_queries(makers, rng, n)


def expression(node, top: bool = True) -> str:
    """A boolean tree as the protocol writes it: (a OR b), (a AND NOT b)."""
    if node[0] == "t":
        return node[1]
    if node[0] == "!":
        inner = "NOT " + expression(node[1], False)
        return f"({inner})" if top else inner
    word = " AND " if node[0] == "&" else " OR "
    return "(" + word.join(expression(c, False) for c in node[1:]) + ")"


def make_kind_queries(gen, ctx, ref, texts, groups, seed: int,
                      fuzzy_terms: bool = True):
    """Queries of the boolean, synonym and fuzzy paths for a verify_text
    table. Boolean: the five tree shapes of tests/test_device_ast.py over
    dense, sparse and CJK terms. Synonym: every term of the synonym file,
    alone, AND another term, and counted. Fuzzy: long EN words as they
    are (FUZZY 1), with a letter dropped (FUZZY 1) and with two letters
    swapped (FUZZY 2), at most FUZZY_EN of them, and FUZZY_KANJI
    3-character terms of rare kanji (every base gram sparse). A fuzzy term with more than FUZZY_CAP
    candidates is dropped. -> (queries, fuzzy terms dropped for the
    cap). Without fuzzy_terms, no fuzzy query."""
    import numpy as np
    from mygramdb_tpu_torch.utils import textproc
    rng = np.random.default_rng(seed + 3)
    pick = pick_from(rng)
    skip = {t for g in groups for t in g}
    cjk, dense_w, sparse_w, _, _, ja_docs = verified_pools(
        gen, ctx, texts, rng, skip)
    terms = dense_w + sparse_w + cjk

    def t():
        return ("t", pick(terms))

    def tree(cmd, node):
        return dict(cmd=cmd, kind="bool", tree=node, terms=[],
                    desc=bool(rng.integers(2)))

    shapes = [
        (0.30, lambda: ("&", ("|", t(), t()), t())),
        (0.25, lambda: ("&", t(), ("!", t()))),
        (0.04, lambda: ("!", ("t", pick(dense_w)))),
        (0.13, lambda: ("|", t(), ("t", "zzznope"))),
        (0.28, lambda: ("&", ("|", t(), ("t", pick(cjk))),
                        ("!", ("&", t(), t())))),
    ]
    weights = np.asarray([w for w, _ in shapes])
    out = []
    for i in range(160):
        node = shapes[int(rng.choice(len(shapes),
                                     p=weights / weights.sum()))][1]()
        out.append(tree("COUNT" if i % 7 == 6 else "SEARCH", node))

    for group in groups:
        for term in group:
            out.append(search([term], bool(rng.integers(2)), kind="syn"))
            out.append(search([term, pick(terms)], True, kind="syn"))
            out.append(search([pick(terms), term], False, kind="syn"))
            out.append(dict(cmd="COUNT", terms=[term], kind="syn"))

    def fuzzy(term, dist):
        return search([term], True, kind="fuzzy", dist=dist)

    if not fuzzy_terms:
        for q in out:
            q["line"] = render(q)
        return out, 0

    # the longer the word, the more of its bigrams a candidate must hold
    long_w = [w for w in gen.vocab[:60_000] if len(w) >= 12
              and w not in KEYWORDS and w not in skip]
    fz = []
    for _ in range(40):
        w = pick(long_w)
        p = int(rng.integers(1, len(w) - 2))
        fz += [fuzzy(w, 1), fuzzy(w[:p] + w[p + 1:], 1),
               fuzzy(w[:p] + w[p + 1] + w[p] + w[p + 2:], 2)]
    # rare kanji: every base gram of the term a sparse term
    dense_row, td, t_cfg = (ctx.index.device.dense_row, ctx.index.term_dict,
                            ctx.table_cfg)
    sparse_char = {}

    def rare(ch: str) -> bool:
        if ch not in sparse_char:
            tid = td.get(ch)
            sparse_char[ch] = (textproc.is_cjk_ideograph(ord(ch))
                               and tid is not None and dense_row[tid] < 0)
        return sparse_char[ch]

    kanji = []
    for d in ja_docs:
        x = texts[d]
        for p in range(len(x) - 2):
            if rare(x[p]) and rare(x[p + 1]) and rare(x[p + 2]):
                base = set(textproc.generate_query_ngrams(
                    x[p:p + 3], t_cfg.ngram_size, t_cfg.kanji_ngram_size,
                    t_cfg.cross_boundary_ngrams))
                tids = [td.get(g) for g in base]
                if None not in tids and all(dense_row[i] < 0 for i in tids):
                    kanji.append(x[p:p + 3])
                break
        if len(kanji) == FUZZY_KANJI:
            break
    check(len(kanji) >= FUZZY_KANJI // 2,
          f"only {len(kanji)} rare-kanji fuzzy terms")
    fz += [fuzzy(k, 1 + i % 2) for i, k in enumerate(kanji)]
    dropped = kept_en = 0
    for q in fz:
        if q["terms"][0].isascii() and kept_en == FUZZY_EN:
            continue  # enough EN fuzzy queries under the cap
        if ref.fuzzy_candidates(q["terms"][0], q["dist"]).size > FUZZY_CAP:
            dropped += 1
        else:
            kept_en += q["terms"][0].isascii()
            out.append(q)
    for q in out:
        q["line"] = render(q)
    return out, dropped


def render(q: dict) -> str:
    if q.get("kind") == "bool":
        parts = [q["cmd"], "articles", expression(q["tree"])]
    else:
        parts = [q["cmd"], "articles", q["terms"][0]]
    for t in q["terms"][1:]:
        parts += ["AND", t]
    for t in q.get("not", ()):
        parts += ["NOT", t]
    if q.get("filter"):
        parts += ["FILTER", "status", "=", "1"]
    if q.get("kind") == "fuzzy":
        parts += ["FUZZY", str(q["dist"])]
    if q.get("score"):
        parts += ["SORT", "_score", "DESC", "LIMIT", "100"]
    elif q["cmd"] == "SEARCH":
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
                resp = await asyncio.wait_for(reader.readline(), 300)
                results.append((q, resp.decode().rstrip("\r\n"),
                                time.perf_counter() - t0))
        finally:
            writer.close()

    await asyncio.gather(*[worker() for _ in range(conns)])
    return results


def search_or_check(ctx, ref, words) -> dict:
    """``SegmentedIndex.search_or`` (no served query reaches it) over the
    grams of each word against the union of their postings in the host
    CSR. -> what was checked."""
    import numpy as np
    sizes = []
    for w in words:
        grams = sorted(query_grams(ctx, w))
        tids = [t for t in (ref.td.get(g) for g in grams) if t is not None]
        want = reduce(np.union1d, [ref.built.postings_of(t) for t in tids],
                      np.empty(0, dtype=np.int32))
        got = ctx.index.search_or(grams)
        check(np.array_equal(got, want),
              f"search_or({w!r}) differs from the union of its postings")
        sizes.append(int(got.size))
    return {"via": "direct SegmentedIndex.search_or calls", "calls":
            len(sizes), "ids": sum(sizes)}


# ---------------------------------------------------------------------------
# The mesh: each sharded program against the single-device program
# ---------------------------------------------------------------------------

POSITIONAL_TERMS = 240  # planned terms of the positional phase (>= 200)
# the forms each planned term is asked in: page, order, count, BM25,
# gram-AND probes, the status filter row
POSITIONAL_FORMS = {
    "desc": dict(limit=100, descending=True),
    "asc": dict(limit=100, descending=False),
    "count": dict(limit=0, descending=True),
    "score": dict(limit=100, descending=True, score_mode=True),
    "probes": dict(limit=100, descending=True, force_probes=True),
    "filter": dict(limit=100, descending=False, filter=True),
}
POSITIONAL_PROFILE_B = (1, 2, 4, 8, 16, 32, 64)


def positional_refusal(dev, to) -> str:
    """Which bucket of ``plan_positional`` a refused plan passed (the JAX
    package's buckets, read from ``index/positional.py``)."""
    from mygramdb_tpu_torch.index import positional as P
    pp = dev.positional
    dfs = [int(dev.lengths[t]) for t, _ in to]
    if min(dfs) == 0:
        return "empty_gram"
    di = dfs.index(min(dfs))
    probes = [t for j, (t, _) in enumerate(to) if j != di]
    for name, value, buckets in (
            ("C", dfs[di], P.C_BUCKETS),
            ("Co", int(pp.occ_len[to[di][0]]), P.CO_BUCKETS),
            ("G", len(probes), P.G_BUCKETS),
            ("C2", max([1] + [dfs[j] for j in range(len(to)) if j != di]),
             P.C2_BUCKETS),
            ("Co2", max([1] + [int(pp.occ_len[t]) for t in probes]),
             P.CO2_BUCKETS)):
        if P._bucket(max(value, 1), buckets) is None:
            return name
    return "overflow" if pp.overflow else "other"


def positional_plans(gen, ctx, texts, seed: int):
    """Covered single terms drawn from the corpus (CJK substrings of 2-4
    characters cut from the stored texts, EN words), each planned with
    ``plan_positional`` until POSITIONAL_TERMS plans are made. -> (plans
    [(term, plan, tid_offsets)], refusals by bucket, terms drawn)."""
    import numpy as np
    from mygramdb_tpu_torch.utils import textproc
    dev, t = ctx.index.device, ctx.table_cfg
    rng = np.random.default_rng(seed + 7)
    ja = [d for d in rng.integers(1, len(texts), 20_000).tolist()
          if texts[d] and not texts[d].isascii()]
    cands = []
    for i, d in enumerate(ja):
        L = 2 + i % 3
        if len(texts[d]) > L:
            p = int(rng.integers(0, len(texts[d]) - L))
            cands.append(texts[d][p:p + L])
    words = [w for w in gen.vocab[300:20_000] if len(w) >= 3
             and w not in KEYWORDS]
    en = [words[i] for i in rng.permutation(len(words))]
    # CJK and EN alternate, so both kinds are planned
    pool = [x for pair in zip(cands, en) for x in pair]
    plans, refused, seen, drawn = [], {}, set(), 0
    for term in pool:
        if len(plans) >= POSITIONAL_TERMS:
            break
        norm = ctx.normalize(term)
        if norm in seen or not norm or " " in norm:
            continue
        seen.add(norm)
        drawn += 1
        pairs, covered = textproc.query_gram_offsets(
            norm, t.ngram_size, t.kanji_ngram_size, t.cross_boundary_ngrams,
            kanji_extra=ctx.kanji_extra_effective)
        to = [(ctx.index.term_dict.get(g), o) for g, o in pairs]
        if not covered or not pairs:
            refused["uncovered"] = refused.get("uncovered", 0) + 1
            continue
        if any(tid is None for tid, _ in to):
            refused["missing_gram"] = refused.get("missing_gram", 0) + 1
            continue
        plan = dev.plan_positional(to)
        if plan is None:
            why = positional_refusal(dev, to)
            refused[why] = refused.get(why, 0) + 1
            continue
        plans.append((norm, plan, to))
    check(len(plans) >= 200, f"only {len(plans)} positional plans of "
          f"{drawn} terms: refused {refused}")
    return plans, refused, drawn


def starts_of(text: str, term: str) -> int:
    """Start positions of term in text, overlapping ones too."""
    n, i = 0, text.find(term)
    while i >= 0:
        n += 1
        i = text.find(term, i + 1)
    return n


def positional_expect(ref, term: str, plan: dict, to, form: str,
                      idf: float, avgdl: float, removed, cache: dict):
    """The reference answer of one positional query: substring
    containment over the stored normalized texts (candidates from the
    host CSR), tombstoned rows removed, the status filter, BM25 with every
    start position (overlapping ones too) as TF. cache holds each term's
    matching ids. -> (count, ids in page order, scores by id or None,
    pre)."""
    import numpy as np
    f = POSITIONAL_FORMS[form]
    if term not in cache:
        cache[term] = np.asarray(
            [d for d in ref.term_ids(term).tolist()
             if term in ref.texts[d] and d not in removed], dtype=np.int64)
    ids = cache[term]
    if f.get("filter"):
        ids = ids[ref.status[ids] == 1]
    if f.get("force_probes"):
        live = reduce(np.intersect1d, [ref.built.postings_of(t)
                                       for t, _ in to])
        pre = int(np.isin(live, list(removed), invert=True).sum())
    else:
        pre = plan["d_len"]  # the driver's doc count
    scores = None
    if f.get("score_mode"):
        tf = np.asarray([starts_of(ref.texts[d], term)
                         for d in ids.tolist()], dtype=np.float64)
        norm = K1_BM25 * (1.0 - B_BM25 + B_BM25 * ref.doc_len[ids] / avgdl)
        sc = idf * tf * (K1_BM25 + 1.0) / (tf + norm)
        scores = dict(zip(ids.tolist(), sc.tolist()))
        order = np.lexsort((-ids, -sc))
        page = ids[order]
    else:
        page = ids[::-1] if f["descending"] else ids
    return int(ids.size), page, scores, pre


def positional_mismatch(want, got, n: int):
    """None when a positional answer is right: count, pre and the page
    (n ids) exact; a score page ranked within the serve's 1e-5 relative
    rule, each returned score within 1e-5 of the reference's."""
    import numpy as np
    count, page, scores, pre = want
    total, ids, sc, gpre = got
    if (total, gpre) != (count, pre):
        return f"count/pre {total}/{gpre}, want {count}/{pre}"
    ids = [int(x) for x in ids[:n]]
    live = [d for d in ids if d >= 0]
    if len(live) != min(n, count) or any(d >= 0 for d in ids[len(live):]):
        return f"a page of {min(n, count)}, got {ids[:12]}"
    if scores is None:
        want_ids = page[:n].tolist()
        return None if live == want_ids else f"ids {live[:8]} want " \
            f"{want_ids[:8]}"
    want_sc = np.asarray([scores[d] for d in page[:n].tolist()])
    if len(set(live)) != len(live) or any(d not in scores for d in live):
        return "a page of verified ids"
    got_ref = np.asarray([scores[d] for d in live])
    tol = 1e-5 * np.maximum(np.abs(want_sc), 1e-9)
    if (np.abs(got_ref - want_sc) > tol).any() or \
            (np.abs(np.asarray(sc[:len(live)]) - got_ref) > tol).any():
        return f"scores {list(zip(live, sc))[:5]} want " \
            f"{list(zip(page[:5].tolist(), want_sc[:5]))}"
    return None


def positional_batch_profile(dev, plans) -> dict:
    """The positional program alone (``positional_verify_batch``, no
    batcher) on the commonest bucket tuple of the planned terms, at each
    B of POSITIONAL_PROFILE_B: device ms and kernels a batch
    (torch.profiler), event ms, K3 launches a batch and the bytes bound
    (the occurrence doc ids and positions the batch reads, 8 B an
    occurrence, over the memory rate). Run before the serve's queries:
    after a serve torch.profiler records few launches."""
    import numpy as np
    from mygramdb_tpu_torch.ops import runtime
    from mygramdb_tpu_torch.ops.positional_ops import positional_verify_batch
    pp = dev.positional
    keys = {}
    for _, plan, _ in plans:
        k = tuple(plan[x] for x in ("C", "Co", "C2", "Co2", "G"))
        keys.setdefault(k, []).append(plan)
    key, group = max(keys.items(), key=lambda kv: len(kv[1]))
    out = {"bucket": dict(zip(("C", "Co", "C2", "Co2", "G"), key)),
           "plans_in_bucket": len(group)}
    for B in POSITIONAL_PROFILE_B:
        batch = [group[i % len(group)] for i in range(B)]
        n = min(100, key[1])

        def call():
            positional_verify_batch(
                dev.postings, pp.occ_doc, pp.occ_pos, dev.deleted,
                pp.doc_len, batch, n, dev.n_words, True)
        before = runtime.launch_forms["slice_gather.positional"]
        call()
        launches = runtime.launch_forms["slice_gather.positional"] - before
        occ = sum(p["d_olen"] + sum(p["p_olen"]) for p in batch)
        out[f"B={B}"] = {"k3_launches": launches, "occurrences": occ,
                         **bound(8 * occ, 0)}
        if dev._device.type == "cuda":  # a CPU rehearsal times nothing
            prof = device_profile(call)
            out[f"B={B}"].update(device_ms=prof["device_ms"],
                                 kernels=prof["kernels"], ms=cuda_ms(call))
    return out


def positional_phase(ctx, ref, plans, removed, conns: int = 64) -> dict:
    """Every planned term in every POSITIONAL_FORMS form from ``conns``
    threads through ``DeviceIndex.search_verified_positional`` (so the
    micro-batcher runs ``_execute_positional``), each answer held against
    ``positional_expect``. -> what was checked and measured."""
    import numpy as np
    from concurrent.futures import ThreadPoolExecutor
    from mygramdb_tpu_torch.ops import positional_ops, runtime
    dev = ctx.index.device
    batcher = dev.batcher
    check(batcher is not None, "the index has no micro-batcher")
    n_docs = ref.doc_len.size - 1
    live = np.ones(n_docs + 1, dtype=bool)
    live[0] = False
    live[list(removed)] = False
    avgdl = float(ref.doc_len[live].mean())
    row = ctx.filter_index.eq_bitmap_device("status", 1, dev.n_words,
                                            dev._device)
    check(row is not None, "no device row for status = 1")
    jobs = [(term, plan, to, form) for term, plan, to in plans
            for form in POSITIONAL_FORMS]
    sizes = []  # the batch sizes the batcher ran
    run = positional_ops.positional_verify_batch

    def counted(*a, **kw):
        sizes.append(len(a[5]))
        return run(*a, **kw)

    def ask(job):
        term, plan, to, form = job
        f = POSITIONAL_FORMS[form]
        idf = math.log(1.0 + n_docs / max(plan["d_len"], 1))
        got = dev.search_verified_positional(
            plan, f["limit"], f["descending"],
            score_mode=f.get("score_mode", False), idf=idf, k1=K1_BM25,
            b=B_BM25, avgdl=avgdl,
            force_probes=f.get("force_probes", False),
            extra_words=(row,) if f.get("filter") else ())
        return idf, got

    f0 = runtime.launch_forms["slice_gather.positional"]
    b0 = (batcher.batches_executed, batcher.queries_batched)
    positional_ops.positional_verify_batch = counted
    t0 = time.perf_counter()
    try:
        with ThreadPoolExecutor(conns) as ex:
            answers = list(ex.map(ask, jobs))
    finally:
        positional_ops.positional_verify_batch = run
    wall = time.perf_counter() - t0
    batches = batcher.batches_executed - b0[0]
    launches = runtime.launch_forms["slice_gather.positional"] - f0
    t0 = time.time()
    bad, nonzero, cache = [], 0, {}
    for (term, plan, to, form), (idf, got) in zip(jobs, answers):
        n = min(POSITIONAL_FORMS[form]["limit"], plan["Co"])
        want = positional_expect(ref, term, plan, to, form, idf, avgdl,
                                 removed, cache)
        nonzero += want[0] > 0
        why = positional_mismatch(want, got, n)
        if why is not None:
            bad.append((term, form, why[:200]))
    check(not bad, f"{len(bad)} positional answers differ from the "
                   f"reference, first: {bad[:5]}")
    check(nonzero > len(jobs) // 2, "too few positional queries matched")
    by_size = {}
    for s in sizes:
        by_size[s] = by_size.get(s, 0) + 1
    return {"queries": len(jobs), "terms": len(plans), "mismatches": 0,
            "nonzero_answers": nonzero, "removed": len(removed),
            "qps": len(jobs) / wall, "batches": batches,
            "avg_batch": (batcher.queries_batched - b0[1]) / max(batches, 1),
            "most_served_batch": max(by_size, key=by_size.get),
            "batch_sizes": dict(sorted(by_size.items())),
            "k3_launches": launches,
            "k3_launches_a_batch": launches / max(batches, 1),
            "reference_s": time.time() - t0}


def positional_bytes(dev) -> dict:
    """The positional index's device bytes, its build seconds and the
    bytes the uncompacted CSR adds (the dense terms' slices)."""
    import numpy as np
    pp = dev.positional
    dense = dev.dense_row >= 0
    return {"occurrences": int(pp.occ_doc.numel()),
            "occ_doc_bytes": int(pp.occ_doc.numel() * 4),
            "occ_pos_bytes": int(pp.occ_pos.numel() * 4),
            "occ_pos_bytes_as_u16": int(pp.occ_pos.numel() * 2),
            "doc_len_bytes": int(pp.doc_len.numel() * 4),
            "extra_csr_bytes": int(dev.lengths[dense].astype(np.int64).sum()
                                   * 4) if dense.any() else 0,
            "positional_bytes": pp.memory_usage(),
            "build": {**pp.upload_detail, **dev.upload_detail}}


MESH_DOCS = 300_000   # documents of the mesh phase's synthetic index


def shard_count() -> int:
    """2 shards on a host of one card, else one a card, up to 8."""
    import torch
    n = torch.cuda.device_count()
    return 2 if n == 1 else min(n, 8)


class SyntheticBuilt:
    """A ``BuiltIndex`` stand-in: V terms with Zipf-like document
    frequencies (0.3 n / rank^0.8 + 16) over n documents, random sorted
    ids per term."""

    def __init__(self, rng, n_docs: int, V: int):
        import numpy as np
        df = (0.3 * n_docs / np.arange(1, V + 1) ** 0.8).astype(np.int64) + 16
        tid = np.repeat(np.arange(V, dtype=np.int64), df)
        key = np.unique(tid * (n_docs + 1)
                        + rng.integers(1, n_docs + 1, size=tid.size))
        self.postings = (key % (n_docs + 1)).astype(np.int32)
        self.lengths = np.bincount(key // (n_docs + 1),
                                   minlength=V).astype(np.int32)
        self.offsets = np.zeros(V, dtype=np.int64)
        np.cumsum(self.lengths[:-1], out=self.offsets[1:])
        self.n_terms, self.n_docs = V, n_docs
        self.max_doc_id = int(self.postings.max())
        self.positional = None

    def postings_of(self, t: int):
        o = int(self.offsets[t])
        return self.postings[o:o + int(self.lengths[t])]


def engine_check(devices) -> dict:
    """``__graft_entry__.dryrun_multichip`` on the card: a
    ``ShardedQueryEngine`` takes one delta-apply, then a batched query,
    held against numpy over the same bitmaps."""
    import numpy as np
    from mygramdb_tpu_torch.parallel.mesh import ShardedQueryEngine, make_mesh
    rng = np.random.default_rng(3)
    W = 1024 * len(devices)
    bm = np.zeros((16, W), dtype=np.uint32)
    bm[:14] = (rng.integers(0, 2 ** 32, size=(14, W), dtype=np.uint32)
               & rng.integers(0, 2 ** 32, size=(14, W), dtype=np.uint32))
    bm[14] = 0xFFFFFFFF
    dl = np.zeros(W, dtype=np.uint32)
    eng = ShardedQueryEngine(make_mesh(devices=devices), bm, dl, topk=16)
    tr = np.asarray([0, 0, 1, 2, 3], dtype=np.int32)
    di = np.asarray([33, 34, 65, 97, W * 32 - 1], dtype=np.int32)
    eng.apply_delta(tr, di)
    np.bitwise_or.at(bm, (tr, di >> 5), np.left_shift(
        np.uint32(1), (di & 31).astype(np.uint32)))
    rows = np.full((8, 4), 14, dtype=np.int32)
    rows[:, 0] = np.arange(8)
    rows[:, 1] = (np.arange(8) + 3) % 14
    counts, ids = eng.search(rows)
    for b in range(8):
        words = np.bitwise_and.reduce(bm[rows[b]], axis=0)
        docs = np.flatnonzero(np.unpackbits(words.view(np.uint8),
                                            bitorder="little"))
        check(int(counts[b]) == docs.size and
              ids[b][ids[b] >= 0].tolist() == docs[::-1][:16].tolist(),
              f"ShardedQueryEngine query {b} differs from numpy")
    return {"queries": 8, "delta_pairs": int(tr.size), "words": W}


def mesh_phase(docs: int = MESH_DOCS, device: str = "cuda") -> dict:
    """The port's mesh on the card: the engine check, then each sharded
    program against the port's single-device program over one synthetic
    index of MESH_DOCS documents and its text, exactly (BM25 scores to
    1e-5 relative): the dense program (``sharded_query_step``, K1 a
    shard), the sparse program's top-n (``sharded_sparse_query``, K3), a
    boolean tree (``sharded_ast_words``, K2) and the fused verify in count
    and score mode (``sharded_fused_verify``: K3's masked form, K6 over
    each shard's rows). Each pair is timed in the same call: device ms
    (torch.profiler) and event ms of the sharded program (the merge and
    its pull included) against the single-device one. device="cpu"
    rehearses the checks on the CPU (no timings)."""
    import numpy as np
    from mygramdb_tpu_torch.index.device_index import DeviceIndex
    from mygramdb_tpu_torch.ops import bitmap_ops, fused, runtime
    from mygramdb_tpu_torch.ops.posting_ops import (pack_sparse_args,
                                                    sparse_probe)
    from mygramdb_tpu_torch.parallel import mesh as pmesh
    from mygramdb_tpu_torch.storage.device_text import DeviceTextStore
    t_phase = time.time()
    S = shard_count() if device == "cuda" else 2
    devices = pmesh.default_devices(S, device)
    out = {"phase": "mesh", "shards": S, "docs": docs,
           "engine": engine_check(devices)}
    rng = np.random.default_rng(11)
    built = SyntheticBuilt(rng, docs, 3000)
    mesh = pmesh.make_mesh(devices=devices)
    m = DeviceIndex(built, mesh=mesh)
    one = DeviceIndex(built, device=device)
    out["layout"] = mesh.layout()
    vocab = ["".join(rng.choice(list("abcdefghijkl"), 3))
             for _ in range(400)]
    picks = rng.integers(0, 400, size=(docs, 40))
    n_words = rng.integers(8, 40, size=docs)
    texts = {d: " ".join(vocab[i] for i in picks[d - 1, :n_words[d - 1]])
             for d in range(1, docs + 1)}
    mst = DeviceTextStore(texts, m.n_docs_capacity,
                          doc_sharding=m.text_doc_sharding)
    sst = DeviceTextStore(texts, one.n_docs_capacity, device=device)
    del texts
    check(mst.doc_sharded and sst.codepoints.dim() == 2,
          "the mesh phase's text store is not padded and doc-sharded")
    dead = rng.choice(np.arange(1, docs + 1), docs // 100, replace=False)
    for idx in (m, one):
        idx.mark_deleted(dead.tolist())
    dense = np.flatnonzero(one.dense_row >= 0)
    sparse = np.flatnonzero(one.dense_row < 0)
    drivers = sparse[(built.lengths[sparse] > 64)
                     & (built.lengths[sparse] <= 2048)]
    B, Ws, Ds = 64, m.words_local, m.shard_docs
    checks, times = {}, {}
    runtime.reset_launches()

    def timed(name, fn_mesh, fn_one, shard_bound=None):
        """shard_bound: the bound of one shard's launch at W / S words."""
        if device != "cuda":
            return
        pm, po = device_profile(fn_mesh), device_profile(fn_one)
        times[name] = {"shard_shape": f"W/S={Ws}", **(shard_bound or {}),
                       "mesh_ms": cuda_ms(fn_mesh, 10),
                       "single_ms": cuda_ms(fn_one, 10),
                       "mesh_device_ms": pm["device_ms"],
                       "single_device_ms": po["device_ms"],
                       "mesh_kernels": pm["kernels"],
                       "single_kernels": po["kernels"]}

    # the dense program: K1 a shard, the merge (two of the commonest
    # dense terms a query, so that most queries match)
    common = dense[np.argsort(built.lengths[dense])[::-1][:8]]
    rows = rng.choice(common, size=(B, 2)).astype(np.int32)
    step = pmesh.sharded_query_step(mesh, n=128, shard_words=Ws)
    got_c, got_i = step([m.bitmaps], rows, [m.deleted])
    rows_t = runtime.to_device(rows, one._device)

    def dense_one():
        return bitmap_ops.dense_and_topn(one.bitmaps, rows_t, None, None,
                                         one.deleted, 128, True)[0]
    want = dense_one().cpu().numpy()
    check(np.array_equal(got_c, want[:, 0]) and
          np.array_equal(got_i, want[:, 1:]),
          "sharded_query_step differs from the single-device K1")
    checks["sharded_query_step"] = {"queries": B, "matches":
                                    int(got_c.sum())}
    distinct = len(np.unique(rows))
    timed("sharded_query_step B=64 K=2 n=128",
          lambda: step([m.bitmaps], rows, [m.deleted]), dense_one,
          bound(4 * ((distinct + 1) * Ws + B * 2 + B * 129), B * 3 * Ws))

    # the sparse program: K3's probe entry a shard, top-n; probes: a
    # sparse NOT term, a sparse term in every fourth query (an empty
    # inverted slot elsewhere), two common dense terms
    drv = rng.choice(drivers, B)
    sp = rng.choice(sparse, size=(B, 2))
    dn = rng.choice(common, size=(B, 2)).astype(np.int64)
    C = 2048
    Cmax = int(one._cand_bucket(int(built.lengths[sp].max())))
    pad = np.zeros((B, 2), dtype=bool)
    pad[:, 1] = np.arange(B) % 4 != 0
    inv = pad.copy()
    inv[:, 0] = True
    args = runtime.to_device(pack_sparse_args(
        one.dev_offsets[drv], built.lengths[drv], one.dev_offsets[sp],
        np.where(pad, 0, built.lengths[sp]), inv, dn,
        np.zeros((B, 2), dtype=bool)), one._device)
    sh = dict(C=C, Cmax=Cmax, limit_b=128, descending=True,
              shard_docs=Ds, words_local=Ws)
    sh_args = (m.offsets_sh[:, drv].T, m.lengths_sh[:, drv].T,
               m.offsets_sh[:, sp].transpose(1, 2, 0),
               np.where(pad[:, :, None], 0,
                        m.lengths_sh[:, sp].transpose(1, 2, 0)),
               np.repeat(inv[:, :, None], S, axis=2), dn,
               np.zeros((B, 2), dtype=bool))

    def sparse_mesh():
        return pmesh.sharded_sparse_query(mesh, m.postings_sh, m.bitmaps,
                                          m.deleted, *sh_args, **sh)

    def sparse_one():
        return sparse_probe(one.postings, one.bitmaps, one.deleted, None,
                            args, Ks=2, Kd=2, C=C, Cmax=Cmax,
                            n_words=one.n_words, form="topn", width=128,
                            descending=True)
    got = sparse_mesh()
    check(np.array_equal(got, sparse_one().cpu().numpy()),
          "sharded_sparse_query differs from the single-device K3")
    checks["sharded_sparse_query"] = {"queries": B,
                                      "matches": int(got[:, 0].sum())}
    d0, l0, so, sl, si = sh_args[:5]   # shard 0's launch, for its bound
    h0 = {"postings": m.postings_sh.parts[0].cpu().numpy(),
          "args": pack_sparse_args(d0[:, 0], l0[:, 0], so[..., 0],
                                   sl[..., 0], si[..., 0], *sh_args[5:])}
    timed("sharded_sparse_query B=64 C=2048 Ks=Kd=2 n=128", sparse_mesh,
          sparse_one, bound(probe_bytes(h0, 2, 2, C, 0, True, True,
                                        B * 129), 0))

    # a boolean tree: K2's tree program a shard, words concatenated
    sig = ("&", ("|", ("t", 0), ("t", 1)), ("!", ("t", 2)))
    leaves = [[int(rng.choice(dense)), int(rng.choice(drivers))],
              [int(rng.choice(sparse))], [int(rng.choice(dense))]]
    uni = [idx.universe_words(np.arange(1, docs + 1))
           for idx in (m, one)]
    got = m.ast_words(sig, leaves, uni[0])
    check(np.array_equal(got, one.ast_words(sig, leaves, uni[1])),
          "sharded_ast_words differs from the single-device K2 tree")
    checks["sharded_ast_words"] = {"trees": 1, "docs": int(np.unpackbits(
        got.view(np.uint8)).sum())}
    tree0 = {"rows": np.asarray([m.dense_row[t] for leaf in leaves
                                 for t in leaf if m.dense_row[t] >= 0]),
             "lens": np.asarray([m.lengths_sh[0, t] for leaf in leaves
                                 for t in leaf if m.dense_row[t] < 0])}
    timed("sharded_ast_words 3 leaves", lambda: m.ast_words(
        sig, leaves, uni[0]), lambda: one.ast_words(sig, leaves, uni[1]),
        bound(tree_bytes(tree0, sig, Ws), 0))

    # the fused verify: drivers of 65-2,048 docs (C = Kv = 2,048, the
    # probe-free masked form), one vocabulary word a query as its needle
    needles = np.zeros((B, 2, 32), dtype=np.uint32)
    nlens = np.zeros((B, 2), dtype=np.int32)
    for b in range(B):
        w = vocab[int(rng.integers(400))]
        needles[b, 0, :3] = [ord(x) for x in w]
        nlens[b, 0] = 3
    idf = np.zeros((B, 2), dtype=np.float32)
    idf[:, 0] = rng.uniform(0.5, 3.0, B)
    zeros = np.zeros((B, 1), dtype=np.int64)
    for score in (False, True):
        kw = dict(idf=idf, k1=1.2, b=0.75, avgdl=80.0, score_mode=score)

        def fused_mesh():
            return pmesh.sharded_fused_verify(
                mesh, m.postings_sh, m.bitmaps, m.deleted, mst,
                m.offsets_sh[:, drv].T, m.lengths_sh[:, drv].T,
                np.zeros((B, 1, S), dtype=np.int64),
                np.zeros((B, 1, S), dtype=np.int64),
                np.ones((B, 1, S), dtype=bool), needles, nlens, None,
                C=C, Cmax=C, Kv=C, n=128, maxT=mst.maxT, descending=True,
                shard_docs=Ds, words_local=Ws,
                dn_rows=np.full((B, 1), m.ones_row), **kw)

        def fused_one():
            return fused.sparse_search_verify_topn_batch(
                one.postings, one.bitmaps, one.deleted,
                one.dev_offsets[drv], built.lengths[drv], zeros, zeros,
                np.ones((B, 1), dtype=bool), zeros + one.ones_row,
                np.zeros((B, 1), dtype=bool), sst, C, C, 128, needles,
                nlens, one.n_words, True, Kv=C, maxT=sst.maxT,
                use_dense_probes=False, **kw)
        pre, clipped, count, ids, sc = pmesh.split_fused(fused_mesh(), 128,
                                                         score)
        want = fused_one()
        check(not clipped.any() and np.array_equal(pre, want[0])
              and np.array_equal(count, want[1])
              and np.array_equal(ids, want[2]),
              f"sharded_fused_verify (score={score}) differs from the "
              "single-device fused program")
        err = 0.0
        if score:
            finite = np.isfinite(want[3])
            check(np.array_equal(finite, np.isfinite(sc)),
                  "sharded BM25 pages differ in length")
            err = float(np.max(np.abs(sc[finite] - want[3][finite])
                               / np.maximum(np.abs(want[3][finite]), 1e-9)))
            check(err <= 1e-5, f"sharded BM25 scores off by {err}")
        mode = "score" if score else "count"
        checks[f"sharded_fused_verify {mode}"] = {
            "queries": B, "verified": int(count.sum()),
            "candidates": int(pre.sum()), "max_rel_err": err}
        timed(f"sharded_fused_verify {mode} B=64 C=Kv=2048 n=128",
              fused_mesh, fused_one)
    out.update({"checks": checks, "timings": times,
                "launches_by_shard": {s: dict(v) for s, v in
                                      runtime.launches_by_shard.items()},
                "launches_by_device": {d: dict(v) for d, v in
                                       runtime.launches_by_device.items()},
                "shard_index_bytes": m.shard_memory(),
                "shard_text_bytes": mst.shard_memory(),
                "seconds": time.time() - t_phase})
    for s in range(S if device == "cuda" else 0):
        for k in ("dense_and", "sparse_probe", "ast_words",
                  "tf_rows_padded"):
            check(out["launches_by_shard"].get(s, {}).get(k, 0) > 0,
                  f"shard {s} launched no {k} in the mesh phase")
    emit(out)
    return out


def serve_phase(name: str, docs: int, seed: int, n_queries: int,
                conns: int = 64, verified: bool = False,
                layout: str = "auto", profile_path: str = "",
                kernels=(), routes_needed=(), kinds: bool = False,
                forms_needed=(), measure_only: bool = False,
                profile_classes=None, mesh_shards: int = 1,
                fuzzy: bool = True, shard_launches=(),
                positional: bool = False, card: str = ""):
    """Load docs documents through ``Application``, serve n_queries over
    TCP from conns connections (with kinds, then the boolean, synonym and
    fuzzy queries and the ``search_or`` check), remove rows and re-ask;
    every answer is checked. kernels, routes_needed and forms_needed
    (launch forms) must each have served queries in this phase.
    measure_only (the paired profile runs, where the tree served may be an
    older one): no fuzzy queries, no removals, no launch or route
    requirements; answers are still checked. profile_classes: a predicate
    on the class names the profile times alone. mesh_shards > 1 serves a
    doc-sharded index (``device.mesh_shards``); shard_launches are the
    kernels and launch forms every shard must have launched. fuzzy=False
    leaves out the FUZZY queries. positional (a verified serve) builds the
    positional index (``device.positional_verify``) and runs the
    ``positional`` phase after the SEARCH/COUNT mix and again after the
    removals; its lines carry ``card``. -> (launches, summary)."""
    import numpy as np
    from mygramdb_tpu_torch import native
    from mygramdb_tpu_torch.app.application import Application
    from mygramdb_tpu_torch.config import load_config
    from mygramdb_tpu_torch.ops import runtime
    from mygramdb_tpu_torch.server.tcp_server import TcpServer

    t_phase = time.time()
    t0 = time.time()
    gen, seed_path, cfg_path, status, groups = write_inputs(
        docs, seed, verified, synonyms=kinds, mesh_shards=mesh_shards,
        positional=positional)
    t_corpus = time.time() - t0
    config = load_config(cfg_path)
    app = Application(config, seed_path=seed_path)
    os.environ["MYGRAM_TEXT_LAYOUT"] = layout
    t0 = time.time()
    try:
        app.initialize()
    finally:
        os.environ.pop("MYGRAM_TEXT_LAYOUT")
    t_init = time.time() - t0
    ctx = app.catalog.resolve("articles")
    check(ctx.doc_count == docs, f"loaded {ctx.doc_count} of {docs} docs")
    dev = ctx.index.device
    check(dev._device.type == runtime.device().type,
          f"index on {dev._device}")
    shards = 1 if dev.mesh is None else dev.mesh.shape["docs"]
    check(shards == mesh_shards, f"{shards} shards, asked for {mesh_shards}")
    dev.warmup()  # must not raise
    csr = dev.postings if dev.mesh is None else dev.postings_sh
    load = {"phase": name, "step": "load", "docs": ctx.doc_count,
            "corpus_s": t_corpus, "initialize_s": t_init,
            "n_words": dev.n_words, "dense_terms": dev.n_dense,
            "terms": int(dev.lengths.size),
            "device_postings": int(csr.numel()),
            "device_bytes": dev.memory_usage(),
            "native_host_library": native._load() is not None}
    if dev.mesh is not None:
        load.update({"mesh": dev.mesh.layout(),
                     "shard_index_bytes": dev.shard_memory(),
                     "shard_postings": [int(p.numel())
                                        for p in dev.postings_sh.parts]})
    texts = None
    if verified:
        st = ctx.fresh_device_text()
        check(st is not None, "no device text store")
        layout_got = "padded" if st.codepoints.dim() == 2 else "flat"
        check(layout in ("auto", layout_got),
              f"text layout {layout_got}, asked for {layout}")
        texts = [None] + ctx.doc_store.texts_batch(list(range(1, docs + 1)))
        load.update({"text_layout": layout_got, "maxT": st.maxT,
                     "text_dtype": np.dtype(st.dtype).name,
                     "text_shape": list(st.codepoints.shape),
                     "text_bytes": st.memory_usage(),
                     "text_overflow": len(st._overflow)})
        if dev.mesh is not None:
            check(st.doc_sharded, "the text store is not doc-sharded")
            load["shard_text_bytes"] = st.shard_memory()
        queries = make_verified_queries(
            gen, ctx, texts, n_queries, seed,
            skip={t for g in groups for t in g})
    else:
        queries = make_queries(gen, ctx, n_queries, seed)
    emit(load)
    ref = Reference(ctx, status, texts, groups)
    if positional:
        check(dev.positional is not None, "no positional index")
        check(np.array_equal(dev.positional.doc_len.cpu().numpy()[1:docs + 1],
                             ref.doc_len[1:]),
              "the positional doc lengths are not the texts' lengths")
        t0 = time.time()
        pos_plans, refused, drawn = positional_plans(gen, ctx, texts, seed)
        pos_line = {"phase": name, "step": "positional", "card": card,
                    **positional_bytes(dev), "terms_drawn": drawn,
                    "terms_planned": len(pos_plans),
                    "refused_by_bucket": refused,
                    "plan_s": time.time() - t0,
                    "profile": positional_batch_profile(dev, pos_plans)}
        emit(pos_line)
    kind_queries, kind_summary = [], {}
    if kinds:
        check(ctx.synonyms is not None
              and ctx.synonyms.group_count == len(groups),
              "the synonym file was not loaded")
        t0 = time.time()
        kind_queries, dropped = make_kind_queries(
            gen, ctx, ref, texts, groups, seed,
            fuzzy_terms=fuzzy and not measure_only)
        kind_summary = {"queries": len(kind_queries),
                        "fuzzy_dropped_for_cap": dropped,
                        "make_s": time.time() - t0}
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
        kind_results = []
        if kinds:
            # before the deletes: a boolean tree runs on the card only
            # while the table has no delta
            t0 = time.perf_counter()
            kind_results = asyncio.run(drive(srv.port, kind_queries, conns))
            kind_wall = time.perf_counter() - t0
            if not measure_only:
                kind_summary["search_or"] = search_or_check(
                    ctx, ref, [q["terms"][0] for q in queries[:12]])
            klat = sorted(s for _, _, s in kind_results)
            by_class = {}
            for q, _, sec in kind_results:
                by_class.setdefault(query_class(ctx, q), []).append(sec)
            kind_summary.update({
                "qps": len(kind_results) / kind_wall,
                "p50_ms": 1e3 * klat[len(klat) // 2],
                "p99_ms": 1e3 * klat[int(len(klat) * 0.99)],
                "classes": {k: {"queries": len(v), "p50_ms":
                                1e3 * sorted(v)[len(v) // 2]}
                            for k, v in sorted(by_class.items())},
                "routes_before_remove": dict(runtime.routes)})
        if positional:
            pos_runs = [positional_phase(ctx, ref, pos_plans, set(), conns)]
        first = results + kind_results
        # remove rows that answers contained; ask the queries whose
        # match sets held them again
        hit = sorted({int(p) for _, r, _ in first
                      if r.startswith("OK RESULTS") for p in r.split()[3:]})
        rng = np.random.default_rng(seed + 1)
        removed = set() if measure_only else set(int(x) for x in rng.choice(
            hit, size=min(100, len(hit)), replace=False))
        again = [q for q, _, _ in first
                 if removed.intersection(ref.ids(q).tolist())]
        for pk in removed:
            check(ctx.remove_row(str(pk)) is not None, f"remove {pk}")
        results2 = asyncio.run(drive(srv.port, again, conns))
        if positional:
            pos_runs.append(positional_phase(ctx, ref, pos_plans, removed,
                                             conns))
            prof = pos_line["profile"]
            served_b = pos_runs[0]["most_served_batch"]
            at = min([b for b in POSITIONAL_PROFILE_B if b >= served_b],
                     default=POSITIONAL_PROFILE_B[-1])
            emit({"phase": name, "step": "positional_served",
                  "card": pos_line["card"],
                  "before_remove": pos_runs[0], "after_remove": pos_runs[1],
                  "profile_B=1": prof["B=1"],
                  f"profile_most_served_B={at}": prof[f"B={at}"]})
        launches = dict(runtime.launches)
        forms = dict(runtime.launch_forms)
        routes = dict(runtime.routes)
        by_shard = {s: dict(v) for s, v in runtime.launches_by_shard.items()}
        by_device = {d: dict(v)
                     for d, v in runtime.launches_by_device.items()}
        shapes = {k: sorted(v.items(), key=lambda kv: -kv[1])
                  for k, v in runtime.launch_shapes.items()}
        b1 = (batcher.batches_executed, batcher.queries_batched)
        t0 = time.time()
        bad = []
        for answered, gone in ((first, set()), (results2, removed)):
            ref.removed = gone
            for q, resp, _ in answered:
                want = ref.mismatch(q, resp)
                if want is not None:
                    bad.append((q["line"], resp[:200], want[:200]))
        t_ref = time.time() - t0
        errors = sum(1 for _, r, _ in first + results2
                     if not r.startswith("OK"))
        lat = sorted(s for _, _, s in results)
        avg_batch = (b1[1] - b0[1]) / max(b1[0] - b0[0], 1)
        classes = {}
        for q in queries:
            k = query_class(ctx, q)
            classes[k] = classes.get(k, 0) + 1
        summary = {
            "phase": name, "docs": docs, "queries": len(results),
            "requeried_after_remove": len(results2), "removed": len(removed),
            "mismatches": len(bad), "errors": errors, "connections": conns,
            "qps": len(results) / wall, "p50_ms": 1e3 * lat[len(lat) // 2],
            "p99_ms": 1e3 * lat[int(len(lat) * 0.99)],
            "batches": b1[0] - b0[0], "avg_batch": avg_batch,
            "nonzero_answers": sum(1 for _, r, _ in results
                                   if r not in ("OK RESULTS 0",
                                                "OK COUNT 0")),
            "launches": launches, "launch_forms": forms, "routes": routes,
            "query_classes": classes, "reference_s": t_ref}
        if verified:
            summary["maxT"] = st.maxT
        if kinds:
            kind_summary.update({
                "requeried_after_remove": sum(1 for q in again
                                              if q.get("kind")),
                "delta_docs_after_remove": len(ctx.index.delta),
                "nonzero_answers": sum(1 for _, r, _ in kind_results
                                       if r not in ("OK RESULTS 0",
                                                    "OK COUNT 0"))})
            summary["kinds"] = kind_summary
        summary["launch_shapes"] = {k: [[*shape, n] for shape, n in v[:6]]
                                    for k, v in shapes.items() if v}
        if shards > 1:
            summary.update({"mesh": dev.mesh.layout(),
                            "launches_by_shard": by_shard,
                            "launches_by_device": by_device})
        check(not bad, f"{len(bad)} answers differ from the reference, "
                       f"first: {bad[:5]}")
        check(len(results) >= n_queries, "too few queries answered")
        check(summary["nonzero_answers"] > len(results) // 3,
              "too few queries matched anything")
        if measure_only:
            kernels = routes_needed = forms_needed = ()
        for f in forms_needed:
            check(forms[f] > 0, f"no launch of form {f}: {forms}")
        for k in kernels:
            check(launches[k] > 0,
                  f"{k} was not launched by the served queries: {launches}")
        for r in routes_needed:
            check(routes[r] > 0, f"no query took the {r} route: {routes}")
        if shards > 1 and not measure_only:
            for s in range(shards):
                for k in shard_launches:
                    check(by_shard.get(s, {}).get(k, 0) > 0,
                          f"shard {s} ({dev.mesh.docs_devices[s]}) launched "
                          f"no {k}: {by_shard.get(s)}")
            # the sharded fused program takes most verified queries with a
            # sparse driver; the rest clip or go exact
            fused_sparse = routes["mesh_fused_sparse"]
            check(fused_sparse > routes["mesh_to_exact"]
                  + routes["fused_clipped"],
                  f"mesh_fused_sparse took too few queries: {routes}")
        if kinds:
            check(kind_summary["nonzero_answers"] > len(kind_results) // 3,
                  "too few boolean, synonym and fuzzy queries matched")
        if not verified and not measure_only:
            # FILTER queries ride K1 as filter rows
            check(forms["dense_and.extra_rows"] > 0,
                  f"no K1 launch carried filter rows: {forms}")
            # dense SEARCHes take their ids from K1 itself
            check(forms["dense_and.topn"] > 0,
                  f"no K1 launch took the top-n: {forms}")
            check(avg_batch > 1,
                  f"micro-batcher average batch {avg_batch} <= 1")
        summary["host_max_rss_gb"] = resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
        summary["seconds"] = time.time() - t_phase
        emit(summary)
        if profile_path:
            profile_phase(srv.port, ctx, queries + kind_queries,
                          profile_path, name, classes=profile_classes)
    finally:
        asyncio.run_coroutine_threadsafe(srv.stop(), loop).result(60)
        loop.call_soon_threadsafe(loop.stop)
        server_thread.join(30)
    return launches, summary


def query_class(ctx, q: dict) -> str:
    """The query's command and clauses, and the kind of each of its terms:
    "dense" (every gram a bitmap row), "sparse" (a sparse driver with more
    grams to probe), "covered" (one sparse gram: probe-free) or "nogram"."""
    if q.get("kind"):
        return q["cmd"] + {"bool": " BOOLEAN", "syn": " SYNONYM",
                           "fuzzy": " FUZZY"}[q["kind"]]
    kinds = set()
    for t in q["terms"]:
        k = term_kind(ctx, t)
        kinds.add({None: "nogram", "probed": "sparse",
                   "single": "covered"}.get(k, k))
    return (q["cmd"] + (" NOT" if q.get("not") else "")
            + (" FILTER" if q.get("filter") else "")
            + (" AND" if len(q["terms"]) > 1 else "")
            + (" SCORE" if q.get("score") else "")
            + " [" + ",".join(sorted(kinds)) + "]")


def profile_phase(port: int, ctx, queries, path: str, serve: str,
                  per_class: int = 400, classes=None) -> None:
    """Each query class with at least 30 queries (and, given the predicate
    ``classes``, a name it accepts) alone, per_class of them at 64
    connections, 60 at one; then torch.profiler over 1,500 mixed queries
    at 64 connections. Prints and appends one JSON line per row to
    path."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    batcher = ctx.index.device.batcher
    out = open(path, "a")

    def put(obj, show=True):
        obj = {"serve": serve, **obj}
        out.write(json.dumps(obj) + "\n")
        if show:
            emit(obj)

    groups = {}
    for q in queries:
        groups.setdefault(query_class(ctx, q), []).append(q)
    for name, qs in sorted(groups.items(), key=lambda kv: -len(kv[1])):
        if len(qs) < 30 or (classes is not None and not classes(name)):
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
    busy = sum(dev_us(e) for e in events) / 1e6

    def calls(match):
        return sum(e.count for e in events if match(e.key))

    put({"phase": "profile", "class": "mix", "connections": 64,
         "queries": len(res), "window_s": wall, "qps": len(res) / wall,
         "device_busy_s": busy, "device_busy_share": busy / wall,
         # cluster kernels (K1, K3's probe entry) launch through
         # cudaLaunchKernelExC
         "kernel_launches": calls(lambda k: k in ("cudaLaunchKernel",
                                                  "cudaLaunchKernelExC")),
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
    ap.add_argument("--docs", type=int, default=1_100_000,
                    help="documents of the verified serve (padded layout)")
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--profile", default="", metavar="PATH",
                    help="after the verified and the unverified serve, "
                         "profile each query class; rows go to PATH")
    ap.add_argument("--kernel-timing", action="store_true",
                    help="only build the kernels and time the sparse, "
                         "fused-sparse and boolean programs (entry points "
                         "every tree of the port has, so a copy of this "
                         "script times an older tree beside it) and, where "
                         "the tree has them, K3's probe entry and K2's "
                         "tree entry; prints no result line")
    ap.add_argument("--pair-profile", default="", metavar="PATH",
                    help="only the verified serve (without fuzzy queries) "
                         "and the unverified serve, each answer checked, "
                         "no removals and no launch requirements, with the "
                         "sparse, boolean and synonym classes profiled "
                         "into PATH (a copy of this script in an older "
                         "tree's checkout measures that tree); prints no "
                         "result line")
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
    for path in (args.profile, args.pair_profile):
        if path:
            open(path, "w").close()  # the serves append their rows
    t_start = time.time()
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
        if args.kernel_timing:
            from mygramdb_tpu_torch.ops import posting_ops
            out = {"phase": "kernel_timing", "card": card,
                   "programs": program_numbers(gen)}
            if hasattr(posting_ops, "sparse_probe"):
                out["sparse_probe"] = {
                    "topn B=64": sparse_probe_numbers(
                        gen, "topn", 64, 2048, 8, 8, 128, 3),
                    "topn B=1": sparse_probe_numbers(
                        gen, "topn", 1, 2048, 8, 8, 128, 3),
                    "compact B=64": sparse_probe_numbers(
                        gen, "compact", 64, 8192, 8, 8, 4096, 1)}
                out["ast_words"] = ast_words_numbers(gen, 3, 4, 2)
            emit(out)
            return 0
        if args.pair_profile:
            # the classes whose programs this comparison is about
            def touched(name):
                return any(k in name for k in ("sparse", "covered",
                                               "BOOLEAN", "SYNONYM"))
            serve_phase("verified_serve", args.docs, args.seed, 1500,
                        verified=True, profile_path=args.pair_profile,
                        kinds=True, measure_only=True,
                        profile_classes=touched)
            serve_phase("plain_serve", PLAIN_DOCS, args.seed, 2400,
                        profile_path=args.pair_profile, measure_only=True)
            emit({"phase": "total", "seconds": time.time() - t_start})
            return 0
        t0 = time.time()
        timings = kernel_phase(gen)
        k1 = dense_topn_phase(gen)
        # K1's line: the micro-batcher's batched program
        timings["dense_and"].update(k1["topn B=64"])
        k2_at_k1_shape = reduce_rows_phase(gen)
        probe_checked = sparse_probe_checks(gen)
        tree_checked = ast_words_checks(gen)
        emit({"phase": "kernels", "kernel": "sparse_probe (K3)",
              "checked": probe_checked})
        emit({"phase": "kernels", "kernel": "ast_words (K2)",
              "checked": tree_checked})
        program_numbers(gen)
        # the new entries' device time at the shapes the serves launch
        # most (torch.profiler records no device time after a serve, so
        # these run first; the served shapes are timed again after)
        pre = [sparse_probe_numbers(gen, *shape) for shape in (
            ("topn", 1, 2048, 1, 1, 128, 0), ("masked", 1, 512, 8, 8, 512, 0),
            ("compact", 1, 2048, 1, 1, 2048, 3),
            ("topn", 64, 2048, 8, 8, 128, 3))]
        pre += [ast_words_numbers(gen, T, K, S)
                for T, K, S in ((3, 4, 1), (3, 12, 1), (3, 4, 2))]
        pre = {r["shape"]: r for r in pre}
        emit({"phase": "kernels", "pre_serve_timings": pre})
        timings.update(verify_kernel_phase(gen, args.docs))
        timings["row_gather"] = row_gather_phase(gen)
        emit({"phase": "kernels", "seconds": time.time() - t0})
        launches = {"row_gather": probe_phase()}
        mesh_phase()
        verified_routes = ("fused_dense", "fused_sparse", "verify_exact")
        got, served = serve_phase(
            "verified_serve", args.docs, args.seed, 1500, verified=True,
            profile_path=args.profile, kinds=True, positional=True,
            card=card,
            kernels=("dense_and", "reduce_rows", "ast_words", "slice_gather",
                     "sparse_probe", "tf_rows_padded"),
            routes_needed=verified_routes + (
                "ast_device", "threshold_merge", "threshold_bitmap",
                "or_rows"),
            # unions run K2's row reduce; the fused sparse program
            # compacts; the positional program gathers through K3
            forms_needed=("reduce_rows.or", "sparse_probe.compact",
                          "slice_gather.positional"))
        shapes = served["launch_shapes"]
        # K2's lines: the shapes that took most of the served launches
        op, B, K, W, _ = shapes["reduce_rows"][0]
        timings["reduce_rows"] = reduce_rows_numbers(gen, op, B, K, W)
        emit({"phase": "kernels", "kernel": "reduce_rows (K2)",
              "most_launched_shape": timings["reduce_rows"],
              "at_dense_and_shape": k2_at_k1_shape})
        T, K, S, _, W, _ = shapes["ast_words"][0]
        timings["ast_words"] = with_device_ms(
            ast_words_numbers(gen, T, K, S, W), pre)
        timings["ast_words"]["max_abs_err"] = tree_checked["max_abs_err"]
        emit({"phase": "kernels", "kernel": "ast_words (K2)",
              "most_launched_shape": timings["ast_words"],
              "served_shapes": shapes["ast_words"]})
        launches["reduce_rows"] = got["reduce_rows"]
        launches["ast_words"] = got["ast_words"]
        launches["slice_gather"] = got["slice_gather"]
        check(served["maxT"] == TEXT_MAXT,
              f"the verified serve's maxT is {served['maxT']}: the kernel "
              f"phase checked K6 at rows of {TEXT_MAXT} + NEEDLE_CAP cells")
        launches["tf_rows_padded"] = got["tf_rows_padded"]
        # K6's line: the shape that took most of the served launches
        whole = served["launch_forms"]["tf_rows_padded.whole_rows"]
        timings["tf_rows_padded"] = timings[
            "tf_rows_padded/store" if 2 * whole > got["tf_rows_padded"]
            else "tf_rows_padded"]
        # the same corpus and mix, doc-sharded (no FUZZY: a mesh counts
        # fuzzy candidates on the host)
        serve_phase(
            "sharded_serve", args.docs, args.seed, SHARDED_QUERIES,
            verified=True, kinds=True, fuzzy=False,
            mesh_shards=shard_count(),
            routes_needed=("mesh_dense", "mesh_sparse", "mesh_fused_sparse",
                           "mesh_fused_dense", "mesh_ast", "mesh_or"),
            shard_launches=("dense_and", "ast_words", "sparse_probe.topn",
                            "sparse_probe.compact", "tf_rows_padded"))
        got, _ = serve_phase(
            "flat_verified_serve", FLAT_DOCS, args.seed + 2, 1000,
            verified=True, layout="flat",
            kernels=("sparse_probe", "tf_rows_flat", "tf_rows_flat_global"),
            routes_needed=verified_routes)
        launches["tf_rows_flat"] = got["tf_rows_flat"]
        launches["tf_rows_flat_global"] = got["tf_rows_flat_global"]
        got, served = serve_phase(
            "plain_serve", PLAIN_DOCS, args.seed, 2400,
            profile_path=args.profile,
            kernels=("dense_and", "sparse_probe"),
            routes_needed=("dense_batched", "dense_unbatched",
                           "sparse_batched"),
            forms_needed=("sparse_probe.topn",))
        launches["dense_and"] = got["dense_and"]
        launches["sparse_probe"] = got["sparse_probe"]
        # K3's probe line: the shape that took most of the served launches
        form, B, C, Ks, Kd, width, probes, _ = \
            served["launch_shapes"]["sparse_probe"][0]
        timings["sparse_probe"] = with_device_ms(sparse_probe_numbers(
            gen, form, B, C, Ks, Kd, width, probes), pre)
        timings["sparse_probe"]["max_abs_err"] = probe_checked["max_abs_err"]
        emit({"phase": "kernels", "kernel": "sparse_probe (K3)",
              "most_launched_shape": timings["sparse_probe"],
              "served_shapes": served["launch_shapes"]["sparse_probe"]})
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    emit({"phase": "total", "seconds": time.time() - t_start})
    print(card)
    rows = []
    for name, (source, replaces) in KERNELS.items():
        t = timings[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"],
                     "library_ms": t.get("library_ms"),
                     "device_ms": t.get("device_ms"),
                     "shape": t["shape"]})
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
