"""The whole slice: ``TableCatalog``, ``ServerCore`` and ``TcpServer`` from
both namespaces on one synthetic corpus. Every SEARCH and COUNT response
line (dense, sparse, covered CJK, NOT, FILTER, zero-hit) must be
byte-identical, also with ``memory.verify_text: all`` and ``SORT _score``
(the fused verified search, the text store's exact-path verify and BM25).
A kernel failure or another device fault on a filtered query answers
ERROR; filter rows raced by a segment swap take the exact path. A
subprocess serves
the port's slice with JAX blocked and shows that neither JAX nor a
JAX-package device module was loaded."""

import asyncio
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mygramdb_tpu.catalog import TableCatalog as JCatalog
from mygramdb_tpu.config import load_config_from_dict
from mygramdb_tpu.server.core import ServerCore as JCore
from mygramdb_tpu.server.tcp_server import TcpServer as JTcp
from mygramdb_tpu.utils.corpusgen import CorpusGenerator
from mygramdb_tpu_torch.catalog import TableCatalog as TCatalog
from mygramdb_tpu_torch.ops import (bitmap_ops, posting_ops, runtime,
                                    verify_ops)
from mygramdb_tpu_torch.ops import fused as tfused
from mygramdb_tpu_torch.server.core import ServerCore as TCore
from mygramdb_tpu_torch.storage.filter_index import FilterIndex
from mygramdb_tpu_torch.server.tcp_server import TcpServer as TTcp

from torch_parity import torch_cpu  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = {
    "tables": [{"name": "articles", "text_source": {"column": "content"},
                "filters": [{"name": "status", "type": "int",
                             "bitmap_index": True}]}],
    "cache": {"enabled": False},
    "device": {"dense_df_ratio": 0.05},
    "api": {"tcp": {"bind": "127.0.0.1", "port": 0}},
    "network": {"allow_cidrs": ["127.0.0.0/8"]},
}
N_DOCS = 2500


def load(catalog_cls, gen, cfg_dict=CFG):
    cfg = load_config_from_dict(cfg_dict)
    cat = catalog_cls(cfg)
    ctx = cat.resolve("articles")
    bulk = ctx.begin_bulk_load()
    for batch in gen.batches(1000):
        bulk.add_batch([(str(i), t, {"status": i % 3}) for i, t in batch])
    bulk.finish()
    return cfg, cat, ctx


def query_lines(gen, ctx, n, seed=3):
    rng = np.random.default_rng(seed)
    words = [w for w in gen.vocab[:4000] if len(w) >= 2 and w not in
             ("and", "or", "not", "asc", "desc", "sort", "limit")]
    ja = gen.sample_ja_terms(200, term_len=2, rng=rng) + \
        gen.sample_ja_terms(50, term_len=1, rng=rng)
    terms = words[:300] + words[1000:1300] + ja + ["zqxv"]
    out = set()
    while len(out) < n:
        t = terms[int(rng.integers(len(terms)))]
        shape = int(rng.integers(6))
        if shape == 0:
            line = f"COUNT articles {t}"
        elif shape == 1:
            u = terms[int(rng.integers(len(terms)))]
            line = f"SEARCH articles {t} NOT {u} SORT id DESC LIMIT 20"
        elif shape == 2:
            line = f"SEARCH articles {t} FILTER status = 1 LIMIT 30"
        elif shape == 3:
            line = f"COUNT articles {t} FILTER status = 2"
        elif shape == 4:
            u = terms[int(rng.integers(len(terms)))]
            line = f"SEARCH articles {t} AND {u} SORT id ASC LIMIT 50"
        else:
            order = "ASC" if rng.integers(2) else "DESC"
            line = f"SEARCH articles {t} SORT id {order} LIMIT 100"
        out.add(line)
    return sorted(out)


@pytest.fixture(scope="module")
def slices(torch_cpu):
    gen = CorpusGenerator(N_DOCS, seed=77, vocab_size=20_000)
    jcfg, jcat, jctx = load(JCatalog, gen)
    tcfg, tcat, tctx = load(TCatalog, gen)
    return gen, (jcfg, jcat, jctx), (tcfg, tcat, tctx)


def test_core_responses_are_byte_identical(slices):
    gen, (jcfg, jcat, jctx), (tcfg, tcat, tctx) = slices
    jcore, tcore = JCore(jcfg, jcat), TCore(tcfg, tcat)
    lines = query_lines(gen, tctx, 240)
    answered = 0
    for line in lines:
        j, t = jcore.handle_line(line), tcore.handle_line(line)
        assert t == j, line
        assert t.startswith("OK"), (line, t)
        answered += t not in ("OK COUNT 0", "OK RESULTS 0")
    assert answered > len(lines) // 2
    dev = tctx.index.device
    assert dev.n_dense > 0 and dev.postings.numel() > 0
    # removing rows tombstones them on the device in both packages
    for pk in range(5, N_DOCS, 11):
        jctx.remove_row(str(pk))
        tctx.remove_row(str(pk))
    for line in lines[:80]:
        assert tcore.handle_line(line) == jcore.handle_line(line), line


def test_tcp_responses_are_byte_identical(slices):
    gen, (jcfg, jcat, jctx), (tcfg, tcat, tctx) = slices
    lines = query_lines(gen, tctx, 60, seed=9)

    async def ask(port):
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        out = []
        for line in lines:
            writer.write(line.encode() + b"\r\n")
            await writer.drain()
            out.append(await asyncio.wait_for(reader.readline(), 30))
        writer.close()
        return out

    async def main():
        servers = [JTcp(JCore(jcfg, jcat), jcfg), TTcp(TCore(tcfg, tcat),
                                                       tcfg)]
        for s in servers:
            await s.start()
        try:
            return await asyncio.gather(*[ask(s.port) for s in servers])
        finally:
            for s in servers:
                await s.stop()

    jout, tout = asyncio.run(main())
    assert tout == jout
    assert all(r.startswith(b"OK") for r in tout)


def word_of_kind(gen, ctx, dense: bool) -> str:
    """A vocabulary word whose grams are all dense rows (dense) or whose
    grams include a sparse term (not dense)."""
    from mygramdb_tpu_torch.utils import textproc
    t, dev = ctx.table_cfg, ctx.index.device
    for w in gen.vocab[:4000]:
        if len(w) < 3 or w in ("and", "not", "asc", "desc", "sort"):
            continue
        grams = textproc.generate_query_ngrams(
            ctx.normalize(w), t.ngram_size, t.kanji_ngram_size,
            t.cross_boundary_ngrams, kanji_extra=ctx.kanji_extra_effective)
        tids = [ctx.index.term_dict.get(g) for g in grams]
        if grams and None not in tids and \
                all(dev.dense_row[x] >= 0 for x in tids) == dense:
            return w
    raise AssertionError("no such word")


@pytest.mark.parametrize("dense", [True, False])
@pytest.mark.parametrize("cmd", ["SEARCH", "COUNT"])
def test_kernel_failure_on_filtered_query_answers_error(slices, monkeypatch,
                                                        dense, cmd):
    """A kernel failure on a FILTER query is an ERROR answer: the device
    fast path re-raises it, and the query is not re-run on the host."""
    gen, _, (tcfg, tcat, tctx) = slices
    core = TCore(tcfg, tcat)
    word = word_of_kind(gen, tctx, dense)
    line = f"{cmd} articles {word} FILTER status = 1"
    runtime.reset_launches()
    ok = core.handle_line(line)
    assert ok.startswith("OK") and ok not in ("OK COUNT 0", "OK RESULTS 0")
    ran = {k: v for k, v in runtime.routes.items() if v}
    assert ran == ({"dense_batched": 1} if dense and cmd == "SEARCH" else
                   {"dense_unbatched": 1} if dense else
                   {"sparse_batched": 1}), ran

    # the first launch fails, so a re-run on the host path would answer OK
    failed = []

    def fail_once(plain):
        def wrapper(*args):
            if not failed:
                failed.append(1)
                raise runtime.kernel_error("injected kernel failure")
            return plain(*args)
        return wrapper

    monkeypatch.setattr(bitmap_ops, "_dense_query_plain",
                        fail_once(bitmap_ops._dense_query_plain))
    monkeypatch.setattr(posting_ops, "_gather_slices_plain",
                        fail_once(posting_ops._gather_slices_plain))
    resp = core.handle_line(line)
    assert failed and resp.startswith("ERR"), resp
    assert "injected kernel failure" in resp, resp


VERIFIED_CFG = dict(CFG, memory={"verify_text": "all"})


@pytest.fixture(scope="module")
def verified_slices(torch_cpu):
    gen = CorpusGenerator(N_DOCS, seed=78, vocab_size=20_000)
    jcfg, jcat, jctx = load(JCatalog, gen, VERIFIED_CFG)
    tcfg, tcat, tctx = load(TCatalog, gen, VERIFIED_CFG)
    assert tctx.device_text is not None
    return gen, (jcfg, jcat, jctx), (tcfg, tcat, tctx)


def verified_lines(gen, n, seed=5):
    """CJK substrings of 3-4 characters cut from the corpus, EN words
    (some self-overlapping), two-term AND, NOT, FILTER, COUNT and
    SORT _score with one and two terms."""
    rng = np.random.default_rng(seed)
    ja = [t for b in gen.batches(1000) for _, t in b if not t.isascii()]
    words = [w for w in gen.vocab[:3000] if len(w) >= 3]
    borders = [w for w in words if verify_ops.has_self_overlap(w)][:40]

    def cjk():
        d = ja[int(rng.integers(len(ja)))]
        L = int(rng.integers(3, 5))
        p = int(rng.integers(0, len(d) - L))
        return d[p:p + L]

    def word():
        return words[int(rng.integers(len(words)))]

    shapes = [
        lambda: f"SEARCH articles {cjk()} SORT id DESC LIMIT 20",
        lambda: f"SEARCH articles {word()} LIMIT 30",
        lambda: f"SEARCH articles {word()} AND {cjk()} LIMIT 10",
        lambda: f"SEARCH articles {cjk()} NOT {word()} LIMIT 10",
        lambda: f"SEARCH articles {word()} FILTER status = 1 LIMIT 30",
        lambda: f"COUNT articles {cjk()}",
        lambda: f"COUNT articles {word()} FILTER status = 2",
        lambda: f"SEARCH articles {word()} SORT _score DESC LIMIT 10",
        lambda: f"SEARCH articles {cjk()} SORT _score DESC LIMIT 10",
        lambda: (f"SEARCH articles {word()} AND {word()} "
                 f"SORT _score DESC LIMIT 10"),
        lambda: (f"SEARCH articles "
                 f"{borders[int(rng.integers(len(borders)))]} "
                 f"SORT _score DESC LIMIT 10"),
    ]
    out = set()
    while len(out) < n:
        out.add(shapes[int(rng.integers(len(shapes)))]())
    return sorted(out)


def test_verified_tcp_responses_are_byte_identical(verified_slices):
    gen, (jcfg, jcat, jctx), (tcfg, tcat, tctx) = verified_slices
    lines = verified_lines(gen, 160)

    async def ask(port):
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        out = []
        for line in lines:
            writer.write(line.encode() + b"\r\n")
            await writer.drain()
            out.append(await asyncio.wait_for(reader.readline(), 60))
        writer.close()
        return out

    async def main():
        servers = [JTcp(JCore(jcfg, jcat), jcfg), TTcp(TCore(tcfg, tcat),
                                                       tcfg)]
        for s in servers:
            await s.start()
        try:
            return await asyncio.gather(*[ask(s.port) for s in servers])
        finally:
            for s in servers:
                await s.stop()

    runtime.reset_launches()
    jout, tout = asyncio.run(main())
    for line, j, t in zip(lines, jout, tout):
        assert t == j, line
    assert all(r.startswith(b"OK") for r in tout)
    assert sum(r not in (b"OK RESULTS 0\r\n", b"OK COUNT 0\r\n")
               for r in tout) > len(lines) // 2
    assert runtime.routes["fused_dense"] + runtime.routes["fused_sparse"] > 0


def test_kernel_failure_on_filtered_verified_query_answers_error(
        verified_slices, monkeypatch):
    """A window-TF kernel failure in a FILTER'ed verified query answers
    ERROR: the fused path re-raises it instead of moving the query to the
    exact host path."""
    gen, _, (tcfg, tcat, tctx) = verified_slices
    core = TCore(tcfg, tcat)
    ja = [t for b in gen.batches(1000) for _, t in b if not t.isascii()]
    line = f"SEARCH articles {ja[0][:3]} FILTER status = {1 % 3} LIMIT 10"
    runtime.reset_launches()
    assert core.handle_line(line).startswith("OK")
    assert runtime.routes["fused_dense"] + runtime.routes["fused_sparse"] \
        == 1, runtime.routes
    failed = []
    plain = verify_ops._tf_rows_plain

    def fail_once(*args, **kw):
        if not failed:
            failed.append(1)
            raise runtime.kernel_error("injected kernel failure")
        return plain(*args, **kw)

    monkeypatch.setattr(verify_ops, "_tf_rows_plain", fail_once)
    resp = core.handle_line(line)
    assert failed and resp.startswith("ERR"), resp
    assert "injected kernel failure" in resp, resp


def test_device_fault_on_filtered_verified_query_answers_error(
        verified_slices, monkeypatch):
    """A torch error around the kernels (an out-of-memory in the fused
    program's tail, say) in a FILTER'ed verified query answers ERROR as
    well: only filter rows raced by a segment swap send a query to the
    exact path."""
    gen, _, (tcfg, tcat, tctx) = verified_slices
    core = TCore(tcfg, tcat)
    ja = [t for b in gen.batches(1000) for _, t in b if not t.isascii()]
    line = f"SEARCH articles {ja[0][:3]} FILTER status = {1 % 3} LIMIT 10"
    assert core.handle_line(line).startswith("OK")

    def fault(*args, **kw):
        raise RuntimeError("injected device fault")

    monkeypatch.setattr(tfused, "_reduce_from_tf", fault)
    runtime.reset_launches()
    resp = core.handle_line(line)
    assert resp.startswith("ERR") and "injected device fault" in resp, resp
    assert runtime.routes["verify_exact"] == 0, runtime.routes


@pytest.mark.parametrize("verified", [False, True])
def test_raced_filter_rows_take_the_exact_path(request, monkeypatch,
                                               verified):
    """Filter rows of another width (made for another segment while a
    swap raced the query) move a FILTER'ed query to the exact path, which
    answers as the JAX package does."""
    gen, (jcfg, jcat, jctx), (tcfg, tcat, tctx) = request.getfixturevalue(
        "verified_slices" if verified else "slices")
    ja = [t for b in gen.batches(1000) for _, t in b if not t.isascii()]
    words = [w for w in gen.vocab[:200] if len(w) >= 3]
    lines = [f"SEARCH articles {ja[0][:3]} FILTER status = 1 LIMIT 10",
             f"SEARCH articles {words[0]} FILTER status = 2 LIMIT 30",
             f"COUNT articles {words[1]} FILTER status = 1"]
    jcore, tcore = JCore(jcfg, jcat), TCore(tcfg, tcat)
    want = [jcore.handle_line(x) for x in lines]
    eq = FilterIndex.eq_bitmap_device
    raced = []

    def other_segment(self, *args, **kw):
        row = eq(self, *args, **kw)
        raced.append(1)
        return None if row is None else torch.cat([row, row[:4]])

    monkeypatch.setattr(FilterIndex, "eq_bitmap_device", other_segment)
    got = [tcore.handle_line(x) for x in lines]
    assert raced and got == want
    assert sum(r not in ("OK RESULTS 0", "OK COUNT 0") for r in got) >= 2


@pytest.fixture(scope="module")
def kinds_slices(torch_cpu, tmp_path_factory):
    """A verified table with a synonym file holding an EN and a CJK group,
    loaded by both packages."""
    gen = CorpusGenerator(N_DOCS, seed=79, vocab_size=20_000)
    words = [w for w in gen.vocab[:3000] if len(w) >= 4]
    ja = [t for b in gen.batches(1000) for _, t in b if not t.isascii()]
    en_group = [words[3], words[40], words[700]]
    cjk_group = [ja[0][4:6], ja[1][10:13], words[5]]
    path = tmp_path_factory.mktemp("syn") / "synonyms.tsv"
    path.write_text("\t".join(en_group) + "\n" + "\t".join(cjk_group) + "\n",
                    encoding="utf-8")
    table = dict(VERIFIED_CFG["tables"][0],
                 synonyms={"enable": True, "file": str(path)})
    cfg = dict(VERIFIED_CFG, tables=[table])
    jcfg, jcat, jctx = load(JCatalog, gen, cfg)
    tcfg, tcat, tctx = load(TCatalog, gen, cfg)
    assert tctx.synonyms is not None and tctx.synonyms.group_count == 2
    return (gen, words, ja, en_group, cjk_group, (jcfg, jcat, jctx),
            (tcfg, tcat, tctx))


def kinds_lines(words, ja, en_group, cjk_group, seed=13):
    """Boolean trees (the shapes of tests/test_device_ast.py over common,
    rare and CJK terms), synonym queries and FUZZY 1 / FUZZY 2."""
    rng = np.random.default_rng(seed)
    grouped = set(en_group + cjk_group)
    pool = [w for w in words if w not in grouped]

    def en():
        return pool[int(rng.integers(400 if rng.integers(2) else len(pool)))]

    def cjk():
        d = ja[int(rng.integers(len(ja)))]
        L = int(rng.integers(2, 4))
        p = int(rng.integers(0, len(d) - L))
        return d[p:p + L]

    def typo(w):
        p = int(rng.integers(1, len(w) - 1))
        return w[:p] + w[p + 1] + w[p] + w[p + 2:]

    trees = [
        lambda: f"(({en()} OR {en()}) AND {en()})",
        lambda: f"({en()} AND NOT {en()})",
        lambda: f"(NOT {en()})",
        lambda: f"({en()} OR zzznope)",
        lambda: f"(({en()} OR {cjk()}) AND NOT ({en()} AND {en()}))",
        lambda: f"(({cjk()} OR {cjk()}) OR {en()})",
    ]
    out = []
    for i in range(36):
        cmd = "COUNT articles" if i % 6 == 5 else "SEARCH articles"
        tail = "" if i % 6 == 5 else " SORT id DESC LIMIT 100"
        out.append(f"{cmd} {trees[i % len(trees)]()}{tail}")
    for t in en_group + cjk_group:
        out.append(f"SEARCH articles {t} LIMIT 100")
        out.append(f"SEARCH articles {t} AND {en()} LIMIT 100")
        out.append(f"COUNT articles {t}")
    for i in range(12):
        w = en()
        out.append(f"SEARCH articles {w} FUZZY 1 LIMIT 100")
        out.append(f"SEARCH articles {typo(w)} FUZZY {1 + i % 2} LIMIT 100")
    out.append(f"SEARCH articles {cjk()} FUZZY 1 LIMIT 100")
    return out


def test_boolean_synonym_fuzzy_tcp_responses_are_byte_identical(kinds_slices):
    """A boolean expression, a term with synonyms and FUZZY 1|2 answer the
    same bytes from both servers, and the port's delta-free table takes
    the device tree (``device_ast`` / ``device_synonym_ast``)."""
    (gen, words, ja, en_group, cjk_group, (jcfg, jcat, jctx),
     (tcfg, tcat, tctx)) = kinds_slices
    lines = kinds_lines(words, ja, en_group, cjk_group)

    async def ask(port):
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        out = []
        for line in lines:
            writer.write(line.encode() + b"\r\n")
            await writer.drain()
            out.append(await asyncio.wait_for(reader.readline(), 60))
        writer.close()
        return out

    async def main():
        servers = [JTcp(JCore(jcfg, jcat), jcfg), TTcp(TCore(tcfg, tcat),
                                                       tcfg)]
        for s in servers:
            await s.start()
        try:
            return await asyncio.gather(*[ask(s.port) for s in servers])
        finally:
            for s in servers:
                await s.stop()

    runtime.reset_launches()
    jout, tout = asyncio.run(main())
    for line, j, t in zip(lines, jout, tout):
        assert t == j, line
    assert all(r.startswith(b"OK") for r in tout)
    assert sum(r not in (b"OK RESULTS 0\r\n", b"OK COUNT 0\r\n")
               for r in tout) > len(lines) // 2
    assert runtime.routes["ast_device"] >= 36
    assert runtime.routes["threshold_merge"] \
        + runtime.routes["threshold_bitmap"] >= 25

    from mygramdb_tpu_torch.query import QueryParser
    from mygramdb_tpu_torch.query.pipeline import SearchPipeline
    pipe = SearchPipeline(tctx, tcfg)
    for line, want in ((lines[0], "device_ast"),
                       (f"SEARCH articles {en_group[0]} LIMIT 10",
                        "device_synonym_ast")):
        out = pipe.execute(QueryParser().parse(line), want_debug=True)
        assert out.success, out.error
        assert out.debug.optimization_used == want, line


NO_JAX_SCRIPT = r"""
import json, os, sys
sys.modules["jax"] = None
os.environ["MYGRAM_TORCH_DEVICE"] = "cpu"
from mygramdb_tpu_torch.catalog import TableCatalog
from mygramdb_tpu_torch.config import load_config_from_dict
from mygramdb_tpu_torch.server.core import ServerCore
from mygramdb_tpu_torch.utils.corpusgen import CorpusGenerator
cfg = load_config_from_dict(json.loads(sys.argv[1]))
cat = TableCatalog(cfg)
ctx = cat.resolve("articles")
bulk = ctx.begin_bulk_load()
gen = CorpusGenerator(1500, seed=4, vocab_size=5000)
for batch in gen.batches(500):
    bulk.add_batch([(str(i), t, {"status": i % 3}) for i, t in batch])
bulk.finish()
ctx.add_row("99999", "delta row beyond the segment", {"status": 1})
core = ServerCore(cfg, cat)
lines = [f"SEARCH articles {w} SORT id DESC LIMIT 10" for w in gen.vocab[:40]]
lines += [f"COUNT articles {w} FILTER status = 1" for w in gen.vocab[:20]]
lines += [f"SEARCH articles {w} NOT {gen.vocab[0]}" for w in gen.vocab[1:20]]
lines += [f"SEARCH articles {t}" for t in gen.sample_ja_terms(20)]
out = [core.handle_line(x) for x in lines]
mods = sorted(m for m, v in sys.modules.items()
              if (v is not None and (m == "jax" or m.startswith("jax.")))
              or m.startswith("mygramdb_tpu.ops")
              or m.startswith("mygramdb_tpu.index")
              or m.startswith("mygramdb_tpu.parallel")
              or m == "mygramdb_tpu.storage.device_text")
print(json.dumps({"responses": out, "modules": mods,
                  "device": str(ctx.index.device.bitmaps.device)}))
"""


def test_port_slice_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", NO_JAX_SCRIPT,
                           json.dumps(CFG)], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["modules"] == []
    assert out["device"] == "cpu"
    assert all(r.startswith("OK") for r in out["responses"]), out
    assert sum(r not in ("OK RESULTS 0", "OK COUNT 0")
               for r in out["responses"]) > 40


@pytest.fixture(scope="module")
def mesh_slices(torch_cpu, tmp_path_factory, eight_cpu_devices):
    """The verified table with synonyms of ``kinds_slices`` at
    ``device.mesh_shards: 8``: the JAX package on its 8 virtual CPU
    devices, the port on 8 CPU shards, and the port at 1 shard."""
    gen = CorpusGenerator(N_DOCS, seed=80, vocab_size=20_000)
    words = [w for w in gen.vocab[:3000] if len(w) >= 4]
    ja = [t for b in gen.batches(1000) for _, t in b if not t.isascii()]
    en_group = [words[3], words[40], words[700]]
    cjk_group = [ja[0][4:6], ja[1][10:13], words[5]]
    path = tmp_path_factory.mktemp("syn") / "synonyms.tsv"
    path.write_text("\t".join(en_group) + "\n" + "\t".join(cjk_group) + "\n",
                    encoding="utf-8")
    table = dict(VERIFIED_CFG["tables"][0],
                 synonyms={"enable": True, "file": str(path)})
    one = dict(VERIFIED_CFG, tables=[table])
    eight = dict(one, device=dict(one["device"], mesh_shards=8))
    j8 = load(JCatalog, gen, eight)
    t8 = load(TCatalog, gen, eight)
    t1 = load(TCatalog, gen, one)
    assert j8[2].index.device.mesh is not None
    assert t8[2].index.device.mesh.shape["docs"] == 8
    assert t8[2].device_text.doc_sharded
    return gen, words, ja, en_group, cjk_group, j8, t8, t1


def test_mesh8_tcp_responses_are_byte_identical(mesh_slices):
    """At ``device.mesh_shards: 8`` every response (dense, sparse, NOT,
    FILTER, AND, SORT _score, boolean, synonym, FUZZY, then the same after
    deletes) is byte-identical to the JAX package's at 8 shards and to the
    port's at 1, and the port served through the mesh routes."""
    gen, words, ja, en_group, cjk_group, j8, t8, t1 = mesh_slices
    lines = (query_lines(gen, t8[2], 80, seed=21)
             + verified_lines(gen, 80, seed=23)
             + kinds_lines(words, ja, en_group, cjk_group, seed=25))

    async def ask(port, batch):
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        out = []
        for line in batch:
            writer.write(line.encode() + b"\r\n")
            await writer.drain()
            out.append(await asyncio.wait_for(reader.readline(), 60))
        writer.close()
        return out

    async def main(batch):
        servers = [JTcp(JCore(j8[0], j8[1]), j8[0]),
                   TTcp(TCore(t8[0], t8[1]), t8[0]),
                   TTcp(TCore(t1[0], t1[1]), t1[0])]
        for s in servers:
            await s.start()
        try:
            return await asyncio.gather(*[ask(s.port, batch)
                                          for s in servers])
        finally:
            for s in servers:
                await s.stop()

    runtime.reset_launches()
    jout, tout, oneout = asyncio.run(main(lines))
    for line, j, t, o in zip(lines, jout, tout, oneout):
        assert t == j, line
        assert t == o, line
    assert all(r.startswith(b"OK") for r in tout)
    assert sum(r not in (b"OK RESULTS 0\r\n", b"OK COUNT 0\r\n")
               for r in tout) > len(lines) // 2
    routes = dict(runtime.routes)
    for r in ("mesh_dense", "mesh_sparse", "mesh_fused_sparse",
              "mesh_fused_dense", "mesh_ast", "threshold_host"):
        assert routes[r] > 0, (r, routes)
    # the deletes reach every shard of both packages
    gone = [str(pk) for pk in range(3, N_DOCS, 7)]
    for ctx in (j8[2], t8[2], t1[2]):
        for pk in gone:
            ctx.remove_row(pk)
    jout, tout, oneout = asyncio.run(main(lines[:160]))
    for line, j, t, o in zip(lines, jout, tout, oneout):
        assert t == j == o, line


def test_mesh_search_or_matches(mesh_slices):
    """``search_or`` on the mesh (K2's OR a shard) over dense and sparse
    terms equals the port's at 1 shard and the JAX package's at 8."""
    gen, words, ja, en_group, cjk_group, j8, t8, t1 = mesh_slices
    d8, d1, dj = (c[2].index.device for c in (t8, t1, j8))
    dense = [int(t) for t in np.flatnonzero(d8.dense_row >= 0)][:6]
    sparse = [int(t) for t in np.flatnonzero((d8.dense_row < 0)
                                             & (d8.lengths > 3))][:6]
    runtime.reset_launches()
    for tids in (dense[:2], dense[2:5] + sparse[:2], sparse[2:5]):
        assert d8.search_or(tids).tolist() == d1.search_or(tids).tolist() \
            == dj.search_or(tids).tolist()
    assert runtime.routes["mesh_or"] == 3
