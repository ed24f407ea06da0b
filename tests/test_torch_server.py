"""The whole slice: ``TableCatalog``, ``ServerCore`` and ``TcpServer`` from
both namespaces on one synthetic corpus. Every SEARCH and COUNT response
line (dense, sparse, covered CJK, NOT, FILTER, zero-hit) must be
byte-identical. A subprocess serves the port's slice with JAX blocked and
shows that neither JAX nor a JAX-package device module was loaded."""

import asyncio
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from mygramdb_tpu.catalog import TableCatalog as JCatalog
from mygramdb_tpu.config import load_config_from_dict
from mygramdb_tpu.server.core import ServerCore as JCore
from mygramdb_tpu.server.tcp_server import TcpServer as JTcp
from mygramdb_tpu.utils.corpusgen import CorpusGenerator
from mygramdb_tpu_torch.catalog import TableCatalog as TCatalog
from mygramdb_tpu_torch.ops import bitmap_ops, posting_ops, runtime
from mygramdb_tpu_torch.server.core import ServerCore as TCore
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


def load(catalog_cls, gen):
    cfg = load_config_from_dict(CFG)
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
