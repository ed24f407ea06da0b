"""The fused verified path over a text store that does not pack every
document, and the score queries whose terms are each one gram (F2).

A table with ``verify_text: all`` is served through ``Application`` (the
seed file's load, the device build, the micro-batcher or the unbatched
route or the doc-sharded mesh) and its answers are held against
``portbench/reference.py``, a plain reference that imports nothing of the
program:

- a JA+EN corpus in which a tenth of the documents are longer than the
  text store's row (``_MAXT_CHOICES`` patched here to the 90th percentile
  of the lengths): ``COUNT``, ``SORT id DESC`` and ``SORT _score DESC``
  pages, 1-3 terms, covered two-kanji terms and three- or four-character
  runs, with and without ``FILTER``, all answered by the fused routes,
  the overflow documents verified and scored on the host;
- planted ``A AND B SORT _score`` queries over two-kanji terms, each one
  gram, so that the verify does not filter: the other term must still
  apply, with the driver's slice within the verify width and past it
  (``C > Kv``, with a dense ``B``).
"""

import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from portbench import gramindex, harness, textrules, traffic
from portbench.reference import Reference

from torch_parity import torch_cpu  # noqa: F401

TABLE = {"name": "articles", "ngram_size": 2, "kanji_ngram_size": 1,
         "kanji_extra_ngram": 2, "status_modulus": 3}
SERVER = {"memory": {"verify_text": "all"}, "cache": {"enabled": False},
          "device": {"microbatch_size": 64, "microbatch_window_us": 200}}
ROUTES = {"batched": {}, "unbatched": {"microbatch_size": 1},
          "mesh": {"mesh_shards": 2}}
# the program sums BM25 in float32; the reference in float64
RTOL = 1e-5


def server_conf(route: str, **device) -> dict:
    s = {k: dict(v) for k, v in SERVER.items()}
    s["device"].update(ROUTES[route], **device)
    return s


class Served:
    """An initialized ``Application`` over a seed file, and the reference
    over the same documents. made: the corpus as ``harness.make_corpus``
    gives it (texts, is_ja, status, seed file)."""

    def __init__(self, tmp, conf: dict, made):
        from mygramdb_tpu_torch.app.application import Application
        from mygramdb_tpu_torch.config import load_config
        self.texts, self.is_ja, self.status, seed = made
        self.app = Application(load_config(harness.server_config(conf, tmp)),
                               seed_path=seed)
        self.app.initialize()
        from mygramdb_tpu_torch.utils import trace
        self.stages = trace.build_stages()
        self.ctx = self.app.catalog.contexts()[0]
        self.corpus = gramindex.Corpus(textrules.normalize_all(self.texts))

    def ask(self, lines, threads: int = 8):
        """Each line through the parser and the pipeline, from several
        threads at once (so that the micro-batcher batches) ->
        [(total, page of primary keys, scores or None)]."""
        core = self.app.core
        pipe = core.pipeline_for(self.ctx)

        def one(line):
            out = pipe.execute(core.parser.parse(line))
            assert out.success, (line, out.error)
            pks = out.sn.doc_store.primary_keys_batch(out.results.tolist())
            return out.total, [int(p) for p in pks], out.scores
        with ThreadPoolExecutor(threads) as ex:
            return list(ex.map(one, lines))

    def reference(self, queries):
        return Reference.for_queries(self.corpus, self.status, TABLE, True,
                                     queries)


def write_seed(tmp, texts, status):
    """The loader's JSONL seed file of texts (docs 1..N) -> its path."""
    path = os.path.join(tmp, "seed.jsonl")
    with open(path, "w", encoding="utf-8") as fh:
        for i in range(1, len(texts)):
            fh.write(json.dumps({"id": i, "content": texts[i],
                                 "status": int(status[i])},
                                ensure_ascii=False) + "\n")
    return path


def route_counts():
    from mygramdb_tpu_torch.ops import runtime
    return dict(runtime.routes), dict(runtime.overflow)


def check_answers(queries, got, ref):
    """Counts and id pages equal to the reference's; a score page's ids
    the reference's, in its order but for scores within RTOL of each
    other, and each score within RTOL of the reference's."""
    for q, (total, page, scores) in zip(queries, got):
        want = ref.answer(q)
        assert total == want["count"], q["line"]
        if q["cmd"] == "COUNT":
            continue
        want_page = [int(d) for d in want["page"]]
        if not q["score"]:
            assert page == want_page, q["line"]
            continue
        exact = want["exact"]
        assert len(page) == len(want_page) == len(set(page)), q["line"]
        served = np.asarray([exact[d] for d in page])
        np.testing.assert_allclose(np.asarray(scores, dtype=np.float64),
                                   served, rtol=RTOL, err_msg=q["line"])
        ranked = np.asarray(want["ranked"])
        np.testing.assert_allclose(served, ranked, rtol=RTOL,
                                   err_msg=q["line"])
        for i, (d, w) in enumerate(zip(page, want_page)):
            ties = np.sum(np.abs(ranked - ranked[i]) <= RTOL * abs(ranked[i]))
            cut = i == len(page) - 1 and want["count"] > len(page)
            if ties == 1 and not cut:
                assert d == w, (q["line"], i)


# ---------------------------------------------------------------------------
# Overflow documents on the fused routes
# ---------------------------------------------------------------------------

OVERFLOW_CORPUS = {"docs": 2000, "ja_ratio": 0.6, "seed": 91,
                   "vocab_size": 20000, "n_kanji": 400,
                   "en_words": {"mean": 30, "sigma": 1.0, "min": 4,
                                "max": 300},
                   "ja_chars": {"mean": 110, "sigma": 1.0, "min": 12,
                                "max": 1200}}
OVERFLOW_TRAFFIC = {"queries": 160, "list_seed": 11, "limit": 20,
                    "table": "articles",
                    "commands": {"search_score": 0.5, "search_id_desc": 0.25,
                                 "count": 0.25},
                    "terms": {"1": 0.45, "2": 0.4, "3": 0.15},
                    "lead": {"en": 0.3, "ja": 0.7}, "filter_share": 0.3,
                    "dense": {"en": None, "ja": None}, "dense_min_df": 0.01,
                    "max_rarest_df": None, "en_min_len": 3, "ja_run": [2, 4]}


@pytest.fixture(scope="module", params=list(ROUTES))
def overflow_served(request, tmp_path_factory):
    from mygramdb_tpu_torch.storage import device_text
    tmp = str(tmp_path_factory.mktemp("overflow"))
    conf = {"corpus": OVERFLOW_CORPUS, "table": TABLE,
            "server": server_conf(request.param)}
    made = harness.make_corpus(conf, tmp)
    lens = [len(t) for t in textrules.normalize_all(made[0][1:])]
    with pytest.MonkeyPatch.context() as mp:
        # the row covers nine documents of ten
        mp.setattr(device_text, "_MAXT_CHOICES",
                   (int(np.percentile(lens, 90)),))
        s = Served(tmp, conf, made)
    s.route = request.param
    return s


def test_overflow_store_holds_a_tenth_of_the_corpus(overflow_served):
    store = overflow_served.ctx.fresh_device_text()
    n = OVERFLOW_CORPUS["docs"]
    assert store.layout == "padded"
    assert 0.05 * n <= store.overflow_ids.size <= 0.15 * n
    assert store.packed_row is not None
    bits = np.unpackbits(store.packed_row.numpy().view(np.uint8),
                         bitorder="little")[:store.capacity]
    assert set(np.flatnonzero(bits == 0).tolist()) == set(
        store.overflow_ids.tolist())
    assert (store.lengths_host[store.overflow_ids] == 0).all()


def test_overflow_fused_answers_equal_the_reference(overflow_served):
    s = overflow_served
    queries = traffic.Generator(OVERFLOW_TRAFFIC, TABLE, s.texts,
                                s.is_ja).queries()
    r0, o0 = route_counts()
    got = s.ask([q["line"] for q in queries])
    r1, o1 = route_counts()
    check_answers(queries, got, s.reference(queries))
    mesh = "mesh_" if s.route == "mesh" else ""
    fused = sum(r1[mesh + k] - r0[mesh + k]
                for k in ("fused_dense", "fused_sparse"))
    # every verified or scored query took the fused program (on the mesh,
    # but for the non-overlapping counts of a sparse driver, which no
    # sharded program takes): none went back to the exact path
    handed = r1["mesh_to_exact"] - r0["mesh_to_exact"]
    assert fused + handed >= sum(q["score"] for q in queries)
    assert fused > 10 * handed
    assert r1["fused_clipped"] == r0["fused_clipped"]
    if not mesh:
        assert r1["verify_exact"] == r0["verify_exact"]
    assert o1["verify_overflow_queries"] > o0["verify_overflow_queries"]
    assert o1["verify_overflow_candidates"] > \
        o0["verify_overflow_candidates"]


# ---------------------------------------------------------------------------
# F2: SORT _score over ANDed terms of one gram each
# ---------------------------------------------------------------------------

N_PLANTED = 2000
# (term, docs holding it); A2 and B2 share 40 documents, A1 and B1 20
PLANTED = {"甲乙": range(1, 61), "丙丁": range(41, 121),
           "戊己": range(201, 301), "庚辛": range(261, 861)}
F2_QUERIES = [["甲乙", "丙丁"], ["丙丁", "甲乙"], ["戊己", "庚辛"],
              ["庚辛", "戊己"], ["甲乙", "丙丁", "庚辛"]]


def planted_corpus():
    """Hiragana and kanji of a block the planted terms are not in, with
    the planted terms at random places of their documents."""
    rng = np.random.default_rng(23)
    kana = [chr(c) for c in range(0x3041, 0x3094)]
    kanji = [chr(c) for c in range(0x5000, 0x50C8)]
    alphabet = np.asarray(kana + kanji)
    texts = [""]
    for d in range(1, N_PLANTED + 1):
        cells = list(alphabet[rng.integers(len(alphabet),
                                           size=int(rng.integers(30, 90)))])
        for term, docs in PLANTED.items():
            if d in docs:
                for _ in range(int(rng.integers(1, 4))):
                    cells.insert(int(rng.integers(len(cells) + 1)), term)
        texts.append("".join(cells))
    status = np.arange(N_PLANTED + 1) % 3
    return texts, status


@pytest.fixture(scope="module", params=list(ROUTES))
def planted_served(request, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("planted"))
    texts, status = planted_corpus()
    # 庚辛 (600 documents) is dense, the rest sparse
    conf = {"table": TABLE,
            "server": server_conf(request.param, dense_df_ratio=0.1)}
    s = Served(tmp, conf, (texts, None, status,
                           write_seed(tmp, texts, status)))
    s.route = request.param
    return s


def f2_queries():
    out = []
    for terms in F2_QUERIES:
        for flt in (False, True):
            for cmd, score in (("SEARCH", True), ("SEARCH", False),
                               ("COUNT", False)):
                q = {"table": "articles", "cmd": cmd, "score": score,
                     "terms": terms, "filter": flt, "limit": 100}
                q["line"] = traffic.render(q)
                out.append(q)
    return out


@pytest.mark.parametrize("kv", ["within", "past"])
def test_f2_score_and_of_one_gram_terms(planted_served, kv, monkeypatch):
    from mygramdb_tpu_torch.index.device_index import DeviceIndex
    s = planted_served
    device = s.ctx.index.device
    for term, docs in PLANTED.items():
        dense = device.dense_row[s.ctx.index.query_tids([term])[0]] >= 0
        assert dense == (len(docs) >= 200), term
    if kv == "past":
        # 戊己's slice (100 documents, C = 512) past the verify width
        monkeypatch.setattr(DeviceIndex, "_KV_BUCKET", 128)
    queries = f2_queries()
    r0, _ = route_counts()
    got = s.ask([q["line"] for q in queries])
    r1, _ = route_counts()
    check_answers(queries, got, s.reference(queries))
    fused = ("mesh_fused_sparse",) if s.route == "mesh" else (
        "fused_sparse",)
    assert sum(r1[k] - r0[k] for k in fused) >= sum(
        q["score"] for q in queries)


def test_f2_answers_are_not_a_driver_posting(planted_served):
    """The F2 shape's answer is the AND, not the first term's posting."""
    s = planted_served
    total, page, _ = s.ask(
        ["SEARCH articles 甲乙 AND 丙丁 SORT _score DESC LIMIT 100"])[0]
    assert total == 20 and sorted(page) == list(range(41, 61))
    total, page, _ = s.ask(
        ["SEARCH articles 戊己 AND 庚辛 SORT _score DESC LIMIT 100"])[0]
    assert total == 40 and sorted(page) == list(range(261, 301))


# ---------------------------------------------------------------------------
# Spans and counters of the overflow part
# ---------------------------------------------------------------------------

def test_overflow_span_and_counters(overflow_served):
    from mygramdb_tpu_torch.server.http_server import HttpServer
    from mygramdb_tpu_torch.utils import trace
    s = overflow_served
    store = s.ctx.fresh_device_text()
    # a two-kanji term of an overflow document, asked scored
    doc = int(store.overflow_ids[
        np.argmax([s.is_ja[d] for d in store.overflow_ids])])
    run = textrules.CJK_RUN.findall(s.texts[doc])
    term = next(r[:2] for r in run if len(r) >= 2)
    line = f"SEARCH articles {term} SORT _score DESC LIMIT 10"
    trace.clear()
    trace.enable()
    try:
        s.ask([line], threads=1)
    finally:
        trace.disable()
    spans = [x for x in trace.spans() if x.name == "verify.overflow"]
    trace.clear()
    assert len(spans) == 1
    assert spans[0].attrs["queries"] == 1
    assert spans[0].attrs["candidates"] >= 1
    stage = [x for x in s.stages if x.name == "build.device"
             and x.attrs.get("what") == "text"][-1]
    assert stage.attrs["layout"] == "padded"
    assert stage.attrs["maxT"] == store.maxT
    assert stage.attrs["overflow"] == len(store._overflow)
    assert stage.attrs["bytes"] == store.memory_usage()
    got = s.app.core.verify_counters()
    assert got["text_store_bytes"] == store.memory_usage() > 0
    assert got["verify_overflow_queries"] >= 1
    info = s.app.core.handle_line("INFO")
    metrics = HttpServer(s.app.core, s.app.config)._prometheus()
    for name, value in got.items():
        assert f"{name}: {value}" in info
    for name in ("verify_overflow_queries_total",
                 "verify_overflow_candidates_total", "text_store_bytes"):
        assert f"mygramdb_{name} " in metrics


def test_overflow_counters_count_whatever_the_flag(overflow_served):
    from mygramdb_tpu_torch.utils import trace
    s = overflow_served
    assert not trace.enabled
    store = s.ctx.fresh_device_text()
    doc = int(store.overflow_ids[0])
    words = s.texts[doc].split() if not s.is_ja[doc] else \
        textrules.CJK_RUN.findall(s.texts[doc])
    term = next(w[:3] for w in words if len(w) >= 3)
    before = dict(s.app.core.verify_counters())
    s.ask([f"SEARCH articles {term} SORT _score DESC LIMIT 10"], threads=1)
    after = s.app.core.verify_counters()
    assert after["verify_overflow_queries"] == \
        before["verify_overflow_queries"] + 1
    assert after["verify_overflow_candidates"] > \
        before["verify_overflow_candidates"]


@pytest.mark.parametrize("lib", ["native", "python"])
def test_overflow_tf_counts_as_str_count(lib, monkeypatch):
    """The overflow documents' counts from their packed code points, with
    the native library and without it, against ``str.count``."""
    from mygramdb_tpu_torch import native
    from mygramdb_tpu_torch.storage import device_text
    if lib == "python":
        monkeypatch.setattr(native, "_load", lambda: None)
    rng = np.random.default_rng(4)
    alphabet = np.asarray(list("ab検索エンジン𠀋"))
    texts = {d: "".join(alphabet[rng.integers(len(alphabet),
                                              size=int(rng.integers(4, 40)))])
             for d in range(1, 200)}
    monkeypatch.setattr(device_text, "_MAXT_CHOICES", (16,))
    store = device_text.DeviceTextStore(texts, 256, device="cpu")
    ids = store.overflow_ids[::3]
    terms = ["ab", "検索", "aa", "𠀋"]
    tf, dl = store.overflow_tf(ids, terms)
    assert ids.size > 20
    assert dl.tolist() == [len(texts[d]) for d in ids.tolist()]
    assert tf.tolist() == [[texts[d].count(t) for t in terms]
                           for d in ids.tolist()]
