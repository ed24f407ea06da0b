"""The comparison, the reference's building blocks and the traffic
generator, on the CPU at small sizes."""

import numpy as np
import pytest

from portbench import check, gramindex, textrules, traffic
from portbench.corpus import CorpusGenerator
from portbench.reference import Reference

TABLE = {"name": "articles", "ngram_size": 2, "kanji_ngram_size": 1,
         "kanji_extra_ngram": 2, "status_modulus": 3}


@pytest.fixture(scope="module")
def small():
    gen = CorpusGenerator(4000, seed=5)
    raw = [""] + [t for b in gen.batches(1000) for _, t in b]
    texts = textrules.normalize_all(raw)
    status = np.arange(len(texts)) % 3
    return raw, texts, status


def test_portbench_rules_match_the_program(small):
    from mygramdb_tpu_torch.utils import textproc
    raw, texts, _ = small
    for t in raw[1:400]:
        assert textrules.normalize(t) == textproc.normalize_text(t)
    runs = [r for t in texts[1:400] for r in textrules.CJK_RUN.findall(t)]
    words = [w for t in texts[1:400] for w in t.split() if t.isascii()]
    for term in runs[:300] + words[:300]:
        want = sorted(set(textproc.generate_query_ngrams(term, 2, 1, True, 2)))
        want = [term] if term in want else want
        assert textrules.query_grams(term, TABLE) == want


def test_portbench_normalize_all_is_normalize(small):
    raw, texts, _ = small
    assert texts == [textrules.normalize(t) for t in raw]


def test_portbench_postings_are_substrings(small):
    _, texts, _ = small
    corpus = gramindex.Corpus(texts)
    grams = ["ab", "th", "e ", "in"] + [r[:2] for t in texts[1:60]
                                        for r in textrules.CJK_RUN.findall(t)
                                        if len(r) >= 2][:40] + \
        [r[0] for t in texts[1:30] for r in textrules.CJK_RUN.findall(t)]
    got = corpus.postings(grams)
    df = corpus.doc_freq()
    for g in set(grams):
        want = [d for d in range(1, len(texts)) if g in texts[d]]
        assert got[g].tolist() == want, g
        assert df(g) == len(want), g


def test_portbench_sets_match_numpy():
    rng = np.random.default_rng(1)
    n = 100_003
    sets = gramindex.Sets(n)
    for trial in range(10):
        ps = [np.unique(rng.integers(1, n + 1, rng.integers(500, 90_000)))
              .astype(np.int32) for _ in range(3)]
        want = ps[0]
        for p in ps[1:]:
            want = np.intersect1d(want, p)
        r = sets.intersect([(f"{trial}.{i}", p) for i, p in enumerate(ps)])
        assert r.count() == want.size
        assert np.array_equal(r.ids(), want)
        assert np.array_equal(r.top(100), want[::-1][:100])
        keep = np.packbits(rng.random(n + 1) < 0.3, bitorder="little")
        w2 = want[gramindex.Sets.test(keep, want)]
        assert np.array_equal(r.where(keep).top(9), w2[::-1][:9])


def score_query(small):
    raw, texts, status = small
    corpus = gramindex.Corpus(texts)
    term = next(w for t in texts[1:] if t.isascii()
                for w in t.split() if len(w) >= 3)
    q = {"table": "articles", "cmd": "SEARCH", "score": True,
         "terms": [term], "filter": False, "limit": 100}
    q["line"] = traffic.render(q)
    ref = Reference.for_queries(corpus, status, TABLE, True, [q])
    return ref, q


def test_portbench_tampered_answers_are_wrong(small):
    ref, q = score_query(small)
    want = ref.answer(q)
    assert len(want["page"]) >= 3
    limits = {"wrong": 0, "bm25_gap": 1e-5}
    right = check.render(q, want)
    assert check.compare(ref, [q], {0: [right]}, 0, limits) == {
        "wrong": {"value": 0, "limit": 0},
        "bm25_gap": {"value": 0.0, "limit": 1e-5}}
    parts = right.split()
    dropped = " ".join(parts[:-1])                     # one id dropped
    swapped = parts[:3] + [parts[-1]] + parts[4:-1] + [parts[3]]
    got = check.compare(ref, [q], {0: [dropped]}, 0, limits)
    assert got["wrong"]["value"] == 1
    got = check.compare(ref, [q], {0: [" ".join(swapped)]}, 0, limits)
    assert got["bm25_gap"]["value"] > limits["bm25_gap"]
    count = q | {"cmd": "COUNT", "score": False}
    c = ref.answer(count)["count"]
    assert check.compare(ref, [count], {0: [f"OK COUNT {c + 1}"]}, 0,
                         limits)["wrong"]["value"] == 1


def test_portbench_bf16_control_reorders(small):
    ref, q = score_query(small)
    got = check.control_answers(ref, [q], [0], "bf16_bm25")
    out = check.compare(ref, [q], got, 0, {"wrong": 0, "bm25_gap": 0.0})
    assert out["bm25_gap"]["value"] > 0


def test_portbench_apportion_is_exact():
    labels = traffic.apportion({"a": 0.7, "b": 0.3}, 4096)
    assert labels.count("a") == 2867 and labels.count("b") == 1229
