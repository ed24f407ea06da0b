"""The port's term dictionary on the native term table
(``mygramdb_tpu_torch.index.term_dict``, ``native.TermTable``): the port's
bulk ``BuiltIndex`` equals the JAX package's builder output, with the
library and without it; the dictionary's interface gives what the Python
dictionary gives; two grams of one hash get two ids; a bulk load followed
by live writes, and a pre-populated dictionary, number new terms next and
in order; the ``build.load`` stage carries the builder's term counts."""

import json
import os
import random

import numpy as np
import pytest

import mygramdb_tpu.native as jax_native
from mygramdb_tpu.index.builder import IndexBuilder as JaxBuilder
from mygramdb_tpu.index.term_dict import TermDict as JaxTermDict
from mygramdb_tpu_torch import native
from mygramdb_tpu_torch.index.builder import IndexBuilder
from mygramdb_tpu_torch.index.term_dict import TermDict
from mygramdb_tpu_torch.utils.corpusgen import CorpusGenerator

from torch_parity import torch_cpu  # noqa: F401

# one gram_hash, other code points (four-code-point grams)
COLLIDING = ("璿以窜\U00030041", "絝钟鹱₫")


@pytest.fixture
def no_native(monkeypatch):
    """Both packages without the library, as MYGRAM_DISABLE_NATIVE=1
    leaves them in a fresh process."""
    monkeypatch.setenv("MYGRAM_DISABLE_NATIVE", "1")
    for mod in (native, jax_native):
        monkeypatch.setattr(mod, "_lib", None)
        monkeypatch.setattr(mod, "_tried", False)
    monkeypatch.setattr(native, "_terms_lib", None)
    monkeypatch.setattr(native, "_terms_tried", False)


def with_native(request, on: bool) -> None:
    if on:
        assert TermDict().native, "the library lacks the term table"
    else:
        request.getfixturevalue("no_native")
        assert not TermDict().native


def corpus(n_docs=480, batch=120, seed=11):
    gen = CorpusGenerator(n_docs, seed=seed, vocab_size=4000,
                          en_words=(8, 90), ja_chars=(30, 260))
    return [[(i, t.lower()) for i, t in b] for b in gen.batches(batch)]


def assert_same_built(a, b):
    assert a.term_dict.state() == b.term_dict.state()
    assert len(a.term_dict) == len(b.term_dict)
    np.testing.assert_array_equal(a.offsets, b.offsets)
    np.testing.assert_array_equal(a.lengths, b.lengths)
    np.testing.assert_array_equal(a.postings, b.postings)
    assert (a.max_doc_id, a.n_docs) == (b.max_doc_id, b.n_docs)
    assert (a.positional is None) == (b.positional is None)
    if a.positional is not None:
        for f in ("occ_cnt", "occ_pos", "occ_base", "occ_len"):
            np.testing.assert_array_equal(getattr(a.positional, f),
                                          getattr(b.positional, f))
        assert a.positional.overflow_docs == b.positional.overflow_docs


@pytest.mark.parametrize("on", [True, False], ids=["native", "no_native"])
@pytest.mark.parametrize("positions", [False, True],
                         ids=["docs", "positions"])
@pytest.mark.parametrize("kanji_extra", [0, 2])
def test_bulk_build_equals_jax_builder(request, on, positions, kanji_extra):
    with_native(request, on)
    batches = corpus()
    port = IndexBuilder(2, 1, True, collect_positions=positions,
                        kanji_extra_ngram=kanji_extra)
    ref = JaxBuilder(2, 1, True, collect_positions=positions,
                     kanji_extra_ngram=kanji_extra)
    for b in batches:
        port.add_batch(b)
        ref.add_batch(b)
    built, want = port.finalize(), ref.finalize()
    assert_same_built(built, want)
    st = built.term_stats
    assert st["term_path"] == ("native" if on else "python")
    assert st["terms_new"] == len(built.term_dict) > 1000
    assert st["terms_found"] > 0 and st["term_collisions"] == 0


def run_ops(td):
    """The interface's answers on a fixed sequence of calls."""
    words = ["ab", "bc", "日", "日本", "ab", "\ud800x", "", "bc", "語"]
    out = [[td.get_or_add(w) for w in words], len(td)]
    out.append(td.get_or_add_many(["q", "ab", "r", "q", "日本"]))
    out.append([td.get(w) for w in ["ab", "zz", "日本", "\ud800x", ""]])
    out.append(td.lookup_many(["r", "zz", "bc", "q"]))
    out.append(td.lookup_many(iter(["語", "nope"])))
    out.append([td.term(i) for i in range(len(td))])
    out.append(list(td.terms()))
    out.append(td.state())
    back = type(td).from_state(td.state())
    out.append([len(back), back.state(), back.lookup_many(td.state()),
                back.get_or_add("new"), back.term(len(back) - 1)])
    return out


def test_term_dict_round_trip_native_equals_fallback(request):
    native_td = TermDict()
    assert native_td.native
    got = run_ops(native_td)
    request.getfixturevalue("no_native")
    py_td = TermDict()
    assert not py_td.native
    assert got == run_ops(py_td)
    with pytest.raises(IndexError):
        native_td.term(len(native_td))


def test_two_grams_of_one_hash_get_two_ids():
    a, b = COLLIDING
    ha = native.hybrid_ngrams(a, 4, 4, True)[2]
    hb = native.hybrid_ngrams(b, 4, 4, True)[2]
    assert ha[0] == hb[0] and a != b  # a true collision of gram_hash
    td = TermDict.from_state(["x", "yz"])
    flat = native.to_cp(a + b + a)
    starts = np.asarray([0, 4, 8], dtype=np.int32)
    lens = np.full(3, 4, dtype=np.int32)
    tids, collisions = td.resolve(flat, starts, lens,
                                  np.repeat(ha[:1], 3))
    # numbered from len(td) in code-point order on the shared hash
    first, second = (2, 3) if a < b else (3, 2)
    assert tids.tolist() == [first, second, first]
    assert collisions == 1 and len(td) == 4
    assert td.get(a) == first and td.get(b) == second
    assert td.term(first) == a and td.term(second) == b
    back = TermDict.from_state(td.state())
    assert back.lookup_many([a, b]) == [first, second]
    # a second batch finds both, and numbers nothing
    tids2, coll2 = td.resolve(flat[4:], starts[:2], lens[:2],
                              np.repeat(ha[:1], 2))
    assert tids2.tolist() == [second, first] and coll2 == 0
    assert len(td) == 4
    # get_or_add of the other one, one call at a time
    one = TermDict()
    assert [one.get_or_add(a), one.get_or_add(b), one.get_or_add(a)] \
        == [0, 1, 0]


@pytest.mark.parametrize("on", [True, False], ids=["native", "no_native"])
def test_bulk_then_live_writes_number_next_in_order(request, on):
    from mygramdb_tpu_torch.index.delta import MutableIndex
    with_native(request, on)
    b = IndexBuilder(2, 1, True)
    b.add_batch([(1, "alpha beta gamma " * 20), (2, "日本語の文章です" * 30)])
    built = b.finalize()
    v = len(built.term_dict)
    idx = MutableIndex(built)
    text = "zq xw alpha"
    grams = set(idx.shred(text))
    new = [g for g in grams if built.term_dict.get(g) is None]
    idx.add_document(3, text)
    td = idx.term_dict
    assert len(td) == v + len(new)
    # the new grams are numbered next, in the order the write met them
    assert [td.get(g) for g in new] == list(range(v, v + len(new)))
    assert [td.term(v + i) for i in range(len(new))] == new
    total, ids = idx.search_and(idx.shred("zq xw"))
    assert total == 1 and ids.tolist() == [3]


@pytest.mark.parametrize("on", [True, False], ids=["native", "no_native"])
def test_prepopulated_dictionary_keeps_ids_and_numbers_next(request, on):
    with_native(request, on)
    batches = corpus(n_docs=240, batch=80, seed=3)
    first = JaxBuilder(2, 1, True)
    first.add_batch(batches[0])
    terms = first.finalize().term_dict.state()
    port = IndexBuilder(2, 1, True, term_dict=TermDict.from_state(terms))
    ref = JaxBuilder(2, 1, True, term_dict=JaxTermDict.from_state(terms))
    for bt in batches[1:]:
        port.add_batch(bt)
        ref.add_batch(bt)
    built, want = port.finalize(), ref.finalize()
    assert_same_built(built, want)
    assert built.term_dict.state()[:len(terms)] == terms
    assert built.term_stats["terms_new"] == len(built.term_dict) - len(terms)


def test_build_load_stage_carries_the_term_counts(tmp_path):
    from mygramdb_tpu_torch.app.application import Application
    from mygramdb_tpu_torch.config import load_config_from_dict
    from mygramdb_tpu_torch.utils import trace
    rng = random.Random(4)
    words = ["".join(rng.choice("abcdefghij") for _ in range(6))
             for _ in range(200)]
    seed = tmp_path / "seed.jsonl"
    with open(seed, "w") as fh:
        for i in range(1, 301):
            fh.write(json.dumps({"id": i, "content": " ".join(
                rng.choices(words, k=40)) + " 日本語テキスト"}) + "\n")
    cfg = load_config_from_dict({
        "tables": [{"name": "t", "text_source": {"column": "content"}}],
        "cache": {"enabled": False}, "build": {"batch_size": 100},
        "dump": {"dir": str(tmp_path / "dumps")},
        "api": {"tcp": {"bind": "127.0.0.1", "port": 0}},
        "network": {"allow_cidrs": ["127.0.0.0/8"]}})
    trace.clear()
    app = Application(cfg, seed_path=str(seed))
    app.initialize()
    load = [s for s in trace.build_stages() if s.name == "build.load"][-1]
    trace.clear()
    td = app.catalog.resolve("t").index.term_dict
    assert load.attrs["term_path"] == "native"
    assert load.attrs["terms_new"] == len(td) > 0
    assert load.attrs["terms_found"] > 0
    assert load.attrs["term_collisions"] == 0


def test_readers_and_a_writer_share_the_table():
    import sys
    import threading
    td = TermDict()
    assert td.native
    words = [f"w{i}" for i in range(20000)]
    want = {}
    errors = []
    done = threading.Event()

    def write():
        for i in range(0, len(words), 50):
            chunk = words[i:i + 50]
            for w, tid in zip(chunk, td.get_or_add_many(chunk)):
                want[w] = tid
        done.set()

    def read(seed):
        rng = random.Random(seed)
        while not done.is_set():
            ws = rng.sample(words, 8)
            for w, tid in zip(ws, td.lookup_many(ws)):
                if tid is not None and td.term(tid) != w:
                    errors.append((w, tid))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=read, args=(s,))
                   for s in range(12)]
        threads.append(threading.Thread(target=write))
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors
    assert len(td) == len(words)
    assert td.lookup_many(words) == [want[w] for w in words]


def test_a_stale_term_library_is_rebuilt(tmp_path, monkeypatch):
    """A library older than csrc/term_table.cpp (one built before an edit
    of the source) is built again and loaded, not passed over for the
    Python dictionary; the JAX package's host library is not where the
    table lives."""
    stale = tmp_path / "torch_host" / "libmygram_terms.so"
    stale.parent.mkdir()
    stale.write_bytes(b"not a library")
    os.utime(stale, (0, 0))
    monkeypatch.setattr(native, "_TERMS_LIB", str(stale))
    monkeypatch.setattr(native, "_terms_lib", None)
    monkeypatch.setattr(native, "_terms_tried", False)
    monkeypatch.setattr(native, "_terms_build", None)
    td = TermDict()
    assert td.native and native._terms_lib is not None
    assert stale.stat().st_mtime > 0
    assert td.get_or_add_many(["ab", "日本", "ab"]) == [0, 1, 0]
    assert not list(tmp_path.glob("torch_host/*.tmp"))
    lib = jax_native._load()
    assert lib is not None and not hasattr(lib, "mg_tt_create")


def test_one_gram_calls_keep_the_interpreter_lock():
    """A query's and a live write's single-gram calls hold the lock (a
    PyDLL call); only the batch calls let it go."""
    import ctypes
    lib = native._load_terms()
    assert lib is not None

    def held(fn):
        return bool(fn._flags_ & ctypes._FUNCFLAG_PYTHONAPI)
    assert held(lib.mg_tt_id) and held(lib.mg_tt_size)
    assert not held(lib.mg_tt_resolve) and not held(lib.mg_tt_copy)
