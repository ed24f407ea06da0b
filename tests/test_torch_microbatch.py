"""The port's micro-batcher: concurrent submissions share one device
program, and batched answers equal unbatched ones (the port's own and the
JAX package's)."""

import threading

import numpy as np
import pytest
import jax.numpy as jnp

from mygramdb_tpu.index import device_index as JD
from mygramdb_tpu_torch.index import device_index as TD
from mygramdb_tpu_torch.server import microbatch as TM

from torch_parity import (build_corpus, i32, random_queries,  # noqa: F401
                          torch_cpu)


@pytest.fixture(scope="module")
def indexes(torch_cpu):
    built = build_corpus(3000, seed=12)
    batched = TD.DeviceIndex(built, dense_df_ratio=0.05)
    batched.batcher = TM.MicroBatcher(batched, max_batch=16,
                                      window_us=20000)
    plain = TD.DeviceIndex(built, dense_df_ratio=0.05)
    jdev = JD.DeviceIndex(built, dense_df_ratio=0.05)
    return built, batched, plain, jdev


def run_concurrently(fn, n):
    out = [None] * n

    def worker(i):
        out[i] = fn(i)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    return out


@pytest.mark.parametrize("opts", [dict(limit=10), dict(limit=100,
                                                       descending=False),
                                  dict(count_only=True)],
                         ids=["limit10", "asc100", "count"])
def test_concurrent_batches_match_unbatched(indexes, opts):
    built, batched, plain, jdev = indexes
    qs = [(t, []) for t, n in random_queries(built, plain, 48, seed=21)]
    b = batched.batcher
    before = (b.batches_executed, b.queries_batched)
    got = run_concurrently(
        lambda i: batched.search_and(qs[i][0], [], None,
                                     TD.SearchOptions(**opts)), len(qs))
    n_batches = b.batches_executed - before[0]
    n_queries = b.queries_batched - before[1]
    assert 0 < n_batches < n_queries  # queries shared programs
    for (tids, _), (total, ids) in zip(qs, got):
        t_plain = plain.search_and(tids, [], None, TD.SearchOptions(**opts))
        t_jax = jdev.search_and(tids, [], None, JD.SearchOptions(**opts))
        assert total == t_plain[0] == t_jax[0], tids
        assert np.array_equal(ids, t_plain[1]) and \
            np.array_equal(ids, t_jax[1]), tids


def test_filter_rows_batch_by_identity(indexes):
    built, batched, plain, jdev = indexes
    rng = np.random.default_rng(4)
    word = rng.integers(0, 2 ** 32, size=batched.n_words, dtype=np.uint32)
    row = i32(word)  # one shared row object, as the filter cache hands out
    qs = [t for t, _ in random_queries(built, plain, 24, seed=8)]
    got = run_concurrently(
        lambda i: batched.search_and(qs[i], [], [row],
                                     TD.SearchOptions(limit=20)), len(qs))
    for tids, (total, ids) in zip(qs, got):
        want = jdev.search_and(tids, [], [jnp.asarray(word)],
                               JD.SearchOptions(limit=20))
        assert total == want[0] and np.array_equal(ids, want[1])


def test_probe_free_and_probed_sparse_queries_batch_apart(indexes):
    built, batched, plain, _ = indexes
    sparse = [t for t in np.flatnonzero(built.lengths > 20)
              if plain.dense_row[t] < 0][:12]
    qs = [[int(t)] for t in sparse] + [[int(a), int(b)] for a, b in
                                       zip(sparse[:6], sparse[6:12])]
    got = run_concurrently(
        lambda i: batched.search_and(qs[i], [], None,
                                     TD.SearchOptions(limit=10)), len(qs))
    for tids, (total, ids) in zip(qs, got):
        want = plain.search_and(tids, [], None, TD.SearchOptions(limit=10))
        assert total == want[0] and np.array_equal(ids, want[1])


def test_over_max_k_takes_unbatched_path(indexes):
    built, batched, plain, _ = indexes
    dense = [int(t) for t in np.flatnonzero(plain.dense_row >= 0)]
    tids = (dense * (TM.MAX_K // len(dense) + 2))[:TM.MAX_K + 3]
    total, ids = batched.search_and(tids, [], None,
                                    TD.SearchOptions(limit=10))
    want = plain.search_and(sorted(set(tids)), [], None,
                            TD.SearchOptions(limit=10))
    assert total == want[0] and np.array_equal(ids, want[1])
    with pytest.raises(ValueError):
        batched.batcher.submit(list(range(TM.MAX_K + 1)), 128, True)


def test_fused_programs_not_ported(torch_cpu):
    """Every batched program runs (the name is kept from when the
    positional one was a placeholder): concurrent positional plans share
    "pos" programs, one dispatch each, and answer as the JAX package."""
    from test_positional import QUERIES, build, norm
    from mygramdb_tpu.utils.textproc import query_gram_offsets
    from mygramdb_tpu_torch.ops import runtime
    built = build()
    jdev = JD.DeviceIndex(built, dense_df_ratio=0.5)
    batched = TD.DeviceIndex(built, dense_df_ratio=0.5)
    batched.batcher = TM.MicroBatcher(batched, max_batch=16,
                                      window_us=20000)
    plans = []
    for term in QUERIES:
        pairs, covered = query_gram_offsets(norm(term).split()[0], 2, 1,
                                            True)
        to = [(built.term_dict.get(g), o) for g, o in pairs]
        if covered and None not in [t for t, _ in to]:
            plans.append((jdev.plan_positional(to),
                          batched.plan_positional(to)))
    d0 = runtime.dispatches.count
    b0 = batched.batcher.batches_executed
    got = run_concurrently(
        lambda i: batched.search_verified_positional(
            plans[i][1], 128, descending=bool(i % 2)), len(plans))
    assert runtime.dispatches.count - d0 == \
        batched.batcher.batches_executed - b0 < len(plans)
    for i, ((pj, _), t) in enumerate(zip(plans, got)):
        j = jdev.search_verified_positional(pj, 128, bool(i % 2))
        assert (int(j[0]), int(j[3])) == (t[0], t[3])
        assert np.array_equal(np.asarray(j[1]), t[1])


def test_fused_verify_batches_match_unbatched(indexes):
    """Concurrent verified searches (dense and sparse drivers, PK and BM25
    order) share fused programs, and each answer equals the same query run
    alone, and the JAX package's."""
    from mygramdb_tpu.storage.device_text import DeviceTextStore as JText
    from mygramdb_tpu.utils.corpusgen import CorpusGenerator
    from mygramdb_tpu.utils.textproc import generate_query_ngrams
    from mygramdb_tpu_torch.storage.device_text import DeviceTextStore
    built, batched, plain, jdev = indexes
    gen = CorpusGenerator(3000, seed=12, vocab_size=20_000)
    texts = {i: t.lower() for b in gen.batches(1000) for i, t in b}
    tst = DeviceTextStore(texts, batched.n_docs_capacity, device="cpu")
    jst = JText(texts, jdev.n_docs_capacity)
    words = [w for w in gen.vocab[:400] if len(w) >= 4][:24]
    qs = []
    for i, w in enumerate(words):
        tids = [built.term_dict.get(g) for g in
                generate_query_ngrams(w, 2, 1, True, kanji_extra=2)]
        if None in tids:
            continue
        ndl, nl = JText._pack_needles([w, ""])
        qs.append((sorted(set(tids)), ndl, nl, bool(i % 2)))
    assert len(qs) >= 12
    idf = np.asarray([1.5, 0.0], dtype=np.float32)

    def ask(idx, st, q):
        tids, ndl, nl, score = q
        return idx.search_and_verified(tids, st, ndl, nl, 32, True,
                                       score_mode=score, idf=idf,
                                       avgdl=40.0)

    b = batched.batcher
    before = (b.batches_executed, b.queries_batched)
    got = run_concurrently(lambda i: ask(batched, tst, qs[i]), len(qs))
    assert 0 < b.batches_executed - before[0] < b.queries_batched - before[1]
    for q, g in zip(qs, got):
        for want in (ask(plain, tst, q), ask(jdev, jst, q)):
            assert (g is None) == (want is None), q[0]
            if g is None:
                continue
            assert g[0] == want[0] and g[3] == want[3], q[0]
            assert np.array_equal(g[1], want[1]), q[0]
            if q[3]:  # scores exist in score mode only
                np.testing.assert_allclose(np.asarray(g[2], np.float64),
                                           np.asarray(want[2], np.float64),
                                           rtol=1e-5)


@pytest.fixture(scope="module")
def mesh_indexes(indexes):
    """The same corpus doc-sharded over 8 CPU shards, with a batcher."""
    built = indexes[0]
    mesh = TD.DeviceIndex(built, dense_df_ratio=0.05, mesh_shards=8)
    mesh.batcher = TM.MicroBatcher(mesh, max_batch=16, window_us=20000)
    return built, mesh, indexes[2]


@pytest.mark.parametrize("opts", [dict(limit=10), dict(limit=100,
                                                       descending=False)],
                         ids=["limit10", "asc100"])
def test_mesh_dense_batches_match_unbatched(mesh_indexes, opts):
    """On a mesh the batcher's dense program runs K1 a shard and merges:
    batches form, and each answer equals the single-device one."""
    from mygramdb_tpu_torch.ops import runtime
    built, mesh, plain = mesh_indexes
    qs = [t for t, _ in random_queries(built, plain, 40, seed=33)
          if all(plain.dense_row[x] >= 0 for x in t)]
    assert len(qs) >= 6
    b = mesh.batcher
    before = (b.batches_executed, b.queries_batched)
    runtime.reset_launches()
    got = run_concurrently(
        lambda i: mesh.search_and(qs[i], [], None, TD.SearchOptions(**opts)),
        len(qs))
    assert 0 < b.batches_executed - before[0] < b.queries_batched - before[1]
    assert runtime.routes["mesh_dense"] == len(qs)
    for tids, (total, ids) in zip(qs, got):
        want = plain.search_and(tids, [], None, TD.SearchOptions(**opts))
        assert total == want[0] and np.array_equal(ids, want[1]), tids


def test_mesh_fused_verify_batches_match_unbatched(mesh_indexes):
    """Dense-driver verified searches on a mesh share the batcher's fused
    program (K1, then the verify over each shard's own text rows, then
    the merge); each answer equals the single-device one."""
    from mygramdb_tpu.utils.corpusgen import CorpusGenerator
    from mygramdb_tpu.utils.textproc import generate_query_ngrams
    from mygramdb_tpu_torch.ops import runtime
    from mygramdb_tpu_torch.storage.device_text import DeviceTextStore
    built, mesh, plain = mesh_indexes
    gen = CorpusGenerator(3000, seed=12, vocab_size=20_000)
    texts = {i: t.lower() for b in gen.batches(1000) for i, t in b}
    st8 = DeviceTextStore(texts, mesh.n_docs_capacity,
                          doc_sharding=mesh.text_doc_sharding)
    st1 = DeviceTextStore(texts, plain.n_docs_capacity, device="cpu")
    assert st8.doc_sharded
    qs = []
    for i, w in enumerate(gen.vocab[:400]):
        tids = [built.term_dict.get(g) for g in
                generate_query_ngrams(w, 2, 1, True, kanji_extra=2)]
        if len(w) < 3 or None in tids or \
                any(plain.dense_row[t] < 0 for t in tids):
            continue
        ndl, nl = DeviceTextStore._pack_needles([w, ""])
        qs.append((sorted(set(tids)), ndl, nl, bool(i % 2)))
    qs = qs[:16]
    assert len(qs) >= 8
    idf = np.asarray([1.5, 0.0], dtype=np.float32)

    def ask(idx, st, q):
        tids, ndl, nl, score = q
        return idx.search_and_verified(tids, st, ndl, nl, 32, True,
                                       score_mode=score, idf=idf,
                                       avgdl=40.0)

    b = mesh.batcher
    before = (b.batches_executed, b.queries_batched)
    runtime.reset_launches()
    got = run_concurrently(lambda i: ask(mesh, st8, qs[i]), len(qs))
    assert 0 < b.batches_executed - before[0] < b.queries_batched - before[1]
    assert runtime.routes["mesh_fused_dense"] == len(qs)
    for q, g in zip(qs, got):
        want = ask(plain, st1, q)
        assert (g is None) == (want is None), q[0]
        if g is None:
            continue
        assert g[0] == want[0] and g[3] == want[3], q[0]
        assert np.array_equal(g[1], want[1]), q[0]
        if q[3]:
            np.testing.assert_allclose(np.asarray(g[2], np.float64),
                                       np.asarray(want[2], np.float64),
                                       rtol=1e-5)
