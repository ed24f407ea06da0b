"""Port parity for the doc-sharded mesh (``mygramdb_tpu_torch.parallel``
and the sharded branches of ``DeviceIndex`` and ``DeviceTextStore``).

Every test of ``tests/test_parallel.py`` has its analog here: the JAX mesh
runs on the 8 virtual CPU devices of ``tests/conftest.py`` and the port's
mesh on 8 CPU shards, over the same numpy-seeded inputs and one
``BuiltIndex``. Counts and ids are exact; BM25 scores hold to the
tolerance of ``tests/test_torch_fused.py`` (rtol 1e-5) with the same tie
order. Beyond the analogs: the port's R2 accounting (exact bytes), config
errors, fewer cards than shards, random query parity over the EN+JA
corpus (dense, sparse, NOT, FILTER, OR, fuzzy, trees), a JAX mesh index
carried across, the sharded text store's exact path, and a term absent
from a shard's doc range giving zeros."""

import numpy as np
import pytest
import torch

from mygramdb_tpu.index import DeviceIndex as JDI
from mygramdb_tpu.index import IndexBuilder
from mygramdb_tpu.index import SearchOptions as JSO
from mygramdb_tpu.parallel import ShardedQueryEngine as JEngine
from mygramdb_tpu.parallel import make_mesh as jmake_mesh
from mygramdb_tpu.storage.device_text import DeviceTextStore as JStore
from mygramdb_tpu_torch.convert import sharded_state_from_jax
from mygramdb_tpu_torch.index.device_index import DeviceIndex as TDI
from mygramdb_tpu_torch.index.device_index import SearchOptions as TSO
from mygramdb_tpu_torch.ops import runtime
from mygramdb_tpu_torch.parallel import mesh as tmesh
from mygramdb_tpu_torch.parallel import ShardedQueryEngine as TEngine
from mygramdb_tpu_torch.storage.device_text import DeviceTextStore as TStore

from torch_parity import build_corpus, random_queries, torch_cpu  # noqa: F401

CPU8 = [torch.device("cpu")] * 8
OPTS = [dict(limit=0), dict(limit=10), dict(limit=10, descending=False),
        dict(limit=300), dict(count_only=True)]


def make_bitmaps(n_terms=6, n_words=256, seed=0):
    """Random doc sets; returns (bitmaps, per-term doc id sets)."""
    rng = np.random.default_rng(seed)
    bitmaps = np.zeros((n_terms + 2, n_words), dtype=np.uint32)
    doc_sets = []
    for t in range(n_terms):
        ids = np.unique(rng.integers(1, n_words * 32, size=500))
        np.bitwise_or.at(bitmaps[t], ids >> 5, np.left_shift(
            np.uint32(1), (ids & 31).astype(np.uint32)))
        doc_sets.append(set(ids.tolist()))
    bitmaps[n_terms] = 0xFFFFFFFF  # ones sentinel
    return bitmaps, doc_sets


def both(jdev, tdev, call):
    """call(index, options class) on both packages."""
    return call(jdev, JSO), call(tdev, TSO)


def same(a, b):
    assert a[0] == b[0]
    assert np.asarray(a[1]).tolist() == np.asarray(b[1]).tolist()


# ---------------------------------------------------------------------------
# tests/test_parallel.py analogs
# ---------------------------------------------------------------------------

def test_sharded_query_matches_host(eight_cpu_devices):
    bitmaps, doc_sets = make_bitmaps()
    deleted = np.zeros(256, dtype=np.uint32)
    eng = TEngine(tmesh.make_mesh(8, dp=2, devices=CPU8), bitmaps, deleted,
                  topk=16)
    jeng = JEngine(jmake_mesh(8, dp=2), bitmaps, deleted, topk=16)
    rows = np.asarray([[0, 1, 6, 6], [2, 3, 6, 6], [0, 6, 6, 6],
                       [4, 5, 6, 6]], dtype=np.int32)
    counts, ids = eng.search(rows)
    jcounts, jids = jeng.search(rows)
    assert counts.tolist() == jcounts.tolist()
    assert ids.tolist() == jids.tolist()
    expected = [doc_sets[0] & doc_sets[1], doc_sets[2] & doc_sets[3],
                doc_sets[0], doc_sets[4] & doc_sets[5]]
    for b, exp in enumerate(expected):
        assert counts[b] == len(exp)
        assert [i for i in ids[b].tolist() if i >= 0] == \
            sorted(exp, reverse=True)[:16]


def test_sharded_update(eight_cpu_devices):
    bitmaps, doc_sets = make_bitmaps()
    deleted = np.zeros(256, dtype=np.uint32)
    eng = TEngine(tmesh.make_mesh(8, dp=1, devices=CPU8), bitmaps, deleted,
                  topk=16)
    jeng = JEngine(jmake_mesh(8, dp=1), bitmaps, deleted, topk=16)
    for e in (eng, jeng):
        e.apply_delta(np.asarray([0, 0, 0, 0], dtype=np.int32),
                      np.asarray([4100, 4101, 4102, 4103], dtype=np.int32))
    rows = np.asarray([[0, 6, 6, 6]], dtype=np.int32)
    counts, ids = eng.search(rows)
    jcounts, jids = jeng.search(rows)
    exp = doc_sets[0] | {4100, 4101, 4102, 4103}
    assert counts[0] == jcounts[0] == len(exp)
    assert ids.tolist() == jids.tolist()
    # repeated pairs and pairs of other shards' ranges set each bit once
    eng.apply_delta(np.asarray([1, 1, 1, 2], dtype=np.int32),
                    np.asarray([70, 70, 8000, -1], dtype=np.int32))
    counts, _ = eng.search(np.asarray([[1, 6, 6, 6]], dtype=np.int32))
    assert counts[0] == len(doc_sets[1] | {70, 8000})


def test_dryrun_multichip_analog():
    """``__graft_entry__.dryrun_multichip`` on the port: one delta-apply,
    then a batched query over the docs axis, the batch split over dp."""
    mesh = tmesh.make_mesh(dp=2, devices=CPU8)
    n_words = 128
    rng = np.random.default_rng(3)
    bitmaps = np.zeros((16, n_words), dtype=np.uint32)
    bitmaps[:14] = rng.integers(0, 2 ** 32, size=(14, n_words),
                                dtype=np.uint32) & rng.integers(
        0, 2 ** 32, size=(14, n_words), dtype=np.uint32)
    bitmaps[14] = 0xFFFFFFFF
    eng = TEngine(mesh, bitmaps, np.zeros(n_words, dtype=np.uint32), topk=16)
    eng.apply_delta(np.asarray([0, 0, 1, 2], dtype=np.int32),
                    np.asarray([33, 34, 65, 97], dtype=np.int32))
    rows = np.full((8, 4), 14, dtype=np.int32)
    rows[:, 0] = np.arange(8) % 14
    counts, ids = eng.search(rows)
    assert counts.shape == (8,) and ids.shape == (8, 16)
    assert int(counts[0]) > 0
    assert 33 in set(ids[0].tolist()) or int(counts[0]) > 16


@pytest.fixture(scope="module")
def greek():
    rng = np.random.default_rng(17)
    words = ["alpha", "beta", "gamma", "delta", "omega"]
    b = IndexBuilder()
    for i in range(1, 40001):
        b.add_document(i, " ".join(rng.choice(words, size=4)))
    return b.finalize()


class TestShardedDeviceIndex:

    def test_sharded_matches_unsharded(self, eight_cpu_devices, greek):
        built = greek
        j8 = JDI(built, dense_df_ratio=0.001, mesh_shards=8)
        t8 = TDI(built, dense_df_ratio=0.001, mesh_shards=8)
        t1 = TDI(built, dense_df_ratio=0.001)
        assert t8.mesh is not None and t8.mesh.shape["docs"] == 8
        tids = [built.term_dict.get(g) for g in ["al", "ph"]]
        for opts in OPTS:
            j, t = both(j8, t8, lambda d, O: d.search_and(tids, opts=O(**opts)))
            same(j, t)
            same(t, t1.search_and(tids, opts=TSO(**opts)))

    def test_sparse_csr_doc_sharded(self, eight_cpu_devices):
        """R2's analog: the port's sharded CSR holds sparse slices only,
        each shard its own postings with no padding, so a device holds
        exactly 4 bytes per posting of the largest shard."""
        rng = np.random.default_rng(23)
        words = [f"w{i:03d}" for i in range(400)]
        b = IndexBuilder()
        for i in range(1, 40001):
            b.add_document(i, " ".join(rng.choice(words, size=5)))
        built = b.finalize()
        t1 = TDI(built, dense_df_ratio=0.5)
        t8 = TDI(built, dense_df_ratio=0.5, mesh_shards=8)
        j8 = JDI(built, dense_df_ratio=0.5, mesh_shards=8)
        assert t8.postings_sh is not None
        sparse = t8.dense_row < 0
        post = np.concatenate([built.postings_of(t)
                               for t in np.flatnonzero(sparse)])
        per_shard = np.bincount(post // t8.shard_docs, minlength=8)
        assert t8.per_device_sparse_bytes() == 4 * int(per_shard.max())
        assert [p.numel() for p in t8.postings_sh.parts] == per_shard.tolist()
        assert t1.per_device_sparse_bytes() == 4 * post.size
        grams = ["w0", "01", "w1", "23"]
        tids = [built.term_dict.get(g) for g in grams
                if built.term_dict.get(g) is not None]
        assert len(tids) >= 2
        for opts in OPTS:
            j, t = both(j8, t8, lambda d, O: d.search_and(tids, opts=O(**opts)))
            same(j, t)
            same(t, t1.search_and(tids, opts=TSO(**opts)))

    def test_r2_cause(self, eight_cpu_devices):
        """What R2 measures, from the JAX test's own data: the JAX sharded
        CSR keeps every dense term's slice that its single-device CSR
        drops, and 3 of its 8 shards are empty (40,000 docs in a capacity
        of 65,536), so the largest shard holds about a fifth of all
        postings, not an eighth."""
        rng = np.random.default_rng(23)
        words = [f"w{i:03d}" for i in range(400)]
        b = IndexBuilder()
        for i in range(1, 40001):
            b.add_document(i, " ".join(rng.choice(words, size=5)))
        built = b.finalize()
        j1 = JDI(built, dense_df_ratio=0.5)
        j8 = JDI(built, dense_df_ratio=0.5, mesh_shards=8)
        shard_sizes = np.bincount(built.postings // j8.shard_docs,
                                  minlength=8)
        assert (shard_sizes == 0).sum() == 3 and j1.n_dense > 0
        from mygramdb_tpu.ops.posting_ops import SLICE_GATHER_PAD
        assert j8.per_device_sparse_bytes() == \
            4 * (int(shard_sizes.max()) + SLICE_GATHER_PAD)
        sparse_total = int(built.lengths[j1.dense_row < 0].sum())
        assert j1.per_device_sparse_bytes() == \
            4 * (sparse_total + SLICE_GATHER_PAD)
        # the ratio the JAX test asserts is at least 4: here below it
        ratio = sparse_total / int(shard_sizes.max())
        assert 3.5 < ratio < 4

    def test_sharded_tombstones(self, eight_cpu_devices):
        b = IndexBuilder()
        for i in range(1, 40001):
            b.add_document(i, "needle text")
        built = b.finalize()
        idx = TDI(built, dense_df_ratio=0.001, mesh_shards=8)
        jdx = JDI(built, dense_df_ratio=0.001, mesh_shards=8)
        t = built.term_dict.get("ne")
        assert idx.search_and([t])[0] == 40000
        for d in (idx, jdx):
            d.mark_deleted([1, 2, 3, 9000, 39999])
        assert idx.search_and([t])[0] == jdx.search_and([t])[0] == 39995
        idx.unmark_deleted([9000])
        assert idx.search_and([t])[0] == 39996
        assert idx.deleted_count() == 4


class TestShardedFusedVerify:

    @staticmethod
    def _corpus(n=4000, seed=11):
        rng = np.random.default_rng(seed)
        texts, phrase_ids = {}, set()
        for i in range(1, n + 1):
            r = rng.random()
            if r < 0.25:
                texts[i] = "xx alpha beta yy"
                phrase_ids.add(i)
            elif r < 0.5:
                texts[i] = "alpha zz beta ww"
            elif r < 0.75:
                texts[i] = "alpha only here"
            else:
                texts[i] = "plain filler text"
        return texts, phrase_ids

    @staticmethod
    def _build(texts, shards):
        b = IndexBuilder()
        for i, t in texts.items():
            b.add_document(i, t)
        built = b.finalize()
        jdx = JDI(built, dense_df_ratio=0.9, mesh_shards=shards)
        jst = JStore(texts, jdx.n_docs_capacity,
                     doc_sharding=jdx.text_doc_sharding)
        tdx = TDI(built, dense_df_ratio=0.9, mesh_shards=shards)
        tst = TStore(texts, tdx.n_docs_capacity,
                     doc_sharding=tdx.text_doc_sharding)
        return built, (jdx, jst), (tdx, tst)

    @staticmethod
    def _needles(*terms):
        ndl = np.zeros((len(terms), 32), dtype=np.uint32)
        lens = np.zeros(len(terms), dtype=np.int32)
        for i, t in enumerate(terms):
            cp = np.frombuffer(t.encode("utf-32-le"), dtype=np.uint32)
            ndl[i, :cp.size] = cp
            lens[i] = cp.size
        return ndl, lens

    def _three(self, texts, **kw):
        built, (j8, js8), (t8, ts8) = self._build(texts, 8)
        _, _, (t1, ts1) = self._build(texts, 1)
        assert t8.postings_sh is not None and ts8.doc_sharded
        assert len(ts8.shards) == 8
        tids = [built.term_dict.get(g) for g in ["al", "lp", "be", "et"]]
        ndl, nlens = self._needles("alpha beta")
        out = [d.search_and_verified(tids, s, ndl, nlens, **kw)
               for d, s in ((j8, js8), (t8, ts8), (t1, ts1))]
        assert all(r is not None for r in out)
        return out

    def test_matches_single_chip_and_bruteforce(self, eight_cpu_devices):
        texts, phrase_ids = self._corpus()
        runtime.reset_launches()
        r8j, r8, r1 = self._three(texts, limit_b=128, descending=True)
        assert runtime.routes["mesh_fused_sparse"] == 1
        assert r8[0] == r8j[0] == r1[0] == len(phrase_ids)
        exp = sorted(phrase_ids, reverse=True)[:128]
        assert [i for i in r8[1].tolist() if i >= 0] == exp
        assert r8[1].tolist() == r8j[1].tolist() == r1[1].tolist()

    def test_ascending_and_filter_row(self, eight_cpu_devices):
        import jax
        texts, phrase_ids = self._corpus(seed=5)
        built, (j8, js8), (t8, ts8) = self._build(texts, 8)
        tids = [built.term_dict.get(g) for g in ["al", "lp", "be", "et"]]
        ndl, nlens = self._needles("alpha beta")
        even = np.arange(2, len(texts) + 1, 2, dtype=np.int64)
        from mygramdb_tpu_torch.ops.bitmap_ops import make_bitmap_from_ids
        row = make_bitmap_from_ids(even, t8.n_words)
        rj = j8.search_and_verified(
            tids, js8, ndl, nlens, limit_b=64, descending=False,
            extra_words=[jax.device_put(row, j8._row_sharding)])
        rt = t8.search_and_verified(
            tids, ts8, ndl, nlens, limit_b=64, descending=False,
            extra_words=[runtime.to_device(row, t8._device)])
        exp_set = {d for d in phrase_ids if d % 2 == 0}
        assert rt[0] == rj[0] == len(exp_set)
        assert [i for i in rt[1].tolist() if i >= 0] == sorted(exp_set)[:64]
        assert rt[1].tolist() == rj[1].tolist()

    @pytest.mark.parametrize("require_match", [True, False])
    def test_score_mode_matches_single_chip(self, eight_cpu_devices,
                                            require_match):
        texts, _ = self._corpus(seed=13 if require_match else 17)
        idf = np.asarray([1.7 if require_match else 0.9], dtype=np.float32)
        r8j, r8, r1 = self._three(
            texts, limit_b=64, descending=True, score_mode=True, idf=idf,
            k1=1.2, b=0.75, avgdl=4.0, require_match=require_match)
        assert r8[0] == r8j[0] == r1[0]
        assert r8[1].tolist() == r8j[1].tolist() == r1[1].tolist()
        np.testing.assert_allclose(r8[2], r8j[2], rtol=1e-5)
        np.testing.assert_allclose(r8[2], r1[2], rtol=1e-5)

    def test_tombstones_respected(self, eight_cpu_devices):
        texts, phrase_ids = self._corpus(seed=7)
        built, (j8, js8), (t8, ts8) = self._build(texts, 8)
        dead = sorted(phrase_ids)[:3]
        for d in (j8, t8):
            d.mark_deleted(dead)
        tids = [built.term_dict.get(g) for g in ["al", "lp", "be", "et"]]
        ndl, nlens = self._needles("alpha beta")
        rj = j8.search_and_verified(tids, js8, ndl, nlens, limit_b=128,
                                    descending=True)
        r = t8.search_and_verified(tids, ts8, ndl, nlens, limit_b=128,
                                   descending=True)
        assert r[0] == rj[0] == len(phrase_ids) - 3
        assert not set(dead) & {i for i in r[1].tolist() if i >= 0}
        assert r[1].tolist() == rj[1].tolist()

    def test_dense_driver_and_exact_path(self, eight_cpu_devices):
        """A dense driver runs K1 then the verify a shard; the text store's
        exact-path calls (verify, contains, TF, BM25 top-n) go to the
        shard holding each candidate and equal the whole store's."""
        texts, phrase_ids = self._corpus(seed=21)
        b = IndexBuilder()
        for i, t in texts.items():
            b.add_document(i, t)
        built = b.finalize()
        t8 = TDI(built, dense_df_ratio=0.05, mesh_shards=8)
        t1 = TDI(built, dense_df_ratio=0.05)
        ts8 = TStore(texts, t8.n_docs_capacity,
                     doc_sharding=t8.text_doc_sharding)
        ts1 = TStore(texts, t1.n_docs_capacity)
        tids = [built.term_dict.get(g) for g in ["al", "lp", "be", "et"]]
        assert all(t8.dense_row[t] >= 0 for t in tids)
        ndl, nlens = self._needles("alpha beta")
        runtime.reset_launches()
        for kw in (dict(limit_b=128, descending=True),
                   dict(limit_b=64, descending=False),
                   dict(limit_b=32, descending=True, score_mode=True,
                        idf=np.asarray([1.1], dtype=np.float32),
                        avgdl=4.0)):
            r8 = t8.search_and_verified(tids, ts8, ndl, nlens, **kw)
            r1 = t1.search_and_verified(tids, ts1, ndl, nlens, **kw)
            assert r8[0] == r1[0] == len(phrase_ids)
            assert r8[1].tolist() == r1[1].tolist()
            np.testing.assert_allclose(r8[2], r1[2], rtol=1e-5)
        assert runtime.routes["mesh_fused_dense"] == 3
        cands = np.arange(1, len(texts) + 1, dtype=np.int64)
        fb = lambda ids: [texts.get(int(i)) for i in ids]  # noqa: E731
        assert np.array_equal(ts8.verify(cands, ["alpha beta"], fb),
                              ts1.verify(cands, ["alpha beta"], fb))
        assert np.array_equal(ts8.contains_masks(cands, ["beta", "xx"], fb),
                              ts1.contains_masks(cands, ["beta", "xx"], fb))
        for a, c in zip(ts8.count_tf(cands, ["a", "al"], fb),
                        ts1.count_tf(cands, ["a", "al"], fb)):
            assert np.array_equal(a, c)
        s8 = ts8.score_topk(cands, ["alpha"], np.ones(1, np.float32), 4.0,
                            1.2, 0.75, 50, fb)
        s1 = ts1.score_topk(cands, ["alpha"], np.ones(1, np.float32), 4.0,
                            1.2, 0.75, 50, fb)
        assert s8[0].tolist() == s1[0].tolist()
        np.testing.assert_allclose(s8[1], s1[1], rtol=1e-5)
        assert ts8.memory_usage() == sum(ts8.shard_memory())
        assert len(ts8.shard_memory()) == 8

    def test_flat_layout_on_a_mesh_takes_the_exact_path(
            self, eight_cpu_devices, monkeypatch):
        texts, _ = self._corpus(seed=3)
        monkeypatch.setenv("MYGRAM_TEXT_LAYOUT", "flat")
        built, _, (t8, ts8) = self._build(texts, 8)
        assert not ts8.doc_sharded and ts8.codepoints.dim() == 1
        tids = [built.term_dict.get(g) for g in ["al", "lp", "be", "et"]]
        ndl, nlens = self._needles("alpha beta")
        runtime.reset_launches()
        assert t8.search_and_verified(tids, ts8, ndl, nlens, limit_b=16,
                                      descending=True) is None
        assert runtime.routes["mesh_to_exact"] == 1


class TestShardedAstWords:

    def test_matches_single_chip(self, eight_cpu_devices):
        rng = np.random.default_rng(31)
        words = ["alpha", "beta", "gamma", "delta"]
        b = IndexBuilder()
        docs = {}
        for i in range(1, 20001):
            docs[i] = " ".join(rng.choice(words, size=rng.integers(1, 4)))
            b.add_document(i, docs[i])
        built = b.finalize()
        t1 = TDI(built, dense_df_ratio=0.9)
        t8 = TDI(built, dense_df_ratio=0.9, mesh_shards=8)
        j8 = JDI(built, dense_df_ratio=0.9, mesh_shards=8)
        leaf_tids = [[built.term_dict.get("al")], [built.term_dict.get("be")],
                     [built.term_dict.get("ga")]]
        sig = ("&", ("t", 0), ("|", ("t", 1), ("!", ("t", 2))))
        all_ids = np.arange(1, 20001, dtype=np.int64)
        w1 = t1.ast_words(sig, leaf_tids, t1.universe_words(all_ids))
        runtime.reset_launches()
        w8 = t8.ast_words(sig, leaf_tids, t8.universe_words(all_ids))
        assert runtime.routes["mesh_ast"] == 1
        wj = j8.ast_words(sig, leaf_tids, j8.universe_words(all_ids))
        assert np.array_equal(w1, w8) and np.array_equal(w8, np.asarray(wj))
        exp = {i for i, t in docs.items()
               if "al" in t and ("be" in t or "ga" not in t)}
        bits = np.unpackbits(w8.view(np.uint8), bitorder="little")
        assert set(np.flatnonzero(bits).tolist()) == exp

    def test_shard_empty_slice_gives_zeros(self):
        """A term whose documents all lie in shard 0's range has empty
        slices on the other shards: there its leaf is zeros, not the
        padding identity (else ``rare AND common`` matches everywhere)."""
        b = IndexBuilder()
        docs = {i: ("rare common" if i < 100 else "common only")
                for i in range(1, 30001)}
        for i, t in docs.items():
            b.add_document(i, t)
        built = b.finalize()
        t8 = TDI(built, dense_df_ratio=0.9, mesh_shards=8)
        rare = built.term_dict.get("ra")
        assert t8.dense_row[rare] < 0
        assert (t8.lengths_sh[1:, rare] == 0).all()
        w = t8.ast_words(("&", ("t", 0), ("t", 1)),
                         [[rare], [built.term_dict.get("co")]],
                         t8._ones_words)
        bits = np.unpackbits(w.view(np.uint8), bitorder="little")
        assert np.flatnonzero(bits).tolist() == list(range(1, 100))
        total, ids = t8.search_and([rare, built.term_dict.get("co")],
                                   opts=TSO(limit=0))
        assert total == 99 and ids.tolist() == list(range(1, 100))


# ---------------------------------------------------------------------------
# Configuration and placement
# ---------------------------------------------------------------------------

def test_shards_that_do_not_divide_the_words_are_a_config_error(greek):
    for S in (3, 5, 6):
        with pytest.raises(ValueError, match="mesh_shards"):
            TDI(greek, mesh_shards=S)
    # n_words 2,048: every power of two that divides it works
    assert TDI(greek, mesh_shards=2).mesh.shape["docs"] == 2


def test_fewer_cards_than_shards_still_runs_every_shard(monkeypatch):
    """Shard i runs on card i mod the card count: two cards, five
    shards; the CPU runs all eight shards on the one host."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    devs = tmesh.default_devices(5, "cuda")
    assert [str(d) for d in devs] == ["cuda:0", "cuda:1", "cuda:0",
                                      "cuda:1", "cuda:0"]
    assert tmesh.default_devices(8, "cpu") == CPU8
    mesh = tmesh.make_mesh(devices=devs)
    assert mesh.shape == {"dp": 1, "docs": 5}
    assert mesh.layout().startswith("shard 0: cuda:0, shard 1: cuda:1")


# ---------------------------------------------------------------------------
# The EN+JA corpus: every route against the JAX mesh and the port at 1
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trio(torch_cpu):
    built = build_corpus(3000)
    j8 = JDI(built, dense_df_ratio=0.05, mesh_shards=8)
    t8 = TDI(built, dense_df_ratio=0.05, mesh_shards=8)
    t1 = TDI(built, dense_df_ratio=0.05)
    return built, j8, t8, t1


@pytest.mark.parametrize("opts", OPTS, ids=lambda o: str(o))
def test_search_and_matches_jax_mesh(eight_cpu_devices, trio, opts):
    built, j8, t8, t1 = trio
    runtime.reset_launches()
    for tids, nots in random_queries(built, t8, 40, seed=9):
        j, t = both(j8, t8, lambda d, O: d.search_and(tids, nots,
                                                      opts=O(**opts)))
        same(j, t)
        same(t, t1.search_and(tids, nots, opts=TSO(**opts)))
    assert runtime.routes["mesh_dense"] > 0
    assert runtime.routes["mesh_sparse"] > 0


def test_filters_or_threshold_and_trees_match_jax_mesh(eight_cpu_devices,
                                                       trio):
    import jax
    built, j8, t8, t1 = trio
    rng = np.random.default_rng(4)
    from mygramdb_tpu_torch.ops.bitmap_ops import make_bitmap_from_ids
    row = make_bitmap_from_ids(rng.choice(np.arange(1, 3000), 1500,
                                          replace=False), t8.n_words)
    jrow = jax.device_put(row, j8._row_sharding)
    trow = runtime.to_device(row, t8._device)
    trow1 = runtime.to_device(row, t1._device)
    queries = random_queries(built, t8, 30, seed=12)
    runtime.reset_launches()
    for tids, nots in queries:
        for opts in (dict(limit=20), dict(count_only=True), dict(limit=0)):
            j = j8.search_and(tids, nots, [jrow], JSO(**opts))
            t = t8.search_and(tids, nots, [trow], TSO(**opts))
            same(j, t)
            same(t, t1.search_and(tids, nots, [trow1], TSO(**opts)))
        assert t8.search_or(tids + nots).tolist() == \
            j8.search_or(tids + nots).tolist() == \
            t1.search_or(tids + nots).tolist()
        for k in (1, 2):
            assert t8.search_by_threshold(tids + nots, k).tolist() == \
                j8.search_by_threshold(tids + nots, k).tolist()
        cands = np.arange(1, 3000, 7, dtype=np.int32)
        assert t8.filter_by_ngrams(cands, tids).tolist() == \
            t1.filter_by_ngrams(cands, tids).tolist()
    assert runtime.routes["mesh_or"] == len(queries)
    assert runtime.routes["threshold_host"] == 2 * len(queries)
    all_ids = np.arange(1, 3001, dtype=np.int64)
    u8, uj, u1 = (d.universe_words(all_ids) for d in (t8, j8, t1))
    sig = ("|", ("&", ("t", 0), ("!", ("t", 1))), ("t", 2))
    for q in range(0, 27, 3):
        leaves = [queries[q][0], queries[q + 1][0], queries[q + 2][0]]
        w8 = t8.ast_words(sig, leaves, u8)
        assert np.array_equal(w8, np.asarray(j8.ast_words(sig, leaves, uj)))
        assert np.array_equal(w8, t1.ast_words(sig, leaves, u1))
    # deletes reach every shard
    for d in (j8, t8, t1):
        d.mark_deleted(list(range(1, 3000, 5)))
    for tids, nots in queries[:10]:
        same(j8.search_and(tids, nots, opts=JSO(limit=50)),
             t8.search_and(tids, nots, opts=TSO(limit=50)))
    for d in (j8, t8, t1):
        d.unmark_deleted(list(range(1, 3000, 5)))


def test_jax_mesh_index_carried_across(eight_cpu_devices, trio):
    """``sharded_state_from_jax`` reads a JAX mesh index (its doc-sharded
    CSR with the dense slices dropped, bitmaps, tombstones) into the
    port's sharded state; ``from_state`` serves the same answers."""
    built, j8, t8, _ = trio
    j8.mark_deleted([7, 8, 2999])
    state = sharded_state_from_jax(j8)
    own = t8.state()
    assert state.keys() == own.keys()
    for k in ("bitmaps", "offsets_sh", "lengths_sh", "dense_row"):
        assert np.array_equal(state[k], own[k]), k
    assert all(np.array_equal(a, b) for a, b in zip(state["postings_sh"],
                                                    own["postings_sh"]))
    carried = TDI.from_state(state, built,
                             mesh=tmesh.make_mesh(devices=CPU8))
    for tids, nots in random_queries(built, carried, 25, seed=31):
        for opts in OPTS:
            same(j8.search_and(tids, nots, opts=JSO(**opts)),
                 carried.search_and(tids, nots, opts=TSO(**opts)))
    j8.unmark_deleted([7, 8, 2999])


def test_memory_and_warmup(trio):
    _, _, t8, t1 = trio
    assert t8.memory_usage() == sum(t8.shard_memory())
    assert len(t8.shard_memory()) == 8
    sparse_bytes = sum(p.numel() for p in t8.postings_sh.parts) * 4
    assert sparse_bytes == t1.postings.numel() * 4
    t8.warmup()
