"""Port parity for ``DeviceIndex``: both packages built from one
``BuiltIndex`` of the synthetic EN+JA corpus must hold the same arrays and
answer every AND query (dense, sparse, NOT, filter rows, count-only,
limits in both directions, after deletes) identically."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from mygramdb_tpu.index import device_index as JD
from mygramdb_tpu_torch.convert import state_from_jax
from mygramdb_tpu_torch.index import device_index as TD

from torch_parity import (build_corpus, i32, random_queries,  # noqa: F401
                          torch_cpu)

OPTS = [dict(limit=0), dict(limit=10), dict(limit=10, descending=False),
        dict(limit=300), dict(count_only=True)]


@pytest.fixture(scope="module")
def pair(torch_cpu):
    built = build_corpus(3000)
    jdev = JD.DeviceIndex(built, dense_df_ratio=0.05)
    tdev = TD.DeviceIndex(built, dense_df_ratio=0.05)
    return built, jdev, tdev


def test_state_from_jax_equals_port_state(pair):
    _, jdev, tdev = pair
    sj, st = state_from_jax(jdev), tdev.state()
    assert sj.keys() == st.keys()
    for k in sj:
        assert np.array_equal(np.asarray(sj[k]), np.asarray(st[k])), k
    assert tdev.n_dense > 0 and st["postings"].size < pair[0].postings.size


@pytest.mark.parametrize("opts", OPTS, ids=lambda o: str(o))
def test_search_and_matches_jax(pair, opts):
    built, jdev, tdev = pair
    for tids, nots in random_queries(built, tdev, 25, seed=len(str(opts))):
        j = jdev.search_and(tids, nots, None, JD.SearchOptions(**opts))
        t = tdev.search_and(tids, nots, None, TD.SearchOptions(**opts))
        assert j[0] == t[0], (tids, nots)
        assert np.array_equal(j[1], t[1]), (tids, nots)
        assert t[1].dtype == np.int32


def test_filter_rows_match_jax(pair):
    built, jdev, tdev = pair
    rng = np.random.default_rng(9)
    words = rng.integers(0, 2 ** 32, size=(2, tdev.n_words), dtype=np.uint32)
    ej = [jnp.asarray(w) for w in words]
    et = [i32(w) for w in words]
    for tids, nots in random_queries(built, tdev, 20, seed=4):
        for opts in (dict(limit=0), dict(limit=50), dict(count_only=True)):
            j = jdev.search_and(tids, nots, ej, JD.SearchOptions(**opts))
            t = tdev.search_and(tids, nots, et, TD.SearchOptions(**opts))
            assert j[0] == t[0] and np.array_equal(j[1], t[1])


def test_deletes_match_jax(torch_cpu):
    built = build_corpus(2500, seed=8)
    jdev = JD.DeviceIndex(built, dense_df_ratio=0.05)
    tdev = TD.DeviceIndex(built, dense_df_ratio=0.05)
    gone = list(range(3, 2500, 7))
    jdev.mark_deleted(gone)
    tdev.mark_deleted(gone)
    jdev.unmark_deleted(gone[:10])
    tdev.unmark_deleted(gone[:10])
    assert tdev.deleted_count() == jdev.deleted_count()
    assert np.array_equal(state_from_jax(jdev)["deleted"],
                          tdev.state()["deleted"])
    for tids, nots in random_queries(built, tdev, 15, seed=2):
        for opts in OPTS:
            j = jdev.search_and(tids, nots, None, JD.SearchOptions(**opts))
            t = tdev.search_and(tids, nots, None, TD.SearchOptions(**opts))
            assert j[0] == t[0] and np.array_equal(j[1], t[1])


def test_from_state_serves_like_the_original(pair):
    built, jdev, tdev = pair
    copy = TD.DeviceIndex.from_state(state_from_jax(jdev), built)
    for tids, nots in random_queries(built, tdev, 15, seed=6):
        for opts in OPTS:
            a = copy.search_and(tids, nots, None, TD.SearchOptions(**opts))
            b = tdev.search_and(tids, nots, None, TD.SearchOptions(**opts))
            assert a[0] == b[0] and np.array_equal(a[1], b[1])


def batch_inputs(built, tdev, seed):
    """Batched candidate-probe inputs as the micro-batcher builds them."""
    qs = random_queries(built, tdev, 12, seed)
    B, Ks, Kd = len(qs), 8, 8
    d_off = np.zeros(B, np.int64)
    d_len = np.zeros(B, np.int64)
    sp_off = np.zeros((B, Ks), np.int64)
    sp_len = np.zeros((B, Ks), np.int64)
    sp_inv = np.ones((B, Ks), bool)
    dn_rows = np.full((B, Kd), tdev.ones_row, np.int32)
    dn_inv = np.zeros((B, Kd), bool)
    for i, (tids, nots) in enumerate(qs):
        dense, sparse = tdev.classify(tids)
        nd, ns = tdev.classify(nots)
        if not sparse:
            continue  # all-dense queries leave an inert (empty) lane
        sparse.sort(key=lambda t: built.lengths[t])
        d_off[i], d_len[i] = tdev.dev_offsets[sparse[0]], built.lengths[
            sparse[0]]
        for k, (t, inv) in enumerate([(t, False) for t in sparse[1:]]
                                     + [(t, True) for t in ns]):
            sp_off[i, k], sp_len[i, k], sp_inv[i, k] = \
                tdev.dev_offsets[t], built.lengths[t], inv
        for k, (r, inv) in enumerate([(r, False) for r in dense]
                                     + [(r, True) for r in nd]):
            dn_rows[i, k], dn_inv[i, k] = r, inv
    return d_off, d_len, sp_off, sp_len, sp_inv, dn_rows, dn_inv


@pytest.mark.parametrize("probe_free", [False, True])
@pytest.mark.parametrize("has_extra", [False, True])
@pytest.mark.parametrize("descending", [True, False])
def test_sparse_query_batch_matches_jax(pair, probe_free, has_extra,
                                        descending):
    built, jdev, tdev = pair
    d_off, d_len, sp_off, sp_len, sp_inv, dn_rows, dn_inv = batch_inputs(
        built, tdev, seed=3)
    rng = np.random.default_rng(11)
    extra = rng.integers(0, 2 ** 32, size=(2, tdev.n_words), dtype=np.uint32)
    kw = dict(C=2048, Cmax=2048, limit_b=128, descending=descending,
              n_words=tdev.n_words, has_extra=has_extra,
              probe_free=probe_free)
    cj, ij = JD._sparse_query_batch(
        jdev.postings, jdev.bitmaps, jdev.deleted,
        jnp.asarray(d_off.astype(np.int32)),
        jnp.asarray(d_len.astype(np.int32)),
        jnp.asarray(sp_off.astype(np.int32)),
        jnp.asarray(sp_len.astype(np.int32)), jnp.asarray(sp_inv),
        jnp.asarray(dn_rows), jnp.asarray(dn_inv), jnp.asarray(extra), **kw)
    ct, it = TD._sparse_query_batch(
        tdev.postings, tdev.bitmaps, tdev.deleted, torch.from_numpy(d_off),
        torch.from_numpy(d_len), torch.from_numpy(sp_off),
        torch.from_numpy(sp_len), torch.from_numpy(sp_inv),
        torch.from_numpy(dn_rows), torch.from_numpy(dn_inv), i32(extra),
        **kw)
    assert np.array_equal(ct.numpy(), np.asarray(cj))
    assert np.array_equal(it.numpy(), np.asarray(ij))
    assert int(ct.sum()) > 0


def test_filter_by_ngrams_and_memory(pair):
    built, jdev, tdev = pair
    cands = np.arange(1, 3000, 3, dtype=np.int32)
    for tids, _ in random_queries(built, tdev, 10, seed=5):
        assert np.array_equal(jdev.filter_by_ngrams(cands, tids),
                              tdev.filter_by_ngrams(cands, tids))
    assert tdev.memory_usage() > 0
    tdev.warmup()


def test_paths_not_ported_raise(pair):
    """Nothing of the index raises any more (the name is kept from when
    the positional paths were placeholders): without positions both
    packages refuse a positional plan; with them the port's
    ``plan_positional`` and ``search_verified_positional`` answer as the
    JAX package's (``tests/test_torch_positional.py`` has the rest)."""
    from test_positional import build, norm
    from mygramdb_tpu.utils.textproc import query_gram_offsets
    built, jdev, tdev = pair
    tid = int(np.argmax(built.lengths))
    assert tdev.positional is None and tdev.plan_positional([(tid, 0)]) \
        is None and jdev.plan_positional([(tid, 0)]) is None
    pbuilt = build()
    pj = JD.DeviceIndex(pbuilt, dense_df_ratio=0.5)
    pt = TD.DeviceIndex(pbuilt, dense_df_ratio=0.5)
    for term in ("日本", "quick", "東京"):
        pairs, _ = query_gram_offsets(norm(term), 2, 1, True)
        to = [(pbuilt.term_dict.get(g), o) for g, o in pairs]
        j = pj.search_verified_positional(pj.plan_positional(to), 128, True)
        t = pt.search_verified_positional(pt.plan_positional(to), 128, True)
        assert (int(j[0]), int(j[3])) == (t[0], t[3])
        assert np.array_equal(np.asarray(j[1]), t[1])
    # the boolean, OR and fuzzy paths are ported
    assert tdev.search_or([1]).dtype == np.int32
    assert tdev.search_by_threshold([1], 1).dtype == np.int32
    assert tdev.ast_words(("t", 0), [[1]], tdev._ones_words).dtype \
        == np.uint32


def test_mesh_shards_build_a_sharded_index(pair):
    """``mesh_shards`` > 1 (ROADMAP item 13, ported) doc-shards the index
    and answers as the single-device index does."""
    built, _, tdev = pair
    mesh = TD.DeviceIndex(built, dense_df_ratio=0.05, mesh_shards=2)
    assert mesh.mesh.shape["docs"] == 2 and mesh.postings is None
    assert mesh.text_doc_sharding is mesh.mesh
    for tids, nots in random_queries(built, tdev, 20, seed=8):
        for opts in OPTS:
            o = TD.SearchOptions(**opts)
            t1, i1 = tdev.search_and(tids, nots, opts=o)
            t2, i2 = mesh.search_and(tids, nots, opts=o)
            assert t1 == t2 and np.array_equal(i1, i2), (tids, nots, opts)


def test_cuda_requested_without_a_card_raises(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.setenv("MYGRAM_TORCH_DEVICE", "cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        TD.DeviceIndex(build_corpus(50))
