"""The port's fused verified search against the JAX package's, on the CPU.

Both packages hold the same index and text pack (the port's taken from the
JAX objects by ``convert``). The dense- and sparse-driver batched programs
(probe-free, with filter rows, score mode with single and multi-term BM25
and a self-overlapping term, clipped compaction, the live-prefix K5 stage)
and ``DeviceIndex.search_and_verified`` must agree: pre, count and ids
exactly, scores within 1e-5 relative (float32 sums in another order).
"""

import numpy as np
import pytest
import torch

from mygramdb_tpu.index.builder import IndexBuilder
from mygramdb_tpu.index.device_index import DeviceIndex as JIndex
from mygramdb_tpu.ops import fused as jfused
from mygramdb_tpu.storage import device_text as jdt
from mygramdb_tpu.utils.textproc import generate_query_ngrams
from mygramdb_tpu_torch.convert import state_from_jax, text_state_from_jax
from mygramdb_tpu_torch.index.device_index import DeviceIndex as TIndex
from mygramdb_tpu_torch.ops import fused as tfused
from mygramdb_tpu_torch.ops import runtime
from mygramdb_tpu_torch.storage.device_text import DeviceTextStore

from torch_parity import torch_cpu  # noqa: F401

WORDS = ["alpha", "beta", "gamma", "quick", "brown", "fox", "aa", "aaaa",
         "検索", "日本語", "エンジン", "高速", "形態素"]
CAP = jdt.NEEDLE_CAP


@pytest.fixture(scope="module", params=["padded", "flat"])
def pair(request):
    rng = np.random.default_rng(9)
    p = 1.0 / np.arange(1, len(WORDS) + 1)  # rarer words drive sparse
    texts = {i: "".join(rng.choice(WORDS, size=int(rng.integers(2, 10)),
                                   p=p / p.sum()))
             for i in range(1, 601)}
    b = IndexBuilder(ngram_size=2, kanji_ngram_size=1)
    for did, t in texts.items():
        b.add_document(did, t)
    built = b.finalize()
    jidx = JIndex(built, dense_df_ratio=0.08, max_dense_terms=16)
    jidx.mark_deleted([5, 17, 300])
    with pytest.MonkeyPatch.context() as mp:
        if request.param == "flat":
            mp.setattr(jdt, "_PADDED_BUDGET_BYTES", 0)
        jst = jdt.DeviceTextStore(texts, capacity=jidx.n_docs_capacity)
    tidx = TIndex.from_state(state_from_jax(jidx), built, device="cpu")
    tst = DeviceTextStore.from_state(text_state_from_jax(jst), device="cpu")
    assert (tst.codepoints.dim() == 1) == (request.param == "flat")
    return request.param, built, texts, (jidx, jst), (tidx, tst)


def tids_of(built, terms):
    out = []
    for t in terms:
        for g in generate_query_ngrams(t, 2, kanji_ngram_size=1):
            tid = built.term_dict.get(g)
            assert tid is not None, (t, g)
            out.append(tid)
    return sorted(set(out))


def needles_of(terms, Nn=2):
    ndl, nl = jdt.DeviceTextStore._pack_needles(terms)
    ndl_p = np.zeros((Nn, CAP), dtype=np.uint32)
    ndl_p[:ndl.shape[0]] = ndl
    nl_p = np.zeros(Nn, dtype=np.int32)
    nl_p[:nl.shape[0]] = nl
    return ndl_p, nl_p


def filter_rows(idx, seed):
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 2 ** 32, idx.n_words, dtype=np.uint64)
    return w.astype(np.uint32)


def assert_same(j, t):
    assert (j is None) == (t is None)
    if j is None:
        return
    assert j[0] == t[0] and j[3] == t[3]
    assert np.array_equal(np.asarray(j[1]), np.asarray(t[1]))
    np.testing.assert_allclose(np.asarray(t[2], dtype=np.float64),
                               np.asarray(j[2], dtype=np.float64),
                               rtol=1e-5)


CASES = [
    (["検索"], {}),
    (["quick"], {}),
    (["検索", "alpha"], {}),
    (["形態素"], dict(descending=False)),
    (["quick"], dict(score_mode=True)),
    (["高速", "日本語"], dict(score_mode=True)),
    (["aa"], dict(score_mode=True, nonoverlap=True)),
    (["aaaa", "fox"], dict(score_mode=True, nonoverlap=True)),
    (["brown"], dict(score_mode=True, require_match=False)),
    (["検索"], dict(score_mode=True, force_probes=True)),
    (["gamma"], dict(filtered=True)),
    (["エンジン", "beta"], dict(filtered=True, score_mode=True)),
]


@pytest.mark.parametrize("terms,kw", CASES)
def test_search_and_verified_equals_jax(pair, terms, kw):
    layout, built, texts, (jidx, jst), (tidx, tst) = pair
    kw = dict(kw)
    extra_j, extra_t = (), ()
    if kw.pop("filtered", False):
        row = filter_rows(jidx, 3)
        import jax.numpy as jnp
        extra_j = (jnp.asarray(row),)
        extra_t = (torch.from_numpy(row.view(np.int32).copy()),)
    desc = kw.pop("descending", True)
    tids = tids_of(built, terms)
    ndl, nl = needles_of(terms)
    idf = np.asarray([1.3, 0.7], dtype=np.float32)
    args = (tids, None, ndl, nl, 64, desc)
    common = dict(idf=idf, k1=1.2, b=0.75, avgdl=30.0, **kw)
    runtime.reset_launches()
    j = jidx.search_and_verified(tids, jst, *args[2:], extra_words=extra_j,
                                 **common)
    t = tidx.search_and_verified(tids, tst, *args[2:], extra_words=extra_t,
                                 **common)
    assert_same(j, t)
    assert t is not None
    assert runtime.routes["fused_dense"] + runtime.routes["fused_sparse"] == 1
    if not kw and not extra_t:  # the brute-force verified count
        assert t[0] == sum(1 for d, x in texts.items()
                           if d not in (5, 17, 300)
                           and all(w in x for w in terms))


def spy_kernels(monkeypatch):
    """Record which wrapper of the kernel family the fused program calls
    (on the CPU each runs its plain version)."""
    ran = []
    for name in ("tf_rows_flat", "tf_rows_flat_global", "tf_rows_padded"):
        def spy(*a, _name=name, _fn=getattr(tfused, name), **k):
            ran.append(_name)
            return _fn(*a, **k)
        monkeypatch.setattr(tfused, name, spy)
    return ran


def expected_kernel(layout, mode):
    if layout == "padded":
        return "tf_rows_padded"
    return "tf_rows_flat_global" if mode == "global_pack" else "tf_rows_flat"


def plan_sparse(idx, tids, offsets):
    dense_rows, sparse = idx.classify(tids)
    sparse = sorted(sparse, key=lambda t: int(idx.lengths[t]))
    driver, probes = sparse[0], sparse[1:]
    sp_off = [int(offsets[t]) for t in probes] + [0] * (8 - len(probes))
    sp_len = ([int(idx.lengths[t]) for t in probes]
              + [0] * (8 - len(probes)))
    sp_inv = [False] * len(probes) + [True] * (8 - len(probes))
    dn_rows = list(dense_rows) + [idx.ones_row] * (8 - len(dense_rows))
    return (int(offsets[driver]), int(idx.lengths[driver]), sp_off, sp_len,
            sp_inv, dn_rows, [False] * 8)


SPARSE_BATCH = [["検索"], ["形態素", "quick"], ["日本語"], ["エンジン"],
                ["gamma", "高速"], ["brown"]]


@pytest.mark.parametrize("mode", ["probe_free", "probes", "clipped",
                                  "score", "filtered", "global_pack"])
def test_sparse_batch_equals_jax(pair, monkeypatch, mode):
    layout, built, texts, (jidx, jst), (tidx, tst) = pair
    ran = spy_kernels(monkeypatch)
    batch = [t for t in SPARSE_BATCH
             if tidx.classify(tids_of(built, t))[1]]
    B = len(batch)
    jp = [plan_sparse(jidx, tids_of(built, t), jidx.offsets32)
          for t in batch]
    tp = [plan_sparse(tidx, tids_of(built, t), tidx.dev_offsets)
          for t in batch]
    cols = [np.asarray([p[i] for p in jp]) for i in range(7)]
    tcols = [np.asarray([p[i] for p in tp]) for i in range(7)]
    ndl = np.stack([needles_of(t)[0] for t in batch])
    nl = np.stack([needles_of(t)[1] for t in batch])
    C, Cmax = 512, 2048
    Kv = 8 if mode == "clipped" else C
    score = mode == "score"
    idf = np.tile(np.asarray([1.1, 0.4], np.float32), (B, 1))
    kw = dict(Kv=Kv, maxT=jst.maxT, idf=idf, k1=1.2, b=0.75, avgdl=25.0,
              score_mode=score, use_dense_probes=mode != "probe_free",
              require_match=True)
    extra_j = extra_t = None
    if mode == "filtered":
        import jax.numpy as jnp
        row = filter_rows(jidx, 4)
        extra_j = jnp.asarray(row[None])
        extra_t = torch.from_numpy(row.view(np.int32)[None].copy())
    if mode == "global_pack":
        monkeypatch.setattr(tfused, "_SCAN_CHUNK", 1)
        # the live-prefix kernel (K5) serves the flat pack only
        assert (tfused._global_pack_policy(tst, B, Kv, False) > 0) == \
            (layout == "flat")
    j = jfused.sparse_search_verify_topn_batch(
        jidx.postings, jidx.bitmaps, jidx.deleted, *cols, jst, C, Cmax, 32,
        ndl, nl, jidx.n_words, True, extra=extra_j, **kw)
    t = tfused.sparse_search_verify_topn_batch(
        tidx.postings, tidx.bitmaps, tidx.deleted, *tcols, tst, C, Cmax, 32,
        ndl, nl, tidx.n_words, True, extra=extra_t, **kw)
    assert len(j) == len(t) == (4 if score else 3)
    for a, b_ in zip(j[:3], t[:3]):
        assert np.array_equal(np.asarray(a), b_)
    if score:
        np.testing.assert_allclose(t[3], np.asarray(j[3]), rtol=1e-5)
    if mode == "clipped":
        assert (t[0] > Kv).any()
    assert ran == [expected_kernel(layout, mode)]


DENSE_BATCH = [["alpha"], ["beta"], ["gamma", "aa"], ["aaaa"]]


@pytest.mark.parametrize("mode", ["pk", "score", "filtered", "global_pack"])
def test_dense_batch_equals_jax(pair, monkeypatch, mode):
    layout, built, texts, (jidx, jst), (tidx, tst) = pair
    ran = spy_kernels(monkeypatch)
    batch = [t for t in DENSE_BATCH
             if not tidx.classify(tids_of(built, t))[1]]
    assert len(batch) >= 2
    B = len(batch)
    rows = np.full((B, 8), jidx.ones_row, dtype=np.int32)
    for i, t in enumerate(batch):
        d = jidx.classify(tids_of(built, t))[0]
        rows[i, :len(d)] = d
    ndl = np.stack([needles_of(t)[0] for t in batch])
    nl = np.stack([needles_of(t)[1] for t in batch])
    C = 512
    score = mode == "score"
    idf = np.tile(np.asarray([0.9, 1.6], np.float32), (B, 1))
    kw = dict(idf=idf, k1=1.2, b=0.75, avgdl=25.0, score_mode=score,
              vbound=B * C)
    import jax.numpy as jnp
    row = filter_rows(jidx, 6)
    has_extra = mode == "filtered"
    if mode == "global_pack":
        monkeypatch.setattr(tfused, "_SCAN_CHUNK", 1)
    j = jfused.search_verify_topn_batch(
        jidx.bitmaps, jnp.asarray(rows),
        jnp.full((B, 1), jidx.zeros_row, dtype=jnp.int32), jidx.deleted,
        jnp.asarray(row[None]) if has_extra else jidx._ones_words[None, :],
        jst, C, 32, ndl, nl, True, has_extra=has_extra, **kw)
    t = tfused.search_verify_topn_batch(
        tidx.bitmaps, torch.from_numpy(rows), tidx.deleted,
        torch.from_numpy(row.view(np.int32)[None].copy()) if has_extra
        else None, tst, C, 32, ndl, nl, True, **kw)
    for a, b_ in zip(j[:3], t[:3]):
        assert np.array_equal(np.asarray(a), b_)
    if score:
        np.testing.assert_allclose(t[3], np.asarray(j[3]), rtol=1e-5)
    assert t[1].sum() > 0
    assert ran == [expected_kernel(layout, mode)]


@pytest.mark.parametrize("filtered", [False, True])
def test_dense_candidates_equal_jax(pair, filtered):
    """The dense-driver program's candidates, K1's first C ids ascending
    with the count as ``pre`` (one launch on the card), against JAX
    ``_dense_search_topn`` over the same index, at the fused widths 512 and
    4,096."""
    from mygramdb_tpu.ops import bitmap_ops as jbm
    import jax.numpy as jnp
    layout, built, texts, (jidx, jst), (tidx, tst) = pair
    rows = np.full((len(DENSE_BATCH), 8), jidx.ones_row, dtype=np.int32)
    for i, t in enumerate(DENSE_BATCH):
        d = jidx.classify(tids_of(built, t))[0]
        rows[i, :len(d)] = d
    row = filter_rows(jidx, 7)
    for C in (512, 4096):
        cj, ij = jbm._dense_search_topn(
            jidx.bitmaps, jnp.asarray(rows),
            jnp.full((rows.shape[0], 1), jidx.zeros_row, dtype=jnp.int32),
            jidx.deleted, jnp.asarray(row[None]), False, filtered, C, False,
            False)
        out, _ = tfused.dense_and_topn(
            tidx.bitmaps, torch.from_numpy(rows), None,
            torch.from_numpy(row.view(np.int32)[None].copy()) if filtered
            else None, tidx.deleted, C, False)
        assert np.array_equal(out[:, 0].numpy(), np.asarray(cj))
        assert np.array_equal(out[:, 1:].numpy(), np.asarray(ij))
        assert out[:, 0].max() > 0


def test_compact_first_k_equals_jax():
    import jax.numpy as jnp
    rng = np.random.default_rng(2)
    cands = np.sort(rng.integers(0, 1000, (3, 50)), axis=1).astype(np.int32)
    mask = rng.random((3, 50)) < 0.4
    for Kv in (4, 50, 64):
        t_sel, t_pre = tfused.compact_first_k(torch.from_numpy(cands),
                                              torch.from_numpy(mask), Kv)
        for r in range(3):
            j_sel, j_pre = jfused.compact_first_k(jnp.asarray(cands[r]),
                                                  jnp.asarray(mask[r]), Kv)
            assert np.array_equal(t_sel[r].numpy(), np.asarray(j_sel))
            assert int(t_pre[r]) == int(j_pre)


def test_policies_equal_jax(pair):
    layout, built, texts, (jidx, jst), (tidx, tst) = pair
    ndl = np.zeros((2, 2, CAP), dtype=np.uint32)
    for B, Kv, nonoverlap, vbound in [(1, 512, False, None),
                                      (64, 4096, False, None),
                                      (64, 4096, False, 5000),
                                      (64, 4096, True, None),
                                      (8, 65536, False, 70000)]:
        want = jfused._global_pack_policy(jst, B, Kv, 2, 4, nonoverlap,
                                          vbound)
        assert tfused._global_pack_policy(tst, B, Kv, nonoverlap,
                                          vbound) == want
    ndl[0, 0, 0] = 0x1F600
    for n in (ndl, ndl * 0):
        assert tfused._needles_need_range(tst, n) == \
            jfused._needles_need_range(jst, n)
