"""The port's ``DeviceTextStore`` against the JAX package's, on the CPU.

Both stores are built from the same texts (and from the same frozen
document store, through the native UTF-8 pack): the layout decision,
maxT, dtype, the overflow set, offsets and lengths must agree, the port's
cells must be the JAX cells without their TPU padding, and ``verify``,
``contains_masks``, ``count_tf`` and ``score_topk`` must give the same
answers (scores within 1e-5 relative: float32 sums in another order).
"""

import numpy as np
import pytest

from mygramdb_tpu.storage import device_text as jdt
from mygramdb_tpu_torch.convert import text_state_from_jax
from mygramdb_tpu_torch.ops import runtime
from mygramdb_tpu_torch.storage import device_text as tdt

from torch_parity import torch_cpu  # noqa: F401

WORDS = ["alpha", "beta", "quick", "fox", "aa", "検索", "日本語", "高速"]


def corpus(seed=5, n=400):
    rng = np.random.default_rng(seed)
    texts = {i: " ".join(rng.choice(WORDS, size=int(rng.integers(1, 30))))
             for i in range(1, n + 1)}
    texts[7] = "x" * 3000 + " 検索"     # past maxT: host verified
    texts[8] = "emoji \U0001F600 quick"  # non-BMP: host verified
    texts[9] = ""
    return texts


@pytest.fixture(params=["padded", "flat"])
def stores(request, monkeypatch):
    texts = corpus()
    if request.param == "flat":
        monkeypatch.setattr(jdt, "_PADDED_BUDGET_BYTES", 0)
        monkeypatch.setenv("MYGRAM_TEXT_LAYOUT", "flat")
    jst = jdt.DeviceTextStore(texts, capacity=1024)
    tst = tdt.DeviceTextStore(texts, capacity=1024, device="cpu")
    return request.param, texts, jst, tst


def assert_same_layout(jst, tst):
    assert tst.maxT == jst.maxT and tst.dtype == jst.dtype
    assert tst._overflow == jst._overflow and tst.n_packed == jst.n_packed
    cap = tst.capacity
    assert np.array_equal(tst.lengths_host, jst.lengths_host[:cap])
    assert np.array_equal(tst.offsets_host, jst.offsets_host[:cap])
    want = text_state_from_jax(jst)["codepoints"]
    got = tst.codepoints.numpy().view(np.dtype(tst.dtype))
    if tst.codepoints.dim() == 2:
        assert got.shape == (cap, tst.maxT + 32)
    assert np.array_equal(got[:want.shape[0]], want)


def test_layout_equals_jax(stores):
    layout, texts, jst, tst = stores
    assert (tst.codepoints.dim() == 2) == (layout == "padded")
    assert_same_layout(jst, tst)
    assert {7, 8} <= tst._overflow
    for bound in (1, 100, 128, 129, 500, 513, 3000):
        assert tst.maxT_bucket(bound) == jst.maxT_bucket(bound)
    assert tst.memory_usage() > 0


def test_frozen_doc_store_pack_equals_jax(monkeypatch):
    """The native one-pass pack from a frozen document store, with overlay
    writes since the freeze shadowing frozen rows."""
    from mygramdb_tpu.storage.document_store import DocumentStore
    from mygramdb_tpu.storage.frozen_docs import FrozenDocBuilder
    from mygramdb_tpu_torch import native
    if not native.available():
        pytest.skip("native host library not built")
    texts = corpus(seed=6)
    texts[10] = "edge \uffff sentinel"  # U+FFFF: the u16 sentinel
    fb = FrozenDocBuilder(store_texts=True)
    fb.append([str(d) for d in sorted(texts)],
              [texts[d] for d in sorted(texts)])
    ds = DocumentStore.from_frozen(fb, True, True, str(len(texts)))
    ds.update_document(2, text="patched 大阪 quick")  # shadows a frozen row
    ds.add_document("9999", None, "a new quick row")
    ds.update_document(3, text="bad \U0001F600")     # overlay goes non-BMP
    for layout in ("auto", "flat"):
        monkeypatch.setenv("MYGRAM_TEXT_LAYOUT", layout)
        if layout == "flat":
            monkeypatch.setattr(jdt, "_PADDED_BUDGET_BYTES", 0)
        jst = jdt.DeviceTextStore.from_doc_store(ds, 2048)
        tst = tdt.DeviceTextStore.from_doc_store(ds, 2048, device="cpu")
        assert_same_layout(jst, tst)


def test_store_queries_equal_jax(stores):
    layout, texts, jst, tst = stores
    rng = np.random.default_rng(1)
    fallback = lambda ids: [texts.get(i) for i in ids]  # noqa: E731
    ids = np.asarray(sorted(rng.choice(list(texts) + [5000], 300,
                                       replace=False)), dtype=np.int32)
    dirty = {int(ids[3])}
    runtime.reset_launches()
    for needles in (["quick"], ["検索", "alpha"], ["aa"], ["q" * 40],
                    ["日本語", "高速", "fox"]):
        a = tst.verify(ids, needles, fallback, dirty=dirty)
        assert np.array_equal(a, jst.verify(ids, needles, fallback,
                                            dirty=dirty)), needles
        assert np.array_equal(
            tst.contains_masks(ids, needles, fallback, dirty=dirty),
            jst.contains_masks(ids, needles, fallback, dirty=dirty))
        tf, dl = tst.count_tf(ids, needles, fallback, dirty=dirty)
        jtf, jdl = jst.count_tf(ids, needles, fallback, dirty=dirty)
        assert np.array_equal(tf, jtf) and np.array_equal(dl, jdl)
        idf = np.linspace(0.5, 2.0, len(needles))
        got = tst.score_topk(ids, needles, idf, 20.5, 1.2, 0.75, 30,
                             fallback, dirty=dirty)
        want = jst.score_topk(ids, needles, idf, 20.5, 1.2, 0.75, 30,
                              fallback, dirty=dirty)
        assert (got is None) == (want is None)
        if got is not None:
            assert np.array_equal(got[0], want[0])
            np.testing.assert_allclose(got[1], want[1], rtol=1e-5)
    assert runtime.routes["verify_exact"] > 0
    # the brute-force answer, for one needle set
    want = [texts.get(int(i)) is not None and "quick" in texts[int(i)]
            for i in ids]
    assert tst.verify(ids, ["quick"], fallback).tolist() == want


def test_doc_sharded_build_is_not_ported():
    """The doc-sharded build (ROADMAP item 13; ported, the name is the
    placeholder's) over a mesh of 4 CPU shards, from texts and from a
    frozen document store with overlay rows: shard s holds exactly rows
    [s * Ds, (s + 1) * Ds) of the whole store's padded matrix, and the
    flat layout stays whole."""
    from mygramdb_tpu.storage.document_store import DocumentStore
    from mygramdb_tpu.storage.frozen_docs import FrozenDocBuilder
    from mygramdb_tpu_torch.parallel.mesh import make_mesh
    import torch
    mesh = make_mesh(devices=[torch.device("cpu")] * 4)
    texts = corpus(seed=7)
    fb = FrozenDocBuilder(store_texts=True)
    fb.append([str(d) for d in sorted(texts)],
              [texts[d] for d in sorted(texts)])
    ds = DocumentStore.from_frozen(fb, True, True, str(len(texts)))
    ds.update_document(5, text="patched 大阪 quick")
    ds.add_document("1500", None, "a new quick row")
    for make in (lambda **kw: tdt.DeviceTextStore(texts, 2048, **kw),
                 lambda **kw: tdt.DeviceTextStore.from_doc_store(ds, 2048,
                                                                 **kw)):
        whole = make(device="cpu")
        sharded = make(doc_sharding=mesh)
        assert sharded.doc_sharded and len(sharded.shards) == 4
        assert [t.lo for t in sharded.shards] == [0, 512, 1024, 1536]
        assert torch.equal(sharded.codepoints.cpu(), whole.codepoints)
        assert torch.equal(sharded.lengths.cpu(), whole.lengths)
        assert sharded.memory_usage() == sum(sharded.shard_memory())
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MYGRAM_TEXT_LAYOUT", "flat")
        flat = tdt.DeviceTextStore(texts, 2048, doc_sharding=mesh)
    assert not flat.doc_sharded and flat.codepoints.dim() == 1
