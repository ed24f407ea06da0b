"""Port parity for the sparse program: K3's probe entry
(``posting_ops.sparse_probe``, on the CPU its plain version) in its three
output forms against the JAX package.

- top-n: ``device_index._sparse_query_batch`` of both packages;
- compaction and masked: the JAX single-query ``_sparse_query`` (its mask
  and candidates), then ``fused.compact_first_k`` or ``where``;
- the whole fused sparse verified search of both packages
  (``fused.sparse_search_verify_topn_batch``), whose mask and compaction
  the probe entry is.

Inputs come from ``torch_parity.sparse_probe_inputs`` (numpy, seeded): C
not a multiple of 32, a driver at offset P and one running past it, NOT
probes, zero-length inverted padding and an empty term, Ks and Kd at 8 and
32, filter rows, tombstones among the candidates, n past C, both orders,
probe-free. Everything is integer: answers equal exactly.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from mygramdb_tpu.index import device_index as JD
from mygramdb_tpu.ops import fused as jfused
from mygramdb_tpu.ops.posting_ops import pad_postings
from mygramdb_tpu_torch.index import device_index as TD
from mygramdb_tpu_torch.ops import posting_ops as T
from mygramdb_tpu_torch.ops import runtime

from torch_parity import i32, sparse_probe_inputs, torch_cpu  # noqa: F401

SENT = 2 ** 31 - 1
W = 2048
# (C, Ks, Kd, n): C not a multiple of 32; 32 probes and n past C; 8 and 32
SHAPES = [(1000, 8, 8, 128), (512, 32, 32, 1024), (2048, 8, 32, 128)]


def jax_inputs(d):
    post = jnp.asarray(pad_postings(d["postings"]))
    return (post, jnp.asarray(d["bitmaps"]), jnp.asarray(d["deleted"]))


def torch_inputs(d):
    return (torch.from_numpy(d["postings"]), i32(d["bitmaps"]),
            i32(d["deleted"]))


def jcols(cols):
    d_off, d_len, sp_off, sp_len, sp_inv, dn_rows, dn_inv = cols
    i = lambda a: jnp.asarray(np.asarray(a).astype(np.int32))
    return (i(d_off), i(d_len), i(sp_off), i(sp_len), jnp.asarray(sp_inv),
            jnp.asarray(dn_rows), jnp.asarray(dn_inv))


@pytest.mark.parametrize("variant", ["probes", "probe_free", "filtered"])
@pytest.mark.parametrize("descending", [True, False])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "C%d-Ks%d-Kd%d-n%d"
                         % s)
def test_topn_matches_jax(shape, descending, variant):
    C, Ks, Kd, n = shape
    d = sparse_probe_inputs(C + Ks + Kd, 8, C, Ks, Kd, W=W)
    probe_free = variant == "probe_free"
    has_extra = variant == "filtered"
    kw = dict(C=C, Cmax=d["Cmax"], limit_b=n, descending=descending,
              n_words=W, has_extra=has_extra, probe_free=probe_free)
    cj, ij = JD._sparse_query_batch(*jax_inputs(d), *jcols(d["cols"]),
                                    jnp.asarray(d["extra"]), **kw)
    cj, ij = np.asarray(cj), np.asarray(ij)
    post, bm, dl = torch_inputs(d)
    extra = i32(d["extra"])
    runtime.reset_launches()
    out = T.sparse_probe(
        post, bm, dl, extra if has_extra else None,
        torch.from_numpy(d["args"]), Ks=Ks, Kd=Kd, C=C, Cmax=d["Cmax"],
        n_words=W, form="topn", width=n, descending=descending,
        sparse_probes=not probe_free, dense_probes=not probe_free).numpy()
    assert out.shape == (8, n + 1) and out.dtype == np.int32
    assert np.array_equal(out[:, 0], cj) and np.array_equal(out[:, 1:], ij)
    # the tensor-signature entry, and nothing launched on the CPU
    ct, it = TD._sparse_query_batch(
        post, bm, dl, *[torch.from_numpy(np.asarray(c)) for c in d["cols"]],
        extra, **kw)
    assert np.array_equal(ct.numpy(), cj) and np.array_equal(it.numpy(), ij)
    assert runtime.launches["sparse_probe"] == 0
    # the edges: the dense-term driver and the empty term match nothing
    assert cj[3] == 0 and (probe_free or cj[6] == 0)
    assert cj.sum() > 0
    if n > C:
        assert (ij[:, C:] == -1).all()


def test_count_only_matches_jax():
    C, Ks, Kd, _ = SHAPES[0]
    d = sparse_probe_inputs(3, 8, C, Ks, Kd, W=W)
    cj, _ = JD._sparse_query_batch(
        *jax_inputs(d), *jcols(d["cols"]), jnp.asarray(d["extra"]), C=C,
        Cmax=d["Cmax"], limit_b=1, descending=True, n_words=W,
        has_extra=True)
    out = T.sparse_probe(*torch_inputs(d), i32(d["extra"]),
                         torch.from_numpy(d["args"]), Ks=Ks, Kd=Kd, C=C,
                         Cmax=d["Cmax"], n_words=W, form="topn", width=0)
    assert out.shape == (8, 1)
    assert np.array_equal(out[:, 0].numpy(), np.asarray(cj))


def reference_selection(d, C, Cmax, Ks, Kd, form, width, sparse, dense):
    """The JAX single-query program's mask and candidates, then its
    compaction (or where) -> (pre (B,), sel (B, width))."""
    d_off, d_len, sp_off, sp_len, sp_inv, dn_rows, dn_inv = d["cols"]
    B = d_off.shape[0]
    post, bm, dl = jax_inputs(d)
    pre = np.zeros(B, dtype=np.int32)
    sel = np.zeros((B, width), dtype=np.int32)
    for b in range(B):
        so, sl, si = sp_off[b], sp_len[b], sp_inv[b]
        if not sparse:  # every slot the inverted empty padding
            so, sl, si = so * 0, sl * 0, np.ones_like(si)
        dr, di = dn_rows[b], dn_inv[b]
        if not dense:  # every row the all-ones padding
            dr, di = np.full_like(dr, d["ones_row"]), np.zeros_like(di)
        i = lambda a: jnp.asarray(np.asarray(a).astype(np.int32))
        _, _, mask, cands = JD._sparse_query(
            post, bm, dl, jnp.asarray(d["extra"]), i(d_off[b]), i(d_len[b]),
            i(so), i(sl), jnp.asarray(si), jnp.asarray(dr),
            jnp.asarray(di), 1, C=C, Cmax=Cmax, limit_b=0,
            descending=False, n_words=W)
        if form == "compact":
            s, p = jfused.compact_first_k(cands, mask, width)
        else:
            s = jnp.where(mask, cands, SENT)
            p = jnp.sum(mask.astype(jnp.int32))
        pre[b], sel[b] = int(p), np.asarray(s)
    return pre, sel


@pytest.mark.parametrize("probes", ["all", "sparse_only", "none"])
@pytest.mark.parametrize("form,width", [("compact", 256), ("compact", None),
                                        ("masked", None)])
@pytest.mark.parametrize("shape", SHAPES[:2], ids=lambda s: "C%d-Ks%d-Kd%d"
                         % s[:3])
def test_selection_matches_jax(shape, form, width, probes):
    C, Ks, Kd, _ = shape
    width = width or C
    d = sparse_probe_inputs(2 * C + Ks, 8, C, Ks, Kd, W=W)
    sparse, dense = probes != "none", probes == "all"
    want_pre, want_sel = reference_selection(d, C, d["Cmax"], Ks, Kd, form,
                                             width, sparse, dense)
    buf = T.sparse_probe(*torch_inputs(d), i32(d["extra"]),
                         torch.from_numpy(d["args"]), Ks=Ks, Kd=Kd, C=C,
                         Cmax=d["Cmax"], n_words=W, form=form, width=width,
                         sparse_probes=sparse, dense_probes=dense)
    assert buf.shape == (8 * (width + 1),)
    pre, sel = T.split_selection(buf.numpy(), 8)
    assert np.array_equal(pre, want_pre) and np.array_equal(sel, want_sel)
    assert want_pre.sum() > 0
    if form == "compact" and width < C:
        assert (want_pre > width).any()  # a compaction that clips


def test_pack_and_unpack_round_trip():
    d = sparse_probe_inputs(7, 5, 300, 8, 8, W=256)
    args = T.pack_sparse_args(*d["cols"])
    assert args.dtype == np.int64 and np.array_equal(args, d["args"])
    back = T.unpack_sparse_args(torch.from_numpy(args), 8, 8)
    for a, b in zip(back, d["cols"]):
        assert np.array_equal(a.numpy(), b)
    assert back[4].dtype == torch.bool and back[5].dtype == torch.int32
    with pytest.raises(ValueError):
        T.sparse_probe(*torch_inputs(d), None, torch.from_numpy(args), Ks=8,
                       Kd=8, C=300, Cmax=d["Cmax"], n_words=256,
                       form="masked", width=299)


# ---------------------------------------------------------------------------
# The fused sparse verified search: the probe entry's compaction feeds it
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def verified_pair(torch_cpu):
    from mygramdb_tpu.index.builder import IndexBuilder
    from mygramdb_tpu.index.device_index import DeviceIndex as JIndex
    from mygramdb_tpu.storage import device_text as jdt
    from mygramdb_tpu_torch.convert import (state_from_jax,
                                            text_state_from_jax)
    from mygramdb_tpu_torch.storage.device_text import DeviceTextStore
    rng = np.random.default_rng(4)
    words = ["alpha", "beta", "gamma", "quick", "brown", "fox", "aa",
             "検索", "日本語", "エンジン", "高速"]
    p = 1.0 / np.arange(1, len(words) + 1)
    texts = {i: "".join(rng.choice(words, size=int(rng.integers(2, 9)),
                                   p=p / p.sum())) for i in range(1, 901)}
    b = IndexBuilder(ngram_size=2, kanji_ngram_size=1)
    for did, t in texts.items():
        b.add_document(did, t)
    built = b.finalize()
    jidx = JIndex(built, dense_df_ratio=0.08, max_dense_terms=16)
    jidx.mark_deleted([4, 40, 400])
    jst = jdt.DeviceTextStore(texts, capacity=jidx.n_docs_capacity)
    tidx = TD.DeviceIndex.from_state(state_from_jax(jidx), built,
                                     device="cpu")
    tst = DeviceTextStore.from_state(text_state_from_jax(jst), device="cpu")
    return built, (jidx, jst), (tidx, tst)


FUSED_BATCH = [["検索"], ["日本語"], ["エンジン", "高速"], ["gamma"],
               ["quick", "fox"], ["brown"]]


@pytest.mark.parametrize("mode", ["masked", "compact", "clipped", "probes"])
def test_fused_sparse_verify_matches_jax(verified_pair, mode):
    from mygramdb_tpu.storage import device_text as jdt
    from mygramdb_tpu.utils.textproc import generate_query_ngrams
    from mygramdb_tpu_torch.ops import fused as tfused
    built, (jidx, jst), (tidx, tst) = verified_pair
    plans = []
    for terms in FUSED_BATCH:
        tids = sorted({built.term_dict.get(g) for t in terms
                       for g in generate_query_ngrams(t, 2, 1)})
        dense, sparse = tidx.classify(tids)
        if not sparse:
            continue
        sparse.sort(key=lambda t: int(tidx.lengths[t]))
        sp = sparse[1:] + [0] * (8 - len(sparse) + 1)
        dn = dense + [tidx.ones_row] * (8 - len(dense))
        plans.append((terms, sparse[0], sp[:8], len(sparse) - 1, dn[:8]))
    assert len(plans) >= 4
    B = len(plans)
    CAP = jdt.NEEDLE_CAP
    ndl = np.zeros((B, 2, CAP), dtype=np.uint32)
    nl = np.zeros((B, 2), dtype=np.int32)
    cols = {k: [] for k in ("d_off", "d_len", "sp_off", "sp_len", "sp_inv",
                            "dn_rows", "dn_inv")}
    jcols_ = {k: [] for k in cols}
    for i, (terms, drv, sp, nsp, dn) in enumerate(plans):
        n, L = jdt.DeviceTextStore._pack_needles(terms)
        ndl[i, :n.shape[0]], nl[i, :L.shape[0]] = n, L
        for c, offs in ((cols, tidx.dev_offsets), (jcols_, jidx.offsets32)):
            c["d_off"].append(int(offs[drv]))
            c["d_len"].append(int(tidx.lengths[drv]))
            c["sp_off"].append([int(offs[t]) if k < nsp else 0
                                for k, t in enumerate(sp)])
            c["sp_len"].append([int(tidx.lengths[t]) if k < nsp else 0
                                for k, t in enumerate(sp)])
            c["sp_inv"].append([k >= nsp for k in range(8)])
            c["dn_rows"].append(dn)
            c["dn_inv"].append([False] * 8)
    C = 512
    Kv = {"masked": C, "compact": C, "clipped": 4, "probes": 256}[mode]
    kw = dict(Kv=Kv, maxT=jst.maxT, idf=None, score_mode=False,
              use_dense_probes=mode in ("compact", "probes"),
              require_match=True)
    args = [np.asarray(cols[k]) for k in cols]
    jargs = [np.asarray(jcols_[k]) for k in jcols_]
    runtime.reset_launches()
    j = jfused.sparse_search_verify_topn_batch(
        jidx.postings, jidx.bitmaps, jidx.deleted, *jargs, jst, C, 2048, 32,
        ndl, nl, jidx.n_words, True, **kw)
    t = tfused.sparse_search_verify_topn_batch(
        tidx.postings, tidx.bitmaps, tidx.deleted, *args, tst, C, 2048, 32,
        ndl, nl, tidx.n_words, True, **kw)
    for a, b in zip(j, t):
        assert np.array_equal(np.asarray(a), b)
    assert int(t[1].sum()) > 0
    if mode == "clipped":
        assert (t[0] > Kv).any()
