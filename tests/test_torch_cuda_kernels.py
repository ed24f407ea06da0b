"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Every test here carries the ``cuda`` marker and skips where
``torch.cuda.is_available()`` is false. The file imports no JAX (the
card's host has none), so it runs there on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from mygramdb_tpu_torch.ops import (bitmap_ops, posting_ops, runtime,
                                    verify_ops)
from mygramdb_tpu_torch.ops.errors import KernelError

from torch_parity import require_cuda, sparse_probe_inputs

pytestmark = pytest.mark.cuda


def dense_inputs(W, B=9, K=40, V=24, Kn=3, F=2, seed=0):
    g = torch.Generator().manual_seed(seed + W)
    bm = torch.randint(-2 ** 31, 2 ** 31 - 1, (V + 2, W), dtype=torch.int32,
                       generator=g)
    bm[V], bm[V + 1] = -1, 0
    rows = torch.randint(0, 3, (B, K), dtype=torch.int32, generator=g)
    rows[:, K // 2:] = V
    nrows = torch.randint(3, V, (B, Kn), dtype=torch.int32, generator=g)
    extra = torch.randint(-2 ** 31, 2 ** 31 - 1, (F, W), dtype=torch.int32,
                          generator=g) | bm[0]
    deleted = torch.randint(-2 ** 31, 2 ** 31 - 1, (W,), dtype=torch.int32,
                            generator=g) & 0x01010101
    return bm, rows, nrows, extra, deleted


@pytest.mark.parametrize("W", [1024, 34816, 313344])
@pytest.mark.parametrize("form", ["and", "not", "extra", "not+extra"])
def test_dense_and_matches_plain(W, form):
    require_cuda()
    bm, rows, nrows, extra, deleted = [t.cuda() for t in dense_inputs(W)]
    args = (bm, rows, nrows if "not" in form else None,
            extra if "extra" in form else None, deleted)
    before = runtime.launches["dense_and"]
    forms = dict(runtime.launch_forms)
    c, r = bitmap_ops.dense_and(*args)
    cp, rp = bitmap_ops._dense_query_plain(*args)
    torch.cuda.synchronize()
    assert runtime.launches["dense_and"] == before + 1
    for f in ("not", "extra"):
        key = f"dense_and.{f}_rows"
        assert runtime.launch_forms[key] == forms[key] + (f in form)
    assert torch.equal(c, cp) and torch.equal(r, rp)
    assert int(c.sum()) > 0


# K1 with the top-n fused in: counts and the first n doc ids in one launch

def topn_plain(args, n, descending):
    """The plain version's (out, res) of ``dense_and_topn``."""
    return bitmap_ops._dense_and_topn_plain(*args, n, descending, True)


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("n", [0, 1, 128, 1024, 65536, 262144])
@pytest.mark.parametrize("W", [1024, 34816, 313344])
def test_dense_and_topn_matches_plain(W, n, descending):
    require_cuda()
    bm, rows, nrows, extra, deleted = [t.cuda() for t in
                                       dense_inputs(W, K=8, seed=n)]
    form = [None, "not", "extra", "not+extra"][(n + W // 1024) % 4]
    args = (bm, rows, nrows if form and "not" in form else None,
            extra if form and "extra" in form else None, deleted)
    before = runtime.launches["dense_and"], runtime.launch_forms[
        "dense_and.topn"]
    out, res = bitmap_ops.dense_and_topn(*args, n, descending)
    want, _ = topn_plain(args, n, descending)
    torch.cuda.synchronize()
    assert (runtime.launches["dense_and"], runtime.launch_forms[
        "dense_and.topn"]) == (before[0] + 1, before[1] + (n > 0))
    assert res is None and out.shape == (9, n + 1)
    assert torch.equal(out, want)
    assert int(out[:, 0].min()) > 0


@pytest.mark.parametrize("B,W,n", [(1, 34816, 128), (1, 313344, 1024),
                                   (64, 34816, 1024), (64, 313344, 128),
                                   (70_000, 1024, 128)])
def test_dense_and_topn_batch_sizes(B, W, n):
    """One query (a cluster of 16 blocks), the micro-batcher's 64, and more
    queries than the grid's 65,535 rows (they loop inside the cluster)."""
    require_cuda()
    bm, _, nrows, extra, deleted = [t.cuda() for t in dense_inputs(W, B=1)]
    g = torch.Generator().manual_seed(B + W)
    rows = torch.randint(0, 3, (B, 3), dtype=torch.int32, generator=g).cuda()
    for descending in (False, True):
        args = (bm, rows, nrows.expand(B, -1).contiguous(), extra, deleted)
        out, _ = bitmap_ops.dense_and_topn(*args, n, descending)
        want, _ = topn_plain(args, n, descending)
        torch.cuda.synchronize()
        assert torch.equal(out, want)


def placed_bits(W, spans, density=0.3, seed=0):
    """(3, W) rows: row 0 with random bits only inside the word spans
    given as (start, end) fractions of W, row 1 all-ones, row 2 all-zeros;
    no tombstones."""
    g = torch.Generator().manual_seed(seed)
    bm = torch.zeros((3, W), dtype=torch.int32)
    for a, b in spans:
        lo, hi = int(a * W), int(b * W)
        bits = torch.rand((hi - lo, 32), generator=g) < density
        words = (bits.long() << torch.arange(32)).sum(1)
        bm[0, lo:hi] = (words - (words >= 2 ** 31).long() * 2 ** 32).int()
    bm[1], bm[2] = -1, 0
    return bm.cuda(), torch.zeros(W, dtype=torch.int32).cuda()


@pytest.mark.parametrize("W", [34816, 313344])
@pytest.mark.parametrize("case", ["last_block", "first_block_passes_n",
                                  "empty", "one_bit_each_end"])
def test_dense_and_topn_rank_edges(W, case):
    """Bits only in the last block of the cluster (the blocks before it
    count nothing); an offset that passes n inside the first block (every
    other block skips its pass 2); an all-zero result (-1 everywhere); a
    bit at each end of the doc range."""
    require_cuda()
    spans = {"last_block": [(0.97, 1.0)],
             "first_block_passes_n": [(0.0, 1.0)],
             "empty": [], "one_bit_each_end": []}[case]
    bm, deleted = placed_bits(W, spans, density=0.9 if "first" in case
                              else 0.3)
    if case == "one_bit_each_end":
        bm[0, 0], bm[0, W - 1] = 1, -2 ** 31  # doc 0 and doc 32 W - 1
    rows = torch.tensor([[0, 1], [0, 0], [2, 1]], dtype=torch.int32).cuda()
    for descending in (False, True):
        for n in (0, 1, 7, 1024, 65536):
            args = (bm, rows, None, None, deleted)
            out, _ = bitmap_ops.dense_and_topn(*args, n, descending)
            want, _ = topn_plain(args, n, descending)
            torch.cuda.synchronize()
            assert torch.equal(out, want), (descending, n)
    assert int(out[2, 0]) == 0 and bool((out[2, 1:] == -1).all())
    if case == "one_bit_each_end":
        assert out[0, 1:3].tolist() == [32 * W - 1, 0]


@pytest.mark.parametrize("n", [0, 128])
@pytest.mark.parametrize("W", [1024, 34816, 313344])
def test_dense_and_topn_words_output(W, n):
    """The result words, asked for beside the ids, against
    ``_dense_query_plain``."""
    require_cuda()
    bm, rows, nrows, extra, deleted = [t.cuda() for t in dense_inputs(W)]
    args = (bm, rows, nrows, extra, deleted)
    out, res = bitmap_ops.dense_and_topn(*args, n, True, words=True)
    count, want = bitmap_ops._dense_query_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(res, want) and torch.equal(out[:, 0], count)
    assert torch.equal(out, topn_plain(args, n, True)[0])


def test_dense_and_topn_refuses_bad_inputs():
    require_cuda()
    bm, rows, _, _, deleted = [t.cuda() for t in dense_inputs(1024)]
    with pytest.raises(KernelError, match="n="):
        bitmap_ops.dense_and_topn(bm, rows, None, None, deleted, -1, True)
    with pytest.raises(KernelError, match="int32"):
        bitmap_ops.dense_and_topn(bm, rows.long(), None, None, deleted, 8,
                                  True)
    with pytest.raises(KernelError, match="aligned"):
        bitmap_ops.dense_and_topn(
            bm, rows, None, None,
            torch.zeros(1025, dtype=torch.int32, device="cuda")[1:], 8, True)
    with pytest.raises(KernelError):
        bitmap_ops.dense_and_topn(bm, rows.cpu(), None, None, deleted, 8,
                                  True)


def test_dense_and_many_queries_and_rows():
    require_cuda()
    bm, _, nrows, _, deleted = [t.cuda() for t in dense_inputs(2048, B=4)]
    rows = torch.randint(0, 3, (70_000, 70), dtype=torch.int32).cuda()
    nrows = nrows[:1].expand(70_000, -1).contiguous()
    c, r = bitmap_ops.dense_and(bm, rows, nrows, None, deleted)
    cp, rp = bitmap_ops._dense_query_plain(bm, rows, nrows, None, deleted)
    torch.cuda.synchronize()
    assert torch.equal(c, cp) and torch.equal(r, rp)


@pytest.mark.parametrize("bucket", [1, 2048, 65536, 131072])
def test_slice_gather_matches_plain(bucket):
    require_cuda()
    g = torch.Generator().manual_seed(bucket)
    P = 3_000_000
    post = torch.randint(0, 2 ** 31 - 1, (P,), dtype=torch.int32,
                         generator=g)
    K = 300
    offs = torch.randint(0, P, (K,), dtype=torch.int64, generator=g)
    lens = torch.randint(0, bucket + 64, (K,), dtype=torch.int64,
                         generator=g)
    lens[::5] = 0
    offs[1::5] = P                   # a dense term's entry
    offs[2::5] = P - lens[2::5]      # slices ending at P
    offs[3::5] = P - 1               # a slice running past P
    args = [t.cuda() for t in (post, offs, lens)]
    before = runtime.launches["slice_gather"]
    got = posting_ops.gather_slices(*args, bucket)
    want = posting_ops._gather_slices_plain(*args, bucket)
    torch.cuda.synchronize()
    assert runtime.launches["slice_gather"] == before + 1
    assert torch.equal(got, want)


def test_slice_gather_more_slices_than_grid_rows():
    require_cuda()
    post = torch.arange(1000, dtype=torch.int32).cuda()
    offs = (torch.arange(70_000, dtype=torch.int64) % 990).cuda()
    lens = torch.full((70_000,), 7, dtype=torch.int64).cuda()
    got = posting_ops.gather_slices(post, offs, lens, 8)
    torch.cuda.synchronize()
    assert torch.equal(got, posting_ops._gather_slices_plain(post, offs,
                                                             lens, 8))


def test_wrappers_refuse_mixed_devices_and_wrong_types():
    require_cuda()
    bm, rows, _, _, deleted = dense_inputs(1024)
    with pytest.raises(KernelError):
        bitmap_ops.dense_and(bm.cuda(), rows, None, None, deleted.cuda())
    # the kernel moves 16-byte vectors: W % 4 == 0 and aligned rows only
    bm, rows, _, _, deleted = [t.cuda() for t in dense_inputs(1030)]
    with pytest.raises(KernelError, match="multiple of 4"):
        bitmap_ops.dense_and(bm, rows, None, None, deleted)
    bm, rows, _, _, deleted = [t.cuda() for t in dense_inputs(1028)]
    with pytest.raises(KernelError, match="aligned"):
        bitmap_ops.dense_and(bm, rows, None, None,
                             torch.zeros(1029, dtype=torch.int32,
                                         device="cuda")[1:])
    with pytest.raises(KernelError):
        posting_ops.gather_slices(torch.zeros(8, dtype=torch.int32).cuda(),
                                  torch.zeros(2, dtype=torch.int32).cuda(),
                                  torch.ones(2, dtype=torch.int64).cuda(), 4)


def test_device_index_on_cuda_matches_cpu():
    """The port's whole AND path on the card against the same index on the
    CPU (plain versions), for dense, sparse, NOT and count-only queries."""
    require_cuda()
    from mygramdb_tpu_torch.index.builder import IndexBuilder
    from mygramdb_tpu_torch.index.device_index import (DeviceIndex,
                                                       SearchOptions)
    rng = np.random.default_rng(1)
    b = IndexBuilder(2, 1, True)
    words = ["".join(rng.choice(list("abcdefgh"), 3)) for _ in range(200)]
    for d in range(1, 4000):
        b.add_document(d, " ".join(rng.choice(words, 12)))
    built = b.finalize()
    gpu = DeviceIndex(built, dense_df_ratio=0.2, device="cuda")
    cpu = DeviceIndex(built, dense_df_ratio=0.2, device="cpu")
    gpu.mark_deleted(range(1, 4000, 13))
    cpu.mark_deleted(range(1, 4000, 13))
    assert gpu.n_dense > 0
    live = np.flatnonzero(built.lengths > 0)
    for i in range(60):
        tids = [int(t) for t in rng.choice(live, 1 + i % 3)]
        nots = [int(rng.choice(live))] if i % 4 == 0 else []
        for opts in (dict(limit=0), dict(limit=10), dict(count_only=True),
                     dict(limit=50, descending=False)):
            a = gpu.search_and(tids, nots, None, SearchOptions(**opts))
            c = cpu.search_and(tids, nots, None, SearchOptions(**opts))
            assert a[0] == c[0] and np.array_equal(a[1], c[1]), (tids, nots)


# ---------------------------------------------------------------------------
# K4-K6: the window-TF kernel family (csrc/verify_tf.cu)
# ---------------------------------------------------------------------------

def text_pack(u32: bool, N=3000, maxT=300, seed=0, runs=False):
    """A random pack over a small alphabet (so needles match often):
    (flat cells numpy, offsets int64, lengths int32). A u32 pack mixes in
    non-BMP code points. With runs, the cells are one code point broken
    every 50 cells, so "aa"-like needles hit more than 32 starts a row. The
    last document is never empty: a row may end at the pack's last cell."""
    g = np.random.default_rng(seed)
    lens = g.integers(0, maxT + 1, N).astype(np.int32)
    lens[::17] = 0
    lens[-1] = maxT
    alphabet = np.asarray([0x4E00, 0x4E01, 0x3042, 0x3043, 0x61, 0x62]
                          + ([0x1F600, 0x1F601] if u32 else []))
    flat = alphabet[g.integers(0, alphabet.size, int(lens.sum()))]
    if runs:
        flat = np.where(np.arange(flat.size) % 50 == 49, alphabet[1],
                        alphabet[0])
    offs = np.zeros(N, dtype=np.int64)
    np.cumsum(lens[:-1], out=offs[1:])
    return flat.astype(np.uint32 if u32 else np.uint16), offs, lens


def needle_table(flat, offs, lens, B, Nn, cap, clamp_cell, seed=1):
    """(B, Nn, CAP) needles cut from the pack, lengths 0..cap (one empty
    needle per query), and for u16 packs one needle holding a code point
    that clamps to the sentinel."""
    g = np.random.default_rng(seed)
    ndl = np.zeros((B, Nn, verify_ops.NEEDLE_CAP), dtype=np.uint32)
    nlen = np.zeros((B, Nn), dtype=np.int32)
    docs = np.flatnonzero(lens >= cap)
    for b in range(B):
        for j in range(Nn):
            L = int(g.integers(1, cap + 1)) if (b + j) % 5 else 0
            d = int(docs[g.integers(docs.size)])
            p = int(offs[d] + g.integers(0, lens[d] - L + 1))
            ndl[b, j, :L] = flat[p:p + L]
            nlen[b, j] = L
    if clamp_cell:
        ndl[0, 0, 0], nlen[0, 0] = 0x1F600, max(nlen[0, 0], 1)
    return ndl, nlen


# The shapes the warp-per-row kernel must get right beside the random rows
# ("random": win 300, a multiple of neither 32 nor the block's 8 rows):
#   "edges"     every flat row starts off a 16-byte boundary, the pack's
#               last document (its row ends at the pack's last cell, or
#               the matrix's: padded rows read whole rows here) is asked
#               for, every third row is dead, M = 6 x 67 is no multiple
#               of the block's 8 rows;
#   "long_docs" the window is shorter than the documents: the flat window
#               ends inside them, the padded prefix width < rowT cuts them
#               (cells at or past width count neither in doc_len nor as a
#               match);
#   "runs"      documents of one code point: more than 32 hits a row, so
#               leftmost-greedy flag words chain;
#   "few_rows"  M = 5, fewer rows than one block's warps.
TF_EDGES = ["random", "edges", "long_docs", "runs", "few_rows"]


@pytest.mark.parametrize("edge", TF_EDGES)
@pytest.mark.parametrize("kernel", ["flat", "flat_global", "padded"])
@pytest.mark.parametrize("u32", [False, True])
@pytest.mark.parametrize("nonoverlap", [False, True])
@pytest.mark.parametrize("use_range", [False, True])
@pytest.mark.parametrize("cap,Nn", [(4, 2), (32, 4)])
def test_tf_rows_match_plain(edge, kernel, u32, nonoverlap, use_range, cap,
                             Nn):
    require_cuda()
    maxT = 300
    B, Kv = {"edges": (6, 67), "few_rows": (1, 5)}.get(edge, (6, 200))
    flat, offs, lens = text_pack(u32, maxT=maxT, runs=edge == "runs")
    ndl, nlen = needle_table(flat, offs, lens, B, Nn, cap,
                             clamp_cell=use_range and not u32)
    dt = np.uint32 if u32 else np.uint16
    dev = torch.device("cuda")
    g = np.random.default_rng(2)
    M = B * Kv
    ids = g.integers(0, lens.size, M)
    alive = g.random(M) < 0.8
    if edge == "edges":
        per_vec = 16 // flat.itemsize
        off_edge = np.flatnonzero((offs % per_vec != 0) & (lens > 0))
        ids = off_edge[g.integers(0, off_edge.size, M)]
        ids[::5] = lens.size - 1            # ends at the pack's last cell
        alive = np.arange(M) % 3 != 1       # dead rows between live ones
    if edge == "few_rows":  # one needle cut from the first row's document
        ids = np.flatnonzero(lens >= 50)[:M]
        alive[:] = True
        L = min(cap, 3)
        ndl[0, Nn - 1] = 0
        ndl[0, Nn - 1, :L] = flat[offs[ids[0]]:offs[ids[0]] + L]
        nlen[0, Nn - 1] = L
    row_lens = np.where(alive, lens[ids], 0).astype(np.int32)
    win = maxT // 2 if edge == "long_docs" else maxT
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    ndl_t = t(verify_ops.cast_needles_i32(ndl, dt, cap))
    nlen_t = t(nlen)
    cells = flat.view(np.int32 if u32 else np.int16)
    kw = dict(cap=cap, use_range=use_range, nonoverlap=nonoverlap)
    if kernel == "padded":
        from mygramdb_tpu_torch.storage.device_text import _pad_on_device
        rowT = maxT + verify_ops.NEEDLE_CAP
        sent = -1 if u32 else np.int16(-1)
        padded = _pad_on_device(t(cells), t(offs), t(lens), rowT, int(sent))
        args = (padded, t(ids), t(row_lens), ndl_t, nlen_t)
        kw.update(Kv=Kv, width=rowT if edge == "edges" else win + cap)
        fn, plain = verify_ops.tf_rows_padded, verify_ops._tf_padded_plain
        name = "tf_rows_padded"
    elif kernel == "flat":
        args = (t(cells), t(offs[ids]), t(row_lens), ndl_t, nlen_t)
        kw.update(Kv=Kv, win=win)
        fn, plain = verify_ops.tf_rows_flat, verify_ops._tf_flat_plain
        name = "tf_rows_flat"
    else:
        owner = t(g.integers(0, B, M).astype(np.int32))
        live = t(np.asarray([M - M // 7], dtype=np.int32))  # dead suffix
        args = (t(cells), t(offs[ids]), t(row_lens), owner, live, ndl_t,
                nlen_t)
        kw.update(win=win)
        fn = verify_ops.tf_rows_flat_global
        plain = verify_ops._tf_flat_global_plain
        name = "tf_rows_flat_global"
    before = runtime.launches[name]
    got = fn(*args, **kw)
    want = plain(*args, **kw)
    torch.cuda.synchronize()
    assert runtime.launches[name] == before + 1
    assert torch.equal(got, want)
    assert int(got[:, :Nn].sum()) > 0
    if edge == "runs":
        assert int(got[:, :Nn].max()) > 32
    if edge == "long_docs" and kernel == "padded":
        assert int(got[:, Nn].max()) == win + cap  # doc_len cut at width


@pytest.mark.parametrize("maxT", [1024, 2048])
@pytest.mark.parametrize("u32", [False, True])
@pytest.mark.parametrize("nonoverlap", [False, True])
@pytest.mark.parametrize("use_range", [False, True])
@pytest.mark.parametrize("cap,Nn", [(4, 2), (32, 4)])
def test_tf_rows_padded_store_call_matches_plain(maxT, u32, nonoverlap,
                                                 use_range, cap, Nn):
    """K6 as the text store calls it: one needle set over a full chunk of
    sorted candidate ids, whole rows of a matrix with maxT 1024 (the
    verified serve's) or 2048 (with u32 cells, the largest shared-memory
    slice the kernel stages)."""
    require_cuda()
    from mygramdb_tpu_torch.storage.device_text import (_C_CHUNK,
                                                        _pad_on_device)
    flat, offs, lens = text_pack(u32, N=_C_CHUNK + 5000, maxT=maxT)
    ndl, nlen = needle_table(flat, offs, lens, 1, Nn, cap,
                             clamp_cell=use_range and not u32)
    dt = np.uint32 if u32 else np.uint16
    dev = torch.device("cuda")
    g = np.random.default_rng(3)
    ids = np.sort(g.choice(lens.size, _C_CHUNK, replace=False))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    cells = flat.view(np.int32 if u32 else np.int16)
    rowT = maxT + verify_ops.NEEDLE_CAP
    padded = _pad_on_device(t(cells), t(offs), t(lens), rowT,
                            -1 if u32 else int(np.int16(-1)))
    args = (padded, t(ids), t(lens[ids]),
            t(verify_ops.cast_needles_i32(ndl, dt, cap)), t(nlen))
    kw = dict(Kv=_C_CHUNK, cap=cap, width=rowT, use_range=use_range,
              nonoverlap=nonoverlap)
    before = runtime.launch_forms["tf_rows_padded.whole_rows"]
    got = verify_ops.tf_rows_padded(*args, **kw)
    want = verify_ops._tf_padded_plain(*args, **kw)
    torch.cuda.synchronize()
    assert runtime.launch_forms["tf_rows_padded.whole_rows"] == before + 1
    assert torch.equal(got, want)
    assert int(got[:, :Nn].sum()) > 0


def test_tf_rows_refuse_bad_inputs():
    require_cuda()
    dev = torch.device("cuda")
    cells = torch.zeros(100, dtype=torch.int16, device=dev)
    starts = torch.zeros(4, dtype=torch.int64, device=dev)
    lens = torch.ones(4, dtype=torch.int32, device=dev)
    ndl = torch.zeros((1, 8), dtype=torch.int32, device=dev)
    nlen = torch.ones((1, 2), dtype=torch.int32, device=dev)
    with pytest.raises(KernelError):  # int32 starts
        verify_ops.tf_rows_flat(cells, starts.int(), lens, ndl, nlen, Kv=4,
                                cap=4, win=8, use_range=False)
    with pytest.raises(KernelError):  # needle table of another cap
        verify_ops.tf_rows_flat(cells, starts, lens, ndl, nlen, Kv=4,
                                cap=8, win=8, use_range=False)
    with pytest.raises(KernelError, match="shared memory"):
        verify_ops.tf_rows_flat(cells, starts, lens, ndl, nlen, Kv=4,
                                cap=4, win=20000, use_range=False)
    with pytest.raises(KernelError, match="16-byte aligned"):  # a view
        verify_ops.tf_rows_flat(cells[1:], starts, lens, ndl, nlen, Kv=4,
                                cap=4, win=8, use_range=False)


def test_verified_search_on_cuda_matches_cpu():
    """The fused verified search and the text store on the card against
    the same index and store on the CPU, both layouts, PK and BM25 order."""
    require_cuda()
    from mygramdb_tpu_torch.index.builder import IndexBuilder
    from mygramdb_tpu_torch.index.device_index import DeviceIndex
    from mygramdb_tpu_torch.storage.device_text import DeviceTextStore
    from mygramdb_tpu_torch.utils import textproc
    rng = np.random.default_rng(3)
    words = ["".join(rng.choice(list("abcdefgh"), 4)) for _ in range(300)]
    texts = {d: " ".join(rng.choice(words, int(rng.integers(3, 40))))
             for d in range(1, 6000)}
    b = IndexBuilder(2, 1, True)
    for d, x in texts.items():
        b.add_document(d, x)
    built = b.finalize()
    for layout in ("padded", "flat"):
        mp = pytest.MonkeyPatch()
        mp.setenv("MYGRAM_TEXT_LAYOUT", layout)
        try:
            pair = []
            for dev in ("cuda", "cpu"):
                idx = DeviceIndex(built, dense_df_ratio=0.2, device=dev)
                st = DeviceTextStore(texts, idx.n_docs_capacity, device=dev)
                pair.append((idx, st))
        finally:
            mp.undo()
        assert (pair[0][1].codepoints.dim() == 2) == (layout == "padded")
        for i in range(40):
            terms = list(rng.choice(words, 1 + i % 2))
            needles = np.zeros((2, verify_ops.NEEDLE_CAP), dtype=np.uint32)
            nlens = np.zeros(2, dtype=np.int32)
            for j, w in enumerate(terms):
                needles[j, :len(w)] = [ord(c) for c in w]
                nlens[j] = len(w)
            tids = sorted({built.term_dict.get(g) for w in terms
                           for g in textproc.generate_query_ngrams(
                               w, 2, 1, True)})
            if None in tids:
                continue
            for score in (False, True):
                res = [idx.search_and_verified(
                    tids, st, needles, nlens, 100, True, score_mode=score,
                    idf=np.ones(2, dtype=np.float32), avgdl=60.0)
                    for idx, st in pair]
                assert (res[0] is None) == (res[1] is None)
                if res[0] is None:
                    continue
                assert res[0][0] == res[1][0] and res[0][3] == res[1][3]
                assert np.array_equal(res[0][1], res[1][1]), terms
                np.testing.assert_allclose(res[0][2], res[1][2], rtol=1e-5)
            ids = np.asarray(sorted(rng.choice(list(texts), 3000,
                                               replace=False)), np.int32)
            fb = lambda xs: [texts.get(x) for x in xs]
            a, c = (st.verify(ids, terms, fb) for _, st in pair)
            assert np.array_equal(a, c)
            (ta, la), (tc, lc) = (st.count_tf(ids, terms, fb)
                                  for _, st in pair)
            assert np.array_equal(ta, tc) and np.array_equal(la, lc)


# ---------------------------------------------------------------------------
# K2: the row reduce (csrc/dense_and.cu), and the boolean / fuzzy paths
# ---------------------------------------------------------------------------

def positional_pair(dense_df_ratio):
    """A small index with positions, planted self-overlapping and
    repeated occurrences, on the card and on the CPU (same doc lengths,
    same tombstones)."""
    from mygramdb_tpu_torch.index.builder import IndexBuilder
    from mygramdb_tpu_torch.index.device_index import DeviceIndex
    rng = np.random.default_rng(4)
    planted = ["aaaa aaaaa", "abababab ab", "日日日日 日本日本", "東京東京東京",
               "the quick quick quick fox"]
    words = ["".join(rng.choice(list("abcdq"), 3)) for _ in range(60)]
    kanji = [chr(c) for c in range(0x65E5, 0x65F5)]
    texts = {}
    for d in range(1, 3001):
        parts = list(rng.choice(words, 6)) + ["".join(rng.choice(kanji, 3))]
        if d % 7 == 0:
            parts.append(planted[d % len(planted)])
        texts[d] = " ".join(parts)
    b = IndexBuilder(2, 1, True, collect_positions=True)
    b.add_batch(sorted(texts.items()))
    built = b.finalize()
    dl = np.zeros(4096, dtype=np.int32)
    for d, t in texts.items():
        dl[d] = len(t)
    out = []
    for dev in ("cuda", "cpu"):
        idx = DeviceIndex(built, dense_df_ratio=dense_df_ratio, device=dev)
        idx.set_positional_doc_lengths(dl)
        idx.mark_deleted(range(5, 3001, 17))
        out.append(idx)
    return built, texts, out[0], out[1], float(dl[1:].mean())


@pytest.mark.parametrize("ratio", [0.5, 0.01], ids=["sparse", "dense"])
def test_positional_program_on_cuda_matches_cpu(ratio):
    """The positional program on ``cuda:0`` (every occurrence gather a K3
    launch, counted under ``slice_gather.positional``) against the CPU
    plain path on the same index: count and top-n descending, ascending,
    BM25 score mode and ``force_probes`` (over dense grams' slices at
    ratio 0.01), with a filter row; ids, counts and pre exact, scores to
    1e-5."""
    require_cuda()
    from mygramdb_tpu_torch.utils.textproc import query_gram_offsets
    built, texts, gpu, cpu, avg = positional_pair(ratio)
    assert gpu.postings.numel() == built.postings.size
    terms = ["aaa", "aaaa", "abab", "日日", "日日日", "東京東京", "quick quick",
             "quick", "日本", "ab"] + [t.split()[0] for t in
                                       list(texts.values())[:20]]
    forms = [dict(descending=True), dict(descending=False),
             dict(descending=True, score_mode=True, idf=1.7, avgdl=avg),
             dict(descending=True, force_probes=True)]
    filt = np.random.default_rng(5).integers(
        0, 2 ** 32, size=gpu.n_words, dtype=np.uint32).view(np.int32)
    runtime.reset_launches()
    checked = 0
    for term in terms:
        pairs, covered = query_gram_offsets(term.split()[0], 2, 1, True)
        to = [(built.term_dict.get(g), o) for g, o in pairs]
        if not covered or None in [t for t, _ in to]:
            continue
        plan = gpu.plan_positional(to)
        assert plan == cpu.plan_positional(to)
        if plan is None:
            continue
        for kw in forms:
            for extra in ((), (torch.from_numpy(filt),)):
                g = gpu.search_verified_positional(
                    plan, 100, extra_words=[e.cuda() for e in extra], **kw)
                c = cpu.search_verified_positional(
                    plan, 100, extra_words=list(extra), **kw)
                assert (g[0], g[3]) == (c[0], c[3]), (term, kw)
                assert np.array_equal(g[1], c[1]), (term, kw)
                np.testing.assert_allclose(g[2], c[2], rtol=1e-5)
                checked += 1
    assert checked >= 40
    assert runtime.launch_forms["slice_gather.positional"] \
        == runtime.launches["slice_gather"] >= 4 * checked


def test_positional_batches_on_cuda():
    """Concurrent plans through the micro-batcher on the card answer as
    each plan alone on the CPU."""
    require_cuda()
    import threading
    from mygramdb_tpu_torch.server.microbatch import MicroBatcher
    from mygramdb_tpu_torch.utils.textproc import query_gram_offsets
    built, texts, gpu, cpu, _ = positional_pair(0.5)
    gpu.batcher = MicroBatcher(gpu, max_batch=64, window_us=20000)
    plans = []
    for t in list(texts.values())[:64]:
        pairs, covered = query_gram_offsets(t.split()[0], 2, 1, True)
        plan = cpu.plan_positional([(built.term_dict.get(g), o)
                                    for g, o in pairs])
        if covered and plan is not None:
            plans.append(plan)
    out = [None] * len(plans)

    def work(i):
        out[i] = gpu.search_verified_positional(plans[i], 50, bool(i % 2))

    threads = [threading.Thread(target=work, args=(i,))
               for i in range(len(plans))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(120)
        assert not th.is_alive()
    assert gpu.batcher.batches_executed < len(plans)
    for i, (plan, g) in enumerate(zip(plans, out)):
        c = cpu.search_verified_positional(plan, 50, bool(i % 2))
        assert (g[0], g[3]) == (c[0], c[3]) and np.array_equal(g[1], c[1])


@pytest.mark.parametrize("op", ["and", "or"])
@pytest.mark.parametrize("B,K,W", [(1, 1, 4), (7, 3, 1028), (64, 8, 34816),
                                   (9, 40, 313344)])
def test_reduce_rows_matches_plain(op, B, K, W):
    require_cuda()
    g = torch.Generator().manual_seed(B * K + W)
    V = 24
    bm = torch.randint(-2 ** 31, 2 ** 31 - 1, (V + 2, W), dtype=torch.int32,
                       generator=g)
    bm[V], bm[V + 1] = -1, 0
    rows = torch.randint(0, V, (B, K), dtype=torch.int32, generator=g)
    rows[:, K // 2 + 1:] = V if op == "and" else V + 1
    rows[0] = rows[0, 0]  # one row repeated
    bm, rows = bm.cuda(), rows.cuda()
    before = runtime.launches["reduce_rows"]
    forms = dict(runtime.launch_forms)
    shapes = runtime.launch_shapes["reduce_rows"].get((op, B, K, W), 0)
    fn = bitmap_ops.and_rows if op == "and" else bitmap_ops.or_rows
    got = fn(bm, rows)
    want = bitmap_ops._reduce_rows_plain(bm, rows, op)
    torch.cuda.synchronize()
    assert runtime.launches["reduce_rows"] == before + 1
    for o in ("and", "or"):
        key = f"reduce_rows.{o}"
        assert runtime.launch_forms[key] == forms[key] + (o == op)
    assert runtime.launch_shapes["reduce_rows"][(op, B, K, W)] == shapes + 1
    assert torch.equal(got, want)
    assert torch.equal(got[0], bm[rows[0, 0].long()])


def test_reduce_rows_more_queries_than_grid_rows():
    require_cuda()
    bm = torch.randint(-2 ** 31, 2 ** 31 - 1, (10, 8), dtype=torch.int32
                       ).cuda()
    rows = torch.randint(0, 10, (70_000, 3), dtype=torch.int32).cuda()
    for op in ("and", "or"):
        got = bitmap_ops.reduce_rows(bm, rows, op)
        torch.cuda.synchronize()
        assert torch.equal(got, bitmap_ops._reduce_rows_plain(bm, rows, op))


def test_reduce_rows_refuses_bad_inputs():
    require_cuda()
    bm = torch.zeros((6, 1024), dtype=torch.int32).cuda()
    rows = torch.zeros((2, 3), dtype=torch.int32).cuda()
    k1 = runtime.launches["dense_and"]
    with pytest.raises(KernelError, match="multiple of 4"):
        bitmap_ops.reduce_rows(bm[:, :1022].contiguous(), rows, "and")
    with pytest.raises(KernelError, match="aligned"):
        bitmap_ops.reduce_rows(
            torch.zeros(6 * 1028 + 1, dtype=torch.int32).cuda()[1:].view(
                6, 1028), rows, "or")
    with pytest.raises(KernelError, match="contiguous"):
        bitmap_ops.reduce_rows(bm[:, ::2], rows, "and")
    with pytest.raises(KernelError, match="contiguous"):
        bitmap_ops.reduce_rows(bm, rows.long(), "and")
    with pytest.raises(KernelError, match="rows per query"):
        bitmap_ops.reduce_rows(bm, rows[:, :0].contiguous(), "or")
    with pytest.raises(KernelError):
        bitmap_ops.reduce_rows(bm, rows.cpu(), "and")
    assert runtime.launches["dense_and"] == k1  # K1 never stands in


def test_posting_scatter_and_threshold_ops_on_cuda_match_cpu():
    """The torch ops around K2 and K3 on the card against the CPU: the
    posting scatter with a document at bit 31 and in the last word, the
    term bitmap, both threshold programs."""
    require_cuda()
    from mygramdb_tpu_torch.ops import threshold_ops
    g = np.random.default_rng(5)
    W = 2048
    n_docs = W * 32
    sets = [np.union1d(g.choice(n_docs, int(g.integers(100, 5000)),
                                replace=False), [31, n_docs - 1]
                       ).astype(np.int32) for _ in range(5)]
    lens = np.asarray([s.size for s in sets], dtype=np.int64)
    offs = np.zeros(5, dtype=np.int64)
    np.cumsum(lens[:-1], out=offs[1:])
    post = torch.from_numpy(np.concatenate(sets))
    bm = torch.randint(-2 ** 31, 2 ** 31 - 1, (10, W), dtype=torch.int32)
    bm[8], bm[9] = -1, 0
    rows = torch.tensor([1, 2, 8], dtype=torch.int32)
    deleted = torch.randint(-2 ** 31, 2 ** 31 - 1, (W,), dtype=torch.int32
                            ) & 0x10101010
    offs_t, lens_t = torch.from_numpy(offs), torch.from_numpy(lens)
    cpu = (bm, rows, post, offs_t, lens_t, deleted)
    gpu = tuple(t.cuda() for t in cpu)
    res = []
    for b, r, p, o, ln, d in (cpu, gpu):
        one = bitmap_ops.bitmap_from_postings(p, int(offs[1]), int(lens[1]),
                                              bucket=8192, n_words=W)
        term = bitmap_ops.term_bitmap(b, r, p, o[:3], ln[:3], d, bucket=8192,
                                      n_words=W)
        cnt = threshold_ops.threshold_count_bitmap(
            b, r[:2], p, o, ln, 2, d, g_sparse=5, c_bucket=8192)
        from mygramdb_tpu_torch.ops.posting_ops import gather_slices
        total, ids = threshold_ops.threshold_merge(
            gather_slices(p, o, ln, 8192), 3, 4096)
        res.append([x.cpu() for x in (one, term, cnt, total, ids)])
    torch.cuda.synchronize()
    for a, c in zip(*res):
        assert torch.equal(a, c)
    one = res[1][0].numpy().view(np.uint32)
    assert np.array_equal(one, bitmap_ops.make_bitmap_from_ids(sets[1], W))
    assert one[0] >> 31 == 1 and one[-1] >> 31 == 1


def test_boolean_and_fuzzy_paths_on_cuda_match_cpu():
    """``ast_words``, ``search_or`` and ``search_by_threshold`` on the
    card (K2 in both forms, K3) against the same index on the CPU."""
    require_cuda()
    from mygramdb_tpu_torch.index.builder import IndexBuilder
    from mygramdb_tpu_torch.index.device_index import DeviceIndex
    rng = np.random.default_rng(1)
    b = IndexBuilder(2, 1, True)
    words = ["".join(rng.choice(list("abcdefgh"), 3)) for _ in range(200)]
    for d in range(1, 4000):
        b.add_document(d, " ".join(rng.choice(words, 12)))
    built = b.finalize()
    gpu = DeviceIndex(built, dense_df_ratio=0.2, device="cuda")
    cpu = DeviceIndex(built, dense_df_ratio=0.2, device="cpu")
    for idx in (gpu, cpu):
        idx.mark_deleted(range(1, 4000, 13))
    assert gpu.n_dense > 0 and gpu.postings.numel() > 0
    live = np.flatnonzero(built.lengths > 0)
    sparse = live[gpu.dense_row[live] < 0]
    uni = [idx.universe_words(np.arange(1, 4000)) for idx in (gpu, cpu)]
    sigs = [("&", ("|", ("t", 0), ("t", 1)), ("t", 2)),
            ("&", ("t", 0), ("!", ("t", 1))), ("!", ("t", 2)),
            ("|", ("t", 0), ("t", 3)),
            ("&", ("|", ("t", 0), ("t", 2)), ("!", ("&", ("t", 1),
                                                   ("t", 0))))]
    runtime.reset_launches()
    for i in range(40):
        leaves = [[int(t) for t in rng.choice(live, 1 + (i + j) % 3)]
                  for j in range(3)] + [None]
        for sig in sigs:
            a = gpu.ast_words(sig, leaves, uni[0])
            c = cpu.ast_words(sig, leaves, uni[1])
            assert np.array_equal(a, c), (sig, leaves)
        assert np.array_equal(gpu.search_or(leaves[0] + leaves[1]),
                              cpu.search_or(leaves[0] + leaves[1]))
        # mixed draws, then sparse terms alone (the sort-and-rank form)
        for tids in (leaves[0] + leaves[1],
                     [int(t) for t in rng.choice(sparse, 3)]):
            for m in (1, 2, len(tids)):
                assert np.array_equal(gpu.search_by_threshold(tids, m),
                                      cpu.search_by_threshold(tids, m))
    # every tree is one launch of the boolean program; K2's row reduce
    # serves the unions
    assert runtime.launches["ast_words"] == 200
    assert runtime.launch_forms["reduce_rows.and"] == 0
    assert runtime.launch_forms["reduce_rows.or"] > 0
    assert runtime.routes["threshold_merge"] > 0
    assert runtime.routes["threshold_bitmap"] > 0


# ---------------------------------------------------------------------------
# K3's probe entry: the sparse program in one launch (csrc/slice_gather.cu)
# ---------------------------------------------------------------------------

def probe_case(C, B, Ks, Kd, W=34816, seed=0):
    d = sparse_probe_inputs(seed + C + B + Ks, B, C, Ks, Kd, W=W)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a).view(
        np.int32) if a.dtype == np.uint32 else a).cuda()
    return d, (t(d["postings"]), t(d["bitmaps"]), t(d["deleted"]),
               t(d["extra"]), t(d["args"]))


# (form, width) for a C: the batcher's pages, count only, n past C, the
# fused program's compactions and the probeless candidate vector
def probe_forms(C):
    return [("topn", 128, False), ("topn", 1024, True), ("topn", 0, True),
            ("topn", 2 * C + 3, True), ("compact", min(4096, C), False),
            ("compact", C, False), ("masked", C, False)]


@pytest.mark.parametrize("Ks,Kd", [(8, 8), (32, 32)])
@pytest.mark.parametrize("B", [1, 64])
@pytest.mark.parametrize("C", [512, 1000, 2048, 8192, 32768, 65536])
def test_sparse_probe_matches_plain(C, B, Ks, Kd):
    require_cuda()
    d, (post, bm, dl, extra, args) = probe_case(C, B, Ks, Kd)
    W = bm.shape[1]
    checks = 0
    for form, width, desc in probe_forms(C):
        for sparse, dense, ext in ((True, True, extra), (False, False, None),
                                   (True, False, None), (True, True, None)):
            kw = dict(Ks=Ks, Kd=Kd, C=C, Cmax=d["Cmax"], n_words=W,
                      form=form, width=width, descending=desc,
                      sparse_probes=sparse, dense_probes=dense)
            before = dict(runtime.launches), dict(runtime.launch_forms)
            got = posting_ops.sparse_probe(post, bm, dl, ext, args, **kw)
            # one launch; the kernel gathers the slices itself
            assert runtime.launches == {
                **before[0], "sparse_probe": before[0]["sparse_probe"] + 1}
            assert runtime.launch_forms[f"sparse_probe.{form}"] == \
                before[1][f"sparse_probe.{form}"] + 1
            assert runtime.launch_forms["sparse_probe.probe_free"] == \
                before[1]["sparse_probe.probe_free"] + (not (sparse or dense))
            want = posting_ops._sparse_probe_plain(post, bm, dl, ext, args,
                                                   **kw)
            torch.cuda.synchronize()
            assert got.shape == want.shape and torch.equal(got, want), \
                (form, width, desc, sparse, dense, ext is not None)
            checks += 1
    counts = want[:B] if want.dim() == 1 else want[:, 0]
    assert checks == 28 and int(counts.sum()) > 0


def test_sparse_probe_truncates_probe_slices_at_cmax():
    require_cuda()
    d, (post, bm, dl, extra, args) = probe_case(2048, 16, 8, 8, W=4096)
    for Cmax in (64, 1000, d["Cmax"]):
        kw = dict(Ks=8, Kd=8, C=2048, Cmax=Cmax, n_words=4096, form="topn",
                  width=1024, descending=True)
        got = posting_ops.sparse_probe(post, bm, dl, extra, args, **kw)
        want = posting_ops._sparse_probe_plain(post, bm, dl, extra, args,
                                               **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want), Cmax


def test_sparse_probe_more_queries_than_grid_rows():
    require_cuda()
    d, (post, bm, dl, extra, args) = probe_case(512, 70, 8, 8, W=1024)
    args = args.repeat(1000, 1)[:70_000].contiguous()
    kw = dict(Ks=8, Kd=8, C=512, Cmax=d["Cmax"], n_words=1024, form="topn",
              width=128, descending=True)
    got = posting_ops.sparse_probe(post, bm, dl, extra, args, **kw)
    want = posting_ops._sparse_probe_plain(post, bm, dl, extra, args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_sparse_probe_refuses_bad_inputs():
    require_cuda()
    d, (post, bm, dl, extra, args) = probe_case(512, 4, 8, 8, W=1024)
    kw = dict(Ks=8, Kd=8, C=512, Cmax=d["Cmax"], n_words=1024, form="topn",
              width=128)
    with pytest.raises(KernelError, match="shape"):
        posting_ops.sparse_probe(post, bm, dl, extra, args[:, :-1]
                                 .contiguous(), **kw)
    with pytest.raises(KernelError, match="int64"):
        posting_ops.sparse_probe(post, bm, dl, extra, args.int(), **kw)
    with pytest.raises(KernelError, match="contiguous"):
        posting_ops.sparse_probe(post, bm[:, ::2], dl[::2], extra[:, ::2],
                                 args, **kw)
    with pytest.raises(KernelError):
        posting_ops.sparse_probe(post, bm, dl.cpu(), extra, args, **kw)
    before = runtime.launches["sparse_probe"]
    out = posting_ops.sparse_probe(post, bm, dl, extra, args[:0], **kw)
    assert out.shape == (0, 129) and runtime.launches["sparse_probe"] == \
        before


# ---------------------------------------------------------------------------
# K2's tree entry: the boolean program in one launch (csrc/dense_and.cu)
# ---------------------------------------------------------------------------

def tree_case(W, T, K, S, seed, pool=6000, keep=0.6):
    """Host inputs of the boolean program: random rows (row V all-ones,
    V + 1 all-zeros, the others 15/16 set), a CSR of sorted slices that
    each keep about ``keep`` of one pool of ``pool`` documents (so their
    ANDs hold documents), rows (T, K), offs and lens (T, S) with padding
    slots, tombstones and a universe."""
    rng = np.random.default_rng(seed)
    V = 24
    n_docs = W * 32
    bm = rng.integers(0, 2 ** 32, size=(V + 2, W), dtype=np.uint32)
    for _ in range(3):
        bm[:V] |= rng.integers(0, 2 ** 32, size=(V, W), dtype=np.uint32)
    bm[V], bm[V + 1] = 0xFFFFFFFF, 0
    docs = rng.choice(n_docs, min(pool, n_docs), replace=False)
    lists = [np.sort(docs[rng.random(docs.size) < keep])
             for _ in range(T * S + 1)]
    lists[0] = np.union1d(lists[0], [0, 31, n_docs - 1])
    lens_all = np.asarray([x.size for x in lists], dtype=np.int64)
    offs_all = np.zeros(len(lists), dtype=np.int64)
    np.cumsum(lens_all[:-1], out=offs_all[1:])
    post = np.concatenate(lists).astype(np.int32)
    rows = rng.integers(0, V, size=(T, K)).astype(np.int32)
    rows[:, K - 1] = V
    if T > 4:
        rows[4] = V + 1                   # an unknown gram's leaf
    offs = offs_all[:T * S].reshape(T, S).copy()
    lens = lens_all[:T * S].reshape(T, S).copy()
    if S:
        lens[0, -1] = 0                   # padding
        if T > 2:
            offs[2, 0] = post.size        # a dense term's entry: zeros
    deleted = np.zeros(W, dtype=np.uint32)
    deleted[rng.integers(0, W, W // 40)] = rng.integers(
        0, 2 ** 32, W // 40, dtype=np.uint32)
    universe = rng.integers(0, 2 ** 32, size=W, dtype=np.uint32) | deleted
    real = rng.random((T, S)) < 0.5
    t = lambda a: torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                                   else a).cuda()
    return (t(bm), t(post), t(deleted), t(universe)), rows, offs, lens, real


def chain(depth, T):
    node = ("t", 0)
    for i in range(depth - 1):
        tag = "&|!"[i % 3]
        node = ("!", node) if tag == "!" else (tag, ("t", (i + 1) % T), node)
    return node


TREE_CASES = {
    "leaf": (("t", 0), 1, 3, 2),
    "not_root": (("!", ("|", ("t", 0), ("&", ("t", 1), ("t", 2)))), 3, 4, 2),
    "zeros_leaf": (("&", ("|", ("t", 3), ("t", 4)), ("!", ("t", 1))), 5, 3,
                   2),
    "no_sparse": (("|", ("t", 0), ("!", ("t", 1))), 2, 8, 0),
    "max_depth": (chain(32, 6), 6, 4, 3),
    # a stack past the shared memory of 128 vectors a block: the span
    # shrinks (no parser tree is this deep)
    "deep_stack": (chain(400, 6), 6, 2, 1),
    # more slices than the block caches windows for: the rest inline
    "many_slices": (("|",) + tuple(("t", i) for i in range(40)), 40, 2, 30),
    # an n-ary AND, a leaf twice (leaf 2 holds a dense term's entry)
    "wide_and": (("&", ("t", 0), ("t", 1), ("t", 3), ("t", 0)), 4, 1, 2),
}


@pytest.mark.parametrize("real", [False, True])
@pytest.mark.parametrize("W", [1024, 34816])
@pytest.mark.parametrize("case", list(TREE_CASES))
def test_ast_words_matches_plain(case, W, real):
    require_cuda()
    sig, T, K, S = TREE_CASES[case]
    (bm, post, dl, uni), rows, offs, lens, rl = tree_case(
        W, T, K, S, seed=len(case) + W, keep=0.97 if S > 10 else 0.6)
    bucket = int(max(lens.max(initial=1), 1))
    kw = dict(bucket=bucket, n_words=W, real=rl if real else None)
    before = dict(runtime.launches)
    got = bitmap_ops.ast_words(sig, bm, post, dl, uni, rows, offs, lens, **kw)
    assert runtime.launches == {**before,
                                "ast_words": before["ast_words"] + 1}
    want = bitmap_ops._ast_words_plain(sig, bm, post, dl, uni, rows, offs,
                                       lens, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want), case
    # (a real empty slot may zero leaf 0 and with it an AND)
    assert case == "zeros_leaf" or real or bool(got.any())


def test_ast_words_bucket_truncates_slices():
    require_cuda()
    (bm, post, dl, uni), rows, offs, lens, _ = tree_case(2048, 3, 2, 3, 9)
    sig = ("|", ("t", 0), ("&", ("t", 1), ("t", 2)))
    for bucket in (1, 100, int(lens.max())):
        kw = dict(bucket=bucket, n_words=2048)
        got = bitmap_ops.ast_words(sig, bm, post, dl, uni, rows, offs, lens,
                                   **kw)
        want = bitmap_ops._ast_words_plain(sig, bm, post, dl, uni, rows,
                                           offs, lens, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want), bucket


def test_ast_words_refuses_bad_inputs():
    require_cuda()
    (bm, post, dl, uni), rows, offs, lens, _ = tree_case(1024, 2, 2, 1, 3)
    kw = dict(bucket=4096, n_words=1024)
    with pytest.raises(KernelError, match="multiple of 4"):
        bitmap_ops.ast_words(("t", 0), bm[:, :1022].contiguous(), post,
                             dl[:1022], uni[:1022], rows, offs, lens, **kw)
    with pytest.raises(KernelError, match="contiguous"):
        bitmap_ops.ast_words(("t", 0), bm[:, ::2], post, dl, uni, rows,
                             offs, lens, **kw)
    with pytest.raises(KernelError, match="leaf"):
        bitmap_ops.ast_words(("t", 5), bm, post, dl, uni, rows, offs, lens,
                             **kw)
    with pytest.raises(KernelError):
        bitmap_ops.ast_words(("t", 0), bm, post, dl.cpu(), uni, rows, offs,
                             lens, **kw)


# ---------------------------------------------------------------------------
# P1: the row gather of the probe (csrc/row_gather.cu)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,N,rowT,R", [
    (torch.int16, 5000, 1024, 1001),       # a text matrix's rows
    (torch.int16, 300, 8, 1),              # one 16-byte row
    (torch.int32, 77, 36, 4099),           # rows of 144 bytes, ids repeat
    (torch.uint8, 1000, 48, 333),
    (torch.int16, 5000, 1024, 100),        # fewer rows than SMs
    (torch.int16, 5000, 1024, 13),         # no multiple of the ring
    (torch.int16, 4000, 8, 70_001),        # 16-byte rows, many
    (torch.int32, 500, 2048, 777),         # 8 KB rows: two stages each
    (torch.int32, 300, 1028, 99),          # 4,112 B: a 16-byte last chunk
])
def test_gather_rows_matches_plain(dtype, N, rowT, R):
    require_cuda()
    from mygramdb_tpu_torch.tools import profile_gather as pg
    g = torch.Generator().manual_seed(N + R)
    src = torch.randint(0, 120, (N, rowT), generator=g).to(dtype).cuda()
    ids = torch.randint(0, N, (R,), dtype=torch.int32, generator=g)
    ids[-1] = N - 1
    ids = ids.cuda()
    before = runtime.launches["row_gather"]
    got = pg.gather_rows(src, ids)
    want = pg._gather_rows_plain(src, ids)
    torch.cuda.synchronize()
    assert runtime.launches["row_gather"] == before + 1
    assert got.shape == (R, rowT) and torch.equal(got, want)
    assert torch.equal(got, torch.index_select(src, 0, ids))


def test_gather_rows_row_base_past_2_31_bytes():
    require_cuda()
    from mygramdb_tpu_torch.tools import profile_gather as pg
    N, rowT = 1_130_496, 1024   # 2.3 GB: the last row starts past 2^31 bytes
    src = torch.zeros((N, rowT), dtype=torch.int16, device="cuda")
    marks = torch.tensor([0, 1, (2 ** 31) // 2048 - 1, (2 ** 31) // 2048,
                          N - 2, N - 1], dtype=torch.int32).cuda()
    src[marks.long()] = (torch.arange(6, dtype=torch.int16).cuda()
                         + 1)[:, None]
    ids = torch.cat([marks, marks.flip(0)])
    got = pg.gather_rows(src, ids)
    torch.cuda.synchronize()
    assert got[:, 0].tolist() == [1, 2, 3, 4, 5, 6, 6, 5, 4, 3, 2, 1]
    assert torch.equal(got, pg._gather_rows_plain(src, ids))


def test_gather_rows_refuses_bad_inputs():
    require_cuda()
    from mygramdb_tpu_torch.tools import profile_gather as pg
    src = torch.zeros((10, 1024), dtype=torch.int16).cuda()
    ids = torch.zeros(4, dtype=torch.int32).cuda()
    with pytest.raises(KernelError, match="multiple of 16"):
        pg.gather_rows(src[:, :1022].contiguous(), ids)
    with pytest.raises(KernelError, match="aligned"):
        pg.gather_rows(torch.zeros(10 * 1024 + 1, dtype=torch.int16).cuda()
                       [1:].view(10, 1024), ids)
    with pytest.raises(KernelError, match="contiguous"):
        pg.gather_rows(src[:, ::2], ids)
    with pytest.raises(KernelError, match="int32"):
        pg.gather_rows(src, ids.long())
    with pytest.raises(KernelError):
        pg.gather_rows(src, ids.cpu())
    assert pg.gather_rows(src, ids[:0]).shape == (0, 1024)


# ---------------------------------------------------------------------------
# Every kernel on a second card (the device guard and per-device state)
# ---------------------------------------------------------------------------

def second_card():
    """cuda:1 while cuda:0 stays current; skips on a host of one card."""
    require_cuda()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs a second CUDA device")
    assert torch.cuda.current_device() == 0
    return torch.device("cuda:1")


@pytest.mark.parametrize("kernel", ["dense_and", "dense_and_topn",
                                    "reduce_rows", "ast_words",
                                    "slice_gather", "sparse_probe",
                                    "tf_rows", "row_gather"])
def test_every_kernel_on_a_second_card(kernel):
    dev = second_card()
    if kernel in ("dense_and", "dense_and_topn", "reduce_rows"):
        bm, rows, nrows, extra, deleted = [t.to(dev) for t in
                                           dense_inputs(313344, K=6)]
        args = (bm, rows, nrows, extra, deleted)
        if kernel == "dense_and":
            got, want = (bitmap_ops.dense_and(*args),
                         bitmap_ops._dense_query_plain(*args))
        elif kernel == "dense_and_topn":
            got = bitmap_ops.dense_and_topn(*args, 1024, True, words=True)
            want = topn_plain(args, 1024, True)
        else:
            got = (bitmap_ops.reduce_rows(bm, rows, "and"),)
            want = (bitmap_ops._reduce_rows_plain(bm, rows, "and"),)
    elif kernel == "ast_words":
        (bm, post, dl, uni), rows, offs, lens, _ = tree_case(313344, 3, 4, 2,
                                                             5)
        bm, post, dl, uni = (x.to(dev) for x in (bm, post, dl, uni))
        sig = ("&", ("|", ("t", 0), ("t", 1)), ("!", ("t", 2)))
        kw = dict(bucket=4096, n_words=313344)
        got = (bitmap_ops.ast_words(sig, bm, post, dl, uni, rows, offs, lens,
                                    **kw),)
        want = (bitmap_ops._ast_words_plain(sig, bm, post, dl, uni, rows,
                                            offs, lens, **kw),)
    elif kernel == "sparse_probe":
        d, inputs = probe_case(65536, 8, 8, 8)
        post, bm, dl, extra, args = (x.to(dev) for x in inputs)
        kw = dict(Ks=8, Kd=8, C=65536, Cmax=d["Cmax"], n_words=34816,
                  form="topn", width=1024, descending=True)
        got = (posting_ops.sparse_probe(post, bm, dl, extra, args, **kw),)
        want = (posting_ops._sparse_probe_plain(post, bm, dl, extra, args,
                                                **kw),)
    elif kernel == "slice_gather":
        post = torch.arange(100_000, dtype=torch.int32, device=dev)
        offs = torch.arange(0, 99_000, 990, dtype=torch.int64, device=dev)
        lens = torch.full_like(offs, 700)
        got = (posting_ops.gather_slices(post, offs, lens, 1024),)
        want = (posting_ops._gather_slices_plain(post, offs, lens, 1024),)
    elif kernel == "tf_rows":
        # u32 cells and a 2,048 window: 66 KB of shared memory a block, past
        # the 48 KB a device allows before its kernel raises the limit
        flat, offs, lens = text_pack(True, N=2000, maxT=2048)
        ndl, nlen = needle_table(flat, offs, lens, 2, 2, 4, False)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        ids = np.arange(1024) % lens.size
        args = (t(flat.view(np.int32)), t(offs[ids]), t(lens[ids]),
                t(verify_ops.cast_needles_i32(ndl, np.uint32, 4)), t(nlen))
        kw = dict(Kv=512, cap=4, win=2048, use_range=True)
        got = (verify_ops.tf_rows_flat(*args, **kw),)
        want = (verify_ops._tf_flat_plain(*args, **kw),)
    else:
        from mygramdb_tpu_torch.tools import profile_gather as pg
        src = torch.randint(0, 1000, (5000, 1024), dtype=torch.int16,
                            device=dev)
        ids = torch.randint(0, 5000, (3001,), dtype=torch.int32, device=dev)
        got, want = (pg.gather_rows(src, ids),), (pg._gather_rows_plain(src,
                                                                         ids),)
    torch.cuda.synchronize(dev)
    for a, b in zip(got, want):
        assert a.device == dev and torch.equal(a, b)


# ---------------------------------------------------------------------------
# The doc-sharded mesh: K1, K2, K3 and K6 a shard, then the merge
# ---------------------------------------------------------------------------

def mesh_corpus(seed=5, n_docs=9000):
    """A small-alphabet corpus (needles match often) and its BuiltIndex;
    docs 1..120 alone hold the word "qqqq" (absent from every other
    shard's doc range)."""
    from mygramdb_tpu_torch.index.builder import IndexBuilder
    rng = np.random.default_rng(seed)
    words = ["".join(rng.choice(list("abcdefgh"), 4)) for _ in range(300)]
    texts = {d: " ".join(rng.choice(words, int(rng.integers(3, 40))))
             for d in range(1, n_docs)}
    for d in range(1, 121):
        texts[d] += " qqqq"
    b = IndexBuilder(2, 1, True)
    for d, x in texts.items():
        b.add_document(d, x)
    return words, texts, b.finalize()


def check_mesh_against_single(devices, single_dev, seed=5):
    """Every mesh route over ``devices`` against the single-device index on
    ``single_dev``: AND (dense, sparse, NOT, count, both orders), trees,
    unions, and the fused verified search (sparse and dense drivers, PK
    and BM25 order), exactly (BM25 to 1e-5)."""
    from mygramdb_tpu_torch.index.device_index import (DeviceIndex,
                                                       SearchOptions)
    from mygramdb_tpu_torch.parallel.mesh import make_mesh
    from mygramdb_tpu_torch.storage.device_text import DeviceTextStore
    from mygramdb_tpu_torch.utils import textproc
    words, texts, built = mesh_corpus(seed)
    mesh = make_mesh(devices=devices)
    m = DeviceIndex(built, dense_df_ratio=0.2, mesh=mesh)
    s = DeviceIndex(built, dense_df_ratio=0.2, device=single_dev)
    mst = DeviceTextStore(texts, m.n_docs_capacity,
                          doc_sharding=m.text_doc_sharding)
    sst = DeviceTextStore(texts, s.n_docs_capacity, device=single_dev)
    assert mst.doc_sharded and len(mst.shards) == len(devices)
    for idx in (m, s):
        idx.mark_deleted(range(1, 9000, 17))
    rng = np.random.default_rng(seed)
    live = np.flatnonzero(built.lengths > 0)
    runtime.reset_launches()
    for i in range(40):
        tids = [int(t) for t in rng.choice(live, 1 + i % 3)]
        nots = [int(rng.choice(live))] if i % 4 == 0 else []
        for opts in (dict(limit=0), dict(limit=10), dict(count_only=True),
                     dict(limit=50, descending=False)):
            a = m.search_and(tids, nots, None, SearchOptions(**opts))
            c = s.search_and(tids, nots, None, SearchOptions(**opts))
            assert a[0] == c[0] and np.array_equal(a[1], c[1]), (tids, nots)
        assert np.array_equal(m.search_or(tids + nots),
                              s.search_or(tids + nots))
    universe = [idx.universe_words(np.asarray(list(texts))) for idx in (m, s)]
    sig = ("|", ("&", ("t", 0), ("!", ("t", 1))), ("t", 2))
    qq = built.term_dict.get("qq")
    for i in range(12):
        leaves = [[int(t) for t in rng.choice(live, 2)] for _ in range(3)]
        if i % 3 == 0:
            leaves[0] = [qq]   # slices empty on every shard but the first
        a, c = (idx.ast_words(sig, leaves, u) for idx, u in zip((m, s),
                                                                 universe))
        assert np.array_equal(a, c), leaves
    verified = 0
    for i in range(30):
        terms = list(rng.choice(words, 1 + i % 2)) if i % 5 else ["qqqq"]
        needles = np.zeros((2, verify_ops.NEEDLE_CAP), dtype=np.uint32)
        nlens = np.zeros(2, dtype=np.int32)
        for j, w in enumerate(terms):
            needles[j, :len(w)] = [ord(x) for x in w]
            nlens[j] = len(w)
        tids = sorted({built.term_dict.get(g) for w in terms
                       for g in textproc.generate_query_ngrams(w, 2, 1,
                                                               True)})
        for score in (False, True):
            res = [idx.search_and_verified(
                tids, st, needles, nlens, 100, bool(i % 2),
                score_mode=score, idf=np.ones(2, dtype=np.float32),
                avgdl=60.0) for idx, st in ((m, mst), (s, sst))]
            if res[0] is None or res[1] is None:
                continue
            verified += 1
            assert res[0][0] == res[1][0], terms
            assert np.array_equal(res[0][1], res[1][1]), terms
            np.testing.assert_allclose(res[0][2], res[1][2], rtol=1e-5)
    assert verified > 20
    routes = dict(runtime.routes)
    for r in ("mesh_dense", "mesh_sparse", "mesh_fused_sparse",
              "mesh_fused_dense", "mesh_ast", "mesh_or"):
        assert routes[r] > 0, (r, routes)
    return mesh


def test_mesh_programs_on_cuda_match_single_device():
    """Two shards on one card (cuda:0) against the single-device index on
    the card: each shard launches K1, K2's tree and OR, K3's probe entry
    (top-n and the fused forms) and K6."""
    require_cuda()
    check_mesh_against_single([torch.device("cuda:0")] * 2, "cuda")
    for shard in (0, 1):
        got = runtime.launches_by_shard[shard]
        for k in ("dense_and", "ast_words", "reduce_rows", "sparse_probe",
                  "sparse_probe.topn", "tf_rows_padded"):
            assert got.get(k, 0) > 0, (shard, k, got)
    assert set(runtime.launches_by_device) == {"cuda:0"}


def test_mesh_on_two_cards():
    """Shards on cuda:0 and cuda:1 (each launch on its shard's card, the
    merge on cuda:0) against the single-device index on the CPU."""
    dev = second_card()
    check_mesh_against_single([torch.device("cuda:0"), dev], "cpu", seed=6)
    for card in ("cuda:0", "cuda:1"):
        got = runtime.launches_by_device[card]
        for k in ("dense_and", "ast_words", "sparse_probe",
                  "tf_rows_padded"):
            assert got.get(k, 0) > 0, (card, k, got)


def test_mesh_shard_empty_slice_gives_zeros_on_cuda():
    """A term absent from a shard's doc range contributes zeros there (not
    the padding identity) in K2's tree and K3's probe, on the card."""
    require_cuda()
    from mygramdb_tpu_torch.index.device_index import (DeviceIndex,
                                                       SearchOptions)
    from mygramdb_tpu_torch.parallel.mesh import make_mesh
    _, texts, built = mesh_corpus(7)
    m = DeviceIndex(built, dense_df_ratio=0.2,
                    mesh=make_mesh(devices=[torch.device("cuda:0")] * 2))
    qq, ab = built.term_dict.get("qq"), built.term_dict.get("ab")
    assert m.dense_row[qq] < 0 and m.lengths_sh[1, qq] == 0
    want = sorted(d for d in range(1, 121) if "ab" in texts[d])
    w = m.ast_words(("&", ("t", 0), ("t", 1)), [[qq], [ab]], m._ones_words)
    bits = np.unpackbits(w.view(np.uint8), bitorder="little")
    assert np.flatnonzero(bits).tolist() == want
    total, ids = m.search_and([qq, ab], [], None, SearchOptions(limit=0))
    assert total == len(want) and ids.tolist() == want


def test_sharded_query_engine_on_cuda():
    """``ShardedQueryEngine`` on two shards of cuda:0: one delta-apply,
    then a batched query (K1 a shard, the merge), against numpy."""
    require_cuda()
    from mygramdb_tpu_torch.parallel.mesh import ShardedQueryEngine, make_mesh
    rng = np.random.default_rng(9)
    W = 2048
    bm = np.zeros((16, W), dtype=np.uint32)
    bm[:14] = (rng.integers(0, 2 ** 32, size=(14, W), dtype=np.uint32)
               & rng.integers(0, 2 ** 32, size=(14, W), dtype=np.uint32))
    bm[14] = 0xFFFFFFFF
    eng = ShardedQueryEngine(make_mesh(devices=[torch.device("cuda:0")] * 2),
                             bm, np.zeros(W, dtype=np.uint32), topk=16)
    tr = np.asarray([0, 0, 1, 5], dtype=np.int32)
    di = np.asarray([33, 34, 40000, W * 32 - 1], dtype=np.int32)
    eng.apply_delta(tr, di)
    np.bitwise_or.at(bm, (tr, di >> 5), np.left_shift(
        np.uint32(1), (di & 31).astype(np.uint32)))
    rows = np.full((6, 3), 14, dtype=np.int32)
    rows[:, 0] = np.arange(6)
    counts, ids = eng.search(rows)
    for b in range(6):
        words = np.bitwise_and.reduce(bm[rows[b]], axis=0)
        docs = np.flatnonzero(np.unpackbits(words.view(np.uint8),
                                            bitorder="little"))
        assert int(counts[b]) == docs.size
        assert ids[b][ids[b] >= 0].tolist() == docs[::-1][:16].tolist()
