"""Port parity for the fuzzy backbone: ``threshold_count_bitmap`` and
``threshold_merge`` against the JAX package's functions and against a
numpy ``bincount`` on the same arrays, and
``DeviceIndex.search_by_threshold`` of both packages on one ``BuiltIndex``.
Integer work: ids, counts and words equal exactly.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from mygramdb_tpu.index import device_index as JD
from mygramdb_tpu.ops import threshold_ops as J
from mygramdb_tpu.ops.posting_ops import pad_postings
from mygramdb_tpu_torch.convert import state_from_jax
from mygramdb_tpu_torch.index import device_index as TD
from mygramdb_tpu_torch.ops import bitmap_ops, runtime
from mygramdb_tpu_torch.ops import threshold_ops as T
from mygramdb_tpu_torch.ops.posting_ops import SENTINEL

from torch_parity import build_corpus, i32, torch_cpu, u32  # noqa: F401

W = 1024
N_DOCS = W * 32


def inputs(seed, n_dense, n_sparse):
    """Dense rows and sparse slices over one id space, each set holding
    doc 31 and the last doc, with a tombstone row."""
    rng = np.random.default_rng(seed)
    sets = [np.union1d(rng.choice(N_DOCS, int(rng.integers(200, 3000)),
                                  replace=False), [31, N_DOCS - 1])
            for _ in range(n_dense + n_sparse)]
    bm = np.zeros((n_dense + 2, W), dtype=np.uint32)
    for r in range(n_dense):
        bm[r] = bitmap_ops.make_bitmap_from_ids(sets[r], W)
    bm[n_dense] = 0xFFFFFFFF
    rows = np.arange(n_dense, dtype=np.int32)
    sp = [s.astype(np.int32) for s in sets[n_dense:]]
    lens = np.asarray([s.size for s in sp] or [0], dtype=np.int64)
    offs = np.zeros(lens.size, dtype=np.int64)
    np.cumsum(lens[:-1], out=offs[1:])
    post = np.concatenate(sp) if sp else np.zeros(1, dtype=np.int32)
    deleted = np.zeros(W, dtype=np.uint32)
    deleted[rng.integers(0, W, 30)] = rng.integers(0, 2 ** 32, 30,
                                                   dtype=np.uint32)
    deleted[-1] &= 0x7FFFFFFF  # the last doc stays live
    deleted[0] &= 0x7FFFFFFF   # and doc 31
    return sets, bm, rows, post, offs, lens, deleted


def bincount_words(sets, min_count, deleted):
    cnt = np.bincount(np.concatenate(sets), minlength=N_DOCS)
    return bitmap_ops.make_bitmap_from_ids(np.flatnonzero(cnt >= min_count),
                                           W) & ~deleted


@pytest.mark.parametrize("n_dense,n_sparse", [(3, 0), (1, 4), (4, 3)],
                         ids=["dense-only", "mostly-sparse", "mixed"])
@pytest.mark.parametrize("min_count", [1, 2, 3])
def test_threshold_count_bitmap_matches_jax(n_dense, n_sparse, min_count):
    sets, bm, rows, post, offs, lens, deleted = inputs(
        7 * n_dense + n_sparse, n_dense, n_sparse)
    c_bucket = 4096 if n_sparse else 0
    # the JAX call pads its rows to a bucket with the all-zeros row
    jrows = np.full(8, n_dense + 1, dtype=np.int32)
    jrows[:n_dense] = rows
    want = np.asarray(J.threshold_count_bitmap(
        jnp.asarray(bm), jnp.asarray(jrows), jnp.asarray(pad_postings(post)),
        jnp.asarray(offs.astype(np.int32)),
        jnp.asarray(lens.astype(np.int32)), jnp.int32(min_count),
        jnp.asarray(deleted), g_sparse=n_sparse, c_bucket=c_bucket))
    before = dict(runtime.launches)
    got = u32(T.threshold_count_bitmap(
        i32(bm), i32(rows), torch.from_numpy(post), torch.from_numpy(offs),
        torch.from_numpy(lens), min_count, i32(deleted), g_sparse=n_sparse,
        c_bucket=c_bucket))
    assert runtime.launches == before
    assert np.array_equal(got, want)
    assert np.array_equal(got, bincount_words(sets, min_count, deleted))
    # doc 31 and the last doc are in every set: bit 31 of both end words
    assert got[0] >> 31 == 1 and got[-1] >> 31 == 1


def test_threshold_count_bitmap_takes_a_tensor_threshold_and_drops_pads():
    sets, bm, rows, post, offs, lens, deleted = inputs(4, 1, 2)
    # a slice running past the CSR's end reads sentinels: they count for
    # nothing
    lens2 = lens.copy()
    lens2[-1] += 50
    got = u32(T.threshold_count_bitmap(
        i32(bm), i32(rows), torch.from_numpy(post), torch.from_numpy(offs),
        torch.from_numpy(lens2), torch.tensor(2, dtype=torch.int32),
        i32(deleted), g_sparse=2, c_bucket=4096))
    assert np.array_equal(got, bincount_words(sets, 2, deleted))


def padded_slices(sets, width):
    out = np.full((len(sets), width), SENTINEL, dtype=np.int32)
    for i, s in enumerate(sets):
        out[i, :s.size] = s
    return out


@pytest.mark.parametrize("max_out", [50, 131072],
                         ids=["total-above", "total-below"])
@pytest.mark.parametrize("min_count", [1, 2, 4])
def test_threshold_merge_matches_jax(max_out, min_count):
    sets, *_ = inputs(11, 0, 5)
    slices = padded_slices(sets, 4096)
    tj, ij = J.threshold_merge(jnp.asarray(slices), jnp.int32(min_count),
                               max_out)
    tt, it = T.threshold_merge(torch.from_numpy(slices), min_count, max_out)
    assert int(tt) == int(tj)
    assert it.dtype == torch.int32
    assert np.array_equal(it.numpy(), np.asarray(ij))
    cnt = np.bincount(np.concatenate(sets), minlength=N_DOCS)
    ids = np.flatnonzero(cnt >= min_count)
    assert int(tt) == ids.size
    n = min(max_out, slices.size)
    want = np.full(n, -1, dtype=np.int32)
    want[:min(n, ids.size)] = ids[:n]
    assert np.array_equal(it.numpy(), want)
    if max_out == 50:
        assert int(tt) > max_out or min_count == 4


def test_threshold_merge_clamps_to_the_flat_length():
    slices = np.asarray([[1, 5, SENTINEL], [5, 9, SENTINEL]], dtype=np.int32)
    total, ids = T.threshold_merge(torch.from_numpy(slices), 1, 100)
    assert int(total) == 3
    assert ids.tolist() == [1, 5, 9, -1, -1, -1]
    total, ids = T.threshold_merge(torch.from_numpy(slices), 2, 100)
    assert int(total) == 1 and ids.tolist() == [5, -1, -1, -1, -1, -1]


# ---------------------------------------------------------------------------
# DeviceIndex.search_by_threshold: one BuiltIndex through both packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair(torch_cpu):
    built = build_corpus(3000)
    jdev = JD.DeviceIndex(built, dense_df_ratio=0.05)
    tdev = TD.DeviceIndex.from_state(state_from_jax(jdev), built)
    gone = list(range(3, 3000, 7))
    jdev.mark_deleted(gone)
    tdev.mark_deleted(gone)
    return built, jdev, tdev


def term_pools(built, tdev):
    live = np.flatnonzero(built.lengths > 0)
    dense = live[tdev.dense_row[live] >= 0]
    sparse = live[tdev.dense_row[live] < 0]
    return dense, sparse[built.lengths[sparse] > 20]


@pytest.mark.parametrize("kind", ["sparse", "dense", "mixed"])
def test_search_by_threshold_matches_jax(pair, kind):
    built, jdev, tdev = pair
    dense, common = term_pools(built, tdev)
    rng = np.random.default_rng(len(kind))
    hits = 0
    for _ in range(12):
        nd = 0 if kind == "sparse" else int(rng.integers(1, 4))
        ns = 0 if kind == "dense" else int(rng.integers(1, 6))
        tids = [int(t) for t in rng.choice(dense, nd, replace=False)] \
            + [int(t) for t in rng.choice(common, ns, replace=False)]
        for min_count in (1, 2, len(tids)):
            runtime.reset_launches()
            want = jdev.search_by_threshold(tids, min_count)
            got = tdev.search_by_threshold(tids, min_count)
            assert got.dtype == np.int32 and np.array_equal(got, want)
            route = "threshold_merge" if kind == "sparse" \
                else "threshold_bitmap"
            assert runtime.routes[route] == 1
            cnt = np.bincount(np.concatenate(
                [built.postings_of(t) for t in tids]), minlength=3001)
            ids = np.flatnonzero(cnt >= min_count)
            assert np.array_equal(got, ids[~tdev._deleted_mask(ids)])
            hits += got.size > 0
    assert hits > 12


def test_search_by_threshold_caps_only_the_sparse_form(pair):
    """The all-sparse form returns at most max_out ids (taken before the
    tombstones are cleared); the form with a dense term returns every
    id. Both as the JAX package."""
    built, jdev, tdev = pair
    dense, common = term_pools(built, tdev)
    sp = [int(t) for t in common[np.argsort(built.lengths[common])[-4:]]]
    want = jdev.search_by_threshold(sp, 1, max_out=40)
    got = tdev.search_by_threshold(sp, 1, max_out=40)
    assert np.array_equal(got, want) and 0 < got.size <= 40
    mixed = sp + [int(dense[0])]
    want = jdev.search_by_threshold(mixed, 1, max_out=40)
    got = tdev.search_by_threshold(mixed, 1, max_out=40)
    assert np.array_equal(got, want) and got.size > 40
    assert tdev.search_by_threshold([], 1).size == 0
    assert tdev.search_by_threshold(sp, 0).size == 0
