"""Port parity for the dense data plane: the row-AND (K1) and its callers.

The port's ``dense_query_auto`` (on the CPU its kernel's plain version)
against the JAX package's ``dense_query`` and ``dense_query_pallas`` in
interpret mode, and the port's top-n against JAX ``_dense_search_topn`` in
each of its three regimes (direct top_k below 1024 words, flat select below
16384, blocked select above).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from mygramdb_tpu.ops import bitmap_ops as J
from mygramdb_tpu_torch.ops import bitmap_ops as T
from mygramdb_tpu_torch.ops import runtime

from torch_parity import i32, torch_cpu, u32  # noqa: F401


def make_bitmaps(rng, V, W, density=0.5):
    """(V+2, W) uint32 rows with about `density` of bits set, plus the
    all-ones and all-zeros sentinel rows."""
    bits = rng.random((V, W * 32)) < density
    bm = np.packbits(bits, axis=1, bitorder="little").view(np.uint32)
    return np.concatenate([bm, np.full((1, W), 0xFFFFFFFF, np.uint32),
                           np.zeros((1, W), np.uint32)])


def query_inputs(seed, V=20, W=1024, B=5, K=6, Kn=3, F=2):
    rng = np.random.default_rng(seed)
    bm = make_bitmaps(rng, V, W, density=0.8)
    rows = rng.integers(0, V, size=(B, K)).astype(np.int32)
    rows[:, K // 2:] = V  # all-ones padding
    nrows = rng.integers(0, V, size=(B, Kn)).astype(np.int32)
    nrows[:, -1] = V + 1  # all-zeros padding
    deleted = np.zeros(W, np.uint32)
    deleted[rng.integers(0, W, size=W // 16)] = rng.integers(
        0, 2 ** 32, size=W // 16, dtype=np.uint32)
    extra = make_bitmaps(rng, F, W, density=0.9)[:F]
    return bm, rows, nrows, deleted, extra


@pytest.mark.parametrize("has_not", [False, True])
@pytest.mark.parametrize("has_extra", [False, True])
@pytest.mark.parametrize("W", [1024, 3072])
def test_dense_query_matches_jax(has_not, has_extra, W):
    bm, rows, nrows, deleted, extra = query_inputs(7 + W, W=W)
    cj, rj = J.dense_query(jnp.asarray(bm), jnp.asarray(rows),
                           jnp.asarray(nrows), jnp.asarray(deleted),
                           jnp.asarray(extra), has_not=has_not,
                           has_extra=has_extra)
    ct, rt = T.dense_query_auto(i32(bm), i32(rows), i32(nrows),
                                i32(deleted), i32(extra), has_not=has_not,
                                has_extra=has_extra)
    assert np.array_equal(u32(rt), u32(rj))
    assert np.array_equal(ct.numpy(), np.asarray(cj))


@pytest.mark.parametrize("K", [1, 8, 32])
def test_dense_query_matches_pallas_interpret(K):
    # K <= 16 takes the K-operand Pallas kernel, K = 32 the (B, K) grid
    bm, rows, _, deleted, _ = query_inputs(11 + K, W=1024, B=3, K=K)
    cp, rp = J.dense_query_pallas(jnp.asarray(bm), jnp.asarray(rows),
                                  jnp.asarray(deleted), interpret=True)
    ct, rt = T.dense_and(i32(bm), i32(rows), None, None, i32(deleted))
    assert np.array_equal(u32(rt), u32(rp))
    assert np.array_equal(ct.numpy(), np.asarray(cp))


@pytest.mark.parametrize("W", [256, 4096, 16384])
@pytest.mark.parametrize("descending", [True, False])
@pytest.mark.parametrize("filtered", [False, True])
def test_dense_search_topn_matches_jax(W, descending, filtered):
    # W < 1024: JAX _topn_direct; < 16384: flat select; else blocked
    rng = np.random.default_rng(W + descending)
    V = 8
    bm = make_bitmaps(rng, V, W, density=0.9)
    # sparse queries too: a row with few bits exercises the -1 padding
    bm[V - 1] = make_bitmaps(rng, 1, W, density=0.0005)[0]
    rows = np.asarray([[0, 1, V, V], [2, 3, 4, V], [V - 1, V, V, V],
                       [V + 1, V, V, V]], dtype=np.int32)
    nrows = np.full((4, 1), V + 1, dtype=np.int32)
    deleted = np.zeros(W, np.uint32)
    deleted[::7] = 0x0F0F0F0F
    extra = make_bitmaps(rng, 1, W, density=0.95)[:1]
    for n in (1, 128, 1024):
        args_j = (jnp.asarray(bm), jnp.asarray(rows), jnp.asarray(nrows),
                  jnp.asarray(deleted), jnp.asarray(extra))
        cj, ij = J._dense_search_topn(*args_j, False, filtered, n,
                                      descending, False)
        args_t = (i32(bm), i32(rows), i32(nrows), i32(deleted), i32(extra))
        ct, it = T.dense_search_topn(*args_t, False, filtered, n, descending)
        assert np.array_equal(ct.numpy(), np.asarray(cj)), n
        assert np.array_equal(it.numpy(), np.asarray(ij)), n
        cpk, ipk = T.dense_search_topn_packed(*args_t, False, filtered, n,
                                              descending)
        cjp, ijp = J.dense_search_topn_packed(*args_j, False, filtered, n,
                                              descending)
        assert cpk.dtype == np.int64 and ipk.dtype == np.int32
        assert np.array_equal(cpk, cjp) and np.array_equal(ipk, ijp)


def test_bit_helpers_match_jax():
    rng = np.random.default_rng(3)
    words = rng.integers(0, 2 ** 32, size=(3, 64), dtype=np.uint32)
    assert np.array_equal(T.popcount_words(i32(words)).numpy(),
                          np.asarray(J.popcount_words(jnp.asarray(words))))
    assert np.array_equal(T.expand_bits(i32(words)).numpy(),
                          np.asarray(J.expand_bits(jnp.asarray(words))))
    ids = rng.integers(0, 64 * 32, size=(3, 50)).astype(np.int32)
    assert np.array_equal(
        T.bit_member(i32(words), torch.from_numpy(ids)).numpy(),
        np.asarray(J.bit_member(jnp.asarray(words), jnp.asarray(ids))))
    assert np.array_equal(
        T.bit_member(i32(words[0]), torch.from_numpy(ids)).numpy(),
        np.asarray(J.bit_member(jnp.asarray(words[0]), jnp.asarray(ids))))
    doc_ids = np.unique(rng.integers(0, 4096, size=300))
    assert np.array_equal(T.make_bitmap_from_ids(doc_ids, 128),
                          J.make_bitmap_from_ids(doc_ids, 128))
    for desc in (True, False):
        assert np.array_equal(
            T.topn_from_bitmap(i32(words), 40, desc).numpy(),
            np.asarray(J.topn_from_bitmap(jnp.asarray(words), 40, desc)))


def test_dispatch_counts_match_jax_contract():
    bm, rows, nrows, deleted, extra = query_inputs(5)
    before = runtime.dispatches.count
    T.dense_query_auto(i32(bm), i32(rows), i32(nrows), i32(deleted),
                       i32(extra))
    T.dense_search_topn_packed(i32(bm), i32(rows), i32(nrows), i32(deleted),
                               i32(extra), False, False, 8)
    assert runtime.dispatches.count - before == 2


def test_cpu_tensors_never_launch_a_kernel():
    bm, rows, nrows, deleted, extra = query_inputs(6)
    before = dict(runtime.launches), dict(runtime.launch_forms)
    T.dense_and(i32(bm), i32(rows), i32(nrows), i32(extra), i32(deleted))
    assert (runtime.launches, runtime.launch_forms) == before


def test_not_ported_rows_reduce_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.or_rows(None, None)
