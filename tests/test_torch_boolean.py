"""Port parity for the boolean path: the row reduce (K2, on the CPU its
plain version) against the JAX package's XLA form and its Pallas kernel in
interpret mode; the posting scatter, the term bitmap and the word algebra;
and ``DeviceIndex.ast_words`` / ``universe_words`` / ``search_or`` of both
packages on one ``BuiltIndex``. Everything is integer: words and ids equal
exactly.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from mygramdb_tpu.index import device_index as JD
from mygramdb_tpu.ops import bitmap_ops as J
from mygramdb_tpu_torch.convert import state_from_jax
from mygramdb_tpu_torch.index import device_index as TD
from mygramdb_tpu_torch.ops import bitmap_ops as T
from mygramdb_tpu_torch.ops import runtime

from torch_parity import build_corpus, i32, torch_cpu, u32  # noqa: F401

V, W = 24, 1024
ONES, ZEROS = V, V + 1


@pytest.fixture(scope="module")
def bitmaps():
    rng = np.random.default_rng(21)
    bm = rng.integers(0, 2 ** 32, size=(V + 2, W), dtype=np.uint32)
    bm[ONES] = 0xFFFFFFFF
    bm[ZEROS] = 0
    return bm


def rows_for(K, op, seed):
    """(5, K) row ids: random rows, a query of one repeated row, one
    padded with the op's identity row, one made of it alone."""
    rng = np.random.default_rng(seed)
    pad = ONES if op == "and" else ZEROS
    rows = rng.integers(0, V, size=(5, K)).astype(np.int32)
    rows[1] = rows[1, 0]
    rows[2, K // 2 + 1:] = pad
    rows[3] = pad
    rows[4, 0] = ZEROS if op == "and" else ONES  # the absorbing row
    return rows


@pytest.mark.parametrize("op", ["and", "or"])
@pytest.mark.parametrize("K", [1, 3, 8])
def test_reduce_rows_matches_jax(bitmaps, op, K):
    rows = rows_for(K, op, seed=K)
    want = np.asarray(J._reduce_rows_jnp(jnp.asarray(bitmaps),
                                         jnp.asarray(rows), op))
    pallas = np.asarray(J._reduce_rows_pallas(
        jnp.asarray(bitmaps), jnp.asarray(rows), op=op, interpret=True))
    fn = T.and_rows if op == "and" else T.or_rows
    before = runtime.dispatches.count
    got = u32(fn(i32(bitmaps), i32(rows)))
    assert runtime.dispatches.count == before + 1
    assert np.array_equal(got, want)
    assert np.array_equal(got, pallas)
    assert np.array_equal(u32(T.reduce_rows(i32(bitmaps), i32(rows), op)),
                          want)
    # the identity row alone gives the identity; the absorbing row wins
    assert (got[3] == (0xFFFFFFFF if op == "and" else 0)).all()
    assert (got[4] == (0 if op == "and" else 0xFFFFFFFF)).all()


def test_reduce_rows_on_the_cpu_launches_nothing(bitmaps):
    before = dict(runtime.launches), dict(runtime.launch_forms)
    T.and_rows(i32(bitmaps), i32(rows_for(3, "and", 1)))
    T.or_rows(i32(bitmaps), i32(rows_for(3, "or", 1)))
    assert (runtime.launches, runtime.launch_forms) == before
    with pytest.raises(ValueError):
        T.reduce_rows(i32(bitmaps), i32(rows_for(3, "or", 1)), "xor")


def csr(seed, n_words, n_slices=6, max_len=300):
    """Sorted distinct doc ids per slice, among them doc 31 (bit 31 of
    word 0) and the last doc of the last word."""
    rng = np.random.default_rng(seed)
    n_docs = n_words * 32
    slices = []
    for s in range(n_slices):
        n = int(rng.integers(1, max_len))
        ids = rng.choice(n_docs, size=n, replace=False)
        if s % 2 == 0:
            ids = np.union1d(ids, [31, n_docs - 1])
        slices.append(np.sort(ids).astype(np.int32))
    lens = np.asarray([s.size for s in slices], dtype=np.int64)
    offs = np.zeros(n_slices, dtype=np.int64)
    np.cumsum(lens[:-1], out=offs[1:])
    return np.concatenate(slices), offs, lens, slices


def jpost(post):
    from mygramdb_tpu.ops.posting_ops import pad_postings
    return jnp.asarray(pad_postings(post))


@pytest.mark.parametrize("bucket", [512, 2048])
def test_bitmap_from_postings_matches_jax(bucket):
    post, offs, lens, slices = csr(3, W)
    for k in range(offs.size):
        want = np.asarray(J.bitmap_from_postings(
            jpost(post), jnp.int32(offs[k]), jnp.int32(lens[k]),
            bucket=bucket, n_words=W))
        got = u32(T.bitmap_from_postings(torch.from_numpy(post), int(offs[k]),
                                         int(lens[k]), bucket=bucket,
                                         n_words=W))
        assert np.array_equal(got, want)
        assert np.array_equal(got, T.make_bitmap_from_ids(slices[k], W))
    assert got.dtype == np.uint32
    # doc 31 is bit 31 of word 0; the last doc is bit 31 of the last word
    w0 = u32(T.bitmap_from_postings(torch.from_numpy(post), int(offs[0]),
                                    int(lens[0]), bucket=bucket, n_words=W))
    assert w0[0] >> 31 == 1 and w0[-1] >> 31 == 1


def test_bitmap_from_postings_drops_ids_out_of_range():
    # a slice gathered past the CSR's end reads sentinels; ids at or past
    # n_words * 32 and negative ids set no bit
    post = np.asarray([5, 31, 40, 64, -3, 2 ** 31 - 1], dtype=np.int32)
    got = u32(T.bitmap_from_postings(torch.from_numpy(post), 0, 6, bucket=16,
                                     n_words=2))
    assert np.array_equal(got, T.make_bitmap_from_ids([5, 31, 40], 2))
    got = u32(T.bitmap_from_postings(torch.from_numpy(post), 6, 4, bucket=16,
                                     n_words=2))
    assert not got.any()


def term_inputs(seed, K=4, S=3, with_real=False):
    rng = np.random.default_rng(seed)
    bm = rng.integers(0, 2 ** 32, size=(V + 2, W), dtype=np.uint32)
    bm[:V] |= rng.integers(0, 2 ** 32, size=(V, W), dtype=np.uint32)
    bm[ONES], bm[ZEROS] = 0xFFFFFFFF, 0
    post, offs, lens, _ = csr(seed + 1, W, n_slices=S, max_len=4000)
    rows = rng.integers(0, V, size=K).astype(np.int32)
    rows[K // 2:] = ONES
    lens = lens.copy()
    lens[-1] = 0  # a padding slot
    deleted = np.zeros(W, dtype=np.uint32)
    deleted[rng.integers(0, W, 40)] = rng.integers(0, 2 ** 32, 40,
                                                   dtype=np.uint32)
    real = None
    if with_real:
        real = np.zeros(S, dtype=bool)
        real[-1] = True  # the empty slot holds a real term: zeros
    return bm, rows, post, offs, lens, deleted, real


@pytest.mark.parametrize("with_real", [False, True])
@pytest.mark.parametrize("S", [1, 3])
def test_term_bitmap_matches_jax(with_real, S):
    K = 4
    bm, rows, post, offs, lens, deleted, real = term_inputs(5 + S, K, S,
                                                            with_real)
    want = np.asarray(J.term_bitmap(
        jnp.asarray(bm), jnp.asarray(rows), jpost(post),
        jnp.asarray(offs.astype(np.int32)),
        jnp.asarray(lens.astype(np.int32)), jnp.asarray(deleted),
        K=K, S=S, bucket=4096, n_words=W,
        real=None if real is None else jnp.asarray(real)))
    got = u32(T.term_bitmap(
        i32(bm), i32(rows), torch.from_numpy(post), torch.from_numpy(offs),
        torch.from_numpy(lens), i32(deleted), bucket=4096, n_words=W,
        real=None if real is None else torch.from_numpy(real)))
    assert np.array_equal(got, want)
    assert not (got & deleted).any()
    if with_real:
        assert not got.any()
    elif S == 1:
        # the one slot is padding: the dense rows alone, minus tombstones
        assert got.any()


def test_word_algebra_matches_jax():
    rng = np.random.default_rng(9)
    a, b = rng.integers(0, 2 ** 32, size=(2, 4096), dtype=np.uint32)
    for name in ("bm_and", "bm_or", "bm_andnot"):
        want = np.asarray(getattr(J, name)(jnp.asarray(a), jnp.asarray(b)))
        assert np.array_equal(u32(getattr(T, name)(i32(a), i32(b))), want)
    ids = np.asarray([0, 31, 32, 63, 4096 * 32 - 1])
    assert np.array_equal(T.make_bitmap_from_ids(ids, 4096),
                          J.make_bitmap_from_ids(ids, 4096))
    assert T.make_bitmap_from_ids(ids, 4096)[0] == 0x80000001
    # a tree's final reduction over the algebra's result
    w = np.bitwise_and(a, b)
    jc, jids = J.bitmap_count_topn(jnp.asarray(w), 64, True)
    tc, tids = T.bitmap_count_topn(i32(w), 64, True)
    assert int(jc) == int(tc) and np.array_equal(np.asarray(jids),
                                                 tids.numpy())


# ---------------------------------------------------------------------------
# DeviceIndex: one BuiltIndex through both packages
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


def leaf_pool(built, tdev, seed):
    """Leaves (gram-id lists) that all hold one live document, so that
    trees over them match something: all dense, dense + sparse, sparse
    only, two sparse, one dense; and None (an unknown gram)."""
    rng = np.random.default_rng(seed)
    live = np.flatnonzero(built.lengths > 0)
    dense = live[tdev.dense_row[live] >= 0]
    sparse = live[tdev.dense_row[live] < 0]
    common = sparse[built.lengths[sparse] > 20]
    while True:
        doc = int(rng.choice(built.postings_of(int(rng.choice(common)))))
        if not tdev._deleted_mask(np.asarray([doc]))[0]:
            break

    def holding(pool, n):
        out = []
        for t in rng.permutation(pool):
            p = built.postings_of(int(t))
            i = np.searchsorted(p, doc)
            if i < p.size and p[i] == doc:
                out.append(int(t))
                if len(out) == n:
                    return out
        raise AssertionError("no such terms")

    d = holding(dense, 4)
    c = holding(common, 4)
    return [d[:2], [d[2], c[0]], [c[1]], c[2:4], [d[3]], None]


SIGS = [
    ("&", ("|", ("t", 0), ("t", 1)), ("t", 2)),
    ("&", ("t", 0), ("!", ("t", 4))),
    ("!", ("t", 0)),
    ("|", ("t", 2), ("t", 5)),
    ("&", ("|", ("t", 0), ("t", 3)), ("!", ("&", ("t", 1), ("t", 4)))),
    ("|", ("t", 1), ("!", ("t", 3))),   # a NOT under an OR
    ("t", 5),
]


@pytest.mark.parametrize("sig", SIGS, ids=[str(i) for i in range(len(SIGS))])
def test_ast_words_matches_jax(pair, sig):
    built, jdev, tdev = pair
    all_ids = np.arange(1, 3001)
    uj = jdev.universe_words(all_ids)
    ut = tdev.universe_words(all_ids)
    assert isinstance(ut, torch.Tensor) and ut.dtype == torch.int32
    assert np.array_equal(u32(ut), np.asarray(uj))
    answered = 0
    for seed in range(6):
        leaves = leaf_pool(built, tdev, seed)
        runtime.reset_launches()
        want = jdev.ast_words(sig, leaves, uj)
        got = tdev.ast_words(sig, leaves, ut)
        assert got.dtype == np.uint32 and np.array_equal(got, want)
        assert not (got & tdev.deleted_host).any()
        assert runtime.routes["ast_device"] == 1
        answered += bool(got.any())
    assert answered >= 5 or sig == ("t", 5)


def test_ast_words_leaf_past_the_last_bucket_returns_none(torch_cpu):
    built = build_corpus(3000)
    kw = dict(dense_df_ratio=0.05, candidate_buckets=(16, 32))
    jdev = JD.DeviceIndex(built, **kw)
    tdev = TD.DeviceIndex(built, **kw)
    sparse = np.flatnonzero((tdev.dense_row < 0) & (built.lengths > 32))
    small = np.flatnonzero((tdev.dense_row < 0) & (built.lengths > 0)
                           & (built.lengths <= 32))
    assert sparse.size and small.size
    sig = ("|", ("t", 0), ("t", 1))
    big = [[int(sparse[0])], [int(small[0])]]
    runtime.reset_launches()
    assert jdev.ast_words(sig, big, jdev._ones_words) is None
    assert tdev.ast_words(sig, big, tdev._ones_words) is None
    assert runtime.routes["ast_host"] == 1
    assert runtime.routes["ast_device"] == 0
    fits = [[int(small[0])], [int(small[-1])]]
    assert np.array_equal(tdev.ast_words(sig, fits, tdev._ones_words),
                          jdev.ast_words(sig, fits, jdev._ones_words))
    assert runtime.routes["ast_device"] == 1


def test_search_or_matches_jax(pair):
    built, jdev, tdev = pair
    assert tdev.search_or([]).size == 0
    hits = 0
    for seed in range(8):
        for leaf in leaf_pool(built, tdev, seed):
            if leaf is None:
                continue
            runtime.reset_launches()
            want, got = jdev.search_or(leaf), tdev.search_or(leaf)
            assert got.dtype == np.int32 and np.array_equal(got, want)
            assert not tdev._deleted_mask(got).any()
            assert runtime.routes["or_rows"] == 1
            hits += got.size > 0
    assert hits > 20


def test_warmup_runs_the_tree_program(pair):
    _, _, tdev = pair
    runtime.reset_launches()
    tdev.warmup()
    assert runtime.routes["ast_device"] == 1


# ---------------------------------------------------------------------------
# The boolean program: K2's tree entry (``bitmap_ops.ast_words``, on the
# CPU its plain version) against the JAX package's tree program
# ---------------------------------------------------------------------------

MAX_DEPTH = 32  # query/ast.py: the parser's bound on nesting


def deep_tree(depth, n_leaves):
    """A chain ``depth`` nodes deep that cycles AND, OR and NOT, every
    level also holding a leaf, so the stack grows with the depth."""
    node = ("t", 0)
    for i in range(depth - 1):
        tag = "&|!"[i % 3]
        node = ("!", node) if tag == "!" else (tag, ("t", (i + 1) % n_leaves),
                                              node)
    return node


def tree_depth(node):
    return 1 + max((tree_depth(c) for c in node[1:]
                    if isinstance(c, tuple)), default=0)


TREES = {
    "leaf": ("t", 0),
    "not_root": ("!", ("|", ("t", 0), ("&", ("t", 1), ("t", 2)))),
    "wide_or": ("|",) + tuple(("t", i) for i in range(5)),
    "deep": deep_tree(MAX_DEPTH, 5),
    "zeros_leaf": ("&", ("|", ("t", 3), ("t", 4)), ("!", ("t", 1))),
}


def tree_inputs(seed, S, T=5, K=3):
    """T leaves of K dense rows and S sparse slots over the W-word space;
    leaf 4 is the all-zeros row (an unknown gram), some slots padding."""
    rng = np.random.default_rng(seed)
    bm = rng.integers(0, 2 ** 32, size=(V + 2, W), dtype=np.uint32)
    bm[:V] |= rng.integers(0, 2 ** 32, size=(V, W), dtype=np.uint32)
    bm[ONES], bm[ZEROS] = 0xFFFFFFFF, 0
    post, offs_all, lens_all, _ = csr(seed, W, n_slices=max(T * S, 1),
                                      max_len=5000)
    rows = rng.integers(0, V, size=(T, K)).astype(np.int32)
    rows[:, K - 1] = ONES
    rows[4] = ZEROS
    offs = offs_all[:T * S].reshape(T, S).copy()
    lens = lens_all[:T * S].reshape(T, S).copy()
    if S:
        lens[1, -1] = 0   # padding slots: the AND identity
        lens[3, 0] = 0
    deleted = np.zeros(W, dtype=np.uint32)
    deleted[rng.integers(0, W, 60)] = rng.integers(0, 2 ** 32, 60,
                                                  dtype=np.uint32)
    universe = rng.integers(0, 2 ** 32, size=W, dtype=np.uint32) | deleted
    return bm, post, rows, offs, lens, deleted, universe


def run_program(sig, leaves, universe):
    """The postfix program of ``ast_program`` run as the kernel runs it,
    over host words."""
    ops, need = T.ast_program(sig)
    stack = []
    for op in ops:
        if op >= 0:
            stack.append(leaves[op])
        elif op == T.AST_NOT:
            stack.append(universe & ~stack.pop())
        else:
            y, x = stack.pop(), stack.pop()
            stack.append(x & y if op == T.AST_AND else x | y)
        assert len(stack) <= need
    assert len(stack) == 1
    return stack[0]


@pytest.mark.parametrize("S", [0, 2])
@pytest.mark.parametrize("tree", list(TREES))
def test_ast_words_entry_matches_jax(tree, S):
    sig = TREES[tree]
    bm, post, rows, offs, lens, deleted, universe = tree_inputs(31 + S, S)
    Tn, K = rows.shape
    bucket = int(max(lens.max(initial=1), 1))
    # the JAX package pads S to at least one slot (a padding slot is the
    # AND identity); the port takes S = 0 as it is
    jo, jl = ((offs, lens) if S else (np.zeros((Tn, 1), np.int64),) * 2)
    want = np.asarray(JD._ast_words_program(sig, K, max(S, 1), bucket, W)(
        jnp.asarray(bm), jpost(post), jnp.asarray(deleted),
        jnp.asarray(universe), jnp.asarray(rows),
        jnp.asarray(jo.astype(np.int32)), jnp.asarray(jl.astype(np.int32))))
    runtime.reset_launches()
    got = u32(T.ast_words(sig, i32(bm), torch.from_numpy(post), i32(deleted),
                          i32(universe), rows, offs, lens, bucket=bucket,
                          n_words=W))
    assert np.array_equal(got, want)
    assert runtime.launches["ast_words"] == 0  # the CPU runs the plain one
    assert not (got & deleted).any()
    assert got.any() or tree == "zeros_leaf"
    # the postfix program the kernel runs gives the same words
    leaves = u32(T._term_bitmaps(i32(bm), torch.from_numpy(rows),
                                 torch.from_numpy(post),
                                 torch.from_numpy(offs),
                                 torch.from_numpy(lens), i32(deleted),
                                 bucket=bucket, n_words=W))
    assert np.array_equal(run_program(sig, leaves, universe) & ~deleted,
                          want)


def test_ast_program_stack_stays_within_the_depth():
    for sig in TREES.values():
        ops, need = T.ast_program(sig)
        assert need <= tree_depth(sig) + 1
        assert sum(op >= 0 for op in ops) == str(sig).count("'t'")
    assert T.ast_program(("t", 7)) == ([7], 1)
    assert T.ast_program(("!", ("&", ("t", 0), ("t", 1), ("t", 2)))) == (
        [0, 1, T.AST_AND, 2, T.AST_AND, T.AST_NOT], 2)
    assert tree_depth(TREES["deep"]) == MAX_DEPTH


@pytest.mark.parametrize("with_real", [False, True])
def test_ast_words_entry_keeps_real(with_real):
    """A leaf's ``real`` slots: an empty slice of a real term gives zeros,
    as the JAX package's ``term_bitmap`` has it."""
    K, S = 4, 3
    bm, rows, post, offs, lens, deleted, real = term_inputs(17, K, S,
                                                            with_real)
    want = np.asarray(J.term_bitmap(
        jnp.asarray(bm), jnp.asarray(rows), jpost(post),
        jnp.asarray(offs.astype(np.int32)),
        jnp.asarray(lens.astype(np.int32)), jnp.asarray(deleted),
        K=K, S=S, bucket=4096, n_words=W,
        real=None if real is None else jnp.asarray(real)))
    got = u32(T.ast_words(("t", 0), i32(bm), torch.from_numpy(post),
                          i32(deleted), i32(np.zeros(W, np.uint32)),
                          rows[None], offs[None], lens[None], bucket=4096,
                          n_words=W, real=None if real is None
                          else real[None]))
    assert np.array_equal(got, want)
    assert got.any() != with_real
