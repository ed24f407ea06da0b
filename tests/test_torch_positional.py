"""The positional engine of the port against the JAX package's.

One ``BuiltIndex`` with positions (``collect_positions=True``) is indexed by
both packages; JAX runs its XLA program on the CPU and the port its torch
program, whose CSR slice gathers take K3's plain version on the CPU. Ids,
counts and ``pre`` must be equal; BM25 scores within 1e-5 relative, in
the same order. The cases are every device case of
``tests/test_positional.py`` plus what it leaves out: dense grams with
``force_probes``, filter rows, ``require_match=False``, ascending pages,
the micro-batcher and its one dispatch a batch, the device layout and the
JAX helpers.
"""

import threading

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from mygramdb_tpu.index.builder import IndexBuilder
from mygramdb_tpu.index.device_index import DeviceIndex as JD
from mygramdb_tpu.ops import positional_ops as JP
from mygramdb_tpu.utils import textproc
from mygramdb_tpu_torch.convert import (positional_state_from_jax,
                                        state_from_jax)
from mygramdb_tpu_torch.index.device_index import DeviceIndex as TD
from mygramdb_tpu_torch.index.positional import DevicePositional
from mygramdb_tpu_torch.ops import positional_ops as TP
from mygramdb_tpu_torch.ops import runtime
from mygramdb_tpu_torch.server.microbatch import MicroBatcher

from test_positional import DOCS, QUERIES, build, norm
from torch_parity import i32, torch_cpu  # noqa: F401

FORMS = {
    "desc": dict(descending=True),
    "asc": dict(descending=False),
    "probes": dict(descending=True, force_probes=True),
    "score": dict(descending=True, score_mode=True, idf=1.3, k1=1.2,
                  b=0.75, avgdl=12.5),
    "nomatch": dict(descending=False, require_match=False),
}


def tid_offsets(built, term):
    """[(tid, offset)] of a covered term, None when uncovered, "missing"
    when a gram is not in the index."""
    pairs, covered = textproc.query_gram_offsets(term, 2, 1, True)
    if not covered or not pairs:
        return None
    out = []
    for g, off in pairs:
        tid = built.term_dict.get(g)
        if tid is None:
            return "missing"
        out.append((tid, off))
    return out


def doc_lengths(docs, capacity):
    dl = np.zeros(capacity, dtype=np.int32)
    for d, t in docs.items():
        dl[d] = len(norm(t))
    return dl


def assert_same(j, t, score=False):
    """(total, ids, scores, pre) of both packages: exact but the scores."""
    jt, jids, jsc, jpre = j
    tt, tids, tsc, tpre = t
    assert (int(jt), int(jpre)) == (tt, tpre)
    assert np.array_equal(np.asarray(jids), tids)
    if score:
        live = np.asarray(jids) >= 0
        np.testing.assert_allclose(tsc[live], np.asarray(jsc)[live],
                                   rtol=1e-5)


def both(jdev, tdev, plan_j, plan_t, limit=128, **kw):
    return (jdev.search_verified_positional(plan_j, limit, **kw),
            tdev.search_verified_positional(plan_t, limit, **kw))


@pytest.fixture(scope="module")
def small(torch_cpu):
    """DOCS, everything sparse (the JAX tests' index), in both packages
    and in the port again from the JAX index's state."""
    built = build()
    jdev = JD(built, dense_df_ratio=0.5)
    tdev = TD(built, dense_df_ratio=0.5)
    dl = doc_lengths(DOCS, tdev.n_docs_capacity)
    jdev.set_positional_doc_lengths(dl)
    tdev.set_positional_doc_lengths(dl)
    carried = TD.from_state(state_from_jax(jdev), built)
    return built, jdev, tdev, carried


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("term", QUERIES)
def test_queries_match_jax(small, term, form):
    built, jdev, tdev, carried = small
    words = norm(term).split()
    if len(words) != 1:
        words = [words[0]]  # single-term scope: the first word
    to = tid_offsets(built, words[0])
    if to in (None, "missing"):
        return
    pj, pt = jdev.plan_positional(to), tdev.plan_positional(to)
    assert (pj is None) == (pt is None)
    if pj is None:
        return
    j, t = both(jdev, tdev, pj, pt, **FORMS[form])
    assert_same(j, t, score=form == "score")
    # the index carried across from the JAX package answers the same
    assert_same(j, carried.search_verified_positional(pt, 128,
                                                      **FORMS[form]),
                score=form == "score")
    if FORMS[form].get("require_match", True):
        want = {d for d, x in DOCS.items() if words[0] in norm(x)}
        assert set(int(x) for x in t[1] if x >= 0) == want


def test_plans_match_jax(small):
    """Same buckets and arguments; int64 occurrence starts in place of the
    TPU's aligned rows; refused (None) for the same inputs."""
    built, jdev, tdev, _ = small
    for term in QUERIES + ["z", "東京タワー", "xyzzy"]:
        to = tid_offsets(built, norm(term).split()[0])
        if to in (None, "missing"):
            continue
        pj, pt = jdev.plan_positional(to), tdev.plan_positional(to)
        assert (pj is None) == (pt is None), term
        if pj is None:
            continue
        for k in ("d_off", "d_len", "d_olen", "p_off", "p_len", "p_olen",
                  "p_delta", "p_valid", "C", "Co", "C2", "Co2", "G"):
            assert pj[k] == pt[k], (term, k)
        pp = tdev.positional
        di = int(np.argmin([built.lengths[t] for t, _ in to]))
        assert pt["d_start"] == int(pp.occ_start[to[di][0]])
        assert pt["p_start"][:len(to) - 1] == [
            int(pp.occ_start[t]) for j, (t, _) in enumerate(to) if j != di]
    assert tdev.plan_positional([]) is None
    # an empty gram and an overflowing segment are refused as in JAX
    empty = int(np.flatnonzero(built.lengths == 0)[0]) \
        if (built.lengths == 0).any() else None
    if empty is not None:
        assert tdev.plan_positional([(empty, 0)]) is None
    to = tid_offsets(built, norm("日本"))
    tdev.positional.overflow.add(1)
    jdev.positional.overflow.add(1)
    try:
        assert tdev.plan_positional(to) is None
        assert jdev.plan_positional(to) is None
    finally:
        tdev.positional.overflow.discard(1)
        jdev.positional.overflow.discard(1)


def test_score_mode_tf_matches_all_positions_count(small):
    built, jdev, tdev, _ = small
    term = norm("日")
    to = tid_offsets(built, term)
    dl = doc_lengths(DOCS, tdev.n_docs_capacity)
    avg = float(dl[dl > 0].mean())
    kw = dict(descending=True, score_mode=True, idf=1.0, k1=1.2, b=0.75,
              avgdl=avg)
    j, t = both(jdev, tdev, jdev.plan_positional(to),
                tdev.plan_positional(to), **kw)
    assert_same(j, t, score=True)
    # BM25 over every start position, overlapping ones too
    tf = {}
    for d, x in DOCS.items():
        nx = norm(x)
        n = sum(1 for i in range(len(nx)) if nx.startswith(term, i))
        if n:
            tf[d] = n
    want = {d: c * 2.2 / (c + 1.2 * (1 - 0.75 + 0.75 * dl[d] / avg))
            for d, c in tf.items()}
    order = sorted(want, key=lambda d: (-want[d], -d))
    got = [int(x) for x in t[1] if x >= 0]
    assert got == order
    np.testing.assert_allclose(t[2][:len(got)], [want[d] for d in got],
                               rtol=1e-5)


def test_tombstones_exclude_deleted_docs(torch_cpu):
    built = build()
    jdev = JD(built, dense_df_ratio=0.5)
    tdev = TD(built, dense_df_ratio=0.5)
    term = norm("日本")
    to = tid_offsets(built, term)
    expected = {d for d, x in DOCS.items() if term in norm(x)}
    kill = sorted(expected)[0]
    jdev.mark_deleted([kill])
    tdev.mark_deleted([kill])
    for form in ("desc", "probes", "score"):
        j, t = both(jdev, tdev, jdev.plan_positional(to),
                    tdev.plan_positional(to), **FORMS[form])
        assert_same(j, t, score=form == "score")
        assert set(int(x) for x in t[1] if x >= 0) == expected - {kill}
        assert t[0] == len(expected) - 1


def fuzz_corpus():
    """test_positional's randomized corpus: mixed scripts, repeats, empty
    documents."""
    rng = np.random.default_rng(42)
    kanji = [chr(c) for c in range(0x65E5, 0x6605)]
    kana = [chr(c) for c in range(0x3042, 0x3062)]
    ascii_w = ["cat", "dog", "fox", "ox", "a", "zz"]

    def rand_doc():
        parts = []
        for _ in range(int(rng.integers(0, 12))):
            r = rng.random()
            if r < 0.4:
                parts.append("".join(rng.choice(kanji, size=int(
                    rng.integers(1, 4)))))
            elif r < 0.7:
                parts.append("".join(rng.choice(kana, size=int(
                    rng.integers(2, 5)))))
            else:
                parts.append(str(rng.choice(ascii_w)))
        return " ".join(parts)

    docs = {i: rand_doc() for i in range(1, 161)}
    queries = (["".join(rng.choice(kanji, size=2)) for _ in range(25)]
               + ["".join(rng.choice(kana, size=2)) for _ in range(10)]
               + ascii_w + [chr(0x65E5), chr(0x65E5) * 2])
    return docs, queries


@pytest.mark.parametrize("ratio", [0.9, 0.05], ids=["sparse", "dense"])
def test_fuzz_random_corpus_parity(torch_cpu, ratio):
    """The randomized corpus against JAX and brute-force substring
    containment; at ratio 0.05 most grams are dense, so the driver's and
    the probes' CSR slices (force_probes) are dense terms' slices."""
    docs, queries = fuzz_corpus()
    b = IndexBuilder(2, 1, True, collect_positions=True)
    b.add_batch([(d, norm(t)) for d, t in sorted(docs.items())])
    built = b.finalize()
    jdev = JD(built, dense_df_ratio=ratio)
    tdev = TD(built, dense_df_ratio=ratio)
    assert tdev.postings.numel() == built.postings.size  # uncompacted
    if ratio < 0.5:
        assert tdev.n_dense > 0
        dense = np.flatnonzero(tdev.dense_row >= 0)
        assert np.array_equal(tdev.dev_offsets[dense], built.offsets[dense])
    checked = 0
    for q in queries:
        nq = norm(q)
        to = tid_offsets(built, nq)
        expected = {d for d, t in docs.items() if nq in norm(t)}
        if to == "missing":
            assert not expected, q
            continue
        if to is None:
            continue
        pj, pt = jdev.plan_positional(to), tdev.plan_positional(to)
        assert (pj is None) == (pt is None)
        if pt is None:
            continue
        for form in ("asc", "probes"):
            j, t = both(jdev, tdev, pj, pt, limit=1024, **FORMS[form])
            assert_same(j, t)
            assert set(int(x) for x in t[1] if x >= 0) == expected, q
            assert t[0] == len(expected)
        checked += 1
    assert checked >= 25


def test_filter_rows_match_jax(small):
    built, jdev, tdev, _ = small
    rng = np.random.default_rng(3)
    words = rng.integers(0, 2 ** 32, size=(2, tdev.n_words),
                         dtype=np.uint32)
    for term in ("日本", "quick", "日", "東京"):
        to = tid_offsets(built, norm(term))
        pj, pt = jdev.plan_positional(to), tdev.plan_positional(to)
        for rows in (words[:1], words):
            for form in ("desc", "score", "probes"):
                j = jdev.search_verified_positional(
                    pj, 128, extra_words=[jnp.asarray(w) for w in rows],
                    **FORMS[form])
                t = tdev.search_verified_positional(
                    pt, 128, extra_words=[i32(w) for w in rows],
                    **FORMS[form])
                assert_same(j, t, score=form == "score")
                assert t[0] <= tdev.search_verified_positional(
                    pt, 128, **FORMS[form])[0]


def test_device_layout_matches_jax(small):
    """The port's own occ_doc build (repeat_interleave over the CSR) and
    occ_pos compaction equal the JAX package's aligned arrays carried
    across by ``positional_state_from_jax``, array for array; the layout
    is compact and int64-addressed."""
    built, jdev, tdev, carried = small
    mine = tdev.positional.state()
    theirs = positional_state_from_jax(jdev)
    for k in ("occ_doc", "occ_pos", "occ_len", "doc_len", "overflow"):
        assert np.array_equal(np.asarray(mine[k]), np.asarray(theirs[k])), k
    pp = tdev.positional
    O = int(built.positional.occ_len.sum())
    assert pp.occ_doc.shape == (O,) and pp.occ_pos.shape == (O,)
    assert pp.occ_doc.dtype == pp.occ_pos.dtype == torch.int32
    assert pp.occ_start.dtype == np.int64 and pp.occ_start[0] == 0
    assert np.array_equal(pp.occ_start[1:],
                          np.cumsum(built.positional.occ_len)[:-1])
    # host oracle: every posting's doc repeated its occurrence count
    assert np.array_equal(mine["occ_doc"], np.repeat(
        built.postings, built.positional.occ_cnt.astype(np.int64)))
    assert pp.memory_usage() == 4 * (2 * O + tdev.n_docs_capacity)
    assert "occ_doc_dev_s" in pp.upload_detail
    assert carried.positional.memory_usage() == pp.memory_usage()
    # per term, the compact slice is term_occurrences' positions
    for tid in range(0, built.n_terms, 7):
        occ = built.positional.term_occurrences(
            tid, built.offsets, built.lengths, built.postings)
        s, n = int(pp.occ_start[tid]), int(pp.occ_len[tid])
        assert np.array_equal(mine["occ_pos"][s:s + n],
                              np.concatenate([p for _, p in occ])
                              if occ else np.zeros(0, np.int32))
    # DevicePositional needs the full CSR it parallels
    with pytest.raises(ValueError):
        DevicePositional(built.positional, tdev.n_docs_capacity,
                         postings=built.postings[:-1])


def test_microbatcher_batches_mixed_plans(torch_cpu):
    """Concurrent plans of mixed shapes and forms through the batcher's
    "pos" program equal the same plans run one by one and the JAX
    package's; each batch is one dispatch."""
    docs, queries = fuzz_corpus()
    b = IndexBuilder(2, 1, True, collect_positions=True)
    b.add_batch([(d, norm(t)) for d, t in sorted(docs.items())])
    built = b.finalize()
    jdev = JD(built, dense_df_ratio=0.2)
    plain = TD(built, dense_df_ratio=0.2)
    batched = TD(built, dense_df_ratio=0.2)
    batched.batcher = MicroBatcher(batched, max_batch=64, window_us=50000)
    dl = doc_lengths(docs, plain.n_docs_capacity)
    for d in (jdev, plain, batched):
        d.set_positional_doc_lengths(dl)
    jobs = []
    for i, q in enumerate(queries):
        to = tid_offsets(built, norm(q))
        if to in (None, "missing"):
            continue
        pj, pt = jdev.plan_positional(to), plain.plan_positional(to)
        if pt is None:
            continue
        form = sorted(FORMS)[i % len(FORMS)]
        jobs.append((pj, pt, form))
    assert len(jobs) >= 20
    out = [None] * len(jobs)
    before = (runtime.dispatches.count, batched.batcher.batches_executed)

    def worker(i):
        pt, form = jobs[i][1], jobs[i][2]
        out[i] = batched.search_verified_positional(pt, 64, **FORMS[form])

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(jobs))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(60)
        assert not th.is_alive()
    batches = batched.batcher.batches_executed - before[1]
    assert runtime.dispatches.count - before[0] == batches
    assert batches < len(jobs)  # peers shared programs
    for (pj, pt, form), got in zip(jobs, out):
        one = plain.search_verified_positional(pt, 64, **FORMS[form])
        assert_same(one, got, score=form == "score")
        j = jdev.search_verified_positional(pj, 64, **FORMS[form])
        assert_same(j, got, score=form == "score")


def test_one_dispatch_a_search(small):
    built, _, tdev, _ = small
    pt = tdev.plan_positional(tid_offsets(built, norm("日本")))
    for form in FORMS.values():
        before = runtime.dispatches.count
        tdev.search_verified_positional(pt, 128, **form)
        assert runtime.dispatches.count - before == 1


def test_cpu_program_launches_no_kernel(small):
    """On CPU tensors the four occurrence gathers take K3's plain version:
    no launch and no launch form is counted."""
    built, _, tdev, _ = small
    runtime.reset_launches()
    pt = tdev.plan_positional(tid_offsets(built, norm("日本")))
    tdev.search_verified_positional(pt, 128, True, force_probes=True)
    assert runtime.launches["slice_gather"] == 0
    assert runtime.launch_forms["slice_gather.positional"] == 0


# ---------------------------------------------------------------------------
# The JAX package's helpers, as plain torch functions
# ---------------------------------------------------------------------------

def test_u16_gathers_match_jax():
    rng = np.random.default_rng(11)
    arr = rng.integers(0, 65535, size=4096 + JP.OCC_GATHER_PAD,
                       dtype=np.uint16)
    offs = rng.integers(0, 4000, size=9).astype(np.int32)
    lens = rng.integers(0, 96, size=9).astype(np.int32)
    want = np.asarray(JP.gather_slices_u16(jnp.asarray(arr),
                                           jnp.asarray(offs),
                                           jnp.asarray(lens), 128, fill=7))
    for t in (torch.from_numpy(arr), torch.from_numpy(arr.view(np.int16)),
              torch.from_numpy(arr.astype(np.int32))):
        got = TP.gather_slices_u16(t, torch.from_numpy(offs.astype(np.int64)),
                                   torch.from_numpy(lens.astype(np.int64)),
                                   128, fill=7)
        assert np.array_equal(got.numpy(), want)
    arr8 = arr[:arr.size // 128 * 128].reshape(-1, 128)
    base8 = rng.integers(0, 20, size=5).astype(np.int32)
    lens8 = rng.integers(0, 300, size=5).astype(np.int32)
    want = np.asarray(JP.gather_rows_u16(jnp.asarray(arr8),
                                         jnp.asarray(base8),
                                         jnp.asarray(lens8), 384))
    got = TP.gather_rows_u16(torch.from_numpy(arr8.view(np.int16)),
                             torch.from_numpy(base8), torch.from_numpy(lens8),
                             384)
    assert np.array_equal(got.numpy(), want)


def test_rank_take_and_cumsum_match_jax():
    rng = np.random.default_rng(12)
    vals = np.sort(rng.integers(0, 10_000, size=640)).astype(np.int32)
    q = rng.integers(-5, 10_100, size=777).astype(np.int32)
    assert np.array_equal(
        TP.blocked_rank_le(torch.from_numpy(vals), torch.from_numpy(q)
                           ).numpy(),
        np.asarray(JP.blocked_rank_le(jnp.asarray(vals), jnp.asarray(q))))
    idx = rng.integers(-3, 700, size=500).astype(np.int32)
    assert np.array_equal(
        TP.blocked_take(torch.from_numpy(vals), torch.from_numpy(idx)
                        ).numpy(),
        np.asarray(JP.blocked_take(jnp.asarray(vals), jnp.asarray(idx))))
    v = rng.integers(0, 4, size=1000).astype(np.int32)
    st = rng.random(1000) < 0.1
    st[0] = False  # a run before the first start
    assert np.array_equal(
        TP.segmented_cumsum(torch.from_numpy(v), torch.from_numpy(st)
                            ).numpy(),
        np.asarray(JP.segmented_cumsum(jnp.asarray(v), jnp.asarray(st))))


@pytest.mark.parametrize("n_pairs", [128 * 3, 128 * 256])
def test_membership_pairs_matches_jax(n_pairs):
    """Flat and hierarchical JAX ranks (256+ blocks) against one search
    over int64 pair keys."""
    rng = np.random.default_rng(n_pairs)
    real = n_pairs - 100
    keys = np.unique(rng.integers(0, 2 ** 40, size=real * 2))[:real]
    doc = (keys >> 16).astype(np.int32)
    pos = (keys & 0xFFFF).astype(np.int32)
    pdoc = np.concatenate([doc, np.full(n_pairs - doc.size, 2 ** 31 - 1,
                                        np.int32)])
    ppos = np.concatenate([pos, np.full(n_pairs - pos.size, -1, np.int32)])
    pick = rng.integers(0, doc.size, size=3000)
    qd = np.concatenate([doc[pick], rng.integers(0, 2 ** 24, 1000)]
                        ).astype(np.int32)
    qp = np.concatenate([pos[pick], rng.integers(-1, 70000, 1000)]
                        ).astype(np.int32)
    want = np.asarray(JP.membership_pairs(*map(jnp.asarray,
                                               (pdoc, ppos, qd, qp))))
    got = TP.membership_pairs(*map(torch.from_numpy, (pdoc, ppos, qd, qp)))
    assert np.array_equal(got.numpy(), want)
    assert want[:3000].all()
