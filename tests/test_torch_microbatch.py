"""The port's micro-batcher: concurrent submissions share one device
program, and batched answers equal unbatched ones (the port's own and the
JAX package's)."""

import threading

import numpy as np
import pytest
import jax.numpy as jnp

from mygramdb_tpu.index import device_index as JD
from mygramdb_tpu_torch.index import device_index as TD
from mygramdb_tpu_torch.server import microbatch as TM

from torch_parity import (build_corpus, i32, random_queries,  # noqa: F401
                          torch_cpu)


@pytest.fixture(scope="module")
def indexes(torch_cpu):
    built = build_corpus(3000, seed=12)
    batched = TD.DeviceIndex(built, dense_df_ratio=0.05)
    batched.batcher = TM.MicroBatcher(batched, max_batch=16,
                                      window_us=20000)
    plain = TD.DeviceIndex(built, dense_df_ratio=0.05)
    jdev = JD.DeviceIndex(built, dense_df_ratio=0.05)
    return built, batched, plain, jdev


def run_concurrently(fn, n):
    out = [None] * n

    def worker(i):
        out[i] = fn(i)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    return out


@pytest.mark.parametrize("opts", [dict(limit=10), dict(limit=100,
                                                       descending=False),
                                  dict(count_only=True)],
                         ids=["limit10", "asc100", "count"])
def test_concurrent_batches_match_unbatched(indexes, opts):
    built, batched, plain, jdev = indexes
    qs = [(t, []) for t, n in random_queries(built, plain, 48, seed=21)]
    b = batched.batcher
    before = (b.batches_executed, b.queries_batched)
    got = run_concurrently(
        lambda i: batched.search_and(qs[i][0], [], None,
                                     TD.SearchOptions(**opts)), len(qs))
    n_batches = b.batches_executed - before[0]
    n_queries = b.queries_batched - before[1]
    assert 0 < n_batches < n_queries  # queries shared programs
    for (tids, _), (total, ids) in zip(qs, got):
        t_plain = plain.search_and(tids, [], None, TD.SearchOptions(**opts))
        t_jax = jdev.search_and(tids, [], None, JD.SearchOptions(**opts))
        assert total == t_plain[0] == t_jax[0], tids
        assert np.array_equal(ids, t_plain[1]) and \
            np.array_equal(ids, t_jax[1]), tids


def test_filter_rows_batch_by_identity(indexes):
    built, batched, plain, jdev = indexes
    rng = np.random.default_rng(4)
    word = rng.integers(0, 2 ** 32, size=batched.n_words, dtype=np.uint32)
    row = i32(word)  # one shared row object, as the filter cache hands out
    qs = [t for t, _ in random_queries(built, plain, 24, seed=8)]
    got = run_concurrently(
        lambda i: batched.search_and(qs[i], [], [row],
                                     TD.SearchOptions(limit=20)), len(qs))
    for tids, (total, ids) in zip(qs, got):
        want = jdev.search_and(tids, [], [jnp.asarray(word)],
                               JD.SearchOptions(limit=20))
        assert total == want[0] and np.array_equal(ids, want[1])


def test_probe_free_and_probed_sparse_queries_batch_apart(indexes):
    built, batched, plain, _ = indexes
    sparse = [t for t in np.flatnonzero(built.lengths > 20)
              if plain.dense_row[t] < 0][:12]
    qs = [[int(t)] for t in sparse] + [[int(a), int(b)] for a, b in
                                       zip(sparse[:6], sparse[6:12])]
    got = run_concurrently(
        lambda i: batched.search_and(qs[i], [], None,
                                     TD.SearchOptions(limit=10)), len(qs))
    for tids, (total, ids) in zip(qs, got):
        want = plain.search_and(tids, [], None, TD.SearchOptions(limit=10))
        assert total == want[0] and np.array_equal(ids, want[1])


def test_over_max_k_takes_unbatched_path(indexes):
    built, batched, plain, _ = indexes
    dense = [int(t) for t in np.flatnonzero(plain.dense_row >= 0)]
    tids = (dense * (TM.MAX_K // len(dense) + 2))[:TM.MAX_K + 3]
    total, ids = batched.search_and(tids, [], None,
                                    TD.SearchOptions(limit=10))
    want = plain.search_and(sorted(set(tids)), [], None,
                            TD.SearchOptions(limit=10))
    assert total == want[0] and np.array_equal(ids, want[1])
    with pytest.raises(ValueError):
        batched.batcher.submit(list(range(TM.MAX_K + 1)), 128, True)


def test_fused_programs_not_ported(indexes):
    _, batched, _, _ = indexes
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        batched.batcher._execute_fused_verify([], ())
