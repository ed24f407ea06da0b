"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Every test here carries the ``cuda`` marker and skips where
``torch.cuda.is_available()`` is false. The file imports no JAX (the
card's host has none), so it runs there on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from mygramdb_tpu_torch.ops import bitmap_ops, posting_ops, runtime
from mygramdb_tpu_torch.ops.errors import KernelError

from torch_parity import require_cuda

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
