"""Shared set-up of the PyTorch-port parity tests (tests/test_torch_*.py).

Both packages get the same inputs, made from a numpy seed; JAX runs on the
CPU (Pallas kernels in interpret mode) and the port on the CPU through its
kernels' plain versions, selected by ``MYGRAM_TORCH_DEVICE=cpu``, which
the ``torch_cpu`` fixture sets. Every comparison is exact: the work is
integer.
"""

import numpy as np
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def torch_cpu():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MYGRAM_TORCH_DEVICE", "cpu")
        yield


def require_cuda():
    """Skip the calling test where there is no CUDA device (decided when
    the test runs, never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel against its plain version)")


def u32(t) -> np.ndarray:
    """A torch int32 word tensor or a JAX uint32 array as numpy uint32."""
    if isinstance(t, torch.Tensor):
        return t.cpu().numpy().view(np.uint32)
    return np.asarray(t).view(np.uint32)


def i32(a) -> torch.Tensor:
    """numpy (uint32 or int) -> a CPU int32 tensor with the same bits."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.astype(np.int32, copy=True))


def build_corpus(n_docs: int, seed: int = 5, kanji_extra: int = 2):
    """BuiltIndex over the synthetic EN+JA corpus (host builder, shared by
    both packages)."""
    from mygramdb_tpu.index.builder import IndexBuilder
    from mygramdb_tpu.utils.corpusgen import CorpusGenerator
    gen = CorpusGenerator(n_docs, seed=seed, vocab_size=20_000)
    b = IndexBuilder(2, 1, True, kanji_extra_ngram=kanji_extra)
    for batch in gen.batches(1000):
        b.add_batch([(i, t.lower()) for i, t in batch])
    return b.finalize()


def random_queries(built, tdev, n, seed):
    """(tids, not_tids) mixing dense and sparse terms of nonzero df."""
    rng = np.random.default_rng(seed)
    live = np.flatnonzero(built.lengths > 0)
    dense = live[tdev.dense_row[live] >= 0]
    sparse = live[tdev.dense_row[live] < 0]
    common = sparse[built.lengths[sparse] > 20]
    out = []
    for i in range(n):
        shape = i % 5
        if shape == 0:      # all dense
            tids = list(rng.choice(dense, int(rng.integers(1, 4))))
        elif shape == 1:    # sparse driver + dense probes
            tids = [rng.choice(common)] + list(rng.choice(dense, 2))
        elif shape == 2:    # sparse driver + sparse probes
            tids = list(rng.choice(common, 2)) + [rng.choice(sparse)]
        elif shape == 3:    # one sparse term (probe-free)
            tids = [rng.choice(common)]
        else:               # dense + NOT
            tids = [rng.choice(dense)]
        nots = (list(rng.choice(np.concatenate([dense, common]), 2))
                if shape in (1, 4) else [])
        out.append(([int(t) for t in tids], [int(t) for t in nots]))
    return out


def sparse_probe_inputs(seed: int, B: int, C: int, Ks: int, Kd: int,
                        W: int = 2048, V: int = 24):
    """Random inputs of the sparse program, numpy, made to hit its edges:
    a CSR of sorted posting lists (drivers up to C entries, one longer
    than C; probe lists that share most of their driver's ids), a driver
    at offset P (a dense term's entry) and one running past P, NOT probes,
    zero-length inverted padding slots and one empty non-inverted slot,
    dense rows with NOT flags padded with the all-ones row V, two filter
    rows and tombstones among the candidates.

    -> dict: postings (P,) int32, bitmaps (V + 2, W) uint32, deleted (W,)
    uint32, extra (2, W) uint32, args (B, 2 + 3 Ks + 2 Kd) int64 (the
    ``pack_sparse_args`` layout), the seven columns (d_off, d_len, sp_off,
    sp_len, sp_inv, dn_rows, dn_inv), and Cmax."""
    rng = np.random.default_rng(seed)
    n_docs = W * 32
    lists = []
    q_driver, q_probes = [], []
    for b in range(B):
        dl = C if b % 5 == 1 else (C + 7 if b % 5 == 2 else
                                   int(rng.integers(1, C + 1)))
        dl = min(dl, n_docs // 2)
        drv = np.sort(rng.choice(n_docs, size=dl, replace=False))
        q_driver.append(len(lists))
        lists.append(drv)
        probes = []
        # query 0 fills every slot (32 slices: one whole group)
        for k in range(Ks if b == 0 else int(rng.integers(0, min(Ks, 6) + 1))):
            inv = k % 3 == 2  # a NOT term shares few of the driver's ids
            keep = drv[rng.random(dl) < (0.1 if inv else 0.9)]
            other = rng.choice(n_docs, replace=False, size=int(
                rng.integers(0, min(3 * C, 8192, n_docs // 2))))
            probes.append((len(lists), inv))
            lists.append(np.union1d(keep, other))
        q_probes.append(probes)
    lens = np.asarray([x.size for x in lists], dtype=np.int64)
    offs = np.zeros(len(lists), dtype=np.int64)
    np.cumsum(lens[:-1], out=offs[1:])
    postings = np.concatenate(lists).astype(np.int32)
    P = postings.size
    d_off = offs[q_driver].copy()
    d_len = lens[q_driver].copy()
    if B > 3:
        d_off[3], d_len[3] = P, 40          # a dense term's entry
    if B > 4:
        d_off[4], d_len[4] = P - 5, 60      # a driver running past P
    sp_off = np.zeros((B, Ks), dtype=np.int64)
    sp_len = np.zeros((B, Ks), dtype=np.int64)
    sp_inv = np.ones((B, Ks), dtype=bool)   # zero-length inverted padding
    for b, probes in enumerate(q_probes):
        for k, (li, inv) in enumerate(probes):
            sp_off[b, k], sp_len[b, k], sp_inv[b, k] = offs[li], lens[li], inv
    if B > 6:
        sp_inv[6, -1] = False               # an empty term: matches nothing
    dn_rows = np.full((B, Kd), V, dtype=np.int32)
    dn_inv = np.zeros((B, Kd), dtype=bool)
    for b in range(B):
        for k in range(int(rng.integers(0, min(Kd, 4) + 1))):
            dn_rows[b, k] = rng.integers(0, V)
            dn_inv[b, k] = k == 2
    bm = np.where(rng.random((V + 2, W * 32)) < 0.85, 1, 0).astype(np.uint8)
    bm = np.packbits(bm, axis=1, bitorder="little").view(np.uint32)
    bm[V] = 0xFFFFFFFF
    bm[V + 1] = 0
    deleted = np.zeros(W, dtype=np.uint32)
    gone = rng.choice(postings, size=max(P // 40, 1))
    np.bitwise_or.at(deleted, gone >> 5,
                     np.left_shift(np.uint32(1), (gone & 31).astype(np.uint32)))
    extra = np.where(rng.random((2, W * 32)) < 0.9, 1, 0).astype(np.uint8)
    extra = np.packbits(extra, axis=1, bitorder="little").view(np.uint32)
    cols = (d_off, d_len, sp_off, sp_len, sp_inv, dn_rows, dn_inv)
    Cmax = 1
    while Cmax < max(int(sp_len.max(initial=1)), 1):
        Cmax <<= 1
    args = np.concatenate([d_off[:, None], d_len[:, None], sp_off, sp_len,
                           sp_inv.astype(np.int64), dn_rows.astype(np.int64),
                           dn_inv.astype(np.int64)], axis=1)
    return {"postings": postings, "bitmaps": bm, "deleted": deleted,
            "extra": extra, "args": args, "cols": cols, "Cmax": Cmax,
            "ones_row": V}
