"""Port parity for the sparse data plane: the CSR slice gather (K3) and the
probe stages around it.

The port's ``gather_slices`` (on the CPU its kernel's plain version, over a
CSR with no pad tail) against JAX ``_gather_slices_jnp`` and
``_gather_slices_pallas`` in interpret mode over the same CSR padded by
``pad_postings``; ``membership_sorted`` in JAX's small, blocked and chunked
regimes; ``bitmap_membership`` and ``mask_to_topn``.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from mygramdb_tpu.ops import posting_ops as J
from mygramdb_tpu_torch.ops import posting_ops as T

from torch_parity import i32, torch_cpu, u32  # noqa: F401

SENT = 2 ** 31 - 1


def make_csr(rng, n_terms=40, max_len=3000, hi=200_000):
    lens = rng.integers(0, max_len, size=n_terms)
    lens[::9] = 0
    post = np.concatenate([np.sort(rng.choice(hi, size=int(n), replace=False))
                           for n in lens]).astype(np.int32)
    offs = np.zeros(n_terms, np.int64)
    np.cumsum(lens[:-1], out=offs[1:])
    return post, offs, lens.astype(np.int64)


def slice_requests(rng, post, offs, lens):
    """Real slices, zero lengths, an offset equal to P with a length (a
    dense term's entry) and a slice that ends exactly at P."""
    P = post.size
    o = list(offs[:12]) + [P, P, P - 5, 0]
    n = list(lens[:12]) + [0, 4000, 5, 0]
    return np.asarray(o, np.int64), np.asarray(n, np.int64)


@pytest.mark.parametrize("bucket", [256, 2048])
def test_gather_slices_matches_jax(bucket):
    rng = np.random.default_rng(bucket)
    post, offs, lens = make_csr(rng)
    o, n = slice_requests(rng, post, offs, lens)
    padded = jnp.asarray(J.pad_postings(post))
    got = T.gather_slices(torch.from_numpy(post), torch.from_numpy(o),
                          torch.from_numpy(n), bucket).numpy()
    o32, n32 = jnp.asarray(o.astype(np.int32)), jnp.asarray(n.astype(np.int32))
    want = np.asarray(J._gather_slices_jnp(padded, o32, n32, bucket))
    assert np.array_equal(got, want)
    want_p = np.asarray(J._gather_slices_pallas(padded, o32, n32, bucket,
                                                interpret=True))
    assert np.array_equal(got, want_p)
    assert (got[-4:-2] == SENT).all()  # offset == P reads sentinels only


def _rows(rng, k, c2, hi):
    rows = np.full((k, c2), SENT, dtype=np.int32)
    for i, f in enumerate(rng.integers(0, c2 + 1, size=k)):
        vals = np.unique(rng.integers(0, hi, size=max(int(f), 1)))
        rows[i, :vals.size] = vals
    return rows


@pytest.mark.parametrize("c2,C", [(64, 128), (4096, 2048), (4096, 3072),
                                  (4160, 8192), (128, 4096)])
def test_membership_sorted_matches_jax(c2, C):
    # JAX regimes: searchsorted (c2 <= 128 or not a multiple of 128),
    # blocked (C <= 2048) and blocked-chunked (C > 2048)
    rng = np.random.default_rng(c2 * 7 + C)
    hi = 3 * max(c2, C)
    rows = _rows(rng, 5, c2, hi)
    cands = np.sort(rng.choice(hi, size=C, replace=False)).astype(np.int32)
    cands[-3:] = SENT
    got = T.membership_sorted(torch.from_numpy(rows),
                              torch.from_numpy(cands)).numpy()
    want = np.asarray(J.membership_sorted(jnp.asarray(rows),
                                          jnp.asarray(cands)))
    assert np.array_equal(got[:, :-3], want[:, :-3])
    expect = np.stack([np.isin(cands[:-3], r) for r in rows])
    assert np.array_equal(got[:, :-3], expect)


def test_bitmap_membership_matches_jax():
    rng = np.random.default_rng(1)
    bm = rng.integers(0, 2 ** 32, size=(6, 128), dtype=np.uint32)
    rows = np.asarray([0, 3, 5, 5], np.int32)
    cands = rng.integers(0, 128 * 32, size=300).astype(np.int32)
    got = T.bitmap_membership(i32(bm), torch.from_numpy(rows),
                              torch.from_numpy(cands)).numpy()
    want = np.asarray(J.bitmap_membership(jnp.asarray(bm), jnp.asarray(rows),
                                          jnp.asarray(cands)))
    assert np.array_equal(got, want)
    # one row per lane (the batched sparse path's form)
    lanes = T.bitmap_membership(i32(bm), torch.from_numpy(rows),
                                torch.from_numpy(np.stack([cands] * 4)))
    assert np.array_equal(lanes.numpy(), want)


@pytest.mark.parametrize("n", [1, 64, 700])
@pytest.mark.parametrize("descending", [True, False])
def test_mask_to_topn_matches_jax(n, descending):
    rng = np.random.default_rng(n)
    C = 512
    cands = np.full(C, SENT, np.int32)
    vals = np.sort(rng.choice(100_000, size=400, replace=False))
    cands[:400] = vals
    mask = rng.random(C) < 0.3
    cj, ij = J.mask_to_topn(jnp.asarray(cands), jnp.asarray(mask), n,
                            descending)
    ct, it = T.mask_to_topn(torch.from_numpy(cands), torch.from_numpy(mask),
                            n, descending)
    assert int(ct) == int(cj)
    assert np.array_equal(it.numpy(), np.asarray(ij))
    # batched form: each row as the 1-D call
    cb, ib = T.mask_to_topn(torch.from_numpy(np.stack([cands, cands])),
                            torch.from_numpy(np.stack([mask, ~mask])), n,
                            descending)
    assert np.array_equal(ib[0].numpy(), np.asarray(ij))
    cj2, ij2 = J.mask_to_topn(jnp.asarray(cands), jnp.asarray(~mask), n,
                              descending)
    assert int(cb[1]) == int(cj2) and np.array_equal(ib[1].numpy(),
                                                     np.asarray(ij2))


def test_u32_helper_roundtrip():
    a = np.asarray([0, 1, 0xFFFFFFFF, 0x80000000], np.uint32)
    assert np.array_equal(u32(i32(a)), a)
