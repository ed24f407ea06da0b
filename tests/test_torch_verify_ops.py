"""The port's verify ops against the JAX package's, on the CPU.

The window-TF kernel family (K4 flat rows, K5 packed live prefix, K6
padded rows) runs here through its plain PyTorch version and must equal
the JAX Pallas kernels run in interpret mode, exactly, on u16 and u32
packs: the cases of ``test_pallas_group_edges.py`` (every sublane of the
padded group, rows across 1024-cell groups, no bleed into the next
document, the ``use_range`` tail) and random rows. The non-overlapping
mode equals ``tf_matrix_nonoverlap``; the XLA-path functions
(``substring_*``, ``count_occurrences_device``, ``bm25_topk_device``)
equal JAX's on the same pack, ids exact and scores within 1e-5 relative
(float32 sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mygramdb_tpu.ops import verify_ops as J
from mygramdb_tpu.storage import device_text as jdt
from mygramdb_tpu_torch.convert import text_state_from_jax
from mygramdb_tpu_torch.ops import verify_ops as T
from mygramdb_tpu_torch.storage.device_text import DeviceTextStore

from torch_parity import torch_cpu  # noqa: F401

R = J._TF_ROWS
WORDS = ["alpha", "beta", "gamma", "quick", "aa", "aaa", "fox",
         "検索", "日本語", "エンジン", "高速", "検索検索"]


def texts_of(seed, n=256):
    rng = np.random.default_rng(seed)
    return {i: "".join(rng.choice(WORDS, size=int(rng.integers(2, 12))))
            for i in range(1, n + 1)}


def jax_store(texts, flat: bool, monkeypatch):
    if flat:
        monkeypatch.setattr(jdt, "_PADDED_BUDGET_BYTES", 0)
    st = jdt.DeviceTextStore(texts, capacity=512)
    assert (st.codepoints.ndim == 1) == flat
    return st


def port_store(jst):
    return DeviceTextStore.from_state(text_state_from_jax(jst),
                                      device="cpu")


def needle_sets(terms_per_query, Nn):
    B = len(terms_per_query)
    ndl = np.zeros((B, Nn, J.NEEDLE_CAP), dtype=np.uint32)
    nlens = np.zeros((B, Nn), dtype=np.int32)
    for b, ts in enumerate(terms_per_query):
        n, ln = jdt.DeviceTextStore._pack_needles(ts)
        ndl[b, :n.shape[0]] = n
        nlens[b, :ln.shape[0]] = ln
    return ndl, nlens


def t64(a):
    return torch.from_numpy(np.asarray(a, dtype=np.int64))


def t32(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))


def cells_of(a: np.ndarray) -> torch.Tensor:
    """u16/u32 numpy cells -> the port's int16/int32 tensor."""
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int16 if a.dtype == np.uint16
                                   else np.int32).copy())


def port_flat(cp: np.ndarray, offs, lens, ndl, nlens, *, Kv, cap, win,
              use_range, nonoverlap=False):
    dt = np.uint16 if cp.dtype == np.uint16 else np.uint32
    return T.tf_rows_flat(cells_of(cp), t64(offs), t32(lens),
                          t32(T.cast_needles_i32(ndl, dt, cap)),
                          t32(nlens), Kv=Kv, cap=cap, win=win,
                          use_range=use_range,
                          nonoverlap=nonoverlap).numpy()


def jax_flat(cp: np.ndarray, offs, lens, ndl, nlens, *, Kv, cap, win,
             use_range):
    """The JAX K4 over a pack that it pads itself (1024-multiple with the
    FLAT_GATHER_PAD sentinel tail)."""
    sent = 0xFFFF if cp.dtype == np.uint16 else 0xFFFFFFFF
    tail = jdt.FLAT_GATHER_PAD + (-(cp.size + jdt.FLAT_GATHER_PAD) % 1024)
    full = np.concatenate([cp, np.full(tail, sent, dtype=cp.dtype)])
    offs = np.asarray(offs, dtype=np.int64)
    return np.asarray(J.tf_rows_flat_pallas(
        jnp.asarray(full), jnp.asarray((offs >> 10).astype(np.int32)),
        jnp.asarray((offs & 1023).astype(np.int32)),
        jnp.asarray(np.asarray(lens, dtype=np.int32)),
        J.cast_needles_i32(jnp.asarray(ndl), full.dtype, cap),
        jnp.asarray(nlens), Kv=Kv, Nn=ndl.shape[1], cap=cap, win=win,
        use_range=use_range, interpret=True))


# ---------------------------------------------------------------------------
# K6: padded rows
# ---------------------------------------------------------------------------

def test_padded_every_sublane_and_last_row():
    """Row i holds the marker [100+i, 200]: only the probed row matches,
    whatever its place in the JAX kernel's 8-row group."""
    N, rowT, cap = 32, 256, 4
    padded = np.full((N, rowT), 0xFFFF, dtype=np.uint16)
    padded[:, 0] = 100 + np.arange(N)
    padded[:, 1] = 200
    ids = np.asarray([0, 1, 2, 3, 4, 5, 6, 7, 8, 15, 16, 23, 24, 30, 31,
                      N - 1], dtype=np.int32)
    for probe in range(ids.size):
        ndl, nlens = np.zeros((1, 1, J.NEEDLE_CAP), np.uint32), \
            np.asarray([[2]], np.int32)
        ndl[0, 0, :2] = [100 + int(ids[probe]), 200]
        want = np.asarray(J.tf_rows_pallas(
            jnp.asarray(padded), jnp.asarray(ids),
            J.cast_needles_i32(jnp.asarray(ndl), jnp.uint16, cap),
            jnp.asarray(nlens), Kv=R, Nn=1, cap=cap, use_range=False,
            interpret=True))
        got = T.tf_rows_padded(
            cells_of(padded), t64(ids), t32(np.full(ids.size, 2)),
            t32(T.cast_needles_i32(ndl, np.uint16, cap)), t32(nlens),
            Kv=R, cap=cap, width=rowT, use_range=False).numpy()
        assert np.array_equal(got, want)
        assert np.array_equal(got[:, 0], (ids == ids[probe]).astype(int))


@pytest.mark.parametrize("use_range", [True, False])
@pytest.mark.parametrize("width", [0, 128])
def test_padded_rows_equal_jax(monkeypatch, use_range, width):
    texts = texts_of(77)
    jst = jax_store(texts, False, monkeypatch)
    pst = port_store(jst)
    rng = np.random.default_rng(3)
    B, Kv, cap = 3, 2 * R, T.needle_cap_bucket(4)
    ndl, nlens = needle_sets([["検索", "alpha"], ["quick", "高速"],
                              ["日本語"]], 2)
    short = [d for d, t in texts.items() if len(t) <= 128 - cap]
    pool = np.asarray(short if width else list(texts), dtype=np.int32)
    ids = rng.choice(pool, B * Kv).astype(np.int32)
    W = width or jst.codepoints.shape[1]
    want = np.asarray(J.tf_rows_pallas(
        jst.codepoints, jnp.asarray(ids),
        J.cast_needles_i32(jnp.asarray(ndl), jnp.uint16, cap),
        jnp.asarray(nlens), Kv=Kv, Nn=2, cap=cap, use_range=use_range,
        width=W, interpret=True))
    # the port's rows are maxT + NEEDLE_CAP wide: read the same prefix,
    # or the whole row where JAX reads its 128-rounded whole row
    Wp = min(W, pst.codepoints.shape[1])
    got = T.tf_rows_padded(
        pst.codepoints, t64(ids), t32(pst.lengths_host[ids]),
        t32(T.cast_needles_i32(ndl, np.uint16, cap)), t32(nlens), Kv=Kv,
        cap=cap, width=Wp, use_range=use_range).numpy()
    assert np.array_equal(got, want)
    assert got[:, :2].sum() > 0


def test_padded_u32_rows_equal_jax():
    """u32 matrix: the 0xFFFFFFFF sentinel is -1 in the compare domain and
    never matches; non-BMP code points compare exactly."""
    rng = np.random.default_rng(5)
    N, rowT, cap = 64, 256, 4
    padded = rng.integers(0x10000, 0x10004, size=(N, rowT), dtype=np.uint32)
    lens = rng.integers(1, rowT - J.NEEDLE_CAP, size=N).astype(np.int32)
    for i in range(N):
        padded[i, lens[i]:] = 0xFFFFFFFF
    ids = rng.integers(0, N, size=2 * R).astype(np.int32)
    ndl = np.zeros((1, 2, J.NEEDLE_CAP), dtype=np.uint32)
    ndl[0, 0, :2] = padded[ids[0], :2]
    ndl[0, 1, :3] = padded[ids[1], 5:8]
    nlens = np.asarray([[2, 3]], dtype=np.int32)
    for use_range in (True, False):
        want = np.asarray(J.tf_rows_pallas(
            jnp.asarray(padded), jnp.asarray(ids),
            J.cast_needles_i32(jnp.asarray(ndl), jnp.uint32, cap),
            jnp.asarray(nlens), Kv=2 * R, Nn=2, cap=cap,
            use_range=use_range, interpret=True))
        got = T.tf_rows_padded(
            cells_of(padded), t64(ids), t32(lens[ids]),
            t32(T.cast_needles_i32(ndl, np.uint32, cap)), t32(nlens),
            Kv=2 * R, cap=cap, width=rowT, use_range=use_range).numpy()
        assert np.array_equal(got, want)
        assert got[:, :2].sum() > 0


# ---------------------------------------------------------------------------
# K4: flat rows
# ---------------------------------------------------------------------------

def test_flat_cross_group_boundary():
    """Documents across 1024-cell group boundaries, at the last cell of a
    group and at the pack start."""
    win, cap = 128, 4
    docs = [(1000, 60), (2047, 10), (0, 5)]
    flat = np.full(8192, 0xFFFF, dtype=np.uint16)
    for off, ln in docs:
        flat[off:off + ln] = [7 if k % 2 == 0 else 9 for k in range(ln)]
    offs = np.zeros(R, dtype=np.int64)
    lens = np.zeros(R, dtype=np.int32)
    for lane, (o, ln) in enumerate(docs):
        offs[lane], lens[lane] = o, ln
    ndl = np.zeros((1, 1, J.NEEDLE_CAP), dtype=np.uint32)
    ndl[0, 0, :2] = [7, 9]
    nlens = np.asarray([[2]], dtype=np.int32)
    kw = dict(Kv=R, cap=cap, win=win, use_range=False)
    got = port_flat(flat, offs, lens, ndl, nlens, **kw)
    assert np.array_equal(got, jax_flat(flat, offs, lens, ndl, nlens, **kw))
    for lane, (_, ln) in enumerate(docs):
        assert got[lane, 0] == ln // 2 and got[lane, 1] == ln
    assert not got[len(docs):].any()


def test_flat_no_cross_doc_bleed():
    """A needle made of the end of document A and the start of B, adjacent
    in the pack, matches neither."""
    win, cap = 128, 4
    flat = np.full(4096, 0xFFFF, dtype=np.uint16)
    flat[100:104] = [11, 12, 13, 14]
    offs = np.zeros(R, dtype=np.int64)
    lens = np.zeros(R, dtype=np.int32)
    offs[:2], lens[:2] = [100, 102], [2, 2]
    ndl = np.zeros((1, 2, J.NEEDLE_CAP), dtype=np.uint32)
    ndl[0, 0, :2] = [12, 13]
    ndl[0, 1, :2] = [11, 12]
    nlens = np.asarray([[2, 2]], dtype=np.int32)
    kw = dict(Kv=R, cap=cap, win=win, use_range=False)
    got = port_flat(flat, offs, lens, ndl, nlens, **kw)
    assert np.array_equal(got, jax_flat(flat, offs, lens, ndl, nlens, **kw))
    assert got[0, 0] == 0 and got[1, 0] == 0
    assert got[0, 1] == 1 and got[1, 1] == 0


@pytest.mark.parametrize("use_range", [True, False])
def test_flat_use_range_tail(use_range):
    """A needle at the start of a document whose prefix reappears at its
    very end counts once: the tail cannot complete."""
    win, cap = 128, 4
    flat = np.full(4096, 0xFFFF, dtype=np.uint16)
    flat[511:517] = [5, 6, 1, 2, 5, 6]
    offs = np.zeros(R, dtype=np.int64)
    lens = np.zeros(R, dtype=np.int32)
    offs[0], lens[0] = 511, 6
    ndl = np.zeros((1, 1, J.NEEDLE_CAP), dtype=np.uint32)
    ndl[0, 0, :3] = [5, 6, 1]
    nlens = np.asarray([[3]], dtype=np.int32)
    kw = dict(Kv=R, cap=cap, win=win, use_range=use_range)
    got = port_flat(flat, offs, lens, ndl, nlens, **kw)
    assert np.array_equal(got, jax_flat(flat, offs, lens, ndl, nlens, **kw))
    assert got[0, 0] == 1 and got[0, 1] == 6


@pytest.mark.parametrize("u32", [False, True])
@pytest.mark.parametrize("use_range", [True, False])
def test_flat_rows_equal_jax(u32, use_range):
    """Random packs over a small alphabet, cap 4 and 32, a needle that
    clamps to the u16 sentinel (with the range mask, as the callers set
    it: without it such a needle matches the sentinel fill, and the port's
    dead rows are zero where the JAX kernels count that fill), empty
    needles and dead rows."""
    rng = np.random.default_rng(11 + u32)
    maxT = 200
    flat, starts, lens = random_pack(rng, u32, maxT=maxT)
    N = lens.size
    for cap, Nn in ((4, 2), (32, 4)):
        B, Kv = 2, 2 * R
        ndl = np.zeros((B, Nn, J.NEEDLE_CAP), dtype=np.uint32)
        nlens = np.zeros((B, Nn), dtype=np.int32)
        for b in range(B):
            for j in range(Nn - 1):  # the last needle stays empty
                L = int(rng.integers(1, min(cap, 6) + 1))
                d = int(rng.choice(np.flatnonzero(lens >= L)))
                ndl[b, j, :L] = flat[starts[d]:starts[d] + L]
                nlens[b, j] = L
        if use_range:  # callers keep the range mask on for such needles
            ndl[0, 0, 0] = 0x1F601  # clamps to 0xFFFF in a u16 pack
        ids = rng.integers(0, N, B * Kv)
        row_lens = np.where(rng.random(B * Kv) < 0.8, lens[ids], 0)
        kw = dict(Kv=Kv, cap=cap, win=maxT, use_range=use_range)
        got = port_flat(flat, starts[ids], row_lens, ndl, nlens, **kw)
        want = jax_flat(flat, starts[ids], row_lens, ndl, nlens, **kw)
        assert np.array_equal(got, want), (cap, Nn)
        assert got[:, :Nn].sum() > 0


# ---------------------------------------------------------------------------
# K5: rows packed across the batch, live prefix
# ---------------------------------------------------------------------------

def random_pack(rng, u32: bool, N=120, maxT=200):
    """A pack over a small alphabet (non-BMP code points in a u32 pack)
    -> (cells, starts int64, lengths int32)."""
    lens = rng.integers(0, maxT + 1, N).astype(np.int32)
    alphabet = np.asarray([0x4E00, 0x61, 0x62] + ([0x1F600] if u32 else []))
    flat = alphabet[rng.integers(0, alphabet.size, int(lens.sum()))]
    starts = np.zeros(N, dtype=np.int64)
    np.cumsum(lens[:-1], out=starts[1:])
    return flat.astype(np.uint32 if u32 else np.uint16), starts, lens


@pytest.mark.parametrize("u32", [False, True])
@pytest.mark.parametrize("use_range", [True, False])
def test_flat_global_equals_jax(u32, use_range):
    """Rows packed across 4 queries, each with its owner's needles; a dead
    step and a partly dead step past the live prefix."""
    rng = np.random.default_rng(9 + u32)
    flat, starts, lens = random_pack(rng, u32)
    B, M, Nn, cap, win = 4, 4 * R, 2, 4, 200
    V = M - R - 3
    ids = rng.integers(0, lens.size, M)
    owner = rng.integers(0, B, size=M).astype(np.int32)
    owner[V:] = 0
    ln = lens[ids].copy()
    ln[V:] = 0
    ndl = np.zeros((B, Nn, J.NEEDLE_CAP), dtype=np.uint32)
    nlens = np.zeros((B, Nn), dtype=np.int32)
    for b in range(B):
        for j in range(Nn):
            L = int(rng.integers(1, cap + 1))
            d = int(rng.choice(np.flatnonzero(lens >= L)))
            ndl[b, j, :L] = flat[starts[d]:starts[d] + L]
            nlens[b, j] = L
    dt = np.uint32 if u32 else np.uint16
    sent = 0xFFFFFFFF if u32 else 0xFFFF
    tail = jdt.FLAT_GATHER_PAD + (-(flat.size + jdt.FLAT_GATHER_PAD) % 1024)
    full = np.concatenate([flat, np.full(tail, sent, dtype=dt)])
    offs = starts[ids]
    want = np.asarray(J.tf_rows_flat_global_pallas(
        jnp.asarray(full), jnp.asarray((offs >> 10).astype(np.int32)),
        jnp.asarray((offs & 1023).astype(np.int32)), jnp.asarray(ln),
        jnp.asarray(owner), jnp.int32(V),
        J.cast_needles_i32(jnp.asarray(ndl), full.dtype,
                           cap).reshape(B, Nn * cap),
        jnp.asarray(nlens), B=B, Nn=Nn, cap=cap, win=win,
        use_range=use_range, interpret=True))
    got = T.tf_rows_flat_global(
        cells_of(flat), t64(offs), t32(ln), t32(owner), t32([V]),
        t32(T.cast_needles_i32(ndl, dt, cap)), t32(nlens), cap=cap,
        win=win, use_range=use_range).numpy()
    assert np.array_equal(got, want)
    assert not got[V:].any() and got[:V, :Nn].sum() > 0


# ---------------------------------------------------------------------------
# The shapes at which the card's warp-per-row kernel differs in how it loads
# ---------------------------------------------------------------------------

def needles_from(rng, flat, starts, lens, B, Nn, cap, max_len=6):
    """(B, Nn, CAP) needles cut from random documents of the pack, lengths
    1..min(cap, max_len), and their lengths."""
    ndl = np.zeros((B, Nn, J.NEEDLE_CAP), dtype=np.uint32)
    nlens = np.zeros((B, Nn), dtype=np.int32)
    for b in range(B):
        for j in range(Nn):
            L = int(rng.integers(1, min(cap, max_len) + 1))
            d = int(rng.choice(np.flatnonzero(lens >= L)))
            p = int(starts[d] + rng.integers(0, lens[d] - L + 1))
            ndl[b, j, :L] = flat[p:p + L]
            nlens[b, j] = L
    return ndl, nlens


@pytest.mark.parametrize("u32", [False, True])
@pytest.mark.parametrize("use_range", [True, False])
def test_flat_unaligned_starts_and_pack_end_equal_jax(u32, use_range):
    """Flat rows that start off a 16-byte boundary (offset % 8 in a u16
    pack, % 4 in a u32 pack), the pack's last document, whose window runs
    past the pack's last cell, and dead rows between live ones; a window of
    150, a multiple of neither 32 nor 8."""
    rng = np.random.default_rng(21 + u32)
    flat, starts, lens = random_pack(rng, u32, maxT=150)
    tail = flat[:97].copy()                     # a last document of 97
    flat = np.concatenate([flat, tail])
    starts = np.append(starts, flat.size - tail.size)
    lens = np.append(lens, np.int32(tail.size)).astype(np.int32)
    per_vec = 16 // flat.itemsize
    off_edge = np.flatnonzero((starts % per_vec != 0) & (lens > 0))
    B, Kv, cap, Nn, win = 2, 2 * R, 4, 2, 150
    M = B * Kv
    ids = off_edge[rng.integers(0, off_edge.size, M)]
    ids[::5] = lens.size - 1
    row_lens = np.where(np.arange(M) % 3 != 1, lens[ids], 0)
    ndl, nlens = needles_from(rng, flat, starts, lens, B, Nn, cap)
    kw = dict(Kv=Kv, cap=cap, win=win, use_range=use_range)
    got = port_flat(flat, starts[ids], row_lens, ndl, nlens, **kw)
    want = jax_flat(flat, starts[ids], row_lens, ndl, nlens, **kw)
    assert np.array_equal(got, want)
    assert got[:, :Nn].sum() > 0 and not got[1::3].any()
    assert (got[::5, Nn][row_lens[::5] > 0] == tail.size).all()


@pytest.mark.parametrize("u32", [False, True])
@pytest.mark.parametrize("use_range", [True, False])
def test_padded_prefix_of_long_documents_equal_jax(u32, use_range):
    """A prefix width < rowT over documents longer than it: cells at or
    past width count neither in doc_len nor as a match, and a needle that
    straddles width never matches there. The JAX kernel's block rule asks
    for rowT and width multiples of 128 and N a multiple of 8, so the
    shapes are N 64, rowT 384, width 128."""
    rng = np.random.default_rng(31 + u32)
    N, rowT, W, cap = 64, 384, 128, 4
    dt = np.uint32 if u32 else np.uint16
    alphabet = np.asarray([0x61, 0x62, 0x4E00] + ([0x1F600] if u32 else []))
    lens = rng.integers(1, rowT - J.NEEDLE_CAP, N).astype(np.int32)
    lens[::2] = rng.integers(W + 1, rowT - J.NEEDLE_CAP, N // 2)
    padded = np.full((N, rowT), 0xFFFFFFFF if u32 else 0xFFFF, dtype=dt)
    for i in range(N):
        padded[i, :lens[i]] = alphabet[rng.integers(0, alphabet.size,
                                                    lens[i])]
    ids = rng.integers(0, N, 2 * R).astype(np.int32)
    long_row = ids[np.flatnonzero(lens[ids] > W)[0]]
    ndl = np.zeros((1, 2, J.NEEDLE_CAP), dtype=np.uint32)
    ndl[0, 0, :2] = padded[ids[0], :2]
    ndl[0, 1, :3] = padded[long_row, W - 2:W + 1]   # straddles width
    nlens = np.asarray([[2, 3]], dtype=np.int32)
    want = np.asarray(J.tf_rows_pallas(
        jnp.asarray(padded), jnp.asarray(ids),
        J.cast_needles_i32(jnp.asarray(ndl), jnp.asarray(padded).dtype, cap),
        jnp.asarray(nlens), Kv=2 * R, Nn=2, cap=cap, use_range=use_range,
        width=W, interpret=True))
    got = T.tf_rows_padded(
        cells_of(padded), t64(ids), t32(lens[ids]),
        t32(T.cast_needles_i32(ndl, dt, cap)), t32(nlens), Kv=2 * R,
        cap=cap, width=W, use_range=use_range).numpy()
    assert np.array_equal(got, want)
    assert got[:, 0].sum() > 0
    assert (got[:, 2] == np.minimum(lens[ids], W)).all()


@pytest.mark.parametrize("u32", [False, True])
@pytest.mark.parametrize("use_range", [True, False])
def test_flat_runs_past_32_hits_equal_jax(u32, use_range):
    """Documents that are runs of one code point, broken every 50 cells,
    and needles of 2-3 cells of the run: more than 32 hits a row, so the
    kernel's 32-start flag words chain. The all-starts count equals
    ``tf_rows_flat_pallas``; the leftmost-greedy count, a mode no Pallas
    kernel has, equals the JAX package's ``tf_matrix_nonoverlap`` over the
    same windows."""
    rng = np.random.default_rng(41 + u32)
    a, b = (0x1F600, 0x61) if u32 else (0x61, 0x62)
    dt = np.uint32 if u32 else np.uint16
    N, win, cap, Nn = 40, 200, 4, 2
    lens = rng.integers(60, win + 1, N).astype(np.int32)
    starts = np.zeros(N, dtype=np.int64)
    np.cumsum(lens[:-1], out=starts[1:])
    flat = np.where(np.arange(int(lens.sum())) % 50 == 49, b, a).astype(dt)
    ndl = np.zeros((1, Nn, J.NEEDLE_CAP), dtype=np.uint32)
    ndl[0, 0, :2] = a
    ndl[0, 1, :3] = [a, a, a]
    nlens = np.asarray([[2, 3]], dtype=np.int32)
    Kv = 2 * R
    ids = rng.integers(0, N, Kv)
    kw = dict(Kv=Kv, cap=cap, win=win, use_range=use_range)
    got = port_flat(flat, starts[ids], lens[ids], ndl, nlens, **kw)
    assert np.array_equal(got, jax_flat(flat, starts[ids], lens[ids], ndl,
                                        nlens, **kw))
    assert got[:, 0].max() > 32
    sent = 0xFFFFFFFF if u32 else 0xFFFF
    text = np.full((Kv, win + cap), sent, dtype=dt)
    for r, d in enumerate(ids):
        n = min(int(lens[d]), win + cap)
        text[r, :n] = flat[starts[d]:starts[d] + n]
    want = np.asarray(J.tf_matrix_nonoverlap(
        jnp.asarray(text), jnp.asarray(lens[ids]), jnp.asarray(ndl[0]),
        jnp.asarray(nlens[0]), win, Nn, cap, use_range))
    greedy = port_flat(flat, starts[ids], lens[ids], ndl, nlens,
                       nonoverlap=True, **kw)
    assert np.array_equal(greedy[:, :Nn], want)
    assert greedy[:, 0].max() > 32 and (greedy[:, 0] < got[:, 0]).all()


# ---------------------------------------------------------------------------
# The non-overlapping mode and the XLA-path functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flat", [True, False])
def test_nonoverlap_equals_tf_matrix_nonoverlap(monkeypatch, flat):
    texts = texts_of(12)
    texts[300] = "aaaa"
    texts[301] = "aaaaa検索検索検索"
    jst = jax_store(texts, flat, monkeypatch)
    pst = port_store(jst)
    ids = np.asarray(sorted(texts), dtype=np.int32)
    ndl, nlens = needle_sets([["aa", "検索検索", "aaa"]], 3)
    cap = T.needle_cap_bucket(4)
    text, dl, win = J.gather_text(jst.codepoints, jst.offsets, jst.lengths,
                                  jnp.asarray(ids), jst.maxT, cap)
    want = np.asarray(J.tf_matrix_nonoverlap(
        text, dl, jnp.asarray(ndl[0]), jnp.asarray(nlens[0]), win, 3, cap))
    got, gdl = T.count_occurrences_device(
        pst.codepoints, pst.offsets, pst.lengths, t32(ids), ndl[0],
        nlens[0], C=ids.size, maxT=pst.maxT, Nn=3, cap=cap,
        nonoverlap=True)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(gdl.numpy(), np.asarray(dl))
    row = {d: i for i, d in enumerate(ids.tolist())}
    assert want[row[300], 0] == 2 and want[row[301], 1] == 1


def test_xla_helpers_equal_jax():
    """gather-free helpers on one text tile: contains_all, tf_matrix and
    tf_matrix_nonoverlap, with and without the range mask."""
    rng = np.random.default_rng(4)
    C, maxT, cap, Nn = 40, 60, 4, 2
    text = rng.integers(1, 4, size=(C, maxT + cap)).astype(np.uint16)
    dl = rng.integers(0, maxT, size=C).astype(np.int32)
    for c in range(C):
        text[c, dl[c]:] = 0xFFFF
    ndl = np.zeros((Nn, J.NEEDLE_CAP), dtype=np.uint32)
    ndl[0, :2] = [1, 1]
    ndl[1, :3] = [2, 3, 1]
    nl = np.asarray([2, 3], dtype=np.int32)
    jt, jd = jnp.asarray(text), jnp.asarray(dl)
    tt = T.cells_i32(cells_of(text))
    td = t32(dl)
    tn = t32(T.cast_needles_i32(ndl, np.uint16, cap).reshape(Nn, cap))
    for use_range in (True, False):
        args_j = (jt, jd, jnp.asarray(ndl), jnp.asarray(nl), maxT, Nn, cap,
                  use_range)
        args_t = (tt, td, tn, t32(nl), maxT, Nn, cap, use_range)
        assert np.array_equal(T.contains_all(*args_t).numpy(),
                              np.asarray(J.contains_all(*args_j)))
        assert np.array_equal(T.tf_matrix(*args_t).numpy(),
                              np.asarray(J.tf_matrix(*args_j)))
        assert np.array_equal(T.tf_matrix_nonoverlap(*args_t).numpy(),
                              np.asarray(J.tf_matrix_nonoverlap(*args_j)))


@pytest.mark.parametrize("flat", [True, False])
def test_store_level_ops_equal_jax(monkeypatch, flat):
    texts = texts_of(21)
    jst = jax_store(texts, flat, monkeypatch)
    pst = port_store(jst)
    rng = np.random.default_rng(8)
    ids = np.full(300, -1, dtype=np.int32)
    ids[:260] = rng.integers(1, 257, 260)
    for terms in (["検索", "alpha"], ["quick"], ["aa", "fox", "高速"]):
        Nn = len(terms)
        ndl, nlens = jdt.DeviceTextStore._pack_needles(terms)
        cap = T.needle_cap_bucket(int(nlens.max()))
        maxT = jst._chunk_maxT(ids)
        assert maxT == pst._chunk_maxT(ids)
        kw = dict(C=ids.size, maxT=maxT, Nn=Nn, cap=cap)
        jargs = (jst.codepoints, jst.offsets, jst.lengths, jnp.asarray(ids),
                 jnp.asarray(ndl), jnp.asarray(nlens))
        targs = (pst.codepoints, pst.offsets, pst.lengths, t32(ids), ndl,
                 nlens)
        for use_range in (True, False):
            assert np.array_equal(
                T.substring_verify_device(*targs, use_range=use_range,
                                          **kw).numpy(),
                np.asarray(J.substring_verify_device(
                    *jargs, use_range=use_range, **kw)))
            assert np.array_equal(
                T.substring_masks_device(*targs, use_range=use_range,
                                         **kw).numpy(),
                np.asarray(J.substring_masks_device(
                    *jargs, use_range=use_range, **kw)))
        for nonoverlap in (False, True):
            tf, dl = T.count_occurrences_device(*targs, nonoverlap=nonoverlap,
                                                **kw)
            jtf, jdl = J.count_occurrences_device(*jargs,
                                                  nonoverlap=nonoverlap, **kw)
            assert np.array_equal(tf.numpy(), np.asarray(jtf))
            assert np.array_equal(dl.numpy(), np.asarray(jdl))
            idf = rng.random(Nn).astype(np.float32) + 0.5
            bm = (1.2, 0.75, 23.5)
            tid, tsc = T.bm25_topk_device(*targs, idf, *bm, n=50,
                                          nonoverlap=nonoverlap, **kw)
            jid, jsc = J.bm25_topk_device(
                *jargs, jnp.asarray(idf), *(jnp.float32(x) for x in bm),
                n=50, nonoverlap=nonoverlap, **kw)
            assert np.array_equal(tid.numpy(), np.asarray(jid))
            np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc),
                                       rtol=1e-5)


def test_host_helpers_equal_jax():
    for n in range(0, 40):
        assert T.needle_cap_bucket(n) == J.needle_cap_bucket(n)
    for term in ("aa", "abab", "abc", "検索検索", "a", "", "abca"):
        assert T.has_self_overlap(term) == J.has_self_overlap(term)
    ndl = np.asarray([[[0x1F600, 0x61, 0xFFFF] + [0] * 29]], np.uint32)
    for dt in (np.uint16, np.uint32):
        want = np.asarray(J.cast_needles_i32(
            jnp.asarray(ndl), jnp.uint16 if dt == np.uint16 else jnp.uint32,
            4))
        assert np.array_equal(T.cast_needles_i32(ndl, dt, 4), want)
