"""Carry a JAX ``DeviceIndex``'s and ``DeviceTextStore``'s state across to
the port.

``state_from_jax(device_index)`` reads the JAX package's device arrays
into numpy, in the shape ``DeviceIndex.from_state`` takes and
``DeviceIndex.state()`` returns; ``sharded_state_from_jax`` does the same
for a JAX mesh index (``mesh_shards`` > 1), into the port's sharded
state; ``text_state_from_jax(store)`` does the
same for the text store and ``DeviceTextStore.from_state``. Tests use them
to show that both packages hold, and verify over, the same data. They
touch the JAX arrays only through ``np.asarray`` and import no JAX.

The boolean, OR and fuzzy paths (``ast_words``, ``search_or``,
``search_by_threshold``) read only what ``state_from_jax`` already carries
(bitmaps, postings, offsets, lengths, tombstones), so they need nothing
new here; ``tests/test_torch_boolean.py`` and
``tests/test_torch_threshold.py`` run them on a carried-over state. A
positional index comes across with ``positional_state_from_jax``.
"""

from __future__ import annotations

import numpy as np

from .ops.posting_ops import SENTINEL


def state_from_jax(device_index) -> dict:
    """-> dict of numpy arrays and ints (see ``index.device_index.host_state``).

    The JAX device CSR ends in a sentinel pad tail for its DMA gather;
    the port's CSR has none, so the tail is stripped here. A JAX index
    with a positional index keeps its CSR uncompacted (so nothing else is
    stripped) and carries ``positional_state_from_jax``'s arrays under
    ``"positional"``. Only the single-device layout is supported."""
    d = device_index
    if d.postings_sh is not None:
        raise ValueError("state_from_jax: only the single-device layout "
                         "is supported")
    dense_row = np.asarray(d.dense_row, dtype=np.int32)
    lengths = np.asarray(d.lengths)
    post = np.asarray(d.postings)
    P = int(lengths[dense_row < 0].astype(np.int64).sum()) \
        if d.n_dense and d.positional is None else int(d.built.postings.size)
    if not (post[P:] == SENTINEL).all():
        raise ValueError("state_from_jax: unexpected device CSR layout")
    state = {"bitmaps": np.asarray(d.bitmaps, dtype=np.uint32),
             "postings": post[:P].astype(np.int32),
             "offsets": np.asarray(d._dev_offsets, dtype=np.int64),
             "lengths": lengths.copy(),
             "dense_row": dense_row.copy(),
             "deleted": np.asarray(d.deleted_host, dtype=np.uint32).copy(),
             "ones_row": int(d.ones_row), "zeros_row": int(d.zeros_row),
             "n_words": int(d.n_words),
             "n_docs_capacity": int(d.n_docs_capacity)}
    if d.positional is not None:
        state["positional"] = positional_state_from_jax(d)
    return state


def positional_state_from_jax(device_index) -> dict:
    """A JAX index's ``DevicePositional`` -> the port's compact arrays (see
    ``index.positional.DevicePositional.from_state``).

    The JAX occurrence arrays are (rows, 128) views whose term regions
    start 128-aligned (``occ_base8`` rows) and end in a pad tail; the port
    keeps exactly the real occurrences, term after term, positions as
    int32, and the doc lengths cut to the index's capacity."""
    from .index.positional import OCC_ALIGN, occurrence_starts
    pp = device_index.positional
    occ_len = np.asarray(pp.occ_len, dtype=np.int64)
    base = (np.asarray(pp.occ_base8, dtype=np.int64) * OCC_ALIGN
            - occurrence_starts(occ_len))
    cells = np.repeat(base, occ_len) + np.arange(int(occ_len.sum()),
                                                 dtype=np.int64)
    cap = int(device_index.n_docs_capacity)
    return {"occ_doc": np.asarray(pp.occ_doc8).reshape(-1)[cells]
            .astype(np.int32),
            "occ_pos": np.asarray(pp.occ_pos8).reshape(-1)[cells]
            .astype(np.int32),
            "occ_len": occ_len.copy(),
            "doc_len": np.asarray(pp.doc_len_pad, dtype=np.int32)[:cap]
            .copy(),
            "overflow": sorted(int(x) for x in pp.overflow)}


def sharded_state_from_jax(device_index) -> dict:
    """A JAX mesh ``DeviceIndex`` -> the port's sharded state (see
    ``index.device_index.sharded_csr``).

    The JAX doc-sharded CSR is an (S, Pmax + pad) matrix of shard-local
    ids that keeps every term's slice, dense terms' too, zero-padded to
    the largest shard and ended by a sentinel tail. The port's shards keep
    sparse terms' slices only, each exactly its size, with dense terms'
    offsets past each shard's end: the dense slices and the padding are
    dropped here."""
    d = device_index
    if d.postings_sh is None:
        raise ValueError("sharded_state_from_jax: not a mesh index")
    dense_row = np.asarray(d.dense_row, dtype=np.int32)
    keep = dense_row < 0
    post_sh = np.asarray(d.postings_sh)
    lengths_sh = np.asarray(d.lengths_sh, dtype=np.int64)
    S, V = lengths_sh.shape
    parts = []
    for s in range(S):
        n = int(lengths_sh[s].sum())
        parts.append(post_sh[s, :n][np.repeat(keep, lengths_sh[s])]
                     .astype(np.int32))
    lengths_sh = np.where(keep[None, :], lengths_sh, 0)
    offsets_sh = np.zeros((S, V), dtype=np.int64)
    if V:
        np.cumsum(lengths_sh[:, :-1], axis=1, out=offsets_sh[:, 1:])
    offsets_sh[:, ~keep] = np.asarray([p.size for p in parts],
                                      dtype=np.int64)[:, None]
    return {"bitmaps": np.asarray(d.bitmaps, dtype=np.uint32),
            "postings_sh": parts, "offsets_sh": offsets_sh,
            "lengths_sh": lengths_sh,
            "lengths": np.asarray(d.lengths).copy(),
            "dense_row": dense_row.copy(),
            "deleted": np.asarray(d.deleted_host, dtype=np.uint32).copy(),
            "ones_row": int(d.ones_row), "zeros_row": int(d.zeros_row),
            "n_words": int(d.n_words),
            "n_docs_capacity": int(d.n_docs_capacity)}


def text_state_from_jax(store) -> dict:
    """A JAX ``DeviceTextStore`` -> the port's store state (see
    ``storage.device_text.DeviceTextStore.from_state``).

    The JAX layouts carry TPU padding that the port drops: the flat pack's
    sentinel tail (cut after the last packed cell), the padded matrix's
    128-cell row rounding (cut to maxT + NEEDLE_CAP columns, which hold
    every packed document) and the rows past the capacity."""
    from .ops.verify_ops import NEEDLE_CAP
    if getattr(store, "doc_sharded", False):
        raise ValueError("text_state_from_jax: only the single-device "
                         "layout is supported")
    cap = int(store.capacity)
    lengths = np.asarray(store.lengths_host, dtype=np.int32)[:cap]
    offsets = np.asarray(store.offsets_host, dtype=np.int64)[:cap]
    cells = np.asarray(store.codepoints)
    if cells.ndim == 2:
        cells = cells[:cap, :store.maxT + NEEDLE_CAP]
    else:
        end = int((offsets + lengths).max()) if cap else 0
        cells = cells[:max(end, 1)]
    return {"capacity": cap, "maxT": int(store.maxT),
            "dtype": np.dtype(store.dtype).name,
            "overflow": sorted(int(d) for d in store._overflow),
            "n_packed": int(store.n_packed),
            "offsets": offsets.copy(), "lengths": lengths.copy(),
            "codepoints": np.ascontiguousarray(cells).copy()}
