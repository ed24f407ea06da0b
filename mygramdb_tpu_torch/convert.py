"""Carry a JAX ``DeviceIndex``'s state across to the port.

``state_from_jax(device_index)`` reads the JAX package's device arrays
into numpy, in the shape ``DeviceIndex.from_state`` takes and
``DeviceIndex.state()`` returns, so tests can show that both packages
hold the same data. It touches the JAX arrays only through ``np.asarray``
and imports no JAX itself.
"""

from __future__ import annotations

import numpy as np

from .ops.posting_ops import SENTINEL


def state_from_jax(device_index) -> dict:
    """-> dict of numpy arrays and ints (see ``index.device_index.host_state``).

    The JAX device CSR ends in a sentinel pad tail for its DMA gather;
    the port's CSR has none, so the tail is stripped here. Only the
    single-device layout without a positional index is supported."""
    d = device_index
    if d.postings_sh is not None or d.positional is not None:
        raise ValueError("state_from_jax: only the single-device layout "
                         "without a positional index is supported")
    dense_row = np.asarray(d.dense_row, dtype=np.int32)
    lengths = np.asarray(d.lengths)
    post = np.asarray(d.postings)
    P = int(lengths[dense_row < 0].astype(np.int64).sum()) \
        if d.n_dense else int(d.built.postings.size)
    if not (post[P:] == SENTINEL).all():
        raise ValueError("state_from_jax: unexpected device CSR layout")
    return {"bitmaps": np.asarray(d.bitmaps, dtype=np.uint32),
            "postings": post[:P].astype(np.int32),
            "offsets": np.asarray(d._dev_offsets, dtype=np.int64),
            "lengths": lengths.copy(),
            "dense_row": dense_row.copy(),
            "deleted": np.asarray(d.deleted_host, dtype=np.uint32).copy(),
            "ones_row": int(d.ones_row), "zeros_row": int(d.zeros_row),
            "n_words": int(d.n_words),
            "n_docs_capacity": int(d.n_docs_capacity)}
