"""Placeholder for ``mygramdb_tpu.ops.verify_ops`` (text-window verify and
BM25, kernels K4-K6): ROADMAP Queue 1, item 8.

Only the host-side needle helpers that the pipeline reads are defined;
any other name raises NotImplementedError.
"""

from __future__ import annotations

from .._overlay import placeholder_getattr

NEEDLE_CAP = 32  # needles longer than this fall back to host verification


def has_self_overlap(term: str) -> bool:
    """True when the term has a proper border (prefix == suffix)."""
    n = len(term)
    return any(term[:i] == term[n - i:] for i in range(1, n))


__getattr__ = placeholder_getattr(__name__, "8")
