"""Device-side ops on PyTorch: the port of ``mygramdb_tpu.ops``.

Every op has a plain PyTorch version; the row-AND (K1), the row reduce
(K2, ``and_rows`` / ``or_rows``), the CSR slice gather (K3) and the
window-TF family of the verified search (K4, K5, K6) are hand-written CUDA
kernels launched for CUDA tensors (see ``runtime.kernels``). The
positional program (``positional_ops``) is torch ops around K3. ``wire``
is not carried into the port: a placeholder that raises
NotImplementedError.
"""

from . import runtime
from .bitmap_ops import (
    popcount_words, and_rows, or_rows, andnot, expand_bits,
    topn_from_bitmap, count_bitmap, bit_member, make_bitmap_from_ids,
)
from .posting_ops import (
    SENTINEL, gather_slices, membership_sorted, bitmap_membership,
    mask_to_topn, intersect_candidates,
)
from .threshold_ops import threshold_merge

__all__ = [
    "runtime", "popcount_words", "and_rows", "or_rows", "andnot",
    "expand_bits", "topn_from_bitmap", "count_bitmap", "bit_member",
    "make_bitmap_from_ids", "SENTINEL", "gather_slices",
    "membership_sorted", "bitmap_membership", "mask_to_topn",
    "intersect_candidates", "threshold_merge",
]
