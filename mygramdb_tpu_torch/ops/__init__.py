"""Device-side ops on PyTorch: the port of ``mygramdb_tpu.ops``.

Every op has a plain PyTorch version; the row-AND (K1) and the CSR slice
gather (K3) are hand-written CUDA kernels launched for CUDA tensors (see
``runtime.kernels``). Modules not ported yet are placeholders that raise
NotImplementedError naming their ROADMAP item.
"""

from .._overlay import extend_path

__path__ = extend_path(__path__, __name__)

from . import runtime  # noqa: E402
from .bitmap_ops import (  # noqa: E402
    popcount_words, and_rows, or_rows, andnot, expand_bits,
    topn_from_bitmap, count_bitmap, bit_member, make_bitmap_from_ids,
)
from .posting_ops import (  # noqa: E402
    SENTINEL, gather_slices, membership_sorted, bitmap_membership,
    mask_to_topn, intersect_candidates,
)
from .threshold_ops import threshold_merge  # noqa: E402

__all__ = [
    "runtime", "popcount_words", "and_rows", "or_rows", "andnot",
    "expand_bits", "topn_from_bitmap", "count_bitmap", "bit_member",
    "make_bitmap_from_ids", "SENTINEL", "gather_slices",
    "membership_sorted", "bitmap_membership", "mask_to_topn",
    "intersect_candidates", "threshold_merge",
]
