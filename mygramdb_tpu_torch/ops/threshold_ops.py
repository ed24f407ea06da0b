"""Placeholder for ``mygramdb_tpu.ops.threshold_ops`` (fuzzy backbone):
ROADMAP Queue 1, item 10. Every name raises NotImplementedError."""

from .._overlay import not_ported, placeholder_getattr

threshold_merge = not_ported(__name__, "threshold_merge", "10")
threshold_count_bitmap = not_ported(__name__, "threshold_count_bitmap", "10")
__getattr__ = placeholder_getattr(__name__, "10")
