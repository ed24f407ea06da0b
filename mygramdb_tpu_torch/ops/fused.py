"""Placeholder for ``mygramdb_tpu.ops.fused`` (fused search + verify +
top-n): ROADMAP Queue 1, item 9. Every name raises NotImplementedError."""

from .._overlay import placeholder_getattr

__getattr__ = placeholder_getattr(__name__, "9")
