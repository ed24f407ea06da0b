"""Placeholder for ``mygramdb_tpu.ops.positional_ops`` (positional
verify): ROADMAP Queue 1, item 14. Every name raises NotImplementedError."""

from .._not_ported import placeholder_getattr

__getattr__ = placeholder_getattr(__name__, "14")
