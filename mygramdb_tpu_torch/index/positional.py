"""``mygramdb_tpu.index.positional`` with its device half held back.

The host half (occurrence-index build, dump state, bucket constants) is
the JAX package's own source, loaded privately so that builds with
``device.positional_verify`` keep working. ``DevicePositional`` (the
positional engine on the device) is ROADMAP Queue 1, item 14, and raises
NotImplementedError.
"""

from .._overlay import load_host_module, not_ported

_host = load_host_module(__package__ + "._positional_host",
                         "index/positional.py")

POS_CAP = _host.POS_CAP
POS_PAD = _host.POS_PAD
OCC_ALIGN = _host.OCC_ALIGN
PositionalPostings = _host.PositionalPostings
finalize_with_positions_np = _host.finalize_with_positions_np
DevicePositional = not_ported(__name__, "DevicePositional", "14")
