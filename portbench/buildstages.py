"""The build stages the program times inside ``Application.initialize()``
(``mygramdb_tpu_torch.utils.trace.build_stages()``), read by the
``build.*_s`` per-layer metrics.

Only the stages of the last ``build.initialize`` count. A program without
the tracer module, or one that timed no ``build.initialize``, reads None.
"""

from __future__ import annotations

from typing import Optional


def seconds(names, own: bool = False) -> Optional[float]:
    """The seconds of the last initialize's stages named in ``names``: each
    stage's whole seconds, less those of the stages nested in it where
    ``own``. A stage nested in another stage of ``names`` is not counted
    again."""
    try:
        from mygramdb_tpu_torch.utils import trace
    except ImportError:
        return None
    stages = trace.build_stages()
    init = [s for s in stages if s.name == "build.initialize"]
    if not init:
        return None
    last = init[-1]
    picked = [s for s in stages if s.name in names
              and last.start <= s.start and s.end <= last.end]
    ids = {s.id for s in picked}
    return sum(s.own if own else s.seconds for s in picked
               if s.parent not in ids)
