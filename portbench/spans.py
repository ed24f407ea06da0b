"""Spans recorded from the benchmark's own files, for the traced run: the
port's entry points of each layer are wrapped, and every call records its
layer, thread, start, end and self time (its time less that of the spans
nested in it on the same thread).

Layers and the entry points wrapped:

- ``server``: ``server.core.ServerCore.handle_line``, a command from its
  line to its answer;
- ``query``: ``query.pipeline.SearchPipeline.execute``;
- ``index``: the ``index.device_index.DeviceIndex`` calls the pipeline
  makes;
- ``batcher``: ``server.microbatch.MicroBatcher._enqueue``, a query's wait
  in the micro-batch queue and, on the thread that flushes it, the batch's
  execution.

A target that is no longer there is not wrapped, and the metrics that read
its layer read nothing.
"""

from __future__ import annotations

import functools
import importlib
import threading
import time
from typing import Dict, List, Tuple

PKG = "mygramdb_tpu_torch"
TARGETS: Dict[str, List[str]] = {
    "server": ["server.core:ServerCore.handle_line"],
    "query": ["query.pipeline:SearchPipeline.execute"],
    "index": ["index.device_index:DeviceIndex." + m for m in (
        "search_and", "search_and_verified", "ast_words", "search_or",
        "search_by_threshold", "filter_by_ngrams",
        "search_verified_positional")],
    "batcher": ["server.microbatch:MicroBatcher._enqueue"],
}
DEPTH = {"server": 0, "query": 1, "index": 2, "batcher": 3}


class Recorder:
    def __init__(self):
        self.tls = threading.local()
        self.lock = threading.Lock()
        # (layer, thread id, start, end, self seconds)
        self.spans: List[Tuple[str, int, float, float, float]] = []
        self.installed: Dict[str, List[str]] = {}
        self._undo = []

    def _wrap(self, layer: str, fn):
        rec = self

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            stack = getattr(rec.tls, "stack", None)
            if stack is None:
                stack = rec.tls.stack = []
            frame = [0.0]  # child seconds
            stack.append(frame)
            t0 = time.monotonic()
            try:
                return fn(*args, **kwargs)
            finally:
                t1 = time.monotonic()
                stack.pop()
                if stack:
                    stack[-1][0] += t1 - t0
                with rec.lock:
                    rec.spans.append((layer, threading.get_ident(), t0, t1,
                                      t1 - t0 - frame[0]))
        return wrapper

    def install(self) -> None:
        for layer, targets in TARGETS.items():
            for target in targets:
                mod_name, attr = target.split(":")
                cls_name, meth = attr.split(".")
                try:
                    cls = getattr(importlib.import_module(
                        f"{PKG}.{mod_name}"), cls_name)
                    fn = cls.__dict__[meth]
                except (ImportError, AttributeError, KeyError):
                    continue
                setattr(cls, meth, self._wrap(layer, fn))
                self._undo.append((cls, meth, fn))
                self.installed.setdefault(layer, []).append(target)

    def uninstall(self) -> None:
        for cls, meth, fn in reversed(self._undo):
            setattr(cls, meth, fn)
        self._undo.clear()

    def window(self, t0: float, t1: float):
        """The spans that ended inside [t0, t1]."""
        with self.lock:
            return [s for s in self.spans if t0 <= s[3] <= t1]
