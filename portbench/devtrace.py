"""The device trace of the traced run's window, from ``torch.profiler``
(CUDA activity only: kernels, copies and sets, with their device times).

The profiler's clock is tied to the host's by two marker kernels
(``torch.cuda._sleep``, a ``spin_kernel``) launched at the window's
instants; without them the window is the span of the recorded activity
and no idle gap is laid against the host's spans.
"""

from __future__ import annotations

import inspect
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

MARK = "spin_kernel"


class DeviceTrace:
    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.torch = torch
        kw = ({"acc_events": True} if "acc_events" in
              inspect.signature(profile.__init__).parameters else {})
        self.prof = profile(activities=[ProfilerActivity.CUDA], **kw)
        self.marks: List[float] = []  # host monotonic seconds
        self.seen = 0  # profiler events read

    def start(self) -> None:
        self.prof.start()

    def mark(self) -> None:
        """A marker kernel now; its host time is kept."""
        self.marks.append(time.monotonic())
        self.torch.cuda._sleep(1000)

    def stop(self) -> None:
        self.torch.cuda.synchronize()
        self.prof.stop()

    def read(self) -> Dict:
        """{"window_s", "busy_s", "kernel_s", "ops": {name: seconds},
        "idle": [(host start, host end)] or None, "marked": bool}, all
        inside the window between the two markers."""
        acts = []  # (start us, end us, name, is_kernel)
        marks = []
        events = self.prof.events() or []
        self.seen = len(events)
        for e in events:
            if getattr(e, "device_type", None) is None or \
                    "cuda" not in str(e.device_type).lower():
                continue
            tr = e.time_range
            if MARK in e.name:
                marks.append(tr.start)
                continue
            kernel = not e.name.startswith(("Memcpy", "Memset"))
            acts.append((tr.start, tr.end, e.name, kernel))
        if not acts:
            return {"window_s": 0.0, "busy_s": 0.0, "kernel_s": 0.0,
                    "ops": {}, "idle": None, "marked": False}
        marked = len(marks) >= 2 and len(self.marks) >= 2
        if marked:
            lo, hi = min(marks), max(marks)
        else:
            lo, hi = min(a[0] for a in acts), max(a[1] for a in acts)
        st = np.array([max(a[0], lo) for a in acts], dtype=np.float64)
        en = np.array([min(a[1], hi) for a in acts], dtype=np.float64)
        keep = en > st
        ops: Dict[str, float] = {}
        kernel_us = 0.0
        for (s, e, name, kern), k, a, b in zip(acts, keep, st, en):
            if k:
                ops[name] = ops.get(name, 0.0) + (b - a) / 1e6
                kernel_us += (b - a) if kern else 0.0
        st, en = st[keep], en[keep]
        order = np.argsort(st)
        st, en = st[order], en[order]
        # union of the busy intervals, and the gaps between them
        reach = np.maximum.accumulate(en)
        new = np.concatenate([[True], st[1:] > reach[:-1]])
        starts = st[new]
        ends = np.concatenate([reach[np.flatnonzero(new)[1:] - 1],
                               [reach[-1]]])
        busy_us = float((ends - starts).sum())
        gaps = list(zip(np.concatenate([[lo], ends]),
                        np.concatenate([starts, [hi]])))
        idle: Optional[List[Tuple[float, float]]] = None
        if marked:
            # profiler microseconds -> host monotonic seconds
            scale = (self.marks[-1] - self.marks[0]) / max(hi - lo, 1e-9)
            idle = [(self.marks[0] + (a - lo) * scale,
                     self.marks[0] + (b - lo) * scale)
                    for a, b in gaps if b > a]
        return {"window_s": (hi - lo) / 1e6, "busy_s": busy_us / 1e6,
                "kernel_s": kernel_us / 1e6, "ops": ops, "idle": idle,
                "marked": marked}


def idle_by_span(idle, spans) -> Dict[str, float]:
    """Idle seconds by the deepest layer with a span open at each gap's
    middle (``none`` where no span was open)."""
    from .spans import DEPTH
    open_at: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    for layer in DEPTH:
        iv = sorted((s[2], s[3]) for s in spans if s[0] == layer)
        if not iv:
            continue
        st = np.array([a for a, _ in iv])
        en = np.maximum.accumulate(np.array([b for _, b in iv]))
        open_at[layer] = (st, en)
    out: Dict[str, float] = {}
    for a, b in idle:
        mid = (a + b) / 2
        name = "none"
        for layer in sorted(open_at, key=DEPTH.get, reverse=True):
            st, en = open_at[layer]
            j = np.searchsorted(st, mid, side="right") - 1
            if j >= 0 and en[j] >= mid:
                name = layer
                break
        out[name] = out.get(name, 0.0) + (b - a)
    return out
