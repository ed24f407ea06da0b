"""Spans and counts of the program's own work, on the host's monotonic clock.

Off by default. ``enable()`` turns it on for the whole process; each
instrumented site then records a span: its name, the request it serves (an
id the TCP server assigns when it reads a command's line, shared by every
span of that command), its own id and its parent's (the span that caused
it), its thread, start, end, the thread's CPU seconds inside it where it
is the outermost span of its thread (a command's ``server.command``; a
read of the thread CPU clock costs tens of microseconds on a loaded host,
so nested spans do not read it), and a few small attributes. Spans go to a bounded ring
in memory (``RING``); nothing is written out. ``spans_between(t0, t1)``
reads them back.

``clock`` is ``time.monotonic``, the clock a device trace's marker kernels
are stamped with, so every span lies on the device trace's time line as
it is.

Off, a site costs one read of the module flag ``enabled``: ``span()``
returns the shared ``NOOP`` and ``record()`` returns at once, with no clock
read and no span made. Sites on a request's path test ``enabled``
themselves before they read the clock.

Build stages (``stage()``: the seed file's load, the device build, the
kernel library, the warm-up) are timed whether tracing is on or not, a few
clock reads a build, and kept in a small ring of their own
(``build_stages()``); with tracing on they are spans too.
"""

from __future__ import annotations

import functools
import itertools
import threading
import time
from collections import deque
from typing import List, Optional

clock = time.monotonic
cpu_clock = time.thread_time

# a 20 s window at 500 queries a second and about 12 spans a query is
# 120,000 spans: the ring holds twice that
RING = 1 << 18

enabled = False

_ring: deque = deque(maxlen=RING)
_stages: deque = deque(maxlen=256)
_span_ids = itertools.count(1)
_request_ids = itertools.count(1)
_tls = threading.local()


class Span:
    """One finished interval. ``cpu`` is None where start and end lie on
    different threads or where the span is nested in another on its
    thread; ``own`` is ``end - start`` less the stages nested
    in it (stages only, else None)."""

    __slots__ = ("name", "rid", "id", "parent", "thread", "start", "end",
                 "cpu", "attrs", "own")

    def __init__(self, name, rid, sid, parent, thread, start, end, cpu,
                 attrs, own=None):
        self.name = name
        self.rid = rid
        self.id = sid
        self.parent = parent
        self.thread = thread
        self.start = start
        self.end = end
        self.cpu = cpu
        self.attrs = attrs
        self.own = own

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, rid={self.rid}, id={self.id}, "
                f"parent={self.parent}, {self.seconds * 1e3:.3f} ms)")


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


NOOP = _Noop()


class _Open:
    """A span being recorded on this thread (the context ``span()``
    returns while tracing is on)."""

    __slots__ = ("name", "attrs", "rid", "id", "parent", "t0", "c0")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self):
        self.rid = getattr(_tls, "rid", None)
        self.parent = getattr(_tls, "span", None)
        self.id = next(_span_ids)
        _tls.span = self.id
        # the thread's CPU seconds on its outermost span alone
        self.c0 = cpu_clock() if self.parent is None else None
        self.t0 = clock()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = clock()
        cpu = None if self.c0 is None else cpu_clock() - self.c0
        _tls.span = self.parent
        _ring.append(Span(self.name, self.rid, self.id, self.parent,
                          threading.get_ident(), self.t0, t1, cpu,
                          self.attrs))
        return False


def enable() -> None:
    global enabled
    enabled = True


def disable() -> None:
    global enabled
    enabled = False


def clear() -> None:
    """Drop every span recorded so far (build stages too)."""
    _ring.clear()
    _stages.clear()


def span(name: str, **attrs):
    """A context that records the block as a span of this thread, child of
    the span open around it; ``NOOP`` while tracing is off."""
    if not enabled:
        return NOOP
    return _Open(name, attrs)


def record(name: str, start: float, end: float, rid: Optional[int] = None,
           parent: Optional[int] = None, attrs: Optional[dict] = None
           ) -> Optional[int]:
    """Record an interval whose two ends were read by the caller, perhaps
    on different threads (no CPU seconds). -> its span id, or None while
    tracing is off."""
    if not enabled:
        return None
    sid = next(_span_ids)
    _ring.append(Span(name, rid, sid, parent, threading.get_ident(), start,
                      end, None, attrs or {}))
    return sid


class phases:
    """Consecutive spans of this thread's work, children of the span open
    around them: each ``end(name)`` records the span running since the
    last ``end`` (or since the object was made), less the recording of
    the span before it. Nested, so they read no CPU clock. Made only while
    tracing is on, so a site pays one flag test when it is off::

        ph = trace.phases() if trace.enabled else None
        ...
        if ph is not None:
            ph.end("batcher.pack")
    """

    __slots__ = ("rid", "parent", "t")

    def __init__(self):
        self.rid, self.parent = context()
        self.t = clock()

    def end(self, name: str, **attrs) -> None:
        _ring.append(Span(name, self.rid, next(_span_ids), self.parent,
                          threading.get_ident(), self.t, clock(), None,
                          attrs))
        self.t = clock()


# ---------------------------------------------------------------------------
# The request and span a thread is working for
# ---------------------------------------------------------------------------

def new_request() -> int:
    return next(_request_ids)


def context():
    """(request id, id of the span open on this thread), either None."""
    return getattr(_tls, "rid", None), getattr(_tls, "span", None)


class request:
    """Run the block on behalf of request ``rid``: spans opened in it carry
    that id. Restores the thread's previous request on exit."""

    __slots__ = ("rid", "prev")

    def __init__(self, rid: Optional[int]):
        self.rid = rid

    def __enter__(self):
        self.prev = context()
        _tls.rid, _tls.span = self.rid, None
        return self

    def __exit__(self, *exc) -> bool:
        _tls.rid, _tls.span = self.prev
        return False


def traced(name: str):
    """Decorator: the call is a span named ``name`` while tracing is on
    (off, the wrapper costs one flag read and the call)."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not enabled:
                return fn(*args, **kwargs)
            with _Open(name, {}):
                return fn(*args, **kwargs)
        return call
    return wrap


# ---------------------------------------------------------------------------
# Build stages: always timed
# ---------------------------------------------------------------------------

class stage:
    """Time a build stage: kept in ``build_stages()`` whatever the flag,
    and a span too while tracing is on. ``own`` is its seconds less those
    of the stages nested in it on this thread."""

    __slots__ = ("name", "attrs", "t0", "c0", "nested", "outer", "sid",
                 "parent")

    def __init__(self, name: str, **attrs):
        self.name = name
        self.attrs = attrs

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self):
        self.outer = getattr(_tls, "stage", None)
        _tls.stage = self
        self.nested = 0.0
        self.parent = (self.outer.sid if self.outer is not None
                       else getattr(_tls, "span", None))
        self.sid = next(_span_ids)
        if enabled:
            _tls.span = self.sid
        self.c0 = cpu_clock()
        self.t0 = clock()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = clock()
        c1 = cpu_clock()
        _tls.stage = self.outer
        if self.outer is not None:
            self.outer.nested += t1 - self.t0
        if enabled:
            _tls.span = self.parent
        s = Span(self.name, getattr(_tls, "rid", None), self.sid,
                 self.parent, threading.get_ident(), self.t0, t1,
                 c1 - self.c0, self.attrs, own=t1 - self.t0 - self.nested)
        _stages.append(s)
        if enabled:
            _ring.append(s)
        return False


def build_stages() -> List[Span]:
    """The build stages timed in this process, oldest first (the last 256)."""
    return list(_stages)


# ---------------------------------------------------------------------------
# Reading
# ---------------------------------------------------------------------------

def spans() -> List[Span]:
    """Every span in the ring, in the order they ended."""
    while True:
        try:
            return list(_ring)
        except RuntimeError:  # appended to while copied: copy again
            continue


def spans_between(t0: float, t1: float) -> List[Span]:
    """The spans that ended inside [t0, t1]."""
    return [s for s in spans() if t0 <= s.end <= t1]
