"""Structured span tracing on an injectable clock.

A span is one timed, named, attributed interval; nesting is tracked per
thread (a span opened while another is live on the same thread records
it as its parent), so the serving stack's hierarchy —

    session.dispatch -> device.execute
    retire.decode -> rescue.rung[k]

— falls out of the ``with tracer.span(...)`` blocks already wrapping
those stages, across the dispatch AND retire threads (each thread keeps
its own stack; a retire-side span is a root, not a fake child of
whatever the dispatch thread happens to be doing).

Determinism: the clock is injectable, so a fake clock yields byte-stable
span timestamps and a test can assert EXACT span trees with zero
``time.sleep``.  Completed spans land in a bounded deque (``maxlen``) —
a long-lived session's trace memory is bounded, old spans fall off the
back.

:data:`NULL_TRACER` is the disabled tracer: ``span()`` returns the one
reusable :data:`NULL_SPAN` singleton (no record, no clock read, no
allocation beyond the call itself).
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque


class Span:
    """One open interval; a context manager.  Records itself into the
    tracer's deque on ``__exit__`` (only completed spans are recorded)."""

    __slots__ = ("name", "attrs", "sid", "parent", "thread", "t0", "t1",
                 "_tracer")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self.sid = None
        self.parent = None
        self.thread = None
        self.t0 = None
        self.t1 = None

    def __enter__(self) -> "Span":
        tr = self._tracer
        self.sid = next(tr._ids)
        stack = tr._stack()
        self.parent = stack[-1].sid if stack else None
        self.thread = threading.current_thread().name
        stack.append(self)
        self.t0 = tr._clock()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        tr = self._tracer
        self.t1 = tr._clock()
        stack = tr._stack()
        # tolerate exception-path unwinding out of order
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        if exc_type is not None:
            self.attrs = {**self.attrs, "error": exc_type.__name__}
        tr._record(self)
        return False


class Tracer:
    """Span collector: injectable clock, per-thread nesting stacks, one
    bounded deque of completed spans."""

    enabled = True

    def __init__(self, clock=None, maxlen: int = 8192):
        self._clock = clock if clock is not None else time.monotonic
        self._records: deque = deque(maxlen=maxlen)
        self._ids = itertools.count()
        self._tls = threading.local()
        self._lock = threading.Lock()

    def _stack(self) -> list:
        s = getattr(self._tls, "stack", None)
        if s is None:
            s = self._tls.stack = []
        return s

    def span(self, name: str, **attrs) -> Span:
        """Open a span: ``with tracer.span("session.dispatch", lanes=8):``
        Attrs must be JSON-serializable scalars (exporters dump them)."""
        return Span(self, name, attrs)

    def _record(self, span: Span) -> None:
        with self._lock:
            self._records.append(span)

    def records(self) -> list[dict]:
        """Completed spans, oldest first, as plain dicts:
        {name, sid, parent, thread, t0, t1, attrs}."""
        with self._lock:
            spans = list(self._records)
        return [{"name": s.name, "sid": s.sid, "parent": s.parent,
                 "thread": s.thread, "t0": s.t0, "t1": s.t1,
                 "attrs": dict(s.attrs)} for s in spans]

    def reset(self) -> None:
        with self._lock:
            self._records.clear()


class _NullSpan:
    """Reusable no-op span: stateless, so one singleton serves every
    disabled ``with`` block on every thread concurrently."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


NULL_SPAN = _NullSpan()


class NullTracer:
    """The disabled tracer: no clock reads, no records, no per-span
    allocation (``span()`` hands back the singleton)."""

    enabled = False

    def span(self, name: str, **attrs) -> _NullSpan:
        return NULL_SPAN

    def records(self) -> list:
        return []

    def reset(self) -> None:
        pass


NULL_TRACER = NullTracer()
