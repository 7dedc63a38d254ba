"""Lightweight span tracing with a ring-buffer trace log (a copy of
:mod:`repro.obs.trace`; spans serialise to the same dicts and Chrome
events).

A *span* is a named wall-clock interval with attributes and child
spans; a *trace* is the tree rooted at a span opened when no other span
is active (for the serve path: one ``serve.step`` root per scheduler
batch).  The tracer keeps a plain Python stack — ``with
tracer.span("plan")`` nests under whatever span is currently open, so
call-graph nesting gives the trace tree for free.

Contracts:

* **Clock domain.**  Span timestamps come from
  :func:`repro_torch.obs.clock` (``time.monotonic``, which on Linux reads
  the same ``CLOCK_MONOTONIC`` as ``time.perf_counter``).  Durations are
  always meaningful; absolute offsets are process-relative (fine for
  ``chrome://tracing``, which renders relative time).
* **Fencing.**  A span that covers device work must fence it
  (:func:`repro_torch.obs.fence`, a ``torch.cuda.synchronize`` of the
  devices the work's tensors live on) *inside* the span.  Otherwise the
  span measures the kernels' dispatch, not their execution.
* **Bounded memory.**  Completed root spans go into a ``TraceLog`` ring
  (``collections.deque(maxlen=...)``); a long-running server keeps the
  newest N traces only.
* **Threading.**  The tracer is deliberately not thread-safe; the serve
  loop is single-threaded host code.  Use one ``Obs`` per thread.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Callable, Dict, List, Optional

__all__ = ["Span", "Tracer", "TraceLog", "to_chrome_trace"]


def clock() -> float:
    """The one blessed wall-clock read (see ``repro_torch.obs.clock``)."""
    return time.monotonic()


class Span:
    """A named interval: ``[start, end]`` seconds, attrs, children."""

    __slots__ = ("name", "start", "end", "attrs", "children")

    def __init__(self, name: str, start: float, **attrs) -> None:
        self.name = name
        self.start = start
        self.end: Optional[float] = None
        self.attrs: Dict[str, object] = dict(attrs)
        self.children: List["Span"] = []

    @property
    def duration(self) -> float:
        return (self.end - self.start) if self.end is not None else 0.0

    def as_dict(self) -> dict:
        return {
            "name": self.name,
            "start": self.start,
            "end": self.end,
            "attrs": dict(self.attrs),
            "children": [c.as_dict() for c in self.children],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Span":
        s = cls(d["name"], d["start"], **d.get("attrs", {}))
        s.end = d.get("end")
        s.children = [cls.from_dict(c) for c in d.get("children", [])]
        return s

    def walk(self):
        yield self
        for c in self.children:
            yield from c.walk()

    def find(self, name: str) -> List["Span"]:
        return [s for s in self.walk() if s.name == name]


class _SpanCtx:
    """Context manager returned by :meth:`Tracer.span`."""

    __slots__ = ("_tracer", "_span")

    def __init__(self, tracer: "Tracer", span: Span) -> None:
        self._tracer = tracer
        self._span = span

    def __enter__(self) -> Span:
        self._tracer._push(self._span)
        return self._span

    def __exit__(self, *exc) -> None:
        self._tracer._pop(self._span)


class TraceLog:
    """Ring buffer of the newest ``maxlen`` completed trace roots."""

    def __init__(self, maxlen: int = 256) -> None:
        self._roots: deque = deque(maxlen=maxlen)

    def record(self, root: Span) -> None:
        self._roots.append(root)

    def roots(self) -> List[Span]:
        return list(self._roots)

    def clear(self) -> None:
        self._roots.clear()

    def __len__(self) -> int:
        return len(self._roots)

    def as_dicts(self) -> List[dict]:
        return [r.as_dict() for r in self._roots]

    def to_chrome_trace(self) -> List[dict]:
        return to_chrome_trace(self.roots())


class Tracer:
    """Stack-based span builder feeding a :class:`TraceLog`.

    ``on_close(span)`` fires for every completed span (the ``Obs``
    facade uses it to auto-record ``span.<name>`` duration histograms).
    """

    def __init__(self, log: TraceLog,
                 on_close: Optional[Callable[[Span], None]] = None) -> None:
        self.log = log
        self._stack: List[Span] = []
        self._on_close = on_close

    @property
    def current(self) -> Optional[Span]:
        return self._stack[-1] if self._stack else None

    def span(self, name: str, **attrs) -> _SpanCtx:
        return _SpanCtx(self, Span(name, clock(), **attrs))

    def _push(self, span: Span) -> None:
        parent = self.current
        if parent is not None:
            parent.children.append(span)
        self._stack.append(span)

    def _pop(self, span: Span) -> None:
        # Tolerate a corrupted stack (exception unwound past us) rather
        # than raising from __exit__.
        while self._stack:
            top = self._stack.pop()
            top.end = clock()
            if self._on_close is not None:
                self._on_close(top)
            if not self._stack:
                self.log.record(top)
            if top is span:
                break

    def record(self, name: str, start: float, end: float, **attrs) -> Span:
        """Attach an already-completed span with explicit timestamps.

        Used for intervals measured outside the tracer — e.g. queue
        wait, whose start is the request's arrival stamp.  Nested under
        the currently-open span (or logged as its own root).
        """
        span = Span(name, start, **attrs)
        span.end = end
        parent = self.current
        if parent is not None:
            parent.children.append(span)
        else:
            self.log.record(span)
        if self._on_close is not None:
            self._on_close(span)
        return span


def to_chrome_trace(roots: List[Span]) -> List[dict]:
    """``chrome://tracing`` / Perfetto "complete" (``ph: "X"``) events.

    One row (``tid``) per trace root; timestamps in microseconds,
    process-relative.  Load via chrome://tracing "Load" or
    ui.perfetto.dev after wrapping in ``{"traceEvents": [...]}`` or
    dumping the bare list (both are accepted).
    """
    events: List[dict] = []

    def emit(span: Span, tid: int) -> None:
        events.append({
            "name": span.name,
            "ph": "X",
            "ts": span.start * 1e6,
            "dur": span.duration * 1e6,
            "pid": 0,
            "tid": tid,
            "args": dict(span.attrs),
        })
        for c in span.children:
            emit(c, tid)

    for tid, root in enumerate(roots):
        emit(root, tid)
    return events
