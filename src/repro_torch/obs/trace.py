"""Span tracing for the serve/train hot paths.

A span is one timed interval with a name, attributes, a parent, and the
report FRAME it closed in.  Two usage shapes, matching how the runtimes
actually overlap work:

* ``with tracer.span("plan", parent=wave, wave=3):`` — synchronous
  host-side sections (planning, cache probes, the engine dispatch
  calls, barrier stalls).  Nesting uses an explicit ``parent`` or, when
  omitted, the innermost open context-manager span.
* ``s = tracer.start("wave", ...); ...; tracer.end(s, device_wait_s=w)``
  — asynchronous intervals that outlive the dispatching code path (a
  pipelined wave is dispatched in one poll and retires in a later one,
  possibly in a later report frame).  ``end`` stamps the CURRENT frame
  index, so a span opened in frame N that closes in frame N+1 is
  attributed to its retire frame — the same attribution the
  latency-gauge audit chose for ticket percentiles.

Clocks are INJECTED (``Tracer(clock=...)``), never read from bare
``time.*`` inside record paths — the timing analogue of the repo's
addressed-randomness discipline: tests drive a fake clock and assert
exact span math, and a runtime's tracer shares the runtime's clock so
spans and ticket timestamps are directly comparable.

Disabled tracing is STRUCTURALLY INERT: the runtimes hold the module
singleton ``NULL_TRACER``, whose ``span``/``start``/``end`` allocate no
Span objects and return shared constants — the hot path pays one
attribute lookup and a no-op call, and the obs contract (reports and
samples bitwise-identical to pre-obs behavior) holds by construction.

Completed spans buffer until a sink drains them (obs/export.py); the
buffer is bounded only by frame cadence, which is fine at wave/round
granularity (the hot loops emit a handful of spans per wave, not per
step).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional


class Span:
    """One timed interval.  ``t1 < 0`` means still open; ``frame`` is
    the report-frame index stamped at close (-1 while open)."""
    __slots__ = ("name", "sid", "parent", "t0", "t1", "frame", "attrs")

    def __init__(self, name: str, sid: int, parent: Optional[int],
                 t0: float, attrs: Dict):
        self.name = name
        self.sid = sid
        self.parent = parent
        self.t0 = t0
        self.t1 = -1.0
        self.frame = -1
        self.attrs = attrs

    @property
    def duration_s(self) -> float:
        return self.t1 - self.t0 if self.t1 >= 0.0 else -1.0

    def as_event(self) -> Dict:
        """Flat machine-readable form (the JSONL sink's span record)."""
        return {"name": self.name, "sid": self.sid, "parent": self.parent,
                "t0": self.t0, "dur_s": self.duration_s,
                "frame": self.frame, "attrs": self.attrs}


class _SpanContext:
    """Context manager for synchronous spans (allocated only when the
    tracer is enabled)."""
    __slots__ = ("_tracer", "span")

    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer = tracer
        self.span = span

    def __enter__(self) -> Span:
        self._tracer._stack.append(self.span)
        return self.span

    def __exit__(self, *exc) -> None:
        self._tracer._stack.pop()
        self._tracer.end(self.span)


class Tracer:
    """Span factory + completion buffer, driven by an injected clock."""

    def __init__(self, clock=time.perf_counter):
        self.clock = clock
        self.frame = 0               # current report-frame index
        self.enabled = True
        self._next_sid = 0
        self._stack: List[Span] = []     # open context-manager spans
        self._done: List[Span] = []      # completed, awaiting drain

    # -- span lifecycle ----------------------------------------------------
    def _new(self, name: str, parent: Optional[Span], attrs: Dict) -> Span:
        if parent is None and self._stack:
            parent = self._stack[-1]
        sid = self._next_sid
        self._next_sid += 1
        return Span(name, sid, None if parent is None else parent.sid,
                    self.clock(), attrs)

    def span(self, name: str, parent: Optional[Span] = None,
             **attrs) -> _SpanContext:
        """Synchronous span: ``with tracer.span(...) as s:``."""
        return _SpanContext(self, self._new(name, parent, attrs))

    def start(self, name: str, parent: Optional[Span] = None,
              **attrs) -> Span:
        """Open an asynchronous span; close it with ``end``.  Does NOT
        join the context-manager stack (overlapping waves are siblings,
        not nested)."""
        return self._new(name, parent, attrs)

    def end(self, span: Optional[Span], **attrs) -> None:
        """Close a span at the current clock, stamping the CURRENT frame
        index (retire-frame attribution — see module notes).  ``None``
        is accepted and ignored so call sites need no disabled-path
        branch."""
        if span is None:
            return
        span.t1 = self.clock()
        span.frame = self.frame
        if attrs:
            span.attrs.update(attrs)
        self._done.append(span)

    # -- buffer ------------------------------------------------------------
    def drain(self) -> List[Span]:
        """Completed spans since the last drain (sink feed)."""
        done, self._done = self._done, []
        return done


class _NullContext:
    """Shared no-op context manager (the disabled ``span`` result)."""
    __slots__ = ()
    span = None

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> None:
        return None


_NULL_CONTEXT = _NullContext()


class NullTracer:
    """Structurally inert tracer: no Span is ever allocated.  All call
    sites go through this singleton when obs is disabled, so the hot
    path's only cost is the call itself."""
    __slots__ = ()
    enabled = False
    frame = 0

    def span(self, name, parent=None, **attrs):
        return _NULL_CONTEXT

    def start(self, name, parent=None, **attrs):
        return None

    def end(self, span, **attrs):
        return None

    def drain(self):
        return []


NULL_TRACER = NullTracer()
