"""Starvation probe: does the device wait for the host between engine steps?

At the close of each engine step the probe records an event on the
stream after the step's last launch; when the host opens the next step
it asks, without blocking, whether that event has completed.  If it has,
the device finished everything the previous step queued before the host
began this one: the device was starved, and the host set the pace.  If
not, the host is ahead and the device sets the pace.

``probed_steps`` counts every step opened, ``starved_steps`` the starved
ones (a step with no earlier step recorded counts as starved: nothing of
the engine's was queued).  Completion order on one stream is exact and no
timestamp is read, so the reading has no clock to map and no drift, and
it holds without a profiler attached.

Two plain (non-timing) events are reused in turn: recording one while
the other is still queried never re-records the event being asked about.
The serve runtime builds a probe only while tracing is on (``Telemetry.
starvation_probe``); the event factory is injected, so tests drive the
probe with scripted events on the CPU.
"""
from __future__ import annotations

from typing import Callable

from repro_torch.obs.metrics import MetricsRegistry


class StarvationProbe:
    """``open()`` at the start of an engine step, ``close()`` after its
    last launch.  ``event`` makes an object with ``record()`` and a
    non-blocking ``query()`` (``torch.cuda.Event`` on a card)."""
    __slots__ = ("_probed", "_starved", "_events", "_next", "_last")

    def __init__(self, registry: MetricsRegistry, event: Callable):
        self._probed = registry.counter("probed_steps")
        self._starved = registry.counter("starved_steps")
        self._events = (event(), event())
        self._next = 0
        self._last = None

    def open(self) -> None:
        self._probed.inc()
        if self._last is None or self._last.query():
            self._starved.inc()

    def close(self) -> None:
        e = self._events[self._next]
        self._next ^= 1
        e.record()
        self._last = e
