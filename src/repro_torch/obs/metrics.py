"""Typed metrics registry: the report substrate for both runtimes.

Reports are derived views over typed instruments, with the
delta-vs-gauge taxonomy of every report field enforced in code:

* **Counter** — monotone total over the instrument's lifetime.  A report
  frame never prints the total; it prints the DELTA between two
  snapshots (``MetricsRegistry.snapshot`` / ``deltas``), which is what
  makes summing report frames meaningful.  Every ``cache_*`` count,
  model-call count, and the recompile counter are Counters.
* **Gauge** — absolute state at read time (resident cache bytes, pending
  payloads, the round cursor).  Never summed across frames; an idle
  frame reports current occupancy, not zero.  Gauges can be backed by a
  callback (``fn=``) so the registry always reads live state.
* **Histogram** — an append-only series of observations (latencies,
  admission waits).  A frame's population is the window of observations
  recorded since its snapshot; percentiles are computed with the exact
  float64 ``np.percentile`` arithmetic the pre-obs reports used, so
  wiring reports through the registry is bitwise-neutral.

``declare`` additionally classifies report keys that are *derived*
(rates, percentiles, per-frame detail lists) rather than instrument-
backed, so a conformance test can require every
key of both runtimes' ``_empty_report`` to carry an explicit delta-or-
gauge classification — the "idle ticks must not change the report
shape" invariant is pinned mechanically instead of by prose.

``RecompileGuard`` is the shared signature guard: wrap an engine stage
and the guard's Counter bumps exactly when the stage first sees a new
argument signature — what a jit would compile.  The smokes assert on
its frame deltas (zero in steady state).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np

DELTA = "delta"   # per-frame difference of a monotone total (summable)
GAUGE = "gauge"   # absolute state at read time (never summed)

KINDS = (DELTA, GAUGE)


class Counter:
    """Monotone lifetime total; frames report snapshot deltas."""
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Absolute state: either ``set()`` explicitly or backed by ``fn``."""
    __slots__ = ("name", "fn", "value")

    def __init__(self, name: str, fn: Optional[Callable] = None):
        self.name = name
        self.fn = fn
        self.value = 0

    def set(self, v) -> None:
        self.value = v

    def read(self):
        return self.fn() if self.fn is not None else self.value


class Histogram:
    """Append-only observation series; frames window it by snapshot."""
    __slots__ = ("name", "values")

    def __init__(self, name: str):
        self.name = name
        self.values: List[float] = []

    def observe(self, v: float) -> None:
        self.values.append(float(v))

    @property
    def count(self) -> int:
        return len(self.values)

    def window(self, n0: int) -> np.ndarray:
        """Observations recorded since count was ``n0`` (float64 — the
        dtype the pre-obs percentile code used, kept for bitwise-equal
        report values)."""
        return np.asarray(self.values[n0:], np.float64)

    @staticmethod
    def percentile(window: np.ndarray, q: float) -> float:
        """The exact percentile arithmetic the hand-maintained reports
        used: float64 ``np.percentile``, 0.0 (never NaN) when empty."""
        return float(np.percentile(window, q)) if window.size else 0.0


@dataclasses.dataclass(frozen=True)
class Snapshot:
    """Frame-start marker: counter totals + histogram counts."""
    counters: Dict[str, int]
    hist_counts: Dict[str, int]


class MetricsRegistry:
    """Named instruments plus the delta/gauge classification of every
    report key derived from them.  One registry per runtime; report
    frames are snapshot/diff views over it."""

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, Histogram] = {}
        self._kinds: Dict[str, str] = {}

    # -- instruments -------------------------------------------------------
    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter(name)
            self._kinds.setdefault(name, DELTA)
        return c

    def gauge(self, name: str, fn: Optional[Callable] = None) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge(name, fn)
            self._kinds.setdefault(name, GAUGE)
        elif fn is not None:
            g.fn = fn
        return g

    def histogram(self, name: str) -> Histogram:
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = Histogram(name)
            self._kinds.setdefault(name, DELTA)
        return h

    # -- classification ----------------------------------------------------
    def declare(self, name: str, kind: str) -> None:
        """Classify a derived report key (rate, percentile, detail list)
        that no instrument backs directly.  Re-declaring with a
        different kind is a schema bug and raises."""
        if kind not in KINDS:
            raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
        prev = self._kinds.get(name)
        if prev is not None and prev != kind:
            raise ValueError(
                f"report key {name!r} already classified {prev!r}; "
                f"re-declaring it {kind!r} would fork the schema")
        self._kinds[name] = kind

    def declare_all(self, kinds: Dict[str, str]) -> None:
        for name, kind in kinds.items():
            self.declare(name, kind)

    def kind_of(self, name: str) -> Optional[str]:
        return self._kinds.get(name)

    def kinds(self) -> Dict[str, str]:
        return dict(self._kinds)

    # -- frame views -------------------------------------------------------
    def snapshot(self) -> Snapshot:
        return Snapshot(
            counters={n: c.value for n, c in self._counters.items()},
            hist_counts={n: h.count for n, h in self._hists.items()})

    def deltas(self, snap: Snapshot) -> Dict[str, int]:
        """Counter movement since ``snap``.  Counters created after the
        snapshot diff against an implicit zero baseline."""
        return {n: c.value - snap.counters.get(n, 0)
                for n, c in self._counters.items()}

    def delta(self, name: str, snap: Snapshot) -> int:
        return self.counter(name).value - snap.counters.get(name, 0)

    def window(self, name: str, snap: Snapshot) -> np.ndarray:
        return self.histogram(name).window(snap.hist_counts.get(name, 0))

    def read_gauge(self, name: str):
        return self.gauge(name).read()

    def values(self, snap: Optional[Snapshot] = None) -> Dict:
        """Flat machine-readable view for sinks: counter deltas (against
        ``snap``; lifetime totals when None) + gauge reads."""
        base = (self.deltas(snap) if snap is not None
                else {n: c.value for n, c in self._counters.items()})
        base.update({n: g.read() for n, g in self._gauges.items()})
        return base


def signature(obj):
    """Hashable shape signature of a call argument: tensors and arrays by
    (shape, dtype, device), containers element-wise, modules by class,
    scalars and strings by value (static arguments)."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, np.ndarray):
        return ("ndarray", obj.shape, obj.dtype.str)
    shape = getattr(obj, "shape", None)
    dtype = getattr(obj, "dtype", None)
    if shape is not None and dtype is not None:
        return ("tensor", tuple(shape), str(dtype),
                str(getattr(obj, "device", "")))
    if isinstance(obj, dict):
        return ("dict",) + tuple((k, signature(v))
                                 for k, v in sorted(obj.items()))
    if isinstance(obj, (list, tuple)):
        return (type(obj).__name__,) + tuple(signature(v) for v in obj)
    return ("object", type(obj).__name__)


class RecompileGuard:
    """The shared signature guard of both runtimes: the counterpart of a
    jit trace counter for eager PyTorch.

    ``wrap(fn)`` returns a callable that bumps the guard's Counter the
    FIRST time it sees an argument signature (``signature``: shapes,
    dtypes, devices, static scalars) and then runs ``fn`` — what a jit
    would compile once.  Its per-frame delta (via the registry snapshot)
    is the guard the smokes assert on: zero in steady state.  One guard
    may wrap several stages (the split serve engine); each wrapped stage
    keeps its own set of seen signatures and the count is the total."""

    def __init__(self, counter: Counter):
        self._counter = counter

    @property
    def count(self) -> int:
        return self._counter.value

    def wrap(self, fn: Callable) -> Callable:
        seen = set()

        def guarded(*args, **kwargs):
            sig = (signature(args), signature(kwargs))
            if sig not in seen:
                seen.add(sig)
                self._counter.inc()
            return fn(*args, **kwargs)
        return guarded
