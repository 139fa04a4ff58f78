"""Telemetry sinks: JSONL stream, Perfetto/Chrome trace, profiler hook.

* **JsonlSink** — one JSON object per line, schema-versioned
  (``OBS_SCHEMA_VERSION``), flushed after each record (a frame's spans:
  once, after the batch) and always at a line's end, so ``tail -f`` (or
  any line-at-a-time consumer) sees complete records.  Three kinds:
  ``meta`` (run header), ``metrics`` (one per closed report frame:
  counter deltas + gauge reads + the frame's report scalars), ``span``
  (one per completed span).  Every record carries ``schema`` and ``t``
  (the sink clock's timestamp at write).
* **write_chrome_trace** — exports completed spans as a Chrome
  trace-event JSON (``{"traceEvents": [...]}``, complete "X" events in
  microseconds) that chrome://tracing and https://ui.perfetto.dev load
  directly; parent links are preserved in ``args`` and waves/rounds
  carry their attrs, so the wave → plan/cache/scan/stall decomposition
  is visible as nested slices.
* **ProfilerHook** — opt-in ``torch.profiler`` session around the
  first N waves/rounds (``--profile-waves``), exported as a Chrome trace
  of host ops and CUDA kernels.  Device-level truth for when span-level
  host accounting isn't enough;
  failures to start the profiler (missing backend support) degrade to a
  warning, never an error — profiling is observability, not semantics.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

from repro_torch.obs.trace import Span

OBS_SCHEMA_VERSION = 1


def _jsonable(v):
    """Best-effort plain-JSON coercion for attr values (numpy scalars,
    tuples); unknown objects fall back to ``repr`` rather than raising —
    a sink must never take down the serving loop."""
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    try:
        import numpy as np
        if isinstance(v, np.generic):
            return v.item()
    except ImportError:                              # pragma: no cover
        pass
    return repr(v)


class JsonlSink:
    """Append-only JSONL event stream; safe to ``tail -f``."""

    def __init__(self, path: str, clock):
        self.path = path
        self._clock = clock
        self._fh = open(path, "a")

    @staticmethod
    def _line(record: Dict) -> str:
        return json.dumps(_jsonable(record), sort_keys=True) + "\n"

    def _write(self, record: Dict) -> None:
        self._fh.write(self._line(record))
        self._fh.flush()

    def meta(self, **fields) -> None:
        self._write({"schema": OBS_SCHEMA_VERSION, "kind": "meta",
                     "t": self._clock(), **fields})

    def metrics(self, frame: int, values: Dict) -> None:
        self._write({"schema": OBS_SCHEMA_VERSION, "kind": "metrics",
                     "t": self._clock(), "frame": frame,
                     "metrics": values})

    def spans(self, spans: Sequence[Span]) -> None:
        """A frame's span records in one write and one flush (the engine
        emits about a thousand a wave), stamped with the write's time."""
        if not spans:
            return
        t = self._clock()
        self._fh.write("".join(
            self._line({"schema": OBS_SCHEMA_VERSION, "kind": "span",
                        "t": t, **s.as_event()}) for s in spans))
        self._fh.flush()

    def close(self) -> None:
        if not self._fh.closed:
            self._fh.close()


def chrome_trace_events(spans: Sequence[Span],
                        pid: int = 1) -> List[Dict]:
    """Spans → Chrome trace-event list (complete "X" events, µs).

    Chrome/Perfetto nest slices by time containment per track; putting
    every span on its wave's track (tid = root span id) makes each
    wave/round a self-contained lane whose children nest inside it, and
    overlapping pipelined waves render side by side instead of
    interleaving."""
    roots: Dict[int, int] = {}
    for s in sorted(spans, key=lambda s: s.sid):
        roots[s.sid] = roots.get(s.parent, s.sid) \
            if s.parent is not None else s.sid
    events = []
    for s in spans:
        if s.t1 < 0.0:                   # still open: not exportable
            continue
        events.append({
            "name": s.name, "ph": "X", "pid": pid,
            "tid": roots.get(s.sid, s.sid),
            "ts": s.t0 * 1e6, "dur": s.duration_s * 1e6,
            "args": _jsonable({"sid": s.sid, "parent": s.parent,
                               "frame": s.frame, **s.attrs}),
        })
    return events


def write_chrome_trace(path: str, spans: Sequence[Span]) -> None:
    with open(path, "w") as f:
        json.dump({"traceEvents": chrome_trace_events(spans),
                   "displayTimeUnit": "ms"}, f)


class ProfilerHook:
    """Run a ``torch.profiler`` session from the first wave/round and stop
    it after ``n``, writing ``<outdir>/trace.json`` (Chrome trace: host
    ops and, on a card, CUDA kernels).  ``step()`` is called once per
    wave/round by the runtimes (only when obs is enabled, so the disabled
    hot path never sees it).  ``profiler`` builds the session (tests
    inject a fake)."""

    def __init__(self, n: int, outdir: str, profiler=None):
        self._make = profiler if profiler is not None else _torch_profile
        self._session = None
        self.n = n
        self.outdir = outdir
        self.seen = 0
        self.active = False
        self.failed: Optional[str] = None

    def step(self) -> None:
        if self.failed is not None or self.n <= 0:
            return
        if self.seen == 0 and not self.active:
            try:
                self._session = self._make()
                self._session.__enter__()
                self.active = True
            except Exception as e:     # profiling must never break serving
                self.failed = f"profiler start failed: {e!r}"
                return
        self.seen += 1
        if self.active and self.seen >= self.n:
            self.stop()

    def stop(self) -> None:
        if not self.active:
            return
        try:
            self._session.__exit__(None, None, None)
            os.makedirs(self.outdir, exist_ok=True)
            self._session.export_chrome_trace(
                os.path.join(self.outdir, "trace.json"))
        except Exception as e:                       # pragma: no cover
            self.failed = f"profiler stop failed: {e!r}"
        self.active = False


def _torch_profile():
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)
