"""Unified telemetry for the serve/train runtimes: metrics registry +
span tracing + machine-readable sinks.

Both runtimes answer "where did this wave/round spend its time, on which
side of the cut, and did the cache/pipeline/DP machinery behave?"
through ONE subsystem:

* ``obs.metrics`` — typed Counter/Gauge/Histogram instruments with the
  delta-vs-gauge report taxonomy enforced in code (and the shared
  ``RecompileGuard`` signature counter the runtimes assert on).
* ``obs.trace`` — nestable spans with injected clocks.  Serve waves
  decompose into straggle_stall / plan / cache_probe / server_scan /
  client_scan / retire children; each scan into one ``server_step`` or
  ``client_step`` a step of the engine's loop (attrs ``step``,
  ``rows``), and each step into one ``model_call`` a call of the
  denoiser (the stacking and the DDPM-step launch, the step's glue,
  stay outside it).  Train rounds decompose into cohort_sample / plan /
  round_dispatch / barrier_stall / fedavg / checkpoint.  Wave and round
  spans close at OBSERVED completion (the ready-probe gauge) and are
  attributed to their retire frame.  Every synchronous span is also a
  ``repro.<name>`` range in any running ``torch.profiler`` session.
* ``obs.probe`` — the starvation probe: while tracing is on, the
  engine's ``probed_steps`` counter counts its steps and
  ``starved_steps`` those the device had finished the previous step
  before the host opened (a CUDA event after each step, queried without
  blocking at the next).
* ``obs.export`` — JSONL event stream, Perfetto/Chrome trace export,
  and an opt-in ``torch.profiler`` session.

THE OBS CONTRACT (pinned by the serve tests and the CLI smoke):

1. **Disabled is the default and structurally inert.**  A runtime built
   without an ObsConfig holds the NullTracer singleton — no Span objects,
   profiler ranges or probe events on the hot path, no sink IO, and
   reports/samples bitwise-identical
   to the pre-obs runtime.  (The metrics registry itself always runs:
   it IS the report mechanism, and its cost is integer adds the old
   hand-maintained dicts paid anyway.)
2. **Enabled never perturbs outputs.**  Tracing adds host-side clock
   reads, buffer appends, profiler ranges and the probe's event
   records and queries only: samples/params stay bitwise-identical
   to the disabled run and the engines see ZERO new signatures
   (asserted in both smokes).

JSONL schema (``schema`` = obs.export.OBS_SCHEMA_VERSION = 1), one JSON
object per line, flushed after each record or frame's batch of spans::

    {"schema":1,"kind":"meta","t":<s>, ...run header fields...}
    {"schema":1,"kind":"metrics","t":<s>,"frame":N,
     "metrics":{<counter deltas for frame N> + <gauge reads>}}
    {"schema":1,"kind":"span","t":<s>,"name":"wave","sid":7,"parent":null,
     "frame":N,"t0":<s>,"dur_s":<s>,"attrs":{"bucket":"cut4_b2_s1",...}}

Timestamps are the runtime clock's (``time.perf_counter`` seconds —
relative, monotonic); ``frame`` is the report-frame index the record
belongs to (a span that closes after ``finish_report`` N lands in frame
N+1, matching the ticket-percentile attribution).

Workflow::

    # live metrics + spans while a long-lived service runs:
    python -m repro_torch.launch.collab_serve --requests 64 --passes 8 \\
        --obs-jsonl /tmp/serve.jsonl --trace-out /tmp/serve_trace.json
    tail -f /tmp/serve.jsonl | python -c 'import sys,json; \\
        [print(json.loads(l)["kind"]) for l in sys.stdin]'

    # then load /tmp/serve_trace.json in https://ui.perfetto.dev (or
    # chrome://tracing): each wave is a lane; its plan/cache_probe/
    # server_scan/client_scan/straggle_stall children nest inside it,
    # and the steps and model calls inside the scans.

    # device-level truth for the first 8 waves (TensorBoard-loadable),
    # the spans as repro.* ranges over the host's ops:
    ... --profile-waves 8 --profile-dir /tmp/torchprof
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Optional

import torch

from repro_torch.obs.export import (OBS_SCHEMA_VERSION, JsonlSink, ProfilerHook,
                              chrome_trace_events, write_chrome_trace)
from repro_torch.obs.metrics import (DELTA, GAUGE, Counter, Gauge, Histogram,
                               MetricsRegistry, RecompileGuard, Snapshot)
from repro_torch.obs.probe import StarvationProbe
from repro_torch.obs.trace import NULL_TRACER, NullTracer, Span, Tracer


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """Observability knobs shared by both runtimes.  The default is
    fully disabled; setting any sink/profile field implies enabled."""
    enabled: bool = False
    jsonl_path: Optional[str] = None      # JSONL metrics+span stream
    trace_path: Optional[str] = None      # Perfetto/Chrome trace (on close)
    profile_waves: int = 0                # torch.profiler, first N waves
    profile_dir: Optional[str] = None     # profiler output directory

    @property
    def active(self) -> bool:
        return (self.enabled or self.jsonl_path is not None
                or self.trace_path is not None or self.profile_waves > 0)


class Telemetry:
    """One runtime's observability bundle: registry + tracer + sinks.

    The registry is ALWAYS live (reports derive from it); the tracer and
    sinks exist only when the config is active — otherwise the singleton
    NullTracer stands in and every sink hook is a no-op."""

    def __init__(self, config: Optional[ObsConfig] = None,
                 clock=time.perf_counter,
                 registry: Optional[MetricsRegistry] = None,
                 event=None):
        self.config = config or ObsConfig()
        self.clock = clock
        self._event = event       # the starvation probe's event factory
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.enabled = self.config.active
        self.tracer = Tracer(clock) if self.enabled else NULL_TRACER
        self._jsonl = (JsonlSink(self.config.jsonl_path, clock)
                       if self.config.jsonl_path else None)
        self._spans = []          # retained for the chrome trace export
        self.profiler = None
        if self.config.profile_waves > 0:
            outdir = self.config.profile_dir or os.path.join(
                tempfile.gettempdir(), "repro_torch_obs_profile")
            self.profiler = ProfilerHook(self.config.profile_waves, outdir)

    def starvation_probe(self, device) -> Optional[StarvationProbe]:
        """The engine's starvation probe while tracing is on: over CUDA
        events on a card, or over the injected ``event`` factory; None
        when tracing is off or a CPU run was given no factory."""
        if not self.enabled:
            return None
        if self._event is not None:
            return StarvationProbe(self.registry, self._event)
        if device.type == "cuda":
            return StarvationProbe(self.registry, torch.cuda.Event)
        return None

    def meta(self, **fields) -> None:
        if self._jsonl is not None:
            self._jsonl.meta(**fields)

    def step(self) -> None:
        """Once per wave/round — drives the opt-in profiler session."""
        if self.profiler is not None:
            self.profiler.step()

    def frame_closed(self, snap: Snapshot, extra: Optional[dict] = None
                     ) -> None:
        """Called by the runtimes at ``finish_report``: emit the frame's
        metrics record, flush completed spans to the JSONL sink, retain
        them for the trace export, and advance the frame index."""
        if not self.enabled:
            return
        done = self.tracer.drain()
        self._spans.extend(done)
        if self._jsonl is not None:
            values = self.registry.values(snap)
            if extra:
                values.update(extra)
            self._jsonl.metrics(self.tracer.frame, values)
            self._jsonl.spans(done)
        self.tracer.frame += 1

    def close(self) -> None:
        """Flush everything: remaining spans, the Perfetto trace file,
        any open profiler session, the JSONL stream."""
        if not self.enabled:
            return
        done = self.tracer.drain()
        self._spans.extend(done)
        if self._jsonl is not None:
            self._jsonl.spans(done)
        if self.config.trace_path is not None:
            write_chrome_trace(self.config.trace_path, self._spans)
        if self.profiler is not None:
            self.profiler.stop()
        if self._jsonl is not None:
            self._jsonl.close()

    def spans(self):
        """Completed spans retained so far (tests/exports; drains the
        tracer buffer first so late retirements are included)."""
        self._spans.extend(self.tracer.drain())
        return list(self._spans)


__all__ = ["DELTA", "GAUGE", "OBS_SCHEMA_VERSION", "Counter", "Gauge",
           "Histogram", "JsonlSink", "MetricsRegistry", "NullTracer",
           "NULL_TRACER", "ObsConfig", "ProfilerHook", "RecompileGuard",
           "Snapshot", "Span", "StarvationProbe", "Telemetry", "Tracer",
           "chrome_trace_events", "write_chrome_trace"]
