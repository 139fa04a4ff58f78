"""CollaFuse serve runtime — persistent collaborative sampling under
repeated traffic, on one CUDA device (or the CPU when asked).

* **Queue → scheduler → cache probe → engine → cache fill → report.**
  ``ServeRuntime.process(queue)`` drains a queue of SampleRequests: the
  shape-stable scheduler (serve/scheduler.py) buckets requests by cut
  depth and chunks them into waves; each wave is planned on the host
  (core/sample_plan.plan_requests) with a cache probe per unique (y, t_ζ,
  stride) group — hits inject their stored handoff x̂_{t_ζ} and skip the
  server phase physically; the padded tables go to the device once
  (pinned, non-blocking) and run through the engine's server and client
  stages (core/sampler.make_sample_engine(split=True)); fresh handoffs
  enter the cross-wave LRU cache (serve/prefix_cache.py); the report
  aggregates latency, throughput, hit rate, physical-vs-logical model
  calls and new signatures.
* **Stable keying is the load-bearing invariant.**  The runtime holds ONE
  base threefry key (``rotate_key`` swaps it deliberately); a group's
  server noise depends only on (base key, a content-derived seed) and a
  request's client noise only on (base key, its arrival id).  So a cached
  handoff is bitwise-valid in any later wave (warm == cold), and
  bucketing, padding, admission timing and pipelining cannot perturb
  outputs — they are performance knobs, never semantics.
* **Batch invariance on the card.**  Each model call sees one group's or
  one request's (B, H, W, C) batch, and the runtime sets cuDNN to
  deterministic, shape-chosen algorithms with TF32 off
  (device.deterministic_cuda), so a row's bits do not depend on which
  other requests share its wave.
* **Shape stability.**  pad_plan pads the request axis to max_wave and
  the scan/inject group axes to power-of-two tiers with inert rows;
  steady traffic converges to ONE signature per bucket, counted by the
  ``RecompileGuard`` (obs/metrics.py) the smoke asserts on.
* **Accounting: physical vs logical.**  ``server_calls_saved_by_dedup``
  and ``..._by_cache`` count logical savings; ``padded_model_calls``
  counts the physical padding the engine still executes.  All counts
  come from the host tables, never from device reads.
* **Pipelined waves without host syncs.**  Each wave dispatches its
  server and client stages on the current CUDA stream and records a
  ``torch.cuda.Event`` after the client stage; nothing in dispatch reads
  a device tensor back, so the host plans wave i+1 (and enqueues its
  server stage) while the card still runs wave i.  A double-buffered
  window (at most two waves in flight) bounds device memory; a wave
  retires when its event is observed complete (``Event.query``, the
  latency gauge) or, when the window is full, by ``Event.synchronize``.
  One stream: a cache entry inserted while still in flight is read by a
  later wave queued behind it on that stream.  On the CPU every stage
  completes when it returns.
* **Continuous admission: ``policy="continuous"``.**  ``submit()``
  appends tickets to per-bucket pending deques, ``poll()`` forms and
  dispatches a wave whenever the in-flight window has a free slot, and
  ``drain()`` runs poll to completion; ``process()`` on a continuous
  runtime is submit + drain.  Continuous output is bitwise equal to
  depth-bucketed output for the same arrival order.
* **Per-request SLO accounting.**  Every request gets a RequestTicket with
  enqueue / admit / dispatch / retire timestamps; the report aggregates
  latency and admission-wait percentiles and deadline misses.  SLOs never
  steer scheduling.
* **Observability.**  Reports are derived views over the metrics registry
  (repro_torch.obs); with an active ObsConfig each wave opens a span
  decomposed into straggle_stall / plan / cache_probe / server_scan /
  client_scan children that closes at observed completion; the engine
  adds a span per step and per model call inside the scans and, on a
  card, the starvation probe (``probed_steps`` / ``starved_steps``,
  which stay 0 while tracing is off).  Disabled is structurally inert;
  enabled never perturbs outputs.

Every mode of this runtime (pipelined or sequential, any scheduler
policy, cache on or off, obs on or off) produces bitwise-identical
samples for the same base key and arrival order.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict, deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.sample_plan import (GroupKey, SamplePlan,
                                          SampleRequest, call_accounting,
                                          inject_to_device, pad_plan,
                                          plan_requests, stable_group_seed,
                                          tables_to_device)
from repro_torch.core.sampler import (check_engine_plan, client_list,
                                      make_sample_engine)
from repro_torch.core.schedules import DiffusionSchedule
from repro_torch.device import deterministic_cuda, resolve_device
from repro_torch.obs import DELTA, GAUGE, ObsConfig, RecompileGuard, \
    Telemetry
from repro_torch.obs.metrics import Histogram
from repro_torch.serve.prefix_cache import PrefixCache
from repro_torch.serve.scheduler import WaveBucket, WaveScheduler

# Delta-vs-gauge classification of every serve report key (the taxonomy
# _empty_report documents, now enforced by the registry + conformance
# test).  DELTA keys describe the report frame only (summing frames is
# meaningful); GAUGE keys are absolute resident state at report time.
_SERVE_REPORT_SCHEMA = {
    "requests": DELTA, "waves": DELTA, "buckets": DELTA, "wall_s": DELTA,
    "req_per_s": DELTA, "samples_per_s": DELTA,
    "latency_p50_s": DELTA, "latency_p95_s": DELTA, "latency_p99_s": DELTA,
    "admit_wait_p50_s": DELTA, "admit_wait_p95_s": DELTA,
    "slo_tracked": DELTA, "slo_misses": DELTA, "slo_miss_rate": DELTA,
    "per_request": DELTA,
    "server_calls_physical": DELTA, "server_calls_logical": DELTA,
    "client_calls_physical": DELTA, "client_calls_logical": DELTA,
    "padded_model_calls": DELTA,
    "server_calls_saved_by_dedup": DELTA,
    "server_calls_saved_by_cache": DELTA,
    "requests_from_cache": DELTA, "engine_traces": DELTA,
    "signatures_per_bucket": DELTA, "max_signatures_per_bucket": DELTA,
    "cache_hits": DELTA, "cache_misses": DELTA, "cache_hit_rate": DELTA,
    "cache_insertions": DELTA, "cache_evictions": DELTA,
    "cache_rejected": DELTA,
    "cache_entries": GAUGE, "cache_bytes": GAUGE,
    "probed_steps": DELTA, "starved_steps": DELTA,
}


def _key_fingerprint(key) -> bytes:
    """Stable bytes of a threefry key — its two uint32 words, the same
    bytes as the JAX package's key data — for cache keys."""
    return prng.key_data(key).tobytes()


def _params_to(params, device):
    """Move a model or a tree of tensors to ``device``."""
    if isinstance(params, torch.nn.Module):
        return params.to(device)
    if isinstance(params, torch.Tensor):
        return params.to(device)
    if isinstance(params, dict):
        return {k: _params_to(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(_params_to(v, device) for v in params)
    return params


def _is_ready(done) -> bool:
    """Non-blocking readiness probe of a wave's completion event (None on
    the CPU, where a stage has finished when it returns)."""
    return done is None or done.query()


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    T: int
    image_shape: Tuple[int, ...]          # per-sample trailing (H, W, C)
    max_wave: int = 8
    policy: str = "depth"    # "depth" | "fifo" (arrival order) |
    #                          "continuous" (admission at wave boundaries)
    server_stride: int = 1                # >1 ⇒ strided DDIM server phase
    adjusted: bool = True
    cache: bool = True
    cache_max_bytes: int = 64 << 20
    cache_max_entries: Optional[int] = None
    pipeline: bool = True                 # False ⇒ per-wave barrier baseline
    straggle_s: float = 0.0               # host-side stall before each wave


@dataclasses.dataclass
class RequestTicket:
    """Per-request admission + SLO record.  Timestamps are absolute
    ``time.perf_counter()`` seconds; -1.0 marks a stage not reached yet.
    ``rid`` is the runtime-lifetime arrival id — it seeds the request's
    client noise (arrival-stable randomness) AND orders continuous
    admission (scheduler.admit pops oldest-rid-first)."""
    rid: int
    request: SampleRequest
    slo_s: Optional[float] = None
    t_enqueue: float = -1.0
    t_admit: float = -1.0
    t_dispatch: float = -1.0
    t_retire: float = -1.0
    output: Optional[torch.Tensor] = None
    span_id: Optional[int] = None      # its wave's span (None: obs off)

    @property
    def latency_s(self) -> float:
        return self.t_retire - self.t_enqueue

    @property
    def admit_wait_s(self) -> float:
        return self.t_admit - self.t_enqueue

    @property
    def slo_miss(self) -> bool:
        return self.slo_s is not None and self.latency_s > self.slo_s

    def as_row(self, t0: float) -> Dict:
        """Report row; times relative to the report frame's start (an
        open-loop arrival handed in via ``enqueue_t`` can legitimately
        predate the frame — its ``enqueue_s`` is then negative)."""
        rel = lambda t: t - t0 if t >= 0.0 else -1.0
        return {"rid": self.rid, "client": self.request.client,
                "t_cut": self.request.t_cut,
                "enqueue_s": self.t_enqueue - t0,
                "admit_s": rel(self.t_admit),
                "dispatch_s": rel(self.t_dispatch),
                "retire_s": rel(self.t_retire),
                "latency_s": self.latency_s,
                "admit_wait_s": self.admit_wait_s,
                "slo_s": self.slo_s, "slo_miss": self.slo_miss,
                "span_id": self.span_id}


class _Frame:
    """One reporting interval: a registry SNAPSHOT plus the frame's
    retired-ticket population and signature-set detail.  process() opens
    and closes a frame per call; poll-driven serving opens one with
    start_report() and closes it with finish_report() whenever a report
    is wanted — tickets retired during the frame are the frame's
    population (their enqueue may predate it; latency stays honest
    because timestamps are absolute).  Every numeric delta the old
    hand-maintained accumulators tracked is now a counter movement
    between this snapshot and report time."""

    def __init__(self, registry, clock):
        self.t0 = clock()
        self.snap = registry.snapshot()
        self.sigs: Dict[str, set] = {}
        self.retired: List[RequestTicket] = []


class ServeRuntime:
    """The persistent serving loop.  Construct once, ``process`` queues
    (or ``submit``/``poll`` a continuous stream) forever; the cache, seed
    registries, and compiled signatures persist across calls (that
    persistence IS the subsystem)."""

    def __init__(self, config: ServeConfig, server_params, client_params,
                 apply_fn, sched: DiffusionSchedule, key,
                 obs=None, device=None):
        if sched.T != config.T:
            raise ValueError(f"schedule T {sched.T} != config T {config.T}")
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            deterministic_cuda()
        self.config = config
        self.server_params = _params_to(server_params, self.device)
        self.client_params = [_params_to(p, self.device)
                              for p in client_list(client_params)]
        self.n_clients = len(self.client_params)
        sched = sched.to(self.device)
        key = key.to(self.device)
        self.sched = sched
        self.scheduler = WaveScheduler(config.max_wave, config.policy,
                                       stride=config.server_stride)
        # -- observability: registry (always live — it IS the report
        # mechanism), tracer + sinks (only when an ObsConfig is active)
        self._obs = obs if isinstance(obs, Telemetry) \
            else Telemetry(obs if isinstance(obs, ObsConfig) else None)
        self._clock = self._obs.clock
        self.registry = self._obs.registry
        self.registry.declare_all(_SERVE_REPORT_SCHEMA)
        self._c = {name: self.registry.counter(name) for name in (
            "waves", "n_samples", "requests_retired",
            "server_calls_physical", "server_calls_logical",
            "client_calls_physical", "client_calls_logical",
            "padded_model_calls", "server_calls_saved_by_dedup",
            "server_calls_saved_by_cache", "requests_from_cache",
            "scan_steps")}
        self._hist_latency = self.registry.histogram("latency_s")
        self._hist_wait = self.registry.histogram("admit_wait_s")
        self.cache = PrefixCache(config.cache_max_bytes,
                                 config.cache_max_entries) \
            if config.cache else None
        if self.cache is not None:
            self.cache.bind_instruments(self.registry)
        self.scheduler.bind_instruments(self.registry)
        self._key = key
        self._key_fp = _key_fingerprint(key)
        self._next_rid = 0
        # continuous-admission state: per-bucket pending tickets and the
        # (shared) double-buffered in-flight window (each entry carries
        # its wave span — None while obs is disabled)
        self._pending: "OrderedDict[WaveBucket, Deque[RequestTicket]]" = \
            OrderedDict()
        self._inflight: "Deque[Tuple[torch.Tensor, Tuple[RequestTicket, ...], object, object]]" \
            = deque()
        self._frame: Optional[_Frame] = None

        raw_server, raw_client = make_sample_engine(
            sched, apply_fn, config.image_shape,
            server_ddim=config.server_stride > 1, split=True,
            tracer=self._obs.tracer,
            probe=self._obs.starvation_probe(self.device))

        # the shared RecompileGuard (obs/metrics.py) counts the first
        # sighting of each stage's argument signature — the counterpart
        # of a jit compile, which the smoke asserts is zero in steady
        # state.  Cold traffic shows TWO stages per signature.
        self._guard = RecompileGuard(self.registry.counter("engine_traces"))
        self._server_stage = self._guard.wrap(raw_server)
        self._client_stage = self._guard.wrap(raw_client)
        self._obs.meta(runtime="serve", policy=config.policy,
                       max_wave=config.max_wave, T=config.T,
                       cache=config.cache, pipeline=config.pipeline)

    @property
    def traces(self) -> int:
        """Lifetime count of new engine-stage signatures — the shared
        RecompileGuard's counter."""
        return self._guard.count

    @property
    def obs(self) -> Telemetry:
        """The runtime's telemetry bundle (registry + tracer + sinks).
        Long-lived callers call ``obs.close()`` at shutdown to flush the
        JSONL stream / Perfetto trace / profiler session."""
        return self._obs

    # -- stable identities -------------------------------------------------
    # Server-noise seeds are sample_plan.stable_group_seed — a digest of
    # the (y, t_ζ, stride) content, so the same prefix gets the same
    # trajectory in every wave, runtime, and scheduler policy.  The cache
    # key appends the seed and base-key fingerprint: the (y, t_ζ, key
    # schedule, stride) identity of the stored x̂_{t_ζ}.
    def _cache_key(self, gk: GroupKey):
        return (gk, stable_group_seed(gk), self._key_fp)

    def _lookup(self, gk: GroupKey):
        return self.cache.lookup(self._cache_key(gk))

    def rotate_key(self, key) -> None:
        """Key rotation for long-lived deployments:
        swap the base PRNG key and start a fresh cache epoch.  Every
        resident entry is addressed by the OLD key fingerprint and could
        never serve a hit again, so they are dropped via
        PrefixCache.clear() — counted as a clear epoch, not as evictions.
        Refused while requests are pending or in flight (their seeds were
        drawn under the old key) and while a report frame is open (the
        frame's cache-delta baseline belongs to the old epoch)."""
        if self.busy:
            raise RuntimeError("rotate_key with requests pending/in flight")
        if self._frame is not None:
            raise RuntimeError("rotate_key inside an open report frame; "
                               "finish_report() first")
        self._key = key.to(self.device)
        self._key_fp = _key_fingerprint(key)
        if self.cache is not None:
            self.cache.clear()

    def rotate_for_epoch(self, epoch: int, base_key) -> bool:
        """DP-epoch-tied key rotation:
        hook this as the train runtime's ``on_dp_epoch`` callback and the
        serve cache turns over its key schedule at EXACTLY the DP release
        boundary — cached x̂_{t_ζ} prefixes computed under the
        pre-release nets never outlive the privacy epoch they were drawn
        in.  The rotated key is the ADDRESSED ``fold_in(base_key,
        epoch)`` (never chained off the previous rotation), and the call
        is IDEMPOTENT per epoch: replaying a round after a checkpoint
        resume re-fires the callback without clearing the cache twice.
        Returns True when a rotation actually happened."""
        if epoch < 0:
            raise ValueError(f"epoch must be >= 0, got {epoch}")
        if getattr(self, "_rotated_epoch", None) == int(epoch):
            return False
        self.rotate_key(prng.fold_in(base_key.to(self.device), int(epoch)))
        self._rotated_epoch = int(epoch)
        return True

    # -- reporting ---------------------------------------------------------
    def _empty_report(self) -> Dict:
        """Zeroed report with the FULL key set — idle ticks must not
        change the report shape consumers sum over.

        Cache field semantics: every ``cache_*`` field
        except the last two is a DELTA for this ``process`` call /
        report frame — hits/misses/hit_rate/insertions/evictions/
        rejected all reset to zero per frame, so summing reports across
        frames is meaningful.  ``cache_entries`` and ``cache_bytes`` are
        GAUGES — absolute resident state at report time (an idle tick
        reports the current occupancy, not zero); never sum them.

        Latency field semantics: ``latency_*``/``admit_wait_*``
        are percentiles over the requests RETIRED in the frame, from the
        ticket timestamps (enqueue → observed-ready; see module notes on
        the ready-probe gauge); an empty frame reports 0.0, never NaN.
        ``slo_*`` count only tickets that carried a deadline;
        ``per_request`` holds the raw ticket rows (a list — inspect it,
        don't sum it)."""
        report = {
            "requests": 0, "waves": 0, "buckets": 0, "wall_s": 0.0,
            "req_per_s": 0.0, "samples_per_s": 0.0,
            "latency_p50_s": 0.0, "latency_p95_s": 0.0,
            "latency_p99_s": 0.0,
            "admit_wait_p50_s": 0.0, "admit_wait_p95_s": 0.0,
            "slo_tracked": 0, "slo_misses": 0, "slo_miss_rate": 0.0,
            "per_request": [],
            "server_calls_physical": 0, "server_calls_logical": 0,
            "client_calls_physical": 0, "client_calls_logical": 0,
            "padded_model_calls": 0,
            "server_calls_saved_by_dedup": 0,
            "server_calls_saved_by_cache": 0,
            "requests_from_cache": 0, "engine_traces": 0,
            "signatures_per_bucket": {}, "max_signatures_per_bucket": 0,
            "probed_steps": 0, "starved_steps": 0,
        }
        if self.cache is not None:
            report.update({
                # deltas (per-frame)
                "cache_hits": 0, "cache_misses": 0, "cache_hit_rate": 0.0,
                "cache_insertions": 0, "cache_evictions": 0,
                "cache_rejected": 0,
                # gauges (absolute resident state)
                "cache_entries": len(self.cache),
                "cache_bytes": self.cache.stats.bytes_in_use,
            })
        return report

    def start_report(self) -> None:
        """Open a fresh accounting frame.  process() does this per call;
        poll-driven serving calls it explicitly (submit/poll open one
        lazily if none is open)."""
        self._frame = _Frame(self.registry, self._clock)

    def finish_report(self) -> Dict:
        """Close the open frame and return its report — a DERIVED VIEW
        over the metrics registry: counter deltas against the frame's
        snapshot, percentile windows over the frame's histogram
        observations, gauge reads at close.  Legal while requests are
        still pending/in flight (a long-lived service reports
        periodically): the frame covers what RETIRED during it; in-flight
        work lands in the next frame."""
        f, self._frame = self._frame, None
        if f is None:
            raise RuntimeError("finish_report without start_report")
        reg = self.registry
        d = lambda name: reg.delta(name, f.snap)
        wall = self._clock() - f.t0
        done = f.retired
        lat = reg.window("latency_s", f.snap)
        wait = reg.window("admit_wait_s", f.snap)
        pct = Histogram.percentile
        tracked = [t for t in done if t.slo_s is not None]
        misses = sum(1 for t in tracked if t.slo_miss)
        report = self._empty_report()
        report.update({
            "requests": len(done), "waves": d("waves"),
            "buckets": len(f.sigs), "wall_s": wall,
            "req_per_s": len(done) / wall if wall > 0 else 0.0,
            "samples_per_s": d("n_samples") / wall if wall > 0 else 0.0,
            "latency_p50_s": pct(lat, 50),
            "latency_p95_s": pct(lat, 95),
            "latency_p99_s": pct(lat, 99),
            "admit_wait_p50_s": pct(wait, 50),
            "admit_wait_p95_s": pct(wait, 95),
            "slo_tracked": len(tracked), "slo_misses": misses,
            "slo_miss_rate": misses / len(tracked) if tracked else 0.0,
            "per_request": [t.as_row(f.t0) for t in done],
            "server_calls_physical": d("server_calls_physical"),
            "server_calls_logical": d("server_calls_logical"),
            "client_calls_physical": d("client_calls_physical"),
            "client_calls_logical": d("client_calls_logical"),
            "padded_model_calls": d("padded_model_calls"),
            "server_calls_saved_by_dedup": d("server_calls_saved_by_dedup"),
            "server_calls_saved_by_cache": d("server_calls_saved_by_cache"),
            "requests_from_cache": d("requests_from_cache"),
            "engine_traces": d("engine_traces"),
            "signatures_per_bucket": {b: len(s)
                                      for b, s in f.sigs.items()},
            "max_signatures_per_bucket": max(
                (len(s) for s in f.sigs.values()), default=0),
            "probed_steps": d("probed_steps"),
            "starved_steps": d("starved_steps"),
        })
        if self.cache is not None:
            d_hits, d_miss = d("cache_hits"), d("cache_misses")
            report.update({
                "cache_hits": d_hits, "cache_misses": d_miss,
                "cache_hit_rate": d_hits / (d_hits + d_miss)
                if d_hits + d_miss else 0.0,
                "cache_insertions": d("cache_insertions"),
                "cache_evictions": d("cache_evictions"),
                "cache_rejected": d("cache_rejected"),
                "cache_entries": reg.read_gauge("cache_entries"),
                "cache_bytes": reg.read_gauge("cache_bytes"),
            })
        self._obs.frame_closed(f.snap, extra={
            "wall_s": wall, "requests": len(done),
            "latency_p50_s": report["latency_p50_s"],
            "latency_p95_s": report["latency_p95_s"],
            "latency_p99_s": report["latency_p99_s"]})
        return report

    # -- wave execution (shared by process and poll) -----------------------
    def _stall(self, seconds: float) -> None:
        """Host-side stall (slow arrivals, planning, IO).  Sleeps in
        ~1 ms slices, probing the in-flight window between slices, so a
        wave finishing on-device mid-stall is retired (and its latency
        time-stamped) the moment it is observably done — not after the
        stall plus the next dispatch.  Sleep releases the GIL, so in
        pipeline mode the accelerator keeps chewing the in-flight waves
        underneath it."""
        deadline = self._clock() + seconds
        while True:
            self._reap()
            rem = deadline - self._clock()
            if rem <= 0.0:
                return
            time.sleep(min(rem, 0.001))

    def _reap(self) -> None:
        """Retire every in-flight wave whose result is observably ready
        (oldest first; retirement order is FIFO regardless of probing)."""
        while self._inflight and _is_ready(self._inflight[0][3]):
            self._retire(block=True)       # ready ⇒ returns immediately

    def _retire(self, block: bool = True) -> bool:
        """Retire the oldest in-flight wave: block on (or probe) its
        result, stamp ``t_retire`` at the moment completion is OBSERVED,
        and scatter outputs to tickets.  Returns False if non-blocking
        and the result is not ready (or nothing is in flight)."""
        if not self._inflight:
            return False
        if not block and not _is_ready(self._inflight[0][3]):
            return False
        out, tickets, wspan, done = self._inflight.popleft()
        tr = self._obs.tracer
        t0w = self._clock()
        with tr.span("retire", parent=wspan, n_requests=len(tickets)):
            if done is not None:
                done.synchronize()
        now = self._clock()
        for j, t in enumerate(tickets):
            t.t_retire = now
            t.output = out[j]
            self._hist_latency.observe(t.latency_s)
            self._hist_wait.observe(t.admit_wait_s)
        self._c["requests_retired"].inc(len(tickets))
        self._frame.retired.extend(tickets)
        tr.end(wspan, device_wait_s=now - t0w)
        return True

    def _dispatch(self, label: str, tickets: List[RequestTicket]) -> None:
        """Plan and dispatch one wave of tickets (all one bucket for
        depth/continuous; one B for fifo).  Stamps admit before planning
        and dispatch after the engine stages are launched; appends the
        un-materialized output (plus its wave span) to the in-flight
        window.  With obs enabled the wave span opens here and closes at
        OBSERVED completion in ``_retire``; its children decompose the
        host-side work (straggle_stall / plan / cache_probe /
        server_scan / client_scan)."""
        cfg = self.config
        tr = self._obs.tracer
        wspan = tr.start("wave", bucket=label,
                         wave=self._c["waves"].value,
                         n_requests=len(tickets),
                         rids=[t.rid for t in tickets])
        self._obs.step()
        if cfg.straggle_s > 0.0:
            with tr.span("straggle_stall", parent=wspan,
                         seconds=cfg.straggle_s):
                self._stall(cfg.straggle_s)
        now = self._clock()
        sid = None if wspan is None else wspan.sid
        for t in tickets:
            t.t_admit = now
            t.span_id = sid
        use_cache = self.cache is not None
        lookup = self._lookup
        if use_cache and tr.enabled:
            # span-per-probe wrapper, installed ONLY when tracing — the
            # disabled path hands plan_requests the raw bound method
            def lookup(gk, _raw=self._lookup, _tr=tr, _w=wspan):
                with _tr.span("cache_probe", parent=_w):
                    return _raw(gk)
        with tr.span("plan", parent=wspan, bucket=label):
            plan = plan_requests(
                [t.request for t in tickets], cfg.T, adjusted=cfg.adjusted,
                n_clients=self.n_clients,
                server_stride=cfg.server_stride,
                group_seed_fn=stable_group_seed,
                # arrival ids grow forever; mask to int31 for the tables
                # (a seed epoch repeats only after ~2.1e9 requests)
                request_seeds=[t.rid & 0x7FFFFFFF for t in tickets],
                lookup_fn=lookup if use_cache else None,
                image_shape=cfg.image_shape if use_cache else None,
                device=self.device)
            check_engine_plan(cfg.server_stride > 1, plan)
            padded = pad_plan(
                plan,
                n_groups=self.scheduler.group_tier(plan.n_groups),
                n_requests=self.scheduler.max_wave,
                n_inject=self.scheduler.inject_tier(plan.n_hits)
                if plan.inject is not None else None)
            tables = tables_to_device(padded.tables, self.device)
            inject = inject_to_device(padded.inject, self.device)
        with tr.span("server_scan", parent=wspan, n_groups=plan.n_groups):
            handoff = self._server_stage(self.server_params, self._key,
                                         tables)
            if use_cache:
                for g in range(plan.n_groups):
                    # zero-step (ICM) prefixes are uncacheable by design;
                    # don't churn the rejected counter every wave.  The
                    # inserted handoff row may still be in flight on the
                    # stream — a later wave's hit is queued behind it —
                    # so this fill point matches the sequential loop's
                    # exactly and cache behavior stays bitwise identical.
                    if plan.group_steps[g] > 0:
                        self.cache.insert(
                            self._cache_key(plan.group_keys[g]),
                            handoff[g], plan.group_steps[g])
        with tr.span("client_scan", parent=wspan, n_hits=plan.n_hits):
            out = self._client_stage(self.client_params, self._key,
                                     tables, handoff, inject)
            done = None
            if self.device.type == "cuda":
                done = torch.cuda.Event()
                done.record()
        self._inflight.append((out, tuple(tickets), wspan, done))
        c = self._c
        for k_, v in call_accounting(padded).items():
            c[k_].inc(v)
        c["scan_steps"].inc(padded.tables.group_t.shape[1] +
                            padded.tables.client_t.shape[1])
        c["server_calls_saved_by_dedup"].inc(plan.server_steps_saved)
        c["server_calls_saved_by_cache"].inc(
            plan.server_steps_saved_by_cache)
        rg = np.asarray(plan.tables.request_group)
        c["requests_from_cache"].inc(int((rg >= plan.n_groups).sum()))
        self._frame.sigs.setdefault(label, set()).add(
            plan_signature(padded))
        c["waves"].inc()
        c["n_samples"].inc(
            sum(int(t.request.y.shape[0]) for t in tickets))
        td = self._clock()
        for t in tickets:
            t.t_dispatch = td

    def _make_ticket(self, r: SampleRequest, slo_s: Optional[float],
                     enqueue_t: Optional[float]) -> RequestTicket:
        t = RequestTicket(
            rid=self._next_rid, request=r,
            slo_s=r.slo_s if r.slo_s is not None else slo_s,
            t_enqueue=self._clock() if enqueue_t is None
            else enqueue_t)
        self._next_rid += 1
        return t

    # -- continuous admission (policy="continuous") ------------------------
    @property
    def busy(self) -> bool:
        """True while any request is pending admission or in flight."""
        return bool(self._inflight) or \
            any(len(q) > 0 for q in self._pending.values())

    def submit(self, requests: Sequence[SampleRequest],
               slo_s: Optional[float] = None,
               enqueue_t: Optional[Sequence[float]] = None
               ) -> List[RequestTicket]:
        """Enqueue requests for continuous admission; returns their
        tickets (outputs land on ``ticket.output`` at retirement).
        ``slo_s`` is the deadline default for requests that don't carry
        their own; ``enqueue_t`` overrides the enqueue timestamps with
        caller-side arrival times (absolute ``time.perf_counter``
        seconds — the open-loop benchmark charges pre-submit queueing to
        the latency gauge this way).  Only the continuous policy admits
        incrementally; depth/fifo admit at queue-drain boundaries
        through process()."""
        if self.config.policy != "continuous":
            raise ValueError(
                f"submit() requires policy='continuous' (got "
                f"{self.config.policy!r}); depth/fifo admit whole queues "
                "via process()")
        if enqueue_t is not None and len(enqueue_t) != len(requests):
            raise ValueError(f"{len(enqueue_t)} enqueue_t for "
                             f"{len(requests)} requests")
        if self._frame is None:
            self.start_report()
        tickets = []
        for i, r in enumerate(requests):
            t = self._make_ticket(
                r, slo_s, None if enqueue_t is None else enqueue_t[i])
            self._pending.setdefault(self.scheduler.bucket_of(r),
                                     deque()).append(t)
            tickets.append(t)
        return tickets

    def poll(self, block: bool = False) -> List[RequestTicket]:
        """One admission turn: retire observably-finished waves, then —
        while the in-flight window has room — form and dispatch waves
        from the pending deques (scheduler.admit).  ``block=True``
        additionally forces the oldest in-flight wave to retire, which
        guarantees progress (drain() is poll(block=True) to emptiness).
        Returns the tickets retired during this call."""
        if self._frame is None:
            self.start_report()
        done0 = len(self._frame.retired)
        self._reap()
        window = 2 if self.config.pipeline else 1
        while len(self._inflight) < window:
            admitted = self.scheduler.admit(self._pending)
            if admitted is None:
                break
            bucket, tickets = admitted
            self._dispatch(bucket.label(), list(tickets))
            self._reap()
        if block and self._inflight:
            self._retire(block=True)
        return self._frame.retired[done0:]

    def drain(self) -> List[RequestTicket]:
        """Poll until nothing is pending or in flight; returns all
        tickets retired along the way."""
        done: List[RequestTicket] = []
        while self.busy:
            done.extend(self.poll(block=True))
        return done

    # -- the loop ----------------------------------------------------------
    def process(self, queue: Sequence[SampleRequest],
                slo_s: Optional[float] = None,
                enqueue_t: Optional[Sequence[float]] = None
                ) -> Tuple[List[torch.Tensor], Dict]:
        """Drain ``queue``; returns (outputs in arrival order — one
        (B, *image_shape) array per request — and the serve report for
        THIS call: latency/SLO accounting, throughput, logical savings,
        physical padding overhead, cache deltas, recompiles and
        signatures per bucket).

        ``config.pipeline=True`` keeps up to two waves in flight
        (dispatch wave i+1 while wave i still runs — see module notes);
        ``False`` is the barrier-per-wave baseline.  Under
        ``policy="continuous"`` the call is submit + drain over the
        incremental admission loop.  Outputs and cache behavior are
        bitwise identical across all of it; ``slo_s``/``enqueue_t`` (see
        submit()) only affect accounting."""
        if self.busy:
            raise RuntimeError("process() while continuous requests are "
                               "pending/in flight; drain() first")
        if self._frame is not None:
            raise RuntimeError("process() inside an open report frame; "
                               "finish_report() first")
        if not queue:
            return [], self._empty_report()
        if enqueue_t is not None and len(enqueue_t) != len(queue):
            raise ValueError(f"{len(enqueue_t)} enqueue_t for "
                             f"{len(queue)} requests")
        self.start_report()
        if self.config.policy == "continuous":
            tickets = self.submit(queue, slo_s=slo_s, enqueue_t=enqueue_t)
            self.drain()
        else:
            tickets = [self._make_ticket(
                r, slo_s, None if enqueue_t is None else enqueue_t[i])
                for i, r in enumerate(queue)]
            for wave in self.scheduler.waves(queue):
                self._reap()
                self._dispatch(wave.bucket.label(),
                               [tickets[qi] for qi in wave.queue_idx])
                while len(self._inflight) > \
                        (1 if self.config.pipeline else 0):
                    self._retire(block=True)
            while self._inflight:
                self._retire(block=True)
        outputs = [t.output for t in tickets]
        return outputs, self.finish_report()


def plan_signature(plan: SamplePlan) -> tuple:
    """Shape signature of a (padded) plan — what a compile would key on."""
    return tuple(a.shape for a in plan.tables) + \
        (tuple(a.shape for a in plan.inject)
         if plan.inject is not None else ())
