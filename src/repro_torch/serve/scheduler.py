"""Shape-stable wave scheduler: compile once per bucket, pad with masks.

The sampling engine sees one argument signature per distinct table
shape (G, H, R, S_max, C_max, B) — a recompile under jit, new algorithm
choices and allocation patterns in eager PyTorch.  Padding only the last
wave's R leaves G drifting with each wave's label/cut mix and burns
padded-step model calls on mixed-depth waves; this module closes the
shape side of both:

* **Depth buckets** (``policy="depth"``, the ``bucket_round_batches``
  trick at inference): requests are bucketed by ``(t_ζ, B)``, so every
  wave of a bucket shares ONE server-step count and ONE client-sweep
  length — S_max and C_max carry zero intra-wave depth padding and the
  physical model-call count drops from G·S_max + R·C_max toward
  Σ(T−t_ζ).  ``policy="fifo"`` keeps arrival-order waves (the
  baseline the serve benchmark measures against).
* **Fixed tiers**: the request axis is always padded to ``max_wave`` and
  the scanned-group / injected-group axes to the next power of two
  (``tier``), using sample_plan.pad_plan's inert all-masked rows.  A
  bucket therefore presents a SMALL, converging set of signatures: cold
  traffic compiles (G=tier(misses), H=1), steady repeated traffic
  settles on (G=1 with S=0 — the server scan vanishes entirely when every
  prefix hits the cache, H=tier(groups)) and stops recompiling — the CI
  smoke asserts exactly one signature per bucket in steady state.
* **Continuous admission** (``policy="continuous"``): depth
  buckets, but wave FORMATION moves from queue-drain boundaries to wave
  boundaries — ``admit`` pops up to ``max_wave`` pending requests from
  one bucket each time the runtime frees an engine slot, so a request
  that arrives one tick after a wave closed joins the NEXT wave instead
  of waiting for the whole queue to drain (LLM-style continuous
  batching, Orca's iteration-level scheduling transplanted to diffusion
  waves).  Partially-refilled waves reuse the exact same tier menu —
  R padded to ``max_wave``, pow2 group tiers, fixed inject tier — so
  the one-signature-per-bucket steady-state guarantee survives
  admission timing, and padding inertness (sample_plan.pad_plan) keeps
  a 1-request wave bitwise-identical to the same request served inside
  a full wave.  Admission timing is the third pure-performance knob
  (after bucketing and caching), pinned by
  the continuous-vs-depth bitwise tests.

The scheduler only DECIDES — buckets, wave membership, tier targets; all
array work stays in the planner.  Waves carry their requests' queue
positions so the runtime can report per-request latency and re-emit
outputs in arrival order regardless of bucketing.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Deque, List, Optional, Sequence, Tuple

from repro_torch.core.sample_plan import SampleRequest


def tier(n: int, cap: int) -> int:
    """Next power of two ≥ max(n, 1), capped at the next power of two
    ≥ ``cap`` — the fixed shape menu that keeps per-bucket signatures
    finite and convergent.  The cap itself is ROUNDED UP to a power of
    two rather than applied raw: a raw non-pow2 cap (e.g. max_wave=6 →
    min(8, 6) = 6) would leak a non-pow2 tier into the menu, breaking
    the docstring's own guarantee AND pad_plan's target-≥-plan
    contract, since a plan with n groups > cap still needs a tier that
    can hold all n rows."""
    t = 1
    while t < n:
        t *= 2
    c = 1
    while c < max(cap, 1):
        c *= 2
    return min(t, c)


@dataclasses.dataclass(frozen=True)
class WaveBucket:
    """One compiled-shape family: every wave of a bucket shares the step
    geometry (t_ζ, stride ⇒ S, C) and the request batch B.  ``fifo``
    buckets degenerate to a single mixed bucket (arrival-order semantics)."""
    t_cut: int                   # -1 for the mixed fifo bucket
    batch: int
    stride: int = 1

    def label(self) -> str:
        cut = "mixed" if self.t_cut < 0 else str(self.t_cut)
        return f"cut{cut}_b{self.batch}_s{self.stride}"


@dataclasses.dataclass(frozen=True)
class Wave:
    bucket: WaveBucket
    requests: Tuple[SampleRequest, ...]   # real requests only (≤ max_wave)
    queue_idx: Tuple[int, ...]            # their positions in the queue


class WaveScheduler:
    """Bucket a request queue into shape-stable waves.

    ``policy="depth"`` buckets by (t_ζ, B) in first-seen bucket order,
    arrival order within a bucket; ``policy="continuous"`` uses the same
    buckets but forms waves incrementally through ``admit`` (see module
    notes — ``waves`` on a whole queue degenerates to depth bucketing);
    ``policy="fifo"`` chunks the queue in arrival order (mixed cuts per
    wave — the pre-scheduler serving loop's behavior, kept as the benchmark baseline),
    breaking a wave early when the request batch size changes, since one
    plan carries one B (plan_requests) — mixed-B queues stay in arrival
    order instead of being silently re-bucketed by B (an earlier bug).
    All policies emit waves of ≤ ``max_wave`` real requests; the runtime
    pads the request axis to exactly ``max_wave`` with inert rows
    (sample_plan.pad_plan), so R never varies."""

    def __init__(self, max_wave: int, policy: str = "depth",
                 stride: int = 1):
        if max_wave < 1:
            raise ValueError(f"max_wave must be >= 1, got {max_wave}")
        if policy not in ("depth", "fifo", "continuous"):
            raise ValueError(f"unknown scheduler policy {policy!r}")
        self.max_wave = max_wave
        self.policy = policy
        self.stride = stride
        self._c = None               # admission instruments (obs)

    def bind_instruments(self, registry) -> None:
        """Admission telemetry (repro_torch.obs.metrics.MetricsRegistry):
        ``admitted_waves``/``admitted_requests`` count what ``admit``
        forms, and ``partial_waves`` how many dispatched below
        ``max_wave`` — the padding-slack signal the continuous policy's
        latency-vs-throughput trade rides on.  Counters only; admission
        DECISIONS never read them (telemetry must not steer waves)."""
        self._c = {name: registry.counter(name) for name in
                   ("admitted_waves", "admitted_requests",
                    "partial_waves")}

    def bucket_of(self, r: SampleRequest) -> WaveBucket:
        """The compiled-shape family ``r`` belongs to.  fifo keys every
        request into the mixed bucket (arrival-order waves); depth and
        continuous key by (t_ζ, B)."""
        return WaveBucket(t_cut=-1 if self.policy == "fifo" else r.t_cut,
                          batch=r.y.shape[0], stride=self.stride)

    def waves(self, queue: Sequence[SampleRequest]) -> List[Wave]:
        out: List[Wave] = []
        if self.policy == "fifo":
            # arrival order, chunked — NOT bucketed.  A wave breaks at
            # max_wave or when B changes (one plan = one B); a mixed-B
            # queue used to be split by (t_cut=-1, B) bucket keys here,
            # reordering it out of arrival order and skewing the fifo
            # baseline the serve bench compares against.
            cur: List[int] = []
            for i, r in enumerate(queue):
                if cur and (len(cur) == self.max_wave or
                            r.y.shape[0] != queue[cur[0]].y.shape[0]):
                    out.append(self._fifo_wave(queue, cur))
                    cur = []
                cur.append(i)
            if cur:
                out.append(self._fifo_wave(queue, cur))
            return out
        buckets: "OrderedDict[WaveBucket, List[int]]" = OrderedDict()
        for i, r in enumerate(queue):
            buckets.setdefault(self.bucket_of(r), []).append(i)
        for b, idxs in buckets.items():
            for s in range(0, len(idxs), self.max_wave):
                chunk = idxs[s:s + self.max_wave]
                out.append(Wave(bucket=b,
                                requests=tuple(queue[i] for i in chunk),
                                queue_idx=tuple(chunk)))
        return out

    def _fifo_wave(self, queue: Sequence[SampleRequest],
                   idxs: List[int]) -> Wave:
        b = WaveBucket(t_cut=-1, batch=queue[idxs[0]].y.shape[0],
                       stride=self.stride)
        return Wave(bucket=b, requests=tuple(queue[i] for i in idxs),
                    queue_idx=tuple(idxs))

    def admit(self, pending: "OrderedDict[WaveBucket, Deque]"
              ) -> Optional[Tuple[WaveBucket, Tuple]]:
        """Slot-reuse wave formation (``policy="continuous"``): pop up to
        ``max_wave`` entries from the bucket whose HEAD entry arrived
        earliest and return (bucket, entries), or None when nothing is
        pending.  Entries are opaque to the scheduler except for ``.rid``
        — the runtime's monotone arrival sequence — so oldest-head-first
        is FIFO *across* buckets: the request that has waited longest is
        always in the next wave, which bounds head-of-line wait (the p95
        the Poisson bench measures).  A partial wave dispatches
        immediately rather than idling for stragglers: its request axis
        is padded to ``max_wave`` anyway, so the physical cost equals a
        full wave's and the trade is honest — the report's
        ``padded_model_calls`` shows the slack, the latency percentiles
        show the win.  Under backlog the pending deques are deep and
        every admitted wave is full, so the knob self-corrects toward
        throughput exactly when throughput matters."""
        live = [(b, q) for b, q in pending.items() if q]
        if not live:
            return None
        b, q = min(live, key=lambda bq: bq[1][0].rid)
        take = tuple(q.popleft()
                     for _ in range(min(len(q), self.max_wave)))
        if self._c is not None:
            self._c["admitted_waves"].inc()
            self._c["admitted_requests"].inc(len(take))
            if len(take) < self.max_wave:
                self._c["partial_waves"].inc()
        return b, take

    def group_tier(self, n_scan_groups: int) -> int:
        """Power-of-two: a padded SCAN row burns a model call per step, so
        the scan axis hugs the real group count (cache hits shrink it —
        all the way to (1, S=0) when every prefix hits).  The fifo policy
        deliberately does NOT tier G: the pre-scheduler serving loop it reproduces let
        the group count drift per wave (the recompile cost the depth
        policy fixes), and tiering it would charge the BASELINE phantom
        padded server calls the old loop never ran — the benchmark's
        old/new comparison must not flatter the new path.  depth and
        continuous share the pow2 menu: a partially-refilled continuous
        wave can only present shapes a depth wave could also present."""
        if self.policy == "fifo":
            return max(n_scan_groups, 1)
        return tier(n_scan_groups, self.max_wave)

    def inject_tier(self, n_hits: int) -> int:
        """FIXED at max_wave: injected rows cost only concat/gather bytes,
        never model calls, so buying one invariant warm signature per
        bucket (the steady-state single-compile guarantee) is free."""
        del n_hits
        return self.max_wave
