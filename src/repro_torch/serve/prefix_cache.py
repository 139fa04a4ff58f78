"""Cross-wave server-prefix cache: the serve runtime's hot-path store.

At "millions of users" scale the server prefix is both the expensive half
of Algorithm 2 and the REDUNDANT half — conditioning labels and cut
points repeat across requests far beyond one wave.  The planner dedups
shared prefixes inside a single wave; this cache extends the same idea
across waves: a completed server trajectory is stored AT ITS HANDOFF
STATE x̂_{t_ζ} (the only tensor Alg. 2 ever ships), keyed by

    (y, t_ζ, server-noise key schedule, stride)

— the full content identity of the prefix.  The first three components
come from sample_plan.group_key (t_cut, stride, y bytes); the key
schedule is the runtime's (base-key bytes, stable group seed) pair, which
pins the exact noise draws the trajectory consumed (fold_in-by-seed,
core/sampler design notes).  Two runtimes with different base keys — or
the same runtime before/after a seed-registry change — can therefore
never alias each other's entries, and a hit is bitwise-exact by
construction: the stored handoff IS the array a cold run would recompute.

Eviction is LRU over an OrderedDict, bounded by bytes and (optionally)
entry count; telemetry (hits/misses/insertions/evictions/bytes, plus the
server model calls the hits skipped) feeds the runtime's serve report.
Entries hold device tensors — at serve scale the cache lives in
accelerator memory next to the engine (host offload is a ROADMAP item).
An entry may still be in flight on the runtime's single CUDA stream when
it is inserted; a later wave that reads it is queued behind it on the
same stream.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Hashable, Optional, Tuple


@dataclasses.dataclass
class CacheStats:
    """Telemetry.  Every field except the last two describes the current
    EPOCH — the interval since construction or the latest ``clear()``;
    ``clears``/``cleared_entries`` are lifetime counters that survive
    epochs (they are how a monitoring loop sees the drops a clear made,
    which would otherwise be invisible: cleared entries are neither
    evictions — there was no capacity pressure — nor a stats wipe)."""
    hits: int = 0
    misses: int = 0
    insertions: int = 0
    evictions: int = 0
    rejected: int = 0            # inserts refused (zero-step prefixes)
    bytes_in_use: int = 0
    peak_bytes: int = 0
    server_calls_saved: int = 0  # model calls the hits skipped
    clears: int = 0              # lifetime: epochs started by clear()
    cleared_entries: int = 0     # lifetime: entries dropped by clears

    @property
    def lookups(self) -> int:
        return self.hits + self.misses

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0

    def as_dict(self) -> dict:
        return {**dataclasses.asdict(self), "hit_rate": self.hit_rate}


@dataclasses.dataclass
class _Entry:
    handoff: object              # (B, *image_shape) device tensor
    steps: int                   # server model calls this entry encodes
    nbytes: int


class PrefixCache:
    """LRU, size-bounded store of server handoffs.

    ``max_bytes`` bounds the resident handoff bytes; ``max_entries``
    optionally bounds the count.  ``lookup`` counts a hit/miss and
    refreshes recency; ``insert`` refuses zero-step prefixes (an ICM
    "handoff" is pure noise the engine regenerates for free — a stored
    copy would only burn budget) and entries that can NEVER serve a hit
    — larger than the whole byte budget, or any entry when
    ``max_entries == 0``.  Both refusals count as ``rejected``, never
    as insertions/evictions, and never touch ``peak_bytes`` (an entry
    that was admitted only to be flushed on the same call used to
    inflate all three AND evict innocent resident entries first)."""

    def __init__(self, max_bytes: int = 64 << 20,
                 max_entries: Optional[int] = None):
        if max_bytes < 0:
            raise ValueError(f"max_bytes must be >= 0, got {max_bytes}")
        if max_entries is not None and max_entries < 0:
            raise ValueError(f"max_entries must be >= 0, got {max_entries}")
        self.max_bytes = max_bytes
        self.max_entries = max_entries
        self._entries: "OrderedDict[Hashable, _Entry]" = OrderedDict()
        self.stats = CacheStats()
        self._c = None               # registry counter mirrors (obs)
        self._base = {}              # counter totals at last clear()

    def bind_instruments(self, registry) -> None:
        """Mirror the epoch stats into a metrics registry
        (repro_torch.obs.metrics.MetricsRegistry): monotone ``cache_*``
        Counters bumped at the same sites as the stats fields, plus
        callback Gauges ``cache_entries``/``cache_bytes`` reading live
        occupancy.  Counters are LIFETIME totals while ``stats`` is
        per-epoch; a report frame never spans a ``clear()`` (the runtime
        refuses key rotation mid-frame), so frame deltas of the two
        agree exactly.  ``verify()`` checks the mirror."""
        self._c = {f: registry.counter(f"cache_{f}") for f in
                   ("hits", "misses", "insertions", "evictions",
                    "rejected")}
        self._base = {f: c.value for f, c in self._c.items()}
        registry.gauge("cache_entries", fn=lambda: len(self))
        registry.gauge("cache_bytes",
                       fn=lambda: self.stats.bytes_in_use)

    def _mark(self, field: str, n: int = 1) -> None:
        if self._c is not None:
            self._c[field].inc(n)

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._entries

    def keys(self) -> Tuple[Hashable, ...]:
        """LRU → MRU order (telemetry/tests)."""
        return tuple(self._entries)

    def lookup(self, key: Hashable):
        """Return the stored handoff (refreshing recency) or None."""
        e = self._entries.get(key)
        if e is None:
            self.stats.misses += 1
            self._mark("misses")
            return None
        self._entries.move_to_end(key)
        self.stats.hits += 1
        self._mark("hits")
        self.stats.server_calls_saved += e.steps
        return e.handoff

    def insert(self, key: Hashable, handoff, steps: int) -> bool:
        """Store a completed prefix's handoff; returns True if admitted.
        Re-inserting an existing key refreshes value and recency."""
        if steps <= 0:
            self.stats.rejected += 1
            self._mark("rejected")
            return False
        nbytes = int(handoff.numel() * handoff.element_size())
        if nbytes > self.max_bytes or self.max_entries == 0:
            # oversized / zero-capacity: could never serve a hit — reject
            # upfront instead of admitting, flushing LRU neighbors, and
            # polluting insertions/evictions/peak_bytes on the way out
            self.stats.rejected += 1
            self._mark("rejected")
            return False
        old = self._entries.pop(key, None)
        if old is not None:
            self.stats.bytes_in_use -= old.nbytes
        self._entries[key] = _Entry(handoff, int(steps), nbytes)
        self.stats.bytes_in_use += nbytes
        self.stats.insertions += 1
        self._mark("insertions")
        self.stats.peak_bytes = max(self.stats.peak_bytes,
                                    self.stats.bytes_in_use)
        self._evict()
        return key in self._entries

    def _evict(self):
        over = lambda: (self.stats.bytes_in_use > self.max_bytes or
                        (self.max_entries is not None and
                         len(self._entries) > self.max_entries))
        while self._entries and over():
            _, e = self._entries.popitem(last=False)   # LRU end
            self.stats.bytes_in_use -= e.nbytes
            self.stats.evictions += 1
            self._mark("evictions")

    def clear(self):
        """Start a new cache EPOCH: drop every entry and reset the epoch
        stats — hits/misses/insertions/evictions/rejected/bytes/peak all
        describe only the new epoch afterwards (an earlier half-reset
        zeroed ``bytes_in_use`` but let ``peak_bytes`` and the hit/miss
        counters leak across epochs, so post-clear hit rates and peaks
        lied).  The drop itself stays visible through the LIFETIME
        counters ``clears`` (+1) and ``cleared_entries`` (+len) — not as
        evictions, which mean capacity pressure.  This is the key-
        rotation hook (ServeRuntime.rotate_key): entries are addressed
        by the base-key fingerprint, so after a rotation every resident
        entry is permanently unreachable and holding it would only burn
        byte budget."""
        dropped = len(self._entries)
        self._entries.clear()
        self.stats = CacheStats(
            clears=self.stats.clears + 1,
            cleared_entries=self.stats.cleared_entries + dropped)
        if self._c is not None:
            # registry counters are lifetime-monotone; re-baseline so the
            # counter-vs-epoch-stats mirror (verify) stays checkable
            self._base = {f: c.value for f, c in self._c.items()}

    def verify(self) -> bool:
        """Debug-mode integrity check: recount the derived state from
        the entries themselves and cross-check every invariant the
        incremental bookkeeping maintains.  O(n) — call it from tests
        and debug sessions, not the hot path.  Returns True; raises
        AssertionError naming the first violated invariant.

        Checked: ``bytes_in_use`` equals the sum of resident entry
        sizes; occupancy respects ``max_bytes``/``max_entries``; every
        resident entry has positive steps and admissible size;
        ``peak_bytes`` dominates ``bytes_in_use``; all stats fields are
        non-negative; and, when ``bind_instruments`` mirrored the stats
        into a registry, each monotone counter's movement since the
        epoch baseline equals its epoch stats field."""
        s = self.stats
        recount = sum(e.nbytes for e in self._entries.values())
        assert s.bytes_in_use == recount, \
            f"bytes_in_use {s.bytes_in_use} != recounted {recount}"
        assert recount <= self.max_bytes, \
            f"resident {recount} over max_bytes {self.max_bytes}"
        if self.max_entries is not None:
            assert len(self._entries) <= self.max_entries, \
                f"{len(self._entries)} entries over max {self.max_entries}"
        for k, e in self._entries.items():
            assert e.steps > 0, f"resident zero-step entry {k!r}"
            assert 0 <= e.nbytes <= self.max_bytes, \
                f"entry {k!r} size {e.nbytes} inadmissible"
        assert s.peak_bytes >= s.bytes_in_use, \
            f"peak_bytes {s.peak_bytes} < bytes_in_use {s.bytes_in_use}"
        for f in ("hits", "misses", "insertions", "evictions", "rejected",
                  "bytes_in_use", "peak_bytes", "server_calls_saved",
                  "clears", "cleared_entries"):
            assert getattr(s, f) >= 0, f"negative stats field {f}"
        # every resident entry was inserted THIS epoch (clear() empties)
        assert s.insertions >= len(self._entries), \
            "more resident entries than epoch insertions"
        if self._c is not None:
            for f, c in self._c.items():
                moved = c.value - self._base[f]
                assert moved == getattr(s, f), \
                    (f"registry mirror cache_{f} moved {moved} since the "
                     f"epoch baseline but stats.{f} == {getattr(s, f)}")
        return True
