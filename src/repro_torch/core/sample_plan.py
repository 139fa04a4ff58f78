"""Planner for the batched collaborative sampling engine (Alg. 2 at serve
scale).

A wave of requests becomes padded, masked step tables that one executor
(core/sampler.make_sample_engine) runs as a single program:

* **Server phase, deduplicated.**  Requests are grouped by ``(y, t_ζ,
  stride)``; each unique group gets one row of the ``(G, S_max)`` server
  table (full DDPM for stride 1, the clamped strided DDIM schedule
  otherwise), front-aligned and zero-padded with an ``active`` mask.
  ``request_group`` maps every request back to its prefix.
* **Cross-wave reuse (serve/prefix_cache.py).**  With a ``lookup_fn``,
  each unique group is probed before it gets a scan row; a hit's stored
  handoff x̂_{t_ζ} enters the plan as a row of ``InjectTables`` instead,
  so a cache hit skips the server phase physically.  ``request_group``
  indexes the combined ``[scan groups | injected groups]`` axis.
* **Client phase, per request.**  The ``(R, C_max)`` client tables carry
  the Alg.-2 M-remap baked in, zero-padded to the longest client sweep.
* **Stable seeds.**  Every group/request row carries an explicit PRNG
  seed; the serve runtime passes content-stable group seeds and
  arrival-stable request seeds, so a cached handoff is bitwise-valid in
  any later wave and scheduling cannot perturb outputs.

Masked steps are no-ops in the executor and every noise draw is
row-keyed, so ``pad_plan`` can pad a plan's axes to the scheduler's shape
tiers with inert all-masked rows; nothing in a plan row depends on wave
composition (padding invariance, continuous == depth).

The tables are numpy arrays built on the host.  ``tables_to_device``
moves them to the executor's device once per wave through pinned memory
without blocking the host; ``request_client`` stays a host array there,
because it selects a Python-side per-client model rather than device
data.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, \
    Tuple

import numpy as np
import torch

from repro_torch.core.splitting import CutPoint


class PlanTables(NamedTuple):
    """The executor's plan.  Host numpy from the planner; torch tensors on
    the device (``request_client`` excepted) after ``tables_to_device``."""
    group_y: object          # (G, B, n_classes) conditioning per group
    group_t: object          # (G, S_max) server timesteps, front-aligned
    group_t_prev: object     # (G, S_max) per-step targets (stride-aware)
    group_active: object     # (G, S_max) 0/1 — 0 = padded no-op step
    group_seed: object       # (G,) int32 — server-noise fold_in seeds
    request_group: object    # (R,) int32 — row into [scan | injected]
    request_client: object   # (R,) int32 — index into the client models
    request_seed: object     # (R,) int32 — client-noise fold_in seeds
    client_t: object         # (R, C_max) remapped client timesteps
    client_t_prev: object    # (R, C_max) their shifted predecessors
    client_active: object    # (R, C_max) 0/1 validity


class InjectTables(NamedTuple):
    """Cache-hit groups: precomputed server handoffs concatenated AFTER
    the server scan's output.  ``x`` holds device tensors (the cached
    handoffs); ``y`` is host numpy until ``inject_to_device``."""
    x: torch.Tensor          # (H, B, *image_shape) stored x̂_{t_ζ}
    y: object                # (H, B, n_classes)


@dataclasses.dataclass(frozen=True)
class SampleRequest:
    """One queue entry: client ``client`` wants ``y.shape[0]`` samples
    conditioned on ``y`` at its own cut point ``t_cut``.  ``slo_s`` is an
    optional latency deadline, accounted only (never steers planning)."""
    client: int
    t_cut: int
    y: np.ndarray                 # (B, n_classes); B shared across a plan
    slo_s: Optional[float] = None


def n_server_calls(T: int, t_cut: int, stride: int = 1) -> int:
    """Server model calls for one prefix: ⌈(T − t_ζ)/stride⌉."""
    return (T - t_cut + stride - 1) // stride


def server_table_np(T: int, t_cut: int, stride: int = 1
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """(t, t_prev) numpy step table for one server prefix.  stride == 1 is
    the full DDPM sweep; stride > 1 the strided DDIM schedule, whose LAST
    target is clamped to exactly t_cut even when stride does not divide
    the server step count."""
    if stride < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    full = np.arange(T, t_cut, -1, dtype=np.float32)
    t = full[::stride]
    t_prev = np.concatenate(
        [t[1:], np.full((min(t.shape[0], 1),), float(t_cut), np.float32)])
    return t, t_prev


def strided_server_table(cut: CutPoint, stride: int
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """``server_table_np`` for a CutPoint (the per-request samplers'
    entry point)."""
    return server_table_np(cut.T, cut.t_cut, stride)


# Cache-key type: (t_cut, stride, y.shape, y.dtype, y.tobytes()) — the
# content identity of one server prefix.
GroupKey = Tuple


def group_key(t_cut: int, y: np.ndarray, stride: int = 1) -> GroupKey:
    y = np.asarray(y, np.float32)
    return (int(t_cut), int(stride), y.shape, y.dtype.str, y.tobytes())


def stable_group_seed(gk: GroupKey) -> int:
    """Content-derived server-noise seed for one prefix group: a stable
    31-bit digest of the (y, t_ζ, stride) identity (the JAX package's
    digest, so both packages seed a group identically)."""
    head = repr(gk[:-1]).encode()
    tail = gk[-1] if isinstance(gk[-1], bytes) else repr(gk[-1]).encode()
    h = hashlib.blake2b(head + b"|" + tail, digest_size=4).digest()
    return int.from_bytes(h, "little") & 0x7FFFFFFF


@dataclasses.dataclass(frozen=True)
class SamplePlan:
    T: int
    adjusted: bool
    tables: PlanTables
    group_t_cut: Tuple[int, ...]      # (G,) scanned (miss) groups
    request_t_cut: Tuple[int, ...]    # (R,)
    server_stride: int = 1
    group_keys: Tuple[GroupKey, ...] = ()   # (G,) for cache fills
    group_seed: Tuple[int, ...] = ()        # (G,) the seeds actually used
    inject: Optional[InjectTables] = None   # cache-hit groups (H rows)
    hit_t_cut: Tuple[int, ...] = ()         # (H,)

    @property
    def n_groups(self) -> int:
        """Scanned (server-phase) groups — excludes injected cache hits
        and padding rows."""
        return len(self.group_t_cut)

    @property
    def n_hits(self) -> int:
        return len(self.hit_t_cut)

    @property
    def n_requests(self) -> int:
        return len(self.request_t_cut)

    @property
    def group_steps(self) -> Tuple[int, ...]:
        return tuple(n_server_calls(self.T, tc, self.server_stride)
                     for tc in self.group_t_cut)

    @property
    def server_steps_run(self) -> int:
        return sum(self.group_steps)

    @property
    def server_steps_saved(self) -> int:
        """Server model calls the (y, t_ζ) dedup avoids vs per-request."""
        uniq = self.server_steps_run + self.server_steps_saved_by_cache
        return sum(n_server_calls(self.T, tc, self.server_stride)
                   for tc in self.request_t_cut) - uniq

    @property
    def server_steps_saved_by_cache(self) -> int:
        return sum(n_server_calls(self.T, tc, self.server_stride)
                   for tc in self.hit_t_cut)


def plan_requests(requests: Sequence[SampleRequest], T: int,
                  adjusted: bool = True,
                  n_clients: Optional[int] = None,
                  server_stride: int = 1,
                  group_seed_fn: Optional[Callable[[GroupKey], int]] = None,
                  request_seeds: Optional[Sequence[int]] = None,
                  lookup_fn: Optional[Callable[[GroupKey],
                                               Optional[torch.Tensor]]] = None,
                  image_shape: Optional[Tuple[int, ...]] = None,
                  device=None) -> SamplePlan:
    """Build the padded step tables for one wave of requests.

    All requests share the global T and the request batch B.  Group order
    is first-seen order, so appending requests never renumbers groups.
    ``server_stride`` > 1 takes the strided DDIM tables (pair with an
    engine built with ``server_ddim=True``).  ``group_seed_fn`` /
    ``request_seeds`` override the wave-local default seeds (``arange``).
    ``lookup_fn`` (requires ``image_shape``) probes each unique group once
    for a stored handoff (a (B, *image_shape) tensor); an empty inject
    table is allocated on ``device``.  ``n_clients`` range-checks the
    requests' client indices."""
    if not requests:
        raise ValueError("plan_requests: empty request wave")
    if lookup_fn is not None and image_shape is None:
        raise ValueError("plan_requests: lookup_fn requires image_shape "
                         "(shapes the empty inject tables)")
    if request_seeds is not None and len(request_seeds) != len(requests):
        raise ValueError(
            f"plan_requests: {len(request_seeds)} request_seeds for "
            f"{len(requests)} requests")
    for r in requests:
        if r.client < 0 or (n_clients is not None and r.client >= n_clients):
            raise ValueError(
                f"request client {r.client} outside [0, {n_clients})")
    B = requests[0].y.shape[0]
    nc = requests[0].y.shape[1]
    groups: Dict[GroupKey, int] = {}          # key -> unique-group ordinal
    uniq_cut: List[int] = []
    uniq_y: List[np.ndarray] = []
    uniq_hit: List[Optional[torch.Tensor]] = []
    req_uniq, req_client, req_cut = [], [], []
    for r in requests:
        y = np.asarray(r.y, np.float32)
        if y.shape[0] != B:
            raise ValueError(
                f"plan_requests: request batch {y.shape[0]} != plan batch "
                f"{B}; pad requests to a common B first")
        if not 0 <= r.t_cut <= T:
            raise ValueError(f"t_cut {r.t_cut} outside [0, {T}]")
        gk = group_key(r.t_cut, y, server_stride)
        u = groups.setdefault(gk, len(uniq_cut))
        if u == len(uniq_cut):
            uniq_cut.append(int(r.t_cut))
            uniq_y.append(y)
            # zero-step (ICM) prefixes are never cacheable: no probe
            hit = lookup_fn(gk) if lookup_fn is not None and \
                n_server_calls(T, r.t_cut, server_stride) > 0 else None
            if hit is not None and tuple(hit.shape) != (B,) + tuple(
                    image_shape):
                raise ValueError(
                    f"lookup_fn handoff shape {tuple(hit.shape)} != "
                    f"{(B,) + tuple(image_shape)}")
            uniq_hit.append(hit)
        req_uniq.append(u)
        req_client.append(int(r.client))
        req_cut.append(int(r.t_cut))

    miss = [u for u in range(len(uniq_cut)) if uniq_hit[u] is None]
    hit = [u for u in range(len(uniq_cut)) if uniq_hit[u] is not None]
    G, H, R = len(miss), len(hit), len(requests)
    final_idx = {u: i for i, u in enumerate(miss)}
    final_idx.update({u: G + j for j, u in enumerate(hit)})
    group_cut = [uniq_cut[u] for u in miss]
    uniq_keys = list(groups)                  # insertion order = ordinal

    steps = [n_server_calls(T, tc, server_stride) for tc in group_cut]
    s_max = max(steps, default=0)
    c_max = max(req_cut)
    # padded entries use t=1 / t_prev=0 — valid schedule coordinates, so a
    # masked step computes finite garbage that the executor's where() drops
    gt = np.ones((G, s_max), np.float32)
    gtp = np.zeros((G, s_max), np.float32)
    ga = np.zeros((G, s_max), np.float32)
    for g, tc in enumerate(group_cut):
        tl, tp = server_table_np(T, tc, server_stride)
        n = tl.shape[0]
        if n:
            gt[g, :n] = tl
            gtp[g, :n] = tp
            ga[g, :n] = 1.0
    ct = np.ones((R, c_max), np.float32)
    ctp = np.zeros((R, c_max), np.float32)
    ca = np.zeros((R, c_max), np.float32)
    for i, tc in enumerate(req_cut):
        tl, tp = CutPoint(T, tc).client_step_table(adjusted)
        n = tl.shape[0]
        if n:
            ct[i, :n] = tl
            ctp[i, :n] = tp
            ca[i, :n] = 1.0
    gy = np.stack([uniq_y[u] for u in miss]) if G else \
        np.zeros((0, B, nc), np.float32)
    gseed = [group_seed_fn(uniq_keys[u]) for u in miss] \
        if group_seed_fn is not None else list(range(G))
    rseed = list(request_seeds) if request_seeds is not None else \
        list(range(R))
    tables = PlanTables(
        group_y=gy, group_t=gt, group_t_prev=gtp, group_active=ga,
        group_seed=np.asarray(gseed, np.int32).reshape((G,)),
        request_group=np.asarray([final_idx[u] for u in req_uniq],
                                 np.int32),
        request_client=np.asarray(req_client, np.int32),
        request_seed=np.asarray(rseed, np.int32),
        client_t=ct, client_t_prev=ctp, client_active=ca)
    inject = None
    if lookup_fn is not None:
        if H:
            ix = torch.stack([uniq_hit[u] for u in hit])
            iy = np.stack([uniq_y[u] for u in hit])
        else:
            ix = torch.zeros((0, B) + tuple(image_shape), device=device)
            iy = np.zeros((0, B, nc), np.float32)
        inject = InjectTables(x=ix, y=iy)
    return SamplePlan(T=T, adjusted=adjusted, tables=tables,
                      group_t_cut=tuple(group_cut),
                      request_t_cut=tuple(req_cut),
                      server_stride=server_stride,
                      group_keys=tuple(uniq_keys[u] for u in miss),
                      group_seed=tuple(int(s) for s in gseed),
                      inject=inject,
                      hit_t_cut=tuple(uniq_cut[u] for u in hit))


def pad_plan(plan: SamplePlan, n_groups: Optional[int] = None,
             n_requests: Optional[int] = None,
             n_inject: Optional[int] = None) -> SamplePlan:
    """Pad a plan's group / request / inject axes up to the scheduler's
    shape tiers with INERT rows — all-masked steps, zero conditioning,
    seed 0.  Padding is appended, so real-row indices are preserved
    (injected rows are re-indexed to sit after the padded scan axis);
    the metadata tuples keep describing only the real rows."""
    t = plan.tables
    G = t.group_t.shape[0]
    R = t.client_t.shape[0]
    gpad = 0 if n_groups is None else n_groups - G
    rpad = 0 if n_requests is None else n_requests - R
    if gpad < 0 or rpad < 0:
        raise ValueError(f"pad_plan: target sizes ({n_groups}, {n_requests})"
                         f" smaller than plan ({G}, {R})")
    rg = np.asarray(t.request_group)
    if gpad:
        rg = np.where(rg >= G, rg + gpad, rg)
    lead = lambda a, n, v=0: np.pad(
        a, ((0, n),) + ((0, 0),) * (a.ndim - 1), constant_values=v)
    tables = t._replace(
        group_y=lead(t.group_y, gpad),
        group_t=lead(t.group_t, gpad, 1.0),
        group_t_prev=lead(t.group_t_prev, gpad),
        group_active=lead(t.group_active, gpad),
        group_seed=lead(t.group_seed, gpad),
        request_group=lead(rg.astype(np.int32), rpad),
        request_client=lead(t.request_client, rpad),
        request_seed=lead(t.request_seed, rpad),
        client_t=lead(t.client_t, rpad, 1.0),
        client_t_prev=lead(t.client_t_prev, rpad),
        client_active=lead(t.client_active, rpad))
    inject = plan.inject
    if n_inject is not None:
        if inject is None:
            raise ValueError("pad_plan: n_inject on a plan without inject "
                             "tables (plan with lookup_fn first)")
        ipad = n_inject - inject.x.shape[0]
        if ipad < 0:
            raise ValueError(f"pad_plan: n_inject {n_inject} smaller than "
                             f"{inject.x.shape[0]}")
        x = inject.x
        inject = InjectTables(
            x=torch.cat([x, x.new_zeros((ipad,) + tuple(x.shape[1:]))]),
            y=lead(np.asarray(inject.y), ipad))
    return dataclasses.replace(plan, tables=tables, inject=inject)


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        # pinned source + non_blocking: the host does not wait for the
        # stream, so planning wave i+1 overlaps wave i's scans
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def tables_to_device(tables: PlanTables, device) -> PlanTables:
    """Host tables → device tensors, once per wave.  ``request_client``
    stays a host int array (it indexes the Python list of client models)."""
    device = torch.device(device)
    return PlanTables(*[
        np.asarray(a) if name == "request_client" else
        _to_device(np.asarray(a), device)
        for name, a in zip(PlanTables._fields, tables)])


def inject_to_device(inject: Optional[InjectTables], device
                     ) -> Optional[InjectTables]:
    if inject is None:
        return None
    device = torch.device(device)
    return InjectTables(x=inject.x.to(device),
                        y=_to_device(np.asarray(inject.y), device))


def call_accounting(plan: SamplePlan) -> Dict[str, int]:
    """Physical vs logical model-call accounting for one (possibly padded)
    plan, from the host tables.  PHYSICAL counts every (row, step) cell —
    a masked step still runs its model call; LOGICAL counts the active
    cells; ``padded_model_calls`` is the gap."""
    t = plan.tables
    phys_s = int(t.group_t.shape[0] * t.group_t.shape[1])
    phys_c = int(t.client_t.shape[0] * t.client_t.shape[1])
    log_s = int(round(float(np.sum(t.group_active))))
    log_c = int(round(float(np.sum(t.client_active))))
    return {
        "server_calls_physical": phys_s,
        "server_calls_logical": log_s,
        "client_calls_physical": phys_c,
        "client_calls_logical": log_c,
        "padded_model_calls": (phys_s - log_s) + (phys_c - log_c),
    }
