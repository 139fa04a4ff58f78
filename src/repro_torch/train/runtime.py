"""CollaFuse federated training runtime — persistent Alg.-1 training under
partial participation; the port of the JAX package's ``train/runtime.py``
on one card.

* **Registry → participation sampler → round plan → engine → aggregation
  → telemetry/checkpoint.**  ``TrainRuntime`` is built once and runs
  rounds: clients ``register_client`` / ``leave`` between rounds; each
  ``run_round`` samples a cohort from the active registry
  (train/participation.py), plans it into padded fixed-shape stacks
  (train/rounds.py), runs ONE masked round
  (core/collab.make_vectorized_round(identity_keyed=True)) on the
  cohort's own models, applies the optional cross-cohort FedAvg and the
  server EMA, and reports.  ``run`` loops rounds with durable checkpoints.
* **One engine signature per participation TIER.**  Cohorts are padded
  along the client axis to power-of-two tiers with fully-masked slots;
  batch count and size are pinned by the config, so a round's signature
  depends only on its tier.  Eager PyTorch has no jit: the shared
  ``RecompileGuard`` (obs/metrics.py) counts the distinct argument
  signatures the engine sees, the counterpart of the reference's trace
  counter, and the smoke asserts exactly one per tier.
* **Identity keying makes participation a pure policy knob.**  Every
  per-client draw is keyed by registry uid (protocol.client_keys), every
  per-sample draw is row-keyed below it, and every runtime purpose folds
  its own stream tag into the ONE base key (participation.TAG_*).  A
  padded slot is never computed (its mask is all-zero: the engine skips
  it on the host), and the server batch holds only rows of weight > 0,
  so a cohort of 3 padded to tier 4 is bitwise the unpadded run on any
  device, and an absent client's model, moments and step stay untouched.
* **Bitwise mid-run resume.**  ``state_dict`` / ``save`` persist the full
  resumable state — server model and AdamW state, each client's, registry
  counters and membership, the cohort cursor, the base key, the EMA
  track, in-flight async uploads and the privacy ledger — through
  checkpointing/checkpoint.py (the reference's file format, version 3);
  randomness is addressed by (base key, tag, round, uid), so a run
  resumed after round j replays rounds j+1.. bit for bit.  Client DATA is
  never checkpointed: callers re-attach it by uid.  A model is saved as
  its ``{name: tensor}`` parameters, a dict model (the toy) as it is.
* **Aggregation.**  ``fedavg_every`` averages the members' client models
  by real trained-sample counts (core/fedavg.average_cohort); the server
  EMA (``ema_decay``) is the model sampling should load
  (``sampling_server_params``).
* **Async (staleness-tolerant) aggregation.**  Stragglers come from the
  addressed ``TAG_LAG`` stream.  Sync mode: the round blocks ``lag_s`` ·
  max-lag seconds, then applies every upload — bitwise the lag-free run.
  Async mode: a straggler's updated model is queued and folded in at its
  arrival round with core/fedavg.average_stale's weight; its record
  stays untouched meanwhile (the engine trained a copy of it), a busy
  client sits out sampling, ``drain()`` flushes the queue, and a client
  that leaves drops its in-flight uploads.
* **Privacy (DP-FedAvg + secagg).**  With ``TrainConfig(privacy=...)``
  enabled (``fedavg_every`` > 0 required) the aggregation boundary runs
  privacy/dp.dp_average_cohort against the broadcast reference
  ``_dp_ref``; the accountant charges one release per applied
  aggregation at the window rate 1 − (1 − q)^fedavg_every.  Disabled, the
  plain ``average_cohort`` path runs untouched (the identity ladder).
* **Observability.**  Round reports derive from the metrics registry
  (``_TRAIN_REPORT_SCHEMA``); with an active ObsConfig each round is a
  JSONL frame and a "round" span with cohort_sample / plan /
  round_dispatch / barrier_stall / fedavg children (and a "checkpoint"
  span in ``run``).  Disabled, tracing is structurally inert; enabled, it
  never perturbs training.

The runtime places everything on ``device`` (CUDA unless the caller
passes ``device="cpu"``).  With a ``mesh`` (a 1-D ``("clients",)``
``DeviceMesh``, sharding/specs.py ``make_client_mesh``) every rank runs
the same runtime: ``run_round`` places the cohort through
``shard_cohort_round``, the engine updates each rank's own slots and
sums the server's gradient over the ranks, and then each real slot's
parameters and AdamW state go from the rank that owns it to every rank
(``collab.broadcast_slots``), an async straggler's queued copy included.
So every rank's registry, queue, FedAvg, DP release and EMA stay whole
and bitwise alike, and a checkpoint written by rank 0 (the only rank
that writes checkpoints and JSONL frames) is the whole state.  A tier the
mesh does not divide runs replicated: every rank computes every slot.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from repro_torch.checkpointing import checkpoint as ckpt
from repro_torch.core import prng, trees
from repro_torch.core.collab import broadcast_slots, make_vectorized_round
from repro_torch.core.fedavg import average_cohort, average_stale
from repro_torch.core.schedules import DiffusionSchedule
from repro_torch.core.splitting import CutPoint
from repro_torch.device import deterministic_cuda, resolve_device
from repro_torch.obs import DELTA, GAUGE, ObsConfig, RecompileGuard, Telemetry
from repro_torch.optim.adamw import AdamWConfig, init_opt_state, named
from repro_torch.privacy.accountant import RdpAccountant
from repro_torch.privacy.dp import TAG_DP, PrivacyConfig, dp_average_cohort
from repro_torch.sharding.specs import shard_cohort_round, slot_owners
from repro_torch.train.participation import (TAG_INIT, TAG_PART, TAG_ROUND,
                                             ParticipationConfig,
                                             sample_cohort, sample_drops,
                                             sample_lags, sampling_rate,
                                             uid_scores)
from repro_torch.train.registry import ClientRegistry
from repro_torch.train.rounds import plan_round

# Delta-vs-gauge classification of every train report key: DELTA keys
# describe THIS round only; GAUGE keys are runtime state at report time.
_TRAIN_REPORT_SCHEMA = {
    "round": GAUGE, "n_registered": GAUGE, "n_active": GAUGE,
    "cohort": DELTA, "cohort_size": DELTA, "strict_subset": DELTA,
    "tier": DELTA, "padded_client_slots": DELTA,
    "real_samples": DELTA, "padded_cells": DELTA, "pad_waste_frac": DELTA,
    "mid_round_drops": DELTA, "engine_traces": DELTA,
    "signatures_per_tier": GAUGE, "max_signatures_per_tier": GAUGE,
    "client_loss": DELTA, "server_loss": DELTA,
    "fedavg_applied": DELTA, "seen_total": GAUGE, "wall_s": DELTA,
    "stragglers": DELTA, "stale_merges": DELTA, "barrier_stall_s": DELTA,
    "pending_payloads": GAUGE,
    "dp_epsilon": GAUGE, "dp_epoch": GAUGE, "dp_clip_frac": GAUGE,
}


def _key_pack(key: torch.Tensor) -> Dict[str, Any]:
    """Checkpointable form of a key: its two uint32 words (the reference's
    raw key data)."""
    return {"data": prng.key_data(key), "typed": False}


def _key_unpack(packed) -> torch.Tensor:
    """A key from ``_key_pack`` (or from a reference file, raw or typed:
    both store the two words)."""
    data = np.asarray(packed["data"]).astype(np.int64).reshape(2)
    return torch.from_numpy(data)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    T: int
    t_cut: int
    image_shape: Tuple[int, int, int]       # (H, W, C)
    n_classes: int
    batch_size: int = 8
    batches_per_round: int = 4              # fixed nb — shape stability
    lr: float = 1e-3
    schedule: str = "linear"
    participation: ParticipationConfig = ParticipationConfig()
    privacy: PrivacyConfig = PrivacyConfig()  # neutral default: disabled
    fedavg_every: int = 0                   # 0 = off
    ema_decay: float = 0.0                  # 0 = off
    tier_cap: Optional[int] = None          # cap on the pow2 cohort tier
    async_mode: bool = False                # True ⇒ staleness-tolerant agg
    stale_alpha: float = 0.6                # async merge weight at s=0
    stale_decay: float = 0.5                # polynomial staleness decay
    lag_s: float = 0.0                      # wall seconds per lag round
                                            # (the sync barrier's stall)

    def cut(self) -> CutPoint:
        return CutPoint(self.T, self.t_cut)

    def sched(self, device=None) -> DiffusionSchedule:
        mk = (DiffusionSchedule.linear if self.schedule == "linear"
              else DiffusionSchedule.cosine)
        return mk(self.T, device=device)


def _to_device(a, device, dtype=None) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))
    return t.to(device=device, dtype=dtype if dtype is not None
                else t.dtype)


class TrainRuntime:
    """The persistent federated training loop.  Construct once, register
    clients, ``run`` rounds; the registry, signatures, counters and EMA
    persist across calls."""

    def __init__(self, config: TrainConfig, init_one, apply_fn, key,
                 mesh=None, obs=None, device=None):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            deterministic_cuda()
        self.mesh = mesh
        self._writer = True              # this rank writes files and frames
        if mesh is not None:
            import torch.distributed as dist
            if mesh.device_type != self.device.type:
                raise ValueError(f"TrainRuntime: a {mesh.device_type} mesh "
                                 f"for a runtime on {self.device}")
            if mesh.get_coordinate() is None:
                raise ValueError("TrainRuntime: this rank is not in the "
                                 "mesh")
            self._writer = dist.get_rank() == 0
            if not self._writer:
                obs = None if isinstance(obs, ObsConfig) else obs
        self.config = config
        self.sched = config.sched(self.device)
        self.cut = config.cut()
        self._init_one = init_one
        self._apply_fn = apply_fn
        self._key = key.detach().cpu()      # the host's base key
        self.registry = ClientRegistry()
        self._obs = obs if isinstance(obs, Telemetry) \
            else Telemetry(obs if isinstance(obs, ObsConfig) else None)
        self._clock = self._obs.clock
        self.metrics = self._obs.registry
        self.metrics.declare_all(_TRAIN_REPORT_SCHEMA)
        self._c = {name: self.metrics.counter(name) for name in (
            "rounds", "real_samples", "padded_cells", "mid_round_drops",
            "stragglers", "stale_merges")}
        self.metrics.gauge("round", fn=lambda: self.round)
        self.metrics.gauge("n_registered", fn=lambda: len(self.registry))
        self.metrics.gauge("n_active",
                           fn=lambda: len(self.registry.active_uids()))
        self.metrics.gauge("pending_payloads",
                           fn=lambda: len(self._pending))
        self.metrics.gauge("seen_total", fn=lambda: sum(
            r.seen for r in self.registry.records()))
        self.metrics.gauge("dp_epoch", fn=lambda: self.dp_epoch)
        self.metrics.gauge("dp_epsilon", fn=lambda: (
            0.0 if self._accountant is None
            else float(self._accountant.epsilon())))
        self.round = 0                       # cohort cursor
        self.total_steps = 0                 # real (client, batch) cells
        self._sigs: Dict[int, set] = {}      # tier -> signatures seen
        # outstanding straggler uploads (async mode): each entry is
        # {uid, params, opt, compute_round, due_round, n_real}
        self._pending: List[Dict] = []
        self.dp_epoch = 0                    # applied DP releases so far
        self.on_dp_epoch = None              # callback(epoch) per release
        self._dp_clip_frac = 0.0             # last release's clip fraction
        if config.privacy.enabled:
            if not config.fedavg_every:
                raise ValueError(
                    "privacy is enforced at the cross-cohort aggregation "
                    "boundary: PrivacyConfig enabled requires "
                    "fedavg_every > 0")
            self._accountant = RdpAccountant(
                config.privacy.noise_multiplier, config.privacy.delta)
            # the broadcast reference deltas are clipped against
            self._dp_ref = self._init(prng.fold_in(
                prng.fold_in(self._key, TAG_DP), 0))
        else:
            self._accountant = None
            self._dp_ref = None
        self.server_params = self._init(prng.fold_in(
            prng.fold_in(self._key, TAG_INIT), 0))
        self.server_opt = init_opt_state(self.server_params)
        self.ema_server = (trees.copy(self.server_params)
                           if config.ema_decay > 0.0 else None)
        raw = make_vectorized_round(self.sched, self.cut, apply_fn,
                                    AdamWConfig(lr=config.lr), masked=True,
                                    identity_keyed=True)
        # the shared RecompileGuard: one count per new argument signature
        # (a new tier) — what the reference's jit trace counter counts
        self._guard = RecompileGuard(self.metrics.counter("engine_traces"))
        self._engine = self._guard.wrap(raw)
        self._obs.meta(runtime="train", T=config.T, t_cut=config.t_cut,
                       fedavg_every=config.fedavg_every,
                       async_mode=config.async_mode,
                       privacy=config.privacy.enabled,
                       device=str(self.device))

    def _init(self, key: torch.Tensor):
        return self._init_one(key.to(self.device))

    @property
    def traces(self) -> int:
        """Lifetime count of engine signatures (the RecompileGuard's)."""
        return self._guard.count

    @property
    def obs(self) -> Telemetry:
        """The runtime's telemetry bundle; long-lived callers call
        ``obs.close()`` at shutdown to flush the sinks."""
        return self._obs

    # -- control plane -----------------------------------------------------
    def register_client(self, x=None, y=None, uid: Optional[int] = None
                        ) -> int:
        """Admit a client: permanent uid, identity-keyed fresh model from
        ``fold_in(fold_in(base, TAG_INIT), 1 + uid)`` (slot 0 is the
        server)."""
        uid = self.registry.register(x=x, y=y, uid=uid,
                                     joined_round=self.round)
        rec = self.registry.get(uid)
        rec.params = self._init(prng.fold_in(
            prng.fold_in(self._key, TAG_INIT), 1 + uid))
        rec.opt = init_opt_state(rec.params)
        return uid

    def leave(self, uid: int) -> None:
        """Deactivate a client and discard its in-flight uploads: a uid
        that leaves and later rejoins must never receive an upload
        computed before it left."""
        self.registry.leave(uid)
        self._pending = [p for p in self._pending
                         if int(p["uid"]) != int(uid)]

    def rejoin(self, uid: int) -> None:
        self.registry.rejoin(uid)

    def attach_data(self, uid: int, x, y) -> None:
        self.registry.attach_data(uid, x, y)

    # -- reporting ---------------------------------------------------------
    def _empty_report(self) -> Dict:
        """Zeroed report with the FULL key set."""
        return {
            "round": self.round, "n_registered": len(self.registry),
            "n_active": len(self.registry.active_uids()),
            "cohort": [], "cohort_size": 0, "strict_subset": False,
            "tier": 0, "padded_client_slots": 0,
            "real_samples": 0, "padded_cells": 0, "pad_waste_frac": 0.0,
            "mid_round_drops": 0, "engine_traces": 0,
            "signatures_per_tier": {t: len(s)
                                    for t, s in sorted(self._sigs.items())},
            "max_signatures_per_tier": max(
                (len(s) for s in self._sigs.values()), default=0),
            "client_loss": 0.0, "server_loss": 0.0,
            "fedavg_applied": False, "seen_total": 0, "wall_s": 0.0,
            "stragglers": 0, "stale_merges": 0, "barrier_stall_s": 0.0,
            "pending_payloads": len(self._pending),
            "dp_epsilon": 0.0, "dp_epoch": 0, "dp_clip_frac": 0.0,
        }

    def _dp_report(self) -> Dict:
        if self._accountant is None:
            return {"dp_epsilon": 0.0, "dp_epoch": 0, "dp_clip_frac": 0.0}
        return {"dp_epsilon": float(self._accountant.epsilon()),
                "dp_epoch": int(self.dp_epoch),
                "dp_clip_frac": float(self._dp_clip_frac)}

    # -- async delivery ----------------------------------------------------
    def _deliver(self, payload: Dict, delivery_round: int) -> bool:
        """Fold one late upload into its client's record at the
        staleness-decayed weight (the opt state travels with the upload
        and replaces the record's).  False when the client left."""
        rec = self.registry.get(int(payload["uid"]))
        if not rec.active:
            return False
        s = max(int(delivery_round) - int(payload["compute_round"]) - 1, 0)
        rec.params = average_stale(rec.params, payload["params"], s,
                                   self.config.stale_alpha,
                                   self.config.stale_decay)
        rec.opt = payload["opt"]
        n_real = int(payload["n_real"])
        rec.seen += n_real
        rec.window_seen += n_real
        rec.window_member = True
        return True

    @staticmethod
    def _delivery_order(p: Dict) -> tuple:
        return (int(p["due_round"]), int(p["compute_round"]),
                int(p["uid"]))

    def _deliver_due(self) -> int:
        due = [p for p in self._pending
               if int(p["due_round"]) <= self.round]
        if not due:
            return 0
        self._pending = [p for p in self._pending
                         if int(p["due_round"]) > self.round]
        return sum(int(self._deliver(p, self.round))
                   for p in sorted(due, key=self._delivery_order))

    def drain(self) -> int:
        """Flush every outstanding straggler upload now, each at the
        staleness its due round implies; returns the number merged."""
        pending, self._pending = self._pending, []
        return sum(
            int(self._deliver(p, max(self.round, int(p["due_round"]))))
            for p in sorted(pending, key=self._delivery_order))

    # -- the loop ----------------------------------------------------------
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run_round(self) -> Dict:
        """One federated round: deliver due async uploads → sample cohort →
        plan → one engine call on the cohort's models → aggregate →
        report.  The cursor advances even for an empty round."""
        t0 = self._clock()
        cfg = self.config
        tr = self._obs.tracer
        snap = self.metrics.snapshot()
        rspan = tr.start("round", round=self.round)
        self._obs.step()
        with tr.span("cohort_sample", parent=rspan):
            stale_merges = self._deliver_due() if self._pending else 0
            active = self.registry.active_uids()
            busy = {int(p["uid"]) for p in self._pending}
            if busy:
                # a client whose upload is in flight sits the round out
                active = [u for u in active if u not in busy]
            cohort = sample_cohort(cfg.participation, self._key,
                                   self.round, active)
            if cfg.tier_cap is not None and len(cohort) > cfg.tier_cap:
                # the cap bounds the cohort: keep the tier_cap members with
                # the smallest participation scores
                scores = uid_scores(self._key, TAG_PART, self.round,
                                    cohort)
                order = np.lexsort((np.asarray(cohort), scores))
                cohort = sorted(int(cohort[i])
                                for i in order[:cfg.tier_cap])
            drops = sample_drops(cfg.participation, self._key, self.round,
                                 cohort, cfg.batches_per_round)
            lags = sample_lags(cfg.participation, self._key, self.round,
                               cohort)
        report = self._empty_report()
        with tr.span("plan", parent=rspan, cohort_size=len(cohort)):
            plan = plan_round(
                self.registry, cohort, self.round, self._key,
                n_batches=cfg.batches_per_round, batch_size=cfg.batch_size,
                image_shape=cfg.image_shape, n_classes=cfg.n_classes,
                tier_cap=cfg.tier_cap, drops=drops, device=self.device)
        report.update({"cohort": list(cohort), "cohort_size": len(cohort),
                       "strict_subset": len(cohort) < len(active),
                       "mid_round_drops": len(drops),
                       "stragglers": len(lags),
                       "stale_merges": stale_merges})
        self._c["mid_round_drops"].inc(len(drops))
        self._c["stragglers"].inc(len(lags))
        self._c["stale_merges"].inc(stale_merges)
        if plan is None:
            with tr.span("fedavg", parent=rspan):
                report["fedavg_applied"] = self._maybe_fedavg()
            self._update_ema()
            self.round += 1
            self._c["rounds"].inc()
            report.update(self._dp_report())
            report["pending_payloads"] = len(self._pending)
            report["wall_s"] = self._clock() - t0
            tr.end(rspan, empty=True)
            self._obs.frame_closed(snap, extra={
                "round": self.round - 1, "wall_s": report["wall_s"]})
            return report

        mask_np = plan.mask
        with tr.span("round_dispatch", parent=rspan, tier=plan.tier,
                     cohort_size=len(plan.cohort)):
            members = [self.registry.get(u) for u in plan.cohort]
            pad = plan.tier - len(members)
            # an async straggler trains a copy: its record stays as it was
            # until the upload lands
            late = {m for m, u in enumerate(plan.cohort)
                    if cfg.async_mode and int(u) in lags and
                    mask_np[:, m, :].any()}
            cp = [trees.copy(r.params) if m in late else r.params
                  for m, r in enumerate(members)]
            co = [trees.copy(r.opt) if m in late else r.opt
                  for m, r in enumerate(members)]
            # pad slots repeat member 0: their mask is all-zero, so the
            # engine never touches them
            cp += [cp[0]] * pad
            co += [co[0]] * pad
            rkey = prng.fold_in(prng.fold_in(self._key, TAG_ROUND),
                                self.round)
            xs, ys, mask, uids = plan.xs, plan.ys, mask_np, plan.uids
            if self.mesh is not None:
                xs, ys, mask, uids = shard_cohort_round(self.mesh, xs, ys,
                                                        mask, uids)
            _, _, self.server_params, self.server_opt, metrics = \
                self._engine(cp, co, self.server_params, self.server_opt,
                             xs, ys, mask, uids, rkey.to(self.device))
            owners = None if self.mesh is None else \
                slot_owners(self.mesh, plan.tier)
            if owners is not None:
                # each real slot from its owner to every rank
                broadcast_slots(cp, co, self.mesh, [
                    m for m in range(len(members))
                    if mask_np[:, m, :].any()], owners)
            self._sync()
        self._sigs.setdefault(plan.tier, set()).add(plan.signature())

        stall = 0.0
        if lags and not cfg.async_mode:
            # THE BARRIER: sync aggregation waits for the slowest upload,
            # then applies every upload as if nobody lagged
            stall = cfg.lag_s * max(lags.values())
            if stall > 0.0:
                with tr.span("barrier_stall", parent=rspan,
                             seconds=stall):
                    time.sleep(stall)

        for m, rec in enumerate(members):
            n_real = int(mask_np[:, m, :].sum())
            uid = int(plan.cohort[m])
            if m in late:
                self._pending.append({
                    "uid": uid, "params": cp[m], "opt": co[m],
                    "compute_round": int(self.round),
                    "due_round": int(self.round + lags[uid]),
                    "n_real": n_real,
                })
                continue
            rec.seen += n_real
            rec.window_seen += n_real
            rec.window_member = True
        cells = mask_np.any(axis=2)                 # (nb, tier)
        self.total_steps += int(cells.sum())
        self._c["real_samples"].inc(plan.real_samples)
        self._c["padded_cells"].inc(plan.padded_cells)

        report.update(self._losses(metrics, mask_np))
        with tr.span("fedavg", parent=rspan):
            report["fedavg_applied"] = self._maybe_fedavg()
        self._update_ema()
        self.round += 1
        self._c["rounds"].inc()
        report.update(self._dp_report())
        report.update({
            "tier": plan.tier, "padded_client_slots": pad,
            "real_samples": plan.real_samples,
            "padded_cells": plan.padded_cells,
            "pad_waste_frac": plan.padded_cells / plan.mask.size,
            "engine_traces": self.metrics.delta("engine_traces", snap),
            "signatures_per_tier": {t: len(s)
                                    for t, s in sorted(self._sigs.items())},
            "max_signatures_per_tier": max(len(s)
                                           for s in self._sigs.values()),
            "seen_total": sum(r.seen for r in self.registry.records()),
            "barrier_stall_s": stall,
            "pending_payloads": len(self._pending),
            "wall_s": self._clock() - t0,
        })
        tr.end(rspan, tier=plan.tier)
        self._obs.frame_closed(snap, extra={
            "round": self.round - 1, "wall_s": report["wall_s"]})
        return report

    def run(self, n_rounds: int, checkpoint_path: Optional[str] = None,
            checkpoint_every: int = 1) -> List[Dict]:
        """Run ``n_rounds`` rounds; checkpoint after every
        ``checkpoint_every``-th round (and once more at the end) when a
        path is given."""
        reports = []
        saved_at = -1
        tr = self._obs.tracer
        for i in range(n_rounds):
            reports.append(self.run_round())
            if checkpoint_path and checkpoint_every > 0 and \
                    (i + 1) % checkpoint_every == 0:
                with tr.span("checkpoint", round=self.round):
                    self.save(checkpoint_path)
                saved_at = i
        if checkpoint_path and saved_at != n_rounds - 1:
            with tr.span("checkpoint", round=self.round):
                self.save(checkpoint_path)
        return reports

    # -- aggregation -------------------------------------------------------
    def _maybe_fedavg(self) -> bool:
        cfg = self.config
        if not cfg.fedavg_every or (self.round + 1) % cfg.fedavg_every:
            return False
        recs = self.registry.records()
        if not recs:
            return False
        # a member that LEFT since it trained neither contributes nor
        # receives: departure freezes its model until rejoin
        members = [r.window_member and r.active for r in recs]
        if cfg.privacy.enabled:
            return self._dp_fedavg(recs, members)
        # the plain path, kept as it is: the identity ladder is structural
        new = average_cohort([r.params for r in recs],
                             [r.window_seen for r in recs], members)
        applied = any(m and r.window_seen > 0
                      for m, r in zip(members, recs))
        for r, p in zip(recs, new):
            r.params = p
            r.window_seen = 0
            r.window_member = False
        return applied

    def _dp_fedavg(self, recs, members) -> bool:
        """The DP release at the fedavg boundary; charges the accountant
        once per applied release at the window-composed sampling rate."""
        cfg = self.config
        # a party that trained this window but left before uploading is a
        # SecAgg dropout: the recovery path removes its pair masks
        dropped = [int(r.uid) for r in recs
                   if r.window_member and not r.active]
        new, new_ref, stats = dp_average_cohort(
            [r.params for r in recs], [r.window_seen for r in recs],
            members, self._dp_ref, [r.uid for r in recs],
            clip=cfg.privacy.clip,
            noise_multiplier=cfg.privacy.noise_multiplier,
            base_key=self._key, round_idx=self.round,
            secagg=cfg.privacy.secagg, dropped_uids=dropped)
        applied = bool(stats["applied"])
        if applied:
            self._dp_ref = new_ref
            self._dp_clip_frac = float(stats["clip_frac"])
            q = sampling_rate(cfg.participation,
                              len(self.registry.active_uids()))
            q_window = 1.0 - (1.0 - q) ** max(int(cfg.fedavg_every), 1)
            self._accountant.charge(q_window)
            self.dp_epoch += 1
            if self.on_dp_epoch is not None:
                self.on_dp_epoch(self.dp_epoch)
        for r, p in zip(recs, new):
            r.params = p
            r.window_seen = 0
            r.window_member = False
        return applied

    @torch.no_grad()
    def _update_ema(self) -> None:
        """ema = d·ema + (1 − d)·server in float32, each leaf kept in its
        dtype, in place."""
        d = self.config.ema_decay
        if self.ema_server is None or d <= 0.0:
            return
        for e, p in zip(trees.leaves(self.ema_server),
                        trees.leaves(self.server_params)):
            e.copy_((d * e.float() + (1.0 - d) * p.float()).to(p.dtype))

    def sampling_server_params(self):
        """The server model inference should load: the EMA track when
        enabled, else the trained model."""
        return (self.server_params if self.ema_server is None
                else self.ema_server)

    def _losses(self, metrics, mask_np) -> Dict[str, float]:
        valid = mask_np.any(axis=2)                 # (nb, tier)
        if not valid.any():
            return {"client_loss": 0.0, "server_loss": 0.0}
        cl = metrics["client_loss"].cpu().numpy()
        out = {"client_loss": float(cl[valid].mean())}
        b_srv = int(np.nonzero(valid.any(axis=1))[0][-1])
        sl = metrics["server_loss"].cpu().numpy()
        out["server_loss"] = float(sl[b_srv])
        return out

    # -- persistence -------------------------------------------------------
    def state_dict(self) -> Dict:
        """The FULL resumable state in the reference's layout (version 3);
        a model as its ``{name: tensor}`` parameters.  Client data is
        absent: re-attach it by uid after ``restore``."""
        P = trees.as_tree
        clients = {}
        for rec in self.registry.records():
            clients[str(rec.uid)] = {
                "params": P(rec.params), "opt": rec.opt,
                "seen": int(rec.seen),
                "window_seen": int(rec.window_seen),
                "window_member": bool(rec.window_member),
                "joined_round": int(rec.joined_round),
                "active": bool(rec.active),
            }
        privacy = None
        if self._accountant is not None:
            privacy = {"dp_ref": P(self._dp_ref),
                       "dp_epoch": int(self.dp_epoch),
                       "accountant": self._accountant.state_dict()}
        return {
            "version": 3,
            "privacy": privacy,
            "round": int(self.round),
            "total_steps": int(self.total_steps),
            "base_key": _key_pack(self._key),
            "server_params": P(self.server_params),
            "server_opt": self.server_opt,
            "ema_server": P(self.ema_server),
            "clients": clients,
            "pending": [
                {"uid": int(p["uid"]), "params": P(p["params"]),
                 "opt": p["opt"],
                 "compute_round": int(p["compute_round"]),
                 "due_round": int(p["due_round"]),
                 "n_real": int(p["n_real"])}
                for p in self._pending],
        }

    def save(self, path: str) -> None:
        """Write the checkpoint (rank 0 of a mesh alone; the other ranks
        wait until the file is whole)."""
        if self._writer:
            ckpt.save(path, self.state_dict())
        if self.mesh is not None and self.mesh.size() > 1:
            import torch.distributed as dist
            dist.barrier(group=self.mesh.get_group())

    def _params_from(self, template, saved):
        """A model of ``template``'s kind holding the saved parameters."""
        if saved is None:
            return None
        if isinstance(template, nn.Module):
            model = trees.copy(template)
            with torch.no_grad():
                for n, p in model.named_parameters():
                    p.copy_(_to_device(saved[n], self.device, p.dtype))
            return model
        return {n: _to_device(saved[n], self.device, t.dtype)
                .requires_grad_(t.requires_grad)
                for n, t in template.items()}

    def _opt_from(self, template, saved) -> Dict:
        """An AdamW state for ``template`` (moments in its parameter
        order) from a saved one; the step stays on the host."""
        names = list(named(template))
        mom = lambda k: {n: _to_device(saved[k][n], self.device,
                                       torch.float32) for n in names}
        return {"m": mom("m"), "v": mom("v"),
                "step": torch.tensor(int(np.asarray(saved["step"])),
                                     dtype=torch.int32)}

    @classmethod
    def restore(cls, config: TrainConfig, init_one, apply_fn, path: str,
                mesh=None, obs=None, device=None) -> "TrainRuntime":
        """Rebuild a runtime from a checkpoint (versions 1–3, the port's
        or the reference's): models, AdamW states, registry, cursor and
        key resume where they stopped, so continuing is bitwise never
        having stopped.  Data is not in the checkpoint: call
        ``attach_data(uid, x, y)`` for every client that keeps training.
        On a ``mesh`` every rank reads the file."""
        state = ckpt.load(path)
        if state.get("version") not in (1, 2, 3):
            raise ValueError(f"unknown checkpoint version "
                             f"{state.get('version')!r}")
        rt = cls(config, init_one, apply_fn, _key_unpack(state["base_key"]),
                 mesh=mesh, obs=obs, device=device)
        tmpl = rt.server_params
        P = lambda saved: rt._params_from(tmpl, saved)
        priv = state.get("privacy")
        if priv is not None:
            if not config.privacy.enabled:
                raise ValueError(
                    "checkpoint carries DP state (format v3) but the "
                    "config's PrivacyConfig is disabled — resuming a DP "
                    "run without its privacy config would silently stop "
                    "clipping/noising mid-stream")
            rt._dp_ref = P(priv["dp_ref"])
            rt.dp_epoch = int(priv["dp_epoch"])
            rt._accountant = RdpAccountant.from_state(priv["accountant"])
        rt.round = int(state["round"])
        rt.total_steps = int(state["total_steps"])
        rt.server_params = P(state["server_params"])
        rt.server_opt = rt._opt_from(tmpl, state["server_opt"])
        rt.ema_server = P(state["ema_server"])
        rt._pending = [
            dict(p, params=P(p["params"]), opt=rt._opt_from(tmpl, p["opt"]))
            for p in state.get("pending", [])]
        for uid_s in sorted(state["clients"], key=int):
            d = state["clients"][uid_s]
            uid = int(uid_s)
            rt.registry.register(uid=uid,
                                 joined_round=int(d["joined_round"]))
            rec = rt.registry.get(uid)
            rec.params = P(d["params"])
            rec.opt = rt._opt_from(tmpl, d["opt"])
            rec.seen = int(d["seen"])
            rec.window_seen = int(d["window_seen"])
            rec.window_member = bool(d["window_member"])
            rec.active = bool(d["active"])
        return rt
