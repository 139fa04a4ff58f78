"""Client registry — the control plane of the federated training runtime.

The port of the JAX package's ``train/registry.py`` (no array code: a
record's ``params`` is the client's model, an ``nn.Module`` or a dict of
tensors, and ``opt`` its AdamW state).

A CollaFuse deployment's client set is not a fixed list: edge devices
join, leave, rejoin, and sit out rounds.  The registry gives every client
a PERMANENT integer identity (``uid``) the moment it first registers —
uids are never reused, and everything downstream keys on them rather than
on list position:

  * PRNG: a client's ε/t draws come from ``fold_in(batch_key, uid)``
    (protocol.client_keys) and its parameter init from
    ``fold_in(init_key, uid)``, so join order, cohort seating, and the
    comings and goings of OTHER clients never perturb its streams;
  * participation: the sampler (train/participation.py) scores uids, so
    one client's draw is independent of the rest of the roster;
  * aggregation: FedAvg weights are the per-uid seen-sample counters
    tracked here (padded/masked cells never count).

Records hold the client's model/optimizer trees and (optionally) its
local dataset.  The DATA never leaves the record and is never
checkpointed — the paper's split-learning premise — while params, opt
states, counters, and membership flags round-trip through the runtime
checkpoint (train/runtime.py ``state_dict``); on resume the caller
re-attaches each client's local data by uid.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional


@dataclasses.dataclass
class ClientRecord:
    """One registered client.  ``params``/``opt`` are the client's own
    model and AdamW state (the round engine updates them in place);
    ``x``/``y`` are the local dataset (may be absent after a checkpoint
    restore until the caller re-attaches it)."""
    uid: int
    params: Any = None
    opt: Any = None
    x: Any = None
    y: Any = None
    seen: int = 0            # lifetime real samples trained (mask-counted)
    window_seen: int = 0     # real samples since the last FedAvg window
    window_member: bool = False  # cohort member since the last window
    joined_round: int = 0
    active: bool = True

    @property
    def n_samples(self) -> int:
        return 0 if self.x is None else int(self.x.shape[0])


class ClientRegistry:
    """uid -> ClientRecord map with monotone uid assignment.  Leaving
    marks a record inactive (params retained — a rejoining client resumes
    its own net); uids of departed clients are never recycled, so every
    identity-keyed stream stays unambiguous for the lifetime of the run."""

    def __init__(self):
        self._records: Dict[int, ClientRecord] = {}
        self._next_uid = 0

    def register(self, x=None, y=None, uid: Optional[int] = None,
                 joined_round: int = 0) -> int:
        if uid is None:
            uid = self._next_uid
        if uid < 0:
            raise ValueError(f"uid must be non-negative, got {uid}")
        if uid in self._records:
            raise ValueError(f"uid {uid} already registered (uids are "
                             f"permanent — rejoin() a departed client)")
        self._next_uid = max(self._next_uid, uid + 1)
        self._records[uid] = ClientRecord(uid=uid, x=x, y=y,
                                          joined_round=joined_round)
        return uid

    def leave(self, uid: int) -> None:
        self.get(uid).active = False

    def rejoin(self, uid: int) -> None:
        self.get(uid).active = True

    def attach_data(self, uid: int, x, y) -> None:
        rec = self.get(uid)
        rec.x, rec.y = x, y

    def get(self, uid: int) -> ClientRecord:
        if uid not in self._records:
            raise KeyError(f"unknown client uid {uid}")
        return self._records[uid]

    def uids(self) -> List[int]:
        return sorted(self._records)

    def active_uids(self) -> List[int]:
        return sorted(u for u, r in self._records.items() if r.active)

    def records(self) -> List[ClientRecord]:
        return [self._records[u] for u in self.uids()]

    def __len__(self) -> int:
        return len(self._records)

    def __contains__(self, uid: int) -> bool:
        return uid in self._records
