"""Round planning: cohort → one shape-stable padded stack per tier; the
port of the JAX package's ``train/rounds.py``.

The masked engine makes zero-padding inert within a client stack
(row/batch masking); this module extends it to the CLIENT AXIS: a
round's cohort is seated into a stack padded to the next power-of-two
participation TIER, the pad slots fully masked.  Batch count and batch
size are pinned by the runtime config, so a round's signature depends on
nothing but the tier: drifting cohort sizes {3, 5, 2, 4, …} converge on
the tier menu {4, 8} (the runtime's RecompileGuard counts exactly one
signature per tier, as the reference's jit trace counter does).

Everything in a plan comes from addressed draws: member m's batches this
round are its own dataset shuffled by
``fold_in(fold_in(fold_in(base, TAG_DATA), round), uid)`` (``prng.
permutation`` on the host, bit for bit JAX's), and the pad slots repeat
member 0's uid — harmless, because their mask is all-zero and the engine
never computes them.  The stacks are tensors on the runtime's device;
the mask is a host numpy array (the engine decides on the host which
cells to skip) and the uid vector a host int32 array, so a plan's mask,
uids and signature equal the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.data.synthetic import batches
from repro_torch.train.participation import TAG_DATA
from repro_torch.train.registry import ClientRegistry


def participation_tier(n: int, cap: Optional[int] = None) -> int:
    """Next power of two >= max(n, 1), optionally capped — the cohort
    axis's fixed shape menu (the client-axis sibling of
    serve/scheduler.tier).  Like its sibling, the cap is rounded UP to
    a power of two before applying: a raw non-pow2 cap would leak a
    non-pow2 tier into the menu and defeat the finite-signature
    guarantee the runtime's trace-counter guard asserts."""
    t = 1
    while t < n:
        t *= 2
    if cap is None:
        return t
    c = 1
    while c < max(cap, 1):
        c *= 2
    return min(t, c)


@dataclasses.dataclass
class RoundPlan:
    """One round's engine inputs: fixed-shape stacks + the identity
    vector.  ``cohort`` lists the real member uids (slot order);
    slots ``len(cohort)..tier-1`` are all-masked padding."""
    round_idx: int
    cohort: List[int]
    tier: int
    xs: torch.Tensor          # (n_batches, tier, B, H, W, C)
    ys: torch.Tensor          # (n_batches, tier, B, n_classes)
    mask: np.ndarray          # (n_batches, tier, B) 0/1 validity (host)
    uids: np.ndarray          # (tier,) int32 registry identities (host)
    drops: Dict[int, int]     # uid -> first masked batch slot (mid-round)

    @property
    def real_samples(self) -> int:
        return int(np.asarray(self.mask).sum())

    @property
    def padded_cells(self) -> int:
        return int(self.mask.size) - self.real_samples

    def signature(self) -> tuple:
        """What a jit would key its compiles on — shapes only, never
        values."""
        return (tuple(self.xs.shape), tuple(self.ys.shape),
                tuple(self.mask.shape), tuple(self.uids.shape))


def plan_round(registry: ClientRegistry, cohort: Sequence[int],
               round_idx: int, base_key, *, n_batches: int, batch_size: int,
               image_shape, n_classes: int, tier_cap: Optional[int] = None,
               drops: Optional[Dict[int, int]] = None, device=None
               ) -> Optional[RoundPlan]:
    """Build the padded stacks for ``cohort``.  Returns None for an empty
    cohort or when no member holds a single sample (the runtime then
    advances the cursor without an engine call).  Each member contributes
    up to ``n_batches`` batches of up to ``batch_size`` rows from its own
    registry data (round-keyed shuffle, trailing partial batch kept);
    shorter members are row/batch-masked like any ragged client.
    The stacks go to ``device`` (default: the first member's data's)."""
    cohort = list(cohort)
    if not cohort:
        return None
    tier = participation_tier(len(cohort), tier_cap)
    if len(cohort) > tier:
        raise ValueError(f"cohort of {len(cohort)} exceeds tier cap {tier}")
    H, W, C = image_shape
    if device is None:
        device = next((registry.get(u).x.device for u in cohort
                       if registry.get(u).n_samples), "cpu")
    xs = torch.zeros((n_batches, tier, batch_size, H, W, C),
                     dtype=torch.float32, device=device)
    ys = torch.zeros((n_batches, tier, batch_size, n_classes),
                     dtype=torch.float32, device=device)
    mask = np.zeros((n_batches, tier, batch_size), np.float32)
    dkey = prng.fold_in(base_key.cpu(), TAG_DATA)
    rkey = prng.fold_in(dkey, round_idx)
    drops = drops or {}
    for m, uid in enumerate(cohort):
        rec = registry.get(uid)
        if rec.n_samples == 0:
            continue
        it = batches(rec.x, rec.y, batch_size,
                     key=prng.fold_in(rkey, uid), drop_last=False)
        for b, (x, y) in enumerate(it):
            if b >= n_batches:
                break
            n = x.shape[0]
            xs[b, m, :n] = x.to(device)
            ys[b, m, :n] = y.to(device)
            mask[b, m, :n] = 1.0
        if uid in drops:                  # gone from slot d onward
            mask[drops[uid]:, m, :] = 0.0
    if mask.sum() == 0:
        return None
    pad_uid = cohort[0]
    uid_vec = np.asarray(cohort + [pad_uid] * (tier - len(cohort)), np.int32)
    return RoundPlan(round_idx=round_idx, cohort=cohort, tier=tier,
                     xs=xs, ys=ys, mask=mask, uids=uid_vec,
                     drops=dict(drops))
