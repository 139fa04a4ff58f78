"""DP-FedAvg primitives — the one clip+noise mechanism shared by the
update-DP path (cohort aggregation, this module + train/runtime.py) and
the payload-DP path (Alg.-1 x_{t_s}, core/protocol.make_payload).

The port of the JAX package's ``privacy/dp.py``.  Each contributing
member's window UPDATE (its model minus the current broadcast reference)
is clipped to ``clip`` in GLOBAL L2 norm over the whole model, the clipped
updates are summed exactly (privacy/secagg.py's fixed-point pipeline, the
same sum with pairwise masking on or off), Gaussian noise of std
``noise_multiplier · clip`` is added to the sum, and the noised mean
becomes the new broadcast reference every member adopts ([McMahan et al.
2018]).  The sensitivity of the sum to one member is ``clip``, so each
release is the subsampled Gaussian mechanism privacy/accountant.py
composes.

Randomness is addressed, never chained: a round's noise key is
``fold_in(fold_in(fold_in(base_key, TAG_DP), round), uid)`` (uid 0 for the
server's draw) and leaf i draws from ``fold_in(noise_key, i)`` — the
leaves of a model in ``core/trees.leaves`` order, all in one pass
(``prng.leafwise_bits``).

The identity ladder (``clip=inf, noise_multiplier=0, secagg=False``
bitwise equal to the runtime without privacy) is structural: a disabled
``PrivacyConfig`` sends the runtime down ``fedavg.average_cohort``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import prng, trees
from repro_torch.core.splitting import row_keys
from repro_torch.privacy import secagg as _secagg

# Stream tag for DP noise (disjoint from train/participation.py's TAG_*
# block and secagg.TAG_SECAGG).
TAG_DP = 0xD9C1

# The shared payload-clip convention (one DP_CLIP across the payload-DP
# and update-DP paths): ~ the typical payload L2 norm at 8x8x3.
DP_CLIP = 16.0


@dataclasses.dataclass(frozen=True)
class PrivacyConfig:
    """The train runtime's privacy knob.  Neutral defaults (clip=inf,
    noise_multiplier=0, secagg=False) disable the subsystem: the runtime
    then runs the plain aggregation path bitwise."""
    clip: float = math.inf          # per-member update L2 clip C
    noise_multiplier: float = 0.0   # sigma: noise std = sigma * C
    delta: float = 1e-5             # accountant's delta target
    secagg: bool = False            # pairwise-masked uploads

    def __post_init__(self):
        if not self.clip > 0.0:
            raise ValueError(f"clip must be > 0, got {self.clip}")
        if self.noise_multiplier < 0.0:
            raise ValueError(f"noise_multiplier must be >= 0, got "
                             f"{self.noise_multiplier}")
        if not 0.0 < self.delta < 1.0:
            raise ValueError(f"delta must be in (0, 1), got {self.delta}")
        if self.noise_multiplier > 0.0 and math.isinf(self.clip):
            raise ValueError("noise_multiplier > 0 needs a finite clip "
                             "(noise std is sigma * clip)")

    @property
    def enabled(self) -> bool:
        return (not math.isinf(self.clip)) or \
            self.noise_multiplier > 0.0 or self.secagg


def dp_noise_key(base_key: torch.Tensor, round_idx: int, uid: int = 0):
    """The addressed key for round ``round_idx``'s noise draw."""
    return prng.fold_in(prng.fold_in(
        prng.fold_in(base_key, TAG_DP), round_idx), uid)


def global_l2_norm(tree) -> torch.Tensor:
    """float32 L2 norm over EVERY leaf of the tree (one bound per member,
    not per layer): the per-leaf sums of squares added in leaf order."""
    sq = sum(torch.sum(torch.square(l.float())) for l in trees.leaves(tree))
    return torch.sqrt(torch.as_tensor(sq, dtype=torch.float32))


def clip_by_global_norm(tree, clip: float):
    """(``tree`` scaled to global L2 norm ≤ ``clip`` by min(1, C /
    max(norm, 1e-9)), the pre-clip norm).  ``clip=inf`` returns the tree
    itself (an identity, not an arithmetic ·1.0)."""
    norm = global_l2_norm(tree)
    if math.isinf(clip):
        return tree, norm
    scale = torch.clamp(clip / torch.clamp(norm, min=1e-9), max=1.0)
    return trees.tree_map(
        lambda l: (l.float() * scale.to(l.device)).to(l.dtype), tree), norm


def gaussian_noise_like(key: torch.Tensor, template, std: float):
    """A tree of N(0, std²) float32 draws shaped like ``template``, leaf i
    from ``fold_in(key, i)``; std=0 gives exact zeros."""
    ls = trees.leaves(template)
    if not ls:
        return trees.unflatten(template, [])
    dev = ls[0].device
    if not std:
        noise = [torch.zeros(l.shape, dtype=torch.float32, device=dev)
                 for l in ls]
    else:
        bits = prng.leafwise_bits(key.to(dev), [tuple(l.shape) for l in ls])
        s = np.float32(std)
        noise = [prng.normal_from_bits(b) * s for b in bits]
    return trees.unflatten(template, noise)


def tree_sub(a, b) -> List[torch.Tensor]:
    """float32 leafwise a − b (a member's window update against the
    broadcast reference), as the list of its leaves in leaf order: a
    module's update is not a module of the module's dtype."""
    return [x.detach().float() - y.detach().float()
            for x, y in zip(trees.leaves(a), trees.leaves(b))]


# ---------------------------------------------------------------------------
# The update-DP aggregation (the average_cohort boundary)
# ---------------------------------------------------------------------------


def dp_average_cohort(client_params: List, seen: Sequence[int],
                      members: Sequence[bool], ref, uids: Sequence[int], *,
                      clip: float, noise_multiplier: float,
                      base_key: torch.Tensor, round_idx: int,
                      secagg: bool = False,
                      dropped_uids: Sequence[int] = (),
                      ) -> Tuple[List, object, Dict[str, float]]:
    """DP-FedAvg at the ``fedavg.average_cohort`` boundary.

    * Contributors are members with ``seen > 0``; each adds its clipped
      window delta ``clip_C(θ_c − ref)`` at weight 1 (the unweighted mean:
      sample-count weights would leak, and would break the C-sensitivity
      bound);
    * the sum runs through privacy/secagg.py's fixed-point pipeline with
      ``secagg`` on or off: bitwise the same aggregate;
    * ``dropped_uids`` are mask-agreement parties that trained this window
      but left before uploading (the recovery path removes their masks);
    * the noised mean becomes the new broadcast ``ref``; EVERY member
      (zero-seen included) adopts its own copy, an absent client comes
      back as it was (the same object);
    * no contributor: a no-op, nothing spent.

    Returns (new client list, new ref, stats) with ``n_contributors``,
    ``clip_frac`` (contributors whose pre-clip norm exceeded C) and
    ``applied`` (0/1)."""
    n = len(client_params)
    if not (len(seen) == len(members) == len(uids) == n):
        raise ValueError(f"one seen-count, member flag and uid per client:"
                         f" {len(seen)}/{len(members)}/{len(uids)} != {n}")
    idx = [c for c in range(n) if members[c] and int(seen[c]) > 0]
    stats = {"n_contributors": len(idx), "clip_frac": 0.0, "applied": 0.0}
    if not idx:
        return list(client_params), ref, stats

    deltas, clipped_ct = [], 0
    for c in idx:
        d, norm = clip_by_global_norm(tree_sub(client_params[c], ref), clip)
        deltas.append(d)
        if not math.isinf(clip) and float(norm) > clip:
            clipped_ct += 1
    stats["clip_frac"] = clipped_ct / len(idx)

    cohort_uids = sorted([int(uids[c]) for c in idx] +
                         [int(u) for u in dropped_uids])
    uploads = {int(uids[c]): d for c, d in zip(idx, deltas)}
    total = _secagg.secagg_sum(uploads, cohort_uids, base_key, round_idx,
                               masked=secagg)

    std = noise_multiplier * clip if noise_multiplier > 0.0 else 0.0
    if std > 0.0:
        noise = gaussian_noise_like(dp_noise_key(base_key, round_idx),
                                    total, std)
        total = [t + z for t, z in zip(total, noise)]

    m = float(len(idx))
    new_ref = trees.unflatten(ref, [
        (r.detach().float() + t / m).to(r.dtype)
        for r, t in zip(trees.leaves(ref), total)])
    out = list(client_params)
    for c in range(n):
        if members[c]:
            out[c] = trees.copy(new_ref)
    stats["applied"] = 1.0
    return out, new_ref, stats


# ---------------------------------------------------------------------------
# Payload DP (the Alg.-1 x_{t_s} path): core/protocol.make_payload's
# mechanism, kept here so that both DP paths share one clip+noise.
# ---------------------------------------------------------------------------


def rowwise_normal(key: torch.Tensor, shape) -> torch.Tensor:
    """(B, ...) standard normals with row-keyed draws: row i depends only
    on (key, i) — protocol.rowwise_normal, repeated here so that this
    module stays below core/protocol in the import order."""
    return prng.normal(row_keys(key, shape[0]), tuple(shape[1:]))


def clip_rows(x: torch.Tensor, clip: float) -> torch.Tensor:
    """Per-SAMPLE L2 clip over a (B, ...) batch: the payload-DP face of
    the clipping convention."""
    B = x.shape[0]
    flat = x.reshape(B, -1)
    norm = torch.linalg.vector_norm(flat.float(), dim=1, keepdim=True)
    scale = torch.clamp(clip / torch.clamp(norm, min=1e-9), max=1.0)
    return (flat * scale).reshape(x.shape)


def privatize_payload(x: torch.Tensor, key: torch.Tensor, sigma: float,
                      clip: float) -> torch.Tensor:
    """Gaussian-mechanism noising of a shipped payload batch: per-row clip
    to ``clip`` then N(0, (sigma·clip)²) row-keyed noise."""
    clipped = clip_rows(x, clip)
    noise = rowwise_normal(key, x.shape)
    return (clipped + sigma * clip * noise).to(x.dtype)
