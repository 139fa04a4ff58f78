"""Partial-participation sampling — identity-keyed, so policy is never
semantics.

FL practice (de Goede et al.; Phoenix) trains each round on a sampled
COHORT of the registered clients, and real cohorts shrink further when
members drop mid-round.  Every draw here is ADDRESSED, never chained
(the serve runtime's discipline): a client's participation score for
round r is a pure function of ``(base_key, tag, r, uid)``, computed as

    uniform(fold_in(fold_in(fold_in(base_key, TAG), r), uid))

so registering or removing one client never perturbs another's draws,
and a checkpoint needs only (base_key, round cursor) to reproduce every
future cohort bitwise — the mid-run-resume guarantee of
train/runtime.py.

Policies:
  * ``full``      — everyone active (the fixed-roster baseline);
  * ``bernoulli`` — each active client independently with prob ``p``;
  * ``fixed``     — the ``cohort_k`` active clients with the smallest
                    scores (uniform-without-replacement in distribution).

Mid-round DROPOUT (``drop_p``): a cohort member drops with prob
``drop_p`` at a batch slot derived from the same score draw — the
runtime zeroes the member's validity mask from that slot on, so a
dropped client simply stops contributing loss/gradient weight and its
remaining AdamW updates are skipped by the masked engine.  The
batch slot is ``floor(score / drop_p * n_batches)``: conditioned on
dropping, the score is uniform on [0, drop_p), so the slot is uniform
over the round — one addressed draw covers both decisions.

STRAGGLER LAG (``lag_p``/``lag_max``, the ``TAG_LAG`` stream): a cohort
member straggles with prob ``lag_p``; its finished payload then arrives
``lag`` rounds late, with ``lag`` uniform on {1, .., lag_max} via the
same conditioned-score trick as dropout (score uniform on [0, lag_p)
given straggling → ``1 + floor(score / lag_p * lag_max)`` uniform over
the lag range).  The sync runtime turns max-lag into a round-barrier
stall; the async runtime folds the late payload in with a
staleness-decayed weight (fedavg.average_stale) instead of waiting —
see train/runtime.py.

The port of the JAX package's ``train/participation.py``: the scores are
``prng.uniform`` of ``fold_in`` keys, bit for bit JAX's, drawn on the
host (a key on the CPU), so every cohort, drop and lag equals the
reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np
import torch

from repro_torch.core import prng

# Disjoint stream tags: every runtime PRNG purpose folds its own tag into
# the base key first, so streams can never collide across purposes.
TAG_INIT = 0x1217          # per-uid parameter init
TAG_ROUND = 0x20D5         # per-round training key (batch/client/row keys)
TAG_PART = 0x9A27          # participation scores
TAG_DROP = 0xD209          # mid-round dropout scores
TAG_DATA = 0xDA7A          # per-(round, uid) data shuffling
TAG_LAG = 0x1A66           # straggler upload-lag draws


@dataclasses.dataclass(frozen=True)
class ParticipationConfig:
    policy: str = "bernoulli"    # "full" | "bernoulli" | "fixed"
    p: float = 0.8               # bernoulli participation probability
    cohort_k: int = 0            # cohort size for "fixed"
    drop_p: float = 0.0          # mid-round dropout probability per member
    min_cohort: int = 1          # floor (lowest-score fill-in)
    lag_p: float = 0.0           # straggler probability per member
    lag_max: int = 1             # max upload lag in rounds (>= 1)

    def __post_init__(self):
        if self.policy not in ("full", "bernoulli", "fixed"):
            raise ValueError(f"unknown participation policy {self.policy!r}")
        if self.policy == "fixed" and self.cohort_k < 1:
            # cohort_k=0 used to fall through to a silent min_cohort fill
            # of 1 — an unconfigured cohort size is a bug, not a policy.
            raise ValueError(
                f"policy='fixed' requires cohort_k >= 1, got "
                f"{self.cohort_k}")
        if not 0.0 <= self.p <= 1.0 or not 0.0 <= self.drop_p <= 1.0 \
                or not 0.0 <= self.lag_p <= 1.0:
            raise ValueError(f"probabilities must be in [0, 1]: "
                             f"p={self.p} drop_p={self.drop_p} "
                             f"lag_p={self.lag_p}")
        if self.lag_max < 1:
            raise ValueError(f"lag_max must be >= 1, got {self.lag_max}")


def uid_scores(base_key: torch.Tensor, tag: int, round_idx: int,
               uids: Sequence[int]) -> np.ndarray:
    """Per-uid uniform scores for round ``round_idx`` — the addressed
    draw everything in this module derives from (float32, host)."""
    rk = prng.fold_in(prng.fold_in(base_key.cpu(), tag), round_idx)
    ids = torch.tensor([int(u) for u in uids], dtype=torch.int64)
    return prng.uniform(prng.fold_in(rk, ids), ()).numpy()


def sample_cohort(cfg: ParticipationConfig, base_key, round_idx: int,
                  active_uids: Sequence[int]) -> List[int]:
    """This round's cohort (sorted uids).  Deterministic in
    (base_key, round_idx, the active set) and independent per uid."""
    uids = sorted(active_uids)
    if not uids or cfg.policy == "full":
        return uids
    scores = uid_scores(base_key, TAG_PART, round_idx, uids)
    if cfg.policy == "bernoulli":
        chosen = [u for u, s in zip(uids, scores) if s < cfg.p]
    else:                                    # fixed: k smallest scores
        k = max(min(cfg.cohort_k, len(uids)), 0)
        order = np.lexsort((uids, scores))   # score, uid-tiebreak
        chosen = sorted(uids[i] for i in order[:k])
    if len(chosen) < cfg.min_cohort:
        order = np.lexsort((uids, scores))
        for i in order:
            if uids[i] not in chosen:
                chosen.append(uids[i])
            if len(chosen) >= min(cfg.min_cohort, len(uids)):
                break
    return sorted(chosen)


def sampling_rate(cfg: ParticipationConfig, n_active: int) -> float:
    """The per-round cohort sampling rate q the privacy accountant
    charges (privacy/accountant.py — amplification by subsampling):
    ``bernoulli`` → p, ``fixed`` → min(cohort_k/n, 1) (the fixed-size-
    without-replacement rate, charged under the Poisson bound as
    standard, conservative practice), ``full`` → 1.0.  ``min_cohort``
    fill-ins can only RAISE the realized rate above q; the accountant
    composes over rounds with the WINDOW rate
    1 - (1-q)^rounds_per_window (a member that joins any round of the
    window contributes to that window's single DP release), which the
    runtime computes from this."""
    if n_active <= 0:
        return 0.0
    if cfg.policy == "full":
        return 1.0
    if cfg.policy == "bernoulli":
        return float(cfg.p)
    return min(float(cfg.cohort_k) / float(n_active), 1.0)


def sample_drops(cfg: ParticipationConfig, base_key, round_idx: int,
                 cohort: Sequence[int], n_batches: int) -> Dict[int, int]:
    """Mid-round dropouts: ``{uid: batch slot it vanishes from}``.  A
    slot of 0 means the member never trains this round (connected, then
    immediately gone) — the masked engine keeps its state untouched."""
    if cfg.drop_p <= 0.0 or n_batches <= 0 or not cohort:
        return {}
    scores = uid_scores(base_key, TAG_DROP, round_idx, cohort)
    drops = {}
    for u, s in zip(cohort, scores):
        if s < cfg.drop_p:
            drops[int(u)] = min(int(s / cfg.drop_p * n_batches),
                                n_batches - 1)
    return drops


def sample_lags(cfg: ParticipationConfig, base_key, round_idx: int,
                cohort: Sequence[int]) -> Dict[int, int]:
    """Straggler upload lags: ``{uid: rounds late}`` for the members
    whose TAG_LAG score lands under ``lag_p``.  A lagging member still
    COMPUTES its round (CollaFuse's client work is unchanged); only its
    upload arrives ``lag`` rounds later, uniform on {1, .., lag_max} by
    the conditioned-score trick ``sample_drops`` uses for slots.
    Addressed per (base_key, round, uid) — adding or removing a client
    never perturbs another's lag draw."""
    if cfg.lag_p <= 0.0 or not cohort:
        return {}
    scores = uid_scores(base_key, TAG_LAG, round_idx, cohort)
    lags = {}
    for u, s in zip(cohort, scores):
        if s < cfg.lag_p:
            lags[int(u)] = 1 + min(int(s / cfg.lag_p * cfg.lag_max),
                                   cfg.lag_max - 1)
    return lags
