"""RDP (moments) accountant for the subsampled Gaussian mechanism —
tracks the cumulative (epsilon, delta) the DP-FedAvg releases spend
across rounds.

The port's own copy of the JAX package's ``privacy/accountant.py``: pure
numpy and ``math`` on the host, line for line the reference's, so its
epsilons are the reference's (to the last bit on the same numpy).

Each DP aggregation (train/runtime.py's ``_maybe_fedavg`` with privacy
enabled) is one release of the Gaussian mechanism with noise multiplier
``sigma`` (noise std sigma*C on a sum of C-sensitivity contributions)
over a cohort subsampled at rate ``q`` from the active registry.  We
track Renyi DP at a fixed grid of INTEGER orders alpha:

  * q = 1 (full participation): RDP(alpha) = alpha / (2 sigma^2)
    (the plain Gaussian mechanism, Mironov 2017);
  * q < 1: the Poisson-subsampled bound at integer orders
    (Mironov-Talwar-Zhang 2019; the TF-privacy ``compute_rdp`` formula)

        RDP(alpha) = 1/(alpha-1) * log( sum_{i=0..alpha}
            C(alpha,i) (1-q)^(alpha-i) q^i  exp((i^2-i)/(2 sigma^2)) )

    — amplification by subsampling, which is what makes per-round
    cohort sampling (participation.py's bernoulli/fixed-k policies) a
    privacy WIN and not just a compute knob.  Fixed-k sampling is
    charged at q = k/n under the same bound (documented approximation:
    sampling without replacement is not Poisson; the bound is standard
    practice and conservative in the regimes the benchmarks sweep).

Composition is additive in RDP; conversion to (epsilon, delta) takes the
minimum over orders of  rdp(alpha) + log(1/delta)/(alpha-1)  (Mironov
2017, Prop. 3).  sigma = 0 is a zero-noise release: epsilon = inf the
moment any data-carrying round is charged.  Epsilon is MONOTONE
NON-DECREASING in charged rounds by construction (RDP only accumulates)
— the CI smoke asserts exactly that on the per-round reports.

The accountant also runs BACKWARDS: ``noise_multiplier_for_epsilon``
bisects sigma so a planned (rounds, q, delta) run lands at a target
epsilon — how benchmarks/privacy_frontier.py derives sigma per
epsilon in {1, 8, inf}.

State is three numbers and a vector (orders, cumulative rdp, steps) —
persisted in checkpoint format v3 and restored bitwise
(train/runtime.py ``state_dict``/``restore``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

DEFAULT_ORDERS: Tuple[int, ...] = tuple(range(2, 65)) + (
    80, 96, 128, 192, 256, 384, 512)


def _log_comb(n: int, k: int) -> float:
    return (math.lgamma(n + 1) - math.lgamma(k + 1)
            - math.lgamma(n - k + 1))


def rdp_subsampled_gaussian(q: float, noise_multiplier: float,
                            orders: Sequence[int] = DEFAULT_ORDERS
                            ) -> np.ndarray:
    """Per-release RDP vector at integer ``orders`` for one subsampled
    Gaussian release.  q=0 spends nothing; sigma=0 spends infinity on
    any q>0 release."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"sampling rate must be in [0, 1], got {q}")
    orders = np.asarray(orders, np.int64)
    if (orders < 2).any():
        raise ValueError("integer RDP orders must be >= 2")
    if q == 0.0:
        return np.zeros(len(orders), np.float64)
    if noise_multiplier <= 0.0:
        return np.full(len(orders), np.inf, np.float64)
    s2 = float(noise_multiplier) ** 2
    if q == 1.0:
        return orders.astype(np.float64) / (2.0 * s2)
    out = np.empty(len(orders), np.float64)
    log_q, log_1q = math.log(q), math.log1p(-q)
    for j, a in enumerate(int(o) for o in orders):
        terms = [_log_comb(a, i) + i * log_q + (a - i) * log_1q
                 + (i * i - i) / (2.0 * s2) for i in range(a + 1)]
        m = max(terms)
        log_a = m + math.log(sum(math.exp(t - m) for t in terms))
        out[j] = max(log_a, 0.0) / (a - 1)
    return out


def rdp_to_epsilon(rdp: np.ndarray, orders: Sequence[int], delta: float
                   ) -> Tuple[float, int]:
    """(epsilon, best order) at ``delta`` from a cumulative RDP vector
    (Mironov 2017 Prop. 3: eps = rdp + log(1/delta)/(alpha-1), minimized
    over the grid)."""
    if not 0.0 < delta < 1.0:
        raise ValueError(f"delta must be in (0, 1), got {delta}")
    orders = np.asarray(orders, np.float64)
    eps = np.asarray(rdp, np.float64) + \
        math.log(1.0 / delta) / (orders - 1.0)
    j = int(np.argmin(eps))
    return float(eps[j]), int(orders[j])


@dataclasses.dataclass
class RdpAccountant:
    """Cumulative accountant: ``charge(q)`` per DP release, ``epsilon()``
    any time.  Checkpoint round trip via ``state_dict``/``from_state``
    is bitwise (the rdp vector is the state)."""
    noise_multiplier: float
    delta: float
    orders: Tuple[int, ...] = DEFAULT_ORDERS

    def __post_init__(self):
        self.orders = tuple(int(o) for o in self.orders)
        self._rdp = np.zeros(len(self.orders), np.float64)
        self.steps = 0

    def charge(self, q: float, releases: int = 1) -> None:
        """Record ``releases`` releases at sampling rate ``q``."""
        if releases < 0:
            raise ValueError(f"releases must be >= 0, got {releases}")
        if releases == 0 or q == 0.0:
            return
        self._rdp = self._rdp + releases * rdp_subsampled_gaussian(
            q, self.noise_multiplier, self.orders)
        self.steps += releases

    def epsilon(self, delta: Optional[float] = None) -> float:
        if self.steps == 0:
            return 0.0
        if not np.isfinite(self._rdp).all():
            return math.inf
        return rdp_to_epsilon(self._rdp, self.orders,
                              self.delta if delta is None else delta)[0]

    # -- persistence (checkpoint v3) ---------------------------------------
    def state_dict(self) -> Dict:
        return {"noise_multiplier": float(self.noise_multiplier),
                "delta": float(self.delta),
                "orders": np.asarray(self.orders, np.int64),
                "rdp": self._rdp.copy(),
                "steps": int(self.steps)}

    @classmethod
    def from_state(cls, state: Dict) -> "RdpAccountant":
        acc = cls(float(state["noise_multiplier"]), float(state["delta"]),
                  tuple(int(o) for o in np.asarray(state["orders"])))
        acc._rdp = np.asarray(state["rdp"], np.float64).copy()
        acc.steps = int(state["steps"])
        return acc


def epsilon_for(noise_multiplier: float, delta: float, releases: int,
                q: float) -> float:
    """Epsilon of a planned run: ``releases`` subsampled releases at rate
    ``q`` and the given noise multiplier."""
    acc = RdpAccountant(noise_multiplier, delta)
    acc.charge(q, releases)
    return acc.epsilon()


def noise_multiplier_for_epsilon(target_epsilon: float, delta: float,
                                 releases: int, q: float,
                                 sigma_max: float = 256.0,
                                 tol: float = 1e-3) -> float:
    """The smallest noise multiplier whose planned run spends at most
    ``target_epsilon`` — bisection on the (monotone decreasing in sigma)
    accountant.  inf target -> 0.0 (no noise)."""
    if math.isinf(target_epsilon):
        return 0.0
    if target_epsilon <= 0.0:
        raise ValueError(f"target epsilon must be > 0, got "
                         f"{target_epsilon}")
    if releases <= 0 or q <= 0.0:
        return 0.0                       # nothing released: no noise due
    lo, hi = 1e-3, sigma_max
    if epsilon_for(hi, delta, releases, q) > target_epsilon:
        raise ValueError(f"target epsilon {target_epsilon} unreachable "
                         f"below sigma_max {sigma_max}")
    while hi - lo > tol:
        mid = 0.5 * (lo + hi)
        if epsilon_for(mid, delta, releases, q) > target_epsilon:
            lo = mid
        else:
            hi = mid
    return hi
