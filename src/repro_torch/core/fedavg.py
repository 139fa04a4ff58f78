"""FedAvg for diffusion models, the baseline the paper names for future
work (§5), and the cross-cohort aggregations of the federated training
runtime.

The port of the JAX package's ``core/fedavg.py``.  Every client trains a
full local diffusion model on its own data over the full timestep range;
after a round the server averages the weights and sends them back
([McMahan et al. 2017]).  Costs tracked per round: client compute (the
full model on every batch, and the full T-step chain at inference), and
communication, 2·|θ| per contributing client (up + down).

Models are ``nn.Module`` s or dicts of tensors (``core/trees.py``); an
aggregate is a new model of client 0's kind, each member receiving its
own copy.  Accumulation runs in float32 in the reference's order
(Σ_i w_i·θ_i, left to right) and each leaf keeps its storage dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

import torch

from repro_torch.core import prng, trees
from repro_torch.core.protocol import _grads, mse_eps_loss
from repro_torch.core.sampler import client_denoise
from repro_torch.core.schedules import DiffusionSchedule
from repro_torch.core.splitting import CutPoint
from repro_torch.optim.adamw import AdamWConfig, adamw_update, init_opt_state


@dataclasses.dataclass
class FedAvgState:
    global_params: object
    client_params: List
    client_opt: List[Dict]
    round: int = 0
    comm_bytes: int = 0


def params_nbytes(params) -> int:
    return sum(int(p.numel() * p.element_size())
               for p in trees.leaves(params))


def fedavg_setup(key: torch.Tensor, init_one: Callable,
                 n_clients: int) -> FedAvgState:
    gp = init_one(key)
    return FedAvgState(
        global_params=gp,
        client_params=[trees.copy(gp) for _ in range(n_clients)],
        client_opt=[init_opt_state(gp) for _ in range(n_clients)])


def make_local_step(sched: DiffusionSchedule, T: int, apply_fn,
                    opt_cfg: AdamWConfig):
    """One full-range DDPM training step (the FL client trains every
    timestep; CollaFuse's split removes this): (params, opt, x0, y, key)
    -> (params, opt, loss), updated in place."""

    def step(params, opt, x0, y, key):
        B = x0.shape[0]
        k_t, k_e = prng.split(key)
        t = prng.randint(k_t, (B,), 1, T + 1)
        eps = prng.normal(k_e, x0.shape)
        x_t = sched.q_sample(x0, t, eps)
        with torch.enable_grad():
            loss = mse_eps_loss(apply_fn, params, x_t, t, y, eps)
            grads = _grads(loss, params)
        params, opt, _ = adamw_update(params, grads, opt, opt_cfg)
        return params, opt, loss.detach()

    return step


def average_weights(client_params: List, weights=None):
    """Weighted FedAvg: ``weights`` is one non-negative coefficient per
    client, normalized to sum to 1 (raw dataset sizes give McMahan's
    n_c/Σn).  Default uniform.  Every client must hold the same per-leaf
    dtypes: the mean runs in float32 and goes back to the leaf's dtype."""
    n = len(client_params)
    if n == 0:
        raise ValueError("average_weights needs at least one client")
    ref = [l.dtype for l in trees.leaves(client_params[0])]
    for c in range(1, n):
        for i, (d0, l) in enumerate(zip(ref,
                                        trees.leaves(client_params[c]))):
            if d0 != l.dtype:
                raise ValueError(
                    f"average_weights: dtype mismatch at leaf {i}: client 0 "
                    f"has {d0}, client {c} has {l.dtype} — cast clients to "
                    f"a common storage dtype before aggregating")
    w = [1.0 / n] * n if weights is None else [float(x) for x in weights]
    if len(w) != n:
        raise ValueError(f"one weight per client: {len(w)} != {n}")
    tot = sum(w)
    if tot <= 0 or any(x < 0 for x in w):
        raise ValueError(f"weights must be non-negative with a positive "
                         f"sum, got {w}")
    w = [x / tot for x in w]

    def avg(*ls):
        out = sum(wi * l.float() for wi, l in zip(w, ls))
        return out.to(ls[0].dtype)

    return trees.tree_map(avg, *client_params)


def average_cohort(client_params: List, seen: List[int],
                   members: List[bool]) -> List:
    """Cross-cohort FedAvg for the training runtime: average the models of
    a partial cohort, weighted by each member's real trained-sample count
    over the window, and give the average to the members only.  An absent
    client comes back as it was (the same object); a member with
    ``seen == 0`` adds no weight but receives the average; when no member
    saw a sample the call is a no-op.  Returns a new list."""
    n = len(client_params)
    if not (len(seen) == len(members) == n):
        raise ValueError(f"one seen-count and member flag per client: "
                         f"{len(seen)}/{len(members)} != {n}")
    idx = [c for c in range(n) if members[c]]
    if not idx:
        return list(client_params)
    w = [float(seen[c]) for c in idx]
    if any(x < 0 for x in w):
        raise ValueError(f"negative seen count: {w}")
    if sum(w) <= 0:
        return list(client_params)          # nobody trained: no-op
    avg = average_weights([client_params[c] for c in idx], weights=w)
    out = list(client_params)
    for c in idx:
        out[c] = trees.copy(avg)
    return out


def average_stale(current, payload, staleness: int, alpha: float = 0.6,
                  decay: float = 0.5):
    """Staleness-weighted async merge (FedAsync, [Xie et al. 2019]): fold
    a late client upload into the model the server has moved on to, at
    w = alpha·(1 + staleness)^(−decay), as (1 − w)·current + w·payload in
    float32 with each leaf's dtype kept.  w ≥ 1 returns ``payload`` itself
    and w ≤ 0 ``current`` itself (identities, not arithmetic)."""
    if staleness < 0:
        raise ValueError(f"staleness must be >= 0, got {staleness}")
    if not 0.0 <= alpha <= 1.0 or decay < 0.0:
        raise ValueError(f"need 0 <= alpha <= 1 and decay >= 0, got "
                         f"alpha={alpha} decay={decay}")
    w = alpha * (1.0 + staleness) ** (-decay)
    if w >= 1.0:
        return payload
    if w <= 0.0:
        return current

    def mix(c, p):
        return ((1.0 - w) * c.float() + w * p.float()).to(c.dtype)

    return trees.tree_map(mix, current, payload)


def fedavg_round(state: FedAvgState, step_fn, batches_per_client, key
                 ) -> Dict[str, float]:
    """One FedAvg round: local training, upload, sample-count-weighted
    average, download.  A client without batches adds neither a loss nor
    weight, and is not charged communication."""
    losses = []
    seen = []
    for c, batches in enumerate(batches_per_client):
        loss = None
        for (x0, y) in batches:
            key, k = prng.split(key)
            state.client_params[c], state.client_opt[c], loss = step_fn(
                state.client_params[c], state.client_opt[c], x0, y, k)
        if loss is not None:
            losses.append(float(loss))
        seen.append(sum(int(x0.shape[0]) for (x0, _) in batches))
    if not losses:
        raise ValueError("fedavg_round: no client contributed any batch")
    state.global_params = average_weights(
        state.client_params, seen if any(seen) else None)
    per_model = params_nbytes(state.global_params)
    n_contrib = sum(1 for s in seen if s > 0)
    state.comm_bytes += 2 * per_model * n_contrib  # up + down
    state.client_params = [trees.copy(state.global_params)
                           for _ in state.client_params]
    state.round += 1
    return {"mean_loss": sum(losses) / len(losses),
            "comm_bytes_total": state.comm_bytes}


@torch.no_grad()
def fedavg_sample(state: FedAvgState, client: int, key, y, shape,
                  sched: DiffusionSchedule, T: int, apply_fn):
    """FL inference: the client runs the whole T-step chain itself (client
    compute share 1.0), through the keyed DDPM step."""
    cut = CutPoint(T, T)  # every step on the client
    x_T = prng.normal(key, shape)
    return client_denoise(state.client_params[client],
                          prng.fold_in(key, 1), x_T, y, sched, cut,
                          apply_fn, adjusted=False)
