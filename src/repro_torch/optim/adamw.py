"""AdamW with clipping by the global norm, as plain functions on tensors.

The port of the JAX package's ``optim/adamw.py``.  The state mirrors the
parameters: ``{"m": {name: tensor}, "v": {name: tensor}, "step": int32}``
with float32 moments shaped like each parameter (float32 also for bf16
parameters), in the fixed order of ``named_parameters()``.  ``step`` is a
0-dim int32 tensor kept on the host, so the update's scalar arithmetic
(bias corrections, the schedule) never waits for the card.

The arithmetic follows the reference, not ``torch.optim.AdamW``: the clip
scale min(1, max_norm / max(norm, 1e-9)), bias corrections 1 − b^step in
float32, mh / (sqrt(vh) + eps) with the weight decay added to the delta,
and the update in float32 cast back to the parameter's dtype.  Parameters
and moments are updated in place under ``no_grad`` with multi-tensor
(``_foreach``) ops: a handful of launches for the whole model.

Partitioned parameters (``DTensor``s, sharding/specs.py
``shard_params``) with their moments and gradients laid out alike: the
update runs on the local parts, and ``global_norm`` sums each
gradient's square over the ranks that hold its pieces, so every rank
clips by the same whole norm; on one rank every step is the unplaced
arithmetic, bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn as nn
from torch.distributed.tensor import DTensor


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 1e-3            # paper §4.1: learning rate 0.001
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: float = 1.0
    schedule: Optional[Callable] = None  # step -> lr multiplier


def named(params) -> Dict[str, torch.Tensor]:
    """{name: tensor} of a module (``named_parameters()``) or of a flat
    dict of tensors (a toy denoiser's parameters)."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def init_opt_state(params) -> Dict:
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
    ps = named(params)
    return {"m": {n: zeros(p) for n, p in ps.items()},
            "v": {n: zeros(p) for n, p in ps.items()},
            "step": torch.zeros((), dtype=torch.int32)}


def _local(t):
    """This rank's part of a placed tensor; a plain tensor itself."""
    return t.to_local() if isinstance(t, DTensor) else t


def _sum_over_shards(sq, gs):
    """Each entry of ``sq`` (the square of ``gs[i]``'s local norm) summed
    over the ranks of every mesh dim that cuts ``gs[i]``: the square of
    its whole norm on every rank (a replicated dim counts once)."""
    from torch.distributed import _functional_collectives as funcol
    placed = [g for g in gs if isinstance(g, DTensor)]
    if not placed:
        return sq
    mesh = placed[0].device_mesh
    for g in placed:
        if any(p.is_partial() for p in g.placements):
            raise ValueError("global_norm: a partial-sum gradient; "
                             "redistribute it to its parameter first")
    for d in range(mesh.ndim):
        cut = [isinstance(g, DTensor) and g.placements[d].is_shard()
               for g in gs]
        if mesh.size(d) == 1 or not any(cut):
            continue
        whole = funcol.wait_tensor(funcol.all_reduce(sq, "sum", (mesh, d)))
        sq = torch.where(torch.tensor(cut, device=sq.device), whole, sq)
    return sq


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient, in float32: the L2
    norm of each tensor in one multi-tensor launch, then the norm of
    those (the reference's sum of per-leaf sums of squares, rounded once
    more per leaf; one sum and square per leaf cost a launch each).
    Placed gradients: each local norm's square summed over the ranks
    holding its pieces (``_sum_over_shards``), a plain tensor alike on
    every rank."""
    gs = list(grads.values()) if isinstance(grads, dict) else list(grads)
    norms = torch._foreach_norm([_local(g).float() for g in gs])
    sq = _sum_over_shards(torch.square(torch.stack(norms)), gs)
    return torch.sqrt(torch.sum(sq))


def clip_by_global_norm(grads, max_norm: float):
    """(float32 gradients scaled by min(1, max_norm / max(norm, 1e-9)),
    norm); ``grads`` is a {name: tensor} dict (placed gradients give
    their local parts)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    names = list(grads)
    out = torch._foreach_mul([_local(grads[n]).float() for n in names],
                             scale)
    return dict(zip(names, out)), norm


def _host_f32(x) -> float:
    """A float32 value as a Python float (exact)."""
    return float(np.float32(x))


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig):
    """One AdamW step over ``grads`` ({name: tensor}, the names of
    ``named(params)``).  Updates the parameters and ``state``'s moments in
    place and returns (params, state, grad_norm) as the reference returns
    (new_params, new_state, grad_norm)."""
    ps = named(params)
    names = list(state["m"])
    if set(names) != set(ps) or set(grads) != set(ps):
        raise ValueError("adamw_update: parameter, gradient and moment "
                         "names differ")
    g_in = {n: grads[n] for n in names}
    if cfg.clip_norm > 0:
        g32, gnorm = clip_by_global_norm(g_in, cfg.clip_norm)
    else:
        g32 = {n: _local(g).float() for n, g in g_in.items()}
        gnorm = global_norm(g_in)
    g = [g32[n] for n in names]
    m = [_local(state["m"][n]) for n in names]
    v = [_local(state["v"][n]) for n in names]
    step = (state["step"] + 1).to(torch.int32)
    s32 = step.to(torch.float32)
    b1c = _host_f32(1.0 - torch.tensor(cfg.b1, dtype=torch.float32) ** s32)
    b2c = _host_f32(1.0 - torch.tensor(cfg.b2, dtype=torch.float32) ** s32)
    lr = cfg.lr
    if cfg.schedule is not None:
        lr = _host_f32(torch.tensor(cfg.lr, dtype=torch.float32) *
                       cfg.schedule(step))
    # m = b1·m + (1 − b1)·g;  v = b2·v + (1 − b2)·g²
    torch._foreach_mul_(m, cfg.b1)
    torch._foreach_add_(m, torch._foreach_mul(g, 1 - cfg.b1))
    torch._foreach_mul_(v, cfg.b2)
    torch._foreach_add_(v, torch._foreach_mul(
        torch._foreach_mul(g, g), 1 - cfg.b2))
    # delta = (m / b1c) / (sqrt(v / b2c) + eps) [+ wd·p]
    denom = torch._foreach_sqrt(torch._foreach_div(v, b2c))
    torch._foreach_add_(denom, cfg.eps)
    delta = torch._foreach_div(torch._foreach_div(m, b1c), denom)
    p = [_local(ps[n]) for n in names]
    p32 = [x.float() for x in p]          # the parameter itself if fp32
    if cfg.weight_decay:
        torch._foreach_add_(delta, torch._foreach_mul(
            p32, cfg.weight_decay))
    torch._foreach_mul_(delta, lr)
    torch._foreach_sub_(p32, delta)
    for x, x32 in zip(p, p32):
        if x32 is not x:
            x.copy_(x32)
    state["step"] = step
    return params, state, gnorm
