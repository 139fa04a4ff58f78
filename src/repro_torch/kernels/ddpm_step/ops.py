"""Public wrapper of the fused DDPM step.

Routing follows the tensor's device and nothing else: a CPU tensor takes
the plain version (ref.py); a CUDA tensor takes the hand-written kernel
(kernel.py) or raises.  Coefficients come from a DiffusionSchedule at
(real-valued) t exactly as core/schedules.ddpm_step derives them, computed
on the schedule's device.
"""
from __future__ import annotations

import torch

from repro_torch.core.schedules import DiffusionSchedule
from repro_torch.kernels.ddpm_step import kernel
from repro_torch.kernels.ddpm_step.ref import ddpm_step_ref


def step_coefficients(sched: DiffusionSchedule, t, t_prev=None):
    """(inv_sqrt_alpha, coef, sigma) at t (scalar or (K,) timesteps)."""
    t = torch.as_tensor(t, dtype=torch.float32, device=sched.device)
    ab_t = sched._interp_alpha_bar(t)
    tp = t - 1.0 if t_prev is None else torch.as_tensor(
        t_prev, dtype=torch.float32, device=sched.device)
    ab_prev = sched._interp_alpha_bar(tp)
    alpha_t = ab_t / torch.clamp(ab_prev, min=1e-12)
    beta_t = 1.0 - alpha_t
    inv_sqrt_alpha = 1.0 / torch.sqrt(torch.clamp(alpha_t, min=1e-12))
    coef = beta_t / torch.sqrt(torch.clamp(1.0 - ab_t, min=1e-12))
    sigma = torch.where(t > 1.0, torch.sqrt(torch.clamp(beta_t, min=0.0)),
                        torch.zeros_like(beta_t))
    return inv_sqrt_alpha, coef, sigma


def _route(x_t):
    if x_t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ddpm_step runs on cpu or cuda, not {x_t.device}")
    return x_t.device.type == "cuda"


def ddpm_step(x_t, eps_pred, noise, sched: DiffusionSchedule, t,
              t_prev=None):
    """One reverse step of the whole tensor at one timestep t."""
    a, c, s = step_coefficients(sched, t, t_prev)
    if not _route(x_t):
        return ddpm_step_ref(x_t, eps_pred, noise, a, c, s)
    coef = torch.stack([a, c, s]).reshape(1, 3)
    return kernel.launch(x_t, eps_pred, noise, coef, "ddpm_step")


def ddpm_step_batched(x_t, eps_pred, noise, sched: DiffusionSchedule, t,
                      t_prev=None):
    """Stacked-timestep variant for the batched sampling engine: ``x_t``
    is (K, ...) and ``t``/``t_prev`` are (K,) — slab k (a dedup group or a
    request of the plan) advances at its OWN timestep.  Slab k equals
    ``ddpm_step(x_t[k], ..., t[k], t_prev[k])``; on CUDA one launch covers
    all K slabs with a (K, 3) coefficient table."""
    a, c, s = step_coefficients(sched, t, t_prev)
    if not _route(x_t):
        bshape = (a.shape[0],) + (1,) * (x_t.ndim - 1)
        return ddpm_step_ref(x_t, eps_pred, noise, a.reshape(bshape),
                             c.reshape(bshape), s.reshape(bshape))
    coef = torch.stack([a, c, s], dim=1).contiguous()
    return kernel.launch(x_t, eps_pred, noise, coef, "ddpm_step_batched")
