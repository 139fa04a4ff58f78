"""Public wrappers of the fused DDPM step.

Routing follows the tensor's device and nothing else: a CPU tensor takes
the plain version; a CUDA tensor takes the hand-written kernel (kernel.py)
or raises.  Coefficients come from a DiffusionSchedule at (real-valued) t
exactly as core/schedules.ddpm_step derives them, computed on the
schedule's device.

``ddpm_step`` / ``ddpm_step_batched`` take the noise as an input (the
Pallas kernel's interface).  The samplers' steps draw it themselves:
``ddpm_step_keyed`` (the per-request chain) and ``ddpm_step_rowwise`` (the
batched engine, with its active mask), each reading its coefficients from
a table that ``step_coefficient_table`` computes once per sample or
stage.  Their plain versions (ref.py) are the composition they replace,
op for op (``prng.split`` / ``prng.normal`` or the row-keyed draw,
``ddpm_step_ref``, ``torch.where``), so a CPU run gives the same bits as
before the kernel drew its own noise.

A meta tensor (the dry run, launch/dryrun.py) takes the same route as a
CUDA one, through the same ``torch.autograd.Function``; the launch then
computes nothing and returns empty outputs of the card path's shapes and
types (its operations counted in ``kernels.FLOPS``), so autograd saves
on meta exactly the tensors it saves on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core.schedules import DiffusionSchedule
from repro_torch.kernels.ddpm_step import kernel
from repro_torch.kernels.ddpm_step.ref import (ddpm_step_keyed_ref,
                                               ddpm_step_ref,
                                               ddpm_step_rowwise_ref)


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


def step_coefficient_table(sched: DiffusionSchedule, t, t_prev=None):
    """(..., 3) float32 table of (inv_sqrt_alpha, coef, sigma) at every
    entry of ``t`` (and ``t_prev``): the steps of a sample or an engine
    stage in one computation.  The arithmetic is elementwise, so row i
    equals ``step_coefficients(sched, t[i], t_prev[i])`` bitwise."""
    return torch.stack(step_coefficients(sched, t, t_prev), dim=-1) \
        .contiguous()


def _route(x_t):
    """True for a CUDA or meta tensor (the kernel, or on meta its shapes
    alone), False for a CPU one (by the tensor's flags: this runs at
    every denoising step)."""
    if x_t.is_cuda or x_t.is_meta:
        return True
    if not x_t.is_cpu:
        raise ValueError(f"ddpm_step runs on cpu, cuda or meta, not "
                         f"{x_t.device}")
    return False


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


def ddpm_step_keyed(x_t, eps_pred, key, coef, key_out):
    """One step of the per-request chain: ``k, kn = split(key)``, x_{t-1}
    with noise ``normal(kn, x_t.shape)`` and the coefficient row ``coef``
    (3,) of a ``step_coefficient_table``; ``k`` is written into the (2,)
    buffer ``key_out`` (not ``key`` itself: a sampler alternates two)."""
    if not _route(x_t):
        out, k = ddpm_step_keyed_ref(x_t, eps_pred, key, coef)
        key_out.copy_(k)
        return out
    return kernel.launch_keyed(x_t, eps_pred, key, coef, key_out)


def ddpm_step_rowwise(x_t, eps_pred, keys, datum: int, coef, active):
    """One step of the batched engine over (K, B, ...) slabs: row b of
    slab k draws its noise from ``fold_in(fold_in(keys[k], datum), b)``
    (``rowwise_normal``), slab k steps with row k of the (K, 3) ``coef``
    (a step's column of a (K, S, 3) table), and a slab whose ``active``
    entry is not > 0 keeps x_t bitwise."""
    if not _route(x_t):
        return ddpm_step_rowwise_ref(x_t, eps_pred, keys, datum, coef,
                                     active)
    return kernel.launch_rowwise(x_t, eps_pred, keys, datum, coef, active)
