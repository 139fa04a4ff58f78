"""Plain PyTorch versions of the fused DDPM reverse-step kernel.

``ddpm_step_ref`` matches core/schedules.DiffusionSchedule.ddpm_step with
precomputed coefficients; ``ddpm_step_keyed_ref`` and
``ddpm_step_rowwise_ref`` add the draw (and the mask) that the keyed
variants do inside the launch, as the samplers composed them from torch
ops.  The wrappers (ops.py) take them for CPU tensors; chip_smoke.py holds
the CUDA kernel against them on the card.  The roundings and their order
are the kernel's: fp32 products and sums, one cast back to x's type.
"""
from __future__ import annotations

import torch

from repro_torch.core import prng
from repro_torch.core.protocol import rowwise_normal


def ddpm_step_ref(x_t, eps_pred, noise, inv_sqrt_alpha, coef, sigma):
    """x_{t-1} = (x_t − coef·ε̂) · inv_sqrt_alpha + sigma·noise.  The
    coefficients are scalars or tensors that broadcast against x_t."""
    x32 = x_t.float()
    e32 = eps_pred.float()
    n32 = noise.float()
    out = (x32 - coef * e32) * inv_sqrt_alpha + sigma * n32
    return out.to(x_t.dtype)


def ddpm_step_keyed_ref(x_t, eps_pred, key, coef):
    """The per-request chain's step: ``k, kn = split(key)``, then the step
    with noise ``normal(kn, x_t.shape)`` and the (3,) coefficient row
    ``coef``.  Returns (x_{t-1}, k)."""
    k, kn = prng.split(key)
    noise = prng.normal(kn, x_t.shape)
    return ddpm_step_ref(x_t, eps_pred, noise, coef[0], coef[1], coef[2]), k


def ddpm_step_rowwise_ref(x_t, eps_pred, keys, datum, coef, active):
    """The batched engine's step over (K, B, ...) slabs: row-keyed noise
    from ``fold_in(keys, datum)``, slab k's coefficients from row k of the
    (K, 3) ``coef``, and ``where(active > 0, step, x_t)``."""
    noise = rowwise_normal(prng.fold_in(keys, datum), x_t.shape[1:])
    bshape = (x_t.shape[0],) + (1,) * (x_t.ndim - 1)
    xn = ddpm_step_ref(x_t, eps_pred, noise, coef[:, 0].reshape(bshape),
                       coef[:, 1].reshape(bshape), coef[:, 2].reshape(bshape))
    return torch.where(active.reshape(bshape) > 0, xn, x_t)
