"""Plain PyTorch version of the fused DDPM reverse-step kernel.

Matches core/schedules.DiffusionSchedule.ddpm_step with precomputed
coefficients.  The wrapper (ops.py) takes it for CPU tensors; chip_smoke.py
holds the CUDA kernel against it on the card.  The roundings and their
order are the kernel's: fp32 products and sums, one cast back to x's type.
"""
from __future__ import annotations


def ddpm_step_ref(x_t, eps_pred, noise, inv_sqrt_alpha, coef, sigma):
    """x_{t-1} = (x_t − coef·ε̂) · inv_sqrt_alpha + sigma·noise.  The
    coefficients are scalars or tensors that broadcast against x_t."""
    x32 = x_t.float()
    e32 = eps_pred.float()
    n32 = noise.float()
    out = (x32 - coef * e32) * inv_sqrt_alpha + sigma * n32
    return out.to(x_t.dtype)
