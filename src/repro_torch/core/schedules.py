"""DDPM variance / noise schedules (paper eq. 1–3) with the continuous
timestep lookup needed by CollaFuse's client-side schedule remap (Alg. 2).

Conventions (match the paper's Alg. 1 notation):
  * timesteps are 1-based: t ∈ {1, …, T}; array index is t-1.
  * ``alpha(t)``  = sqrt(ᾱ_t)      — the *cumulative* signal coefficient
  * ``sigma(t)``  = sqrt(1 - ᾱ_t)  — the cumulative noise coefficient
  * ``q_sample``  : x_t = alpha(t)·x_0 + sigma(t)·ε             (eq. 1)
  * ``ddpm_step`` : eq. 2 reverse update with β_t posterior noise.

``alpha``/``sigma`` accept *real-valued* t (linear interpolation of ᾱ in
t): Alg. 2 line 3 builds a linearly spaced float t_list over [1, M] and
evaluates the schedulers at those points.

The tables are built in float32 on the host with the same formulas as the
JAX package (``linspace_f32`` is ``jnp.linspace``'s), then moved to the
schedule's device once; every lookup runs on that device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def linspace_f32(start: float, stop: float, num: int) -> np.ndarray:
    """``jnp.linspace(start, stop, num, dtype=float32)``: start·(1−s) +
    stop·s with s = i/(num−1) in float32, the endpoint appended exactly."""
    if num <= 0:
        return np.zeros((0,), np.float32)
    start32, stop32 = np.float32(start), np.float32(stop)
    if num == 1:
        return np.array([start32], np.float32)
    div = num - 1
    step = np.arange(div, dtype=np.float32) / np.float32(div)
    out = start32 * (np.float32(1) - step) + stop32 * step
    return np.concatenate([out, [stop32]]).astype(np.float32)


def _as_f32(t, device) -> torch.Tensor:
    return torch.as_tensor(t, dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    T: int
    betas: torch.Tensor         # (T,)
    alphas: torch.Tensor        # (T,)  = 1 - betas
    alpha_bar: torch.Tensor     # (T,)  = cumprod(alphas)

    # ------------------------------------------------------------------
    @staticmethod
    def _from_betas(T: int, betas: torch.Tensor, device
                    ) -> "DiffusionSchedule":
        alphas = 1.0 - betas
        ab = torch.cumprod(alphas, 0)
        return DiffusionSchedule(T, betas.to(device), alphas.to(device),
                                 ab.to(device))

    @staticmethod
    def linear(T: int, beta_min: float = 1e-4, beta_max: float = 0.02,
               device=None) -> "DiffusionSchedule":
        betas = torch.from_numpy(linspace_f32(beta_min, beta_max, T))
        return DiffusionSchedule._from_betas(T, betas, device)

    @staticmethod
    def cosine(T: int, s: float = 0.008, device=None) -> "DiffusionSchedule":
        t = torch.arange(T + 1, dtype=torch.float32) / T
        f = torch.cos((t + s) / (1 + s) * np.float32(np.pi / 2)) ** 2
        ab = f[1:] / f[0]
        prev = torch.cat([torch.ones(1), ab[:-1]])
        betas = torch.clamp(1.0 - ab / prev, 1e-5, 0.999)
        return DiffusionSchedule._from_betas(T, betas, device)

    @property
    def device(self) -> torch.device:
        return self.alpha_bar.device

    def to(self, device) -> "DiffusionSchedule":
        return DiffusionSchedule(self.T, self.betas.to(device),
                                 self.alphas.to(device),
                                 self.alpha_bar.to(device))

    # ------------------------------------------------------------------
    def _interp_alpha_bar(self, t) -> torch.Tensor:
        """ᾱ at real-valued 1-based t, linear interpolation, ᾱ(0) := 1 —
        ``jnp.interp`` over the grid 0..T with t clipped to [0, T]."""
        t = torch.clamp(_as_f32(t, self.device), 0.0, float(self.T))
        grid = torch.cat([torch.ones(1, device=self.device), self.alpha_bar])
        xp = torch.arange(self.T + 1, dtype=torch.float32, device=self.device)
        i = torch.clamp(torch.searchsorted(xp, t.reshape(-1), right=True),
                        1, self.T).reshape(t.shape)
        lo = grid[i - 1]
        return lo + (t - xp[i - 1]) / (xp[i] - xp[i - 1]) * (grid[i] - lo)

    def alpha(self, t) -> torch.Tensor:
        """sqrt(ᾱ_t) — accepts int or real t (broadcasts)."""
        return torch.sqrt(self._interp_alpha_bar(t))

    def sigma(self, t) -> torch.Tensor:
        return torch.sqrt(torch.clamp(1.0 - self._interp_alpha_bar(t),
                                      min=1e-12))

    # ------------------------------------------------------------------
    def q_sample(self, x0, t, eps):
        """Diffuse x0 to timestep t (eq. 1 closed form). t: (B,) or scalar."""
        shape = (-1,) + (1,) * (x0.ndim - 1)
        a = self.alpha(t).reshape(shape)
        s = self.sigma(t).reshape(shape)
        return (a * x0 + s * eps).to(x0.dtype)

    def ddpm_step(self, x_t, eps_pred, t, noise, *, t_prev=None):
        """Eq. 2 reverse step at (real) t; adds β_t posterior noise except
        at t == 1."""
        t = _as_f32(t, self.device)
        ab_t = self._interp_alpha_bar(t)
        tp = t - 1.0 if t_prev is None else _as_f32(t_prev, self.device)
        ab_prev = self._interp_alpha_bar(tp)
        alpha_t = ab_t / torch.clamp(ab_prev, min=1e-12)
        beta_t = 1.0 - alpha_t
        coef = beta_t / torch.sqrt(torch.clamp(1.0 - ab_t, min=1e-12))
        mean = (x_t - coef * eps_pred) / torch.sqrt(
            torch.clamp(alpha_t, min=1e-12))
        sigma = torch.sqrt(torch.clamp(beta_t, min=0.0))
        add = torch.where(t > 1.0, sigma, torch.zeros_like(sigma))
        return (mean + add * noise).to(x_t.dtype)

    def ddim_step(self, x_t, eps_pred, t, t_prev):
        """Deterministic DDIM update [Song et al. 2021] from (real) t to
        t_prev (the strided server schedule).  ``t``/``t_prev`` broadcast
        against ``x_t``."""
        ab_t = self._interp_alpha_bar(t)
        ab_p = self._interp_alpha_bar(t_prev)
        x32 = x_t.float()
        e32 = eps_pred.float()
        x0_pred = (x32 - torch.sqrt(torch.clamp(1 - ab_t, min=1e-12)) * e32) \
            / torch.sqrt(torch.clamp(ab_t, min=1e-12))
        out = torch.sqrt(ab_p) * x0_pred + \
            torch.sqrt(torch.clamp(1 - ab_p, min=0.0)) * e32
        return out.to(x_t.dtype)
