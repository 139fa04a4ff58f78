"""The DDPM schedule, the reverse step and CollaFuse's cut, in plain
PyTorch and NumPy: a frozen copy for the benchmark's reference.

* Linear β schedule (Ho et al. 2020), ᾱ linearly interpolated at real
  timesteps with ᾱ(0) = 1, as the client's remapped sweep needs.
* The reverse step x_{t-1} = (x_t − coef·ε̂)·inv_sqrt_alpha + sigma·z in
  float32, each product and sum rounded on its own (no fused multiply-add).
* CollaFuse Alg. 2: the server sweeps T … t_ζ+1, the client stretches its
  t_ζ steps over [1, M] with M = ⌊t_ζ + (t_ζ/T)(T − t_ζ)⌋.
* The content digest that seeds a shared server prefix: a 31-bit blake2b
  of the prefix's (t_ζ, stride, y) identity, so the same prefix draws the
  same trajectory in any wave.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch


def linspace_f32(start: float, stop: float, num: int) -> np.ndarray:
    """start·(1−s) + stop·s with s = i/(num−1) in float32, the endpoint
    appended exactly."""
    if num <= 0:
        return np.zeros((0,), np.float32)
    start32, stop32 = np.float32(start), np.float32(stop)
    if num == 1:
        return np.array([start32], np.float32)
    div = num - 1
    step = np.arange(div, dtype=np.float32) / np.float32(div)
    out = start32 * (np.float32(1) - step) + stop32 * step
    return np.concatenate([out, [stop32]]).astype(np.float32)


class Schedule:
    """Linear β from 1e-4 to 0.02 over T steps, on ``device``."""

    def __init__(self, T: int, device, beta_min: float = 1e-4,
                 beta_max: float = 0.02):
        self.T = T
        betas = torch.from_numpy(linspace_f32(beta_min, beta_max, T))
        self.alpha_bar = torch.cumprod(1.0 - betas, 0).to(device)
        self.device = torch.device(device)

    def alpha_bar_at(self, t) -> torch.Tensor:
        t = torch.clamp(torch.as_tensor(t, dtype=torch.float32,
                                        device=self.device), 0.0,
                        float(self.T))
        grid = torch.cat([torch.ones(1, device=self.device),
                          self.alpha_bar])
        xp = torch.arange(self.T + 1, dtype=torch.float32,
                          device=self.device)
        i = torch.clamp(torch.searchsorted(xp, t.reshape(-1), right=True),
                        1, self.T).reshape(t.shape)
        lo = grid[i - 1]
        return lo + (t - xp[i - 1]) / (xp[i] - xp[i - 1]) * (grid[i] - lo)

    def alpha(self, t):
        return torch.sqrt(self.alpha_bar_at(t))

    def sigma(self, t):
        return torch.sqrt(torch.clamp(1.0 - self.alpha_bar_at(t), min=1e-12))

    def q_sample(self, x0, t, eps):
        """x_t = α(t)·x0 + σ(t)·ε for (B,) timesteps."""
        shape = (-1,) + (1,) * (x0.ndim - 1)
        return self.alpha(t).reshape(shape) * x0 + \
            self.sigma(t).reshape(shape) * eps

    def coefficients(self, t, t_prev):
        """(inv_sqrt_alpha, coef, sigma) of the reverse step t → t_prev."""
        t = torch.as_tensor(t, dtype=torch.float32, device=self.device)
        tp = torch.as_tensor(t_prev, dtype=torch.float32, device=self.device)
        ab_t = self.alpha_bar_at(t)
        alpha_t = ab_t / torch.clamp(self.alpha_bar_at(tp), min=1e-12)
        beta_t = 1.0 - alpha_t
        inv_sqrt_alpha = 1.0 / torch.sqrt(torch.clamp(alpha_t, min=1e-12))
        coef = beta_t / torch.sqrt(torch.clamp(1.0 - ab_t, min=1e-12))
        sigma = torch.where(t > 1.0, torch.sqrt(torch.clamp(beta_t, min=0.0)),
                            torch.zeros_like(beta_t))
        return inv_sqrt_alpha, coef, sigma


def reverse_step(x, eps, noise, inv_sqrt_alpha, coef, sigma):
    """One reverse step in float32; coefficients broadcast against x."""
    return (x - coef * eps.float()) * inv_sqrt_alpha + sigma * noise


def client_steps(T: int, t_cut: int, adjusted: bool = True):
    """(t, t_prev) of the client's remapped sweep over [1, M]."""
    if t_cut == 0:
        z = np.zeros((0,), np.float32)
        return z, z
    M = int(t_cut + (t_cut / T) * (T - t_cut))
    t = linspace_f32(float(M) if adjusted else float(t_cut), 1.0, t_cut)
    tp = np.concatenate([t[1:], np.zeros((1,), np.float32)])
    return t, tp.astype(np.float32)


def prefix_seed(t_cut: int, y: np.ndarray, stride: int = 1) -> int:
    """The 31-bit content seed of the server prefix (y, t_ζ, stride)."""
    y = np.asarray(y, np.float32)
    head = repr((int(t_cut), int(stride), y.shape, y.dtype.str)).encode()
    h = hashlib.blake2b(head + b"|" + y.tobytes(), digest_size=4).digest()
    return int.from_bytes(h, "little") & 0x7FFFFFFF
