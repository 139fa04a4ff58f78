"""Cross-client inversion attack (paper Fig. 8).

The port of the JAX package's ``eval/inversion.py``.  A simulated
malicious client trains a direct conv regressor g(x_{t_ζ}) → x_0 on its
OWN (x_{t_ζ}, x_0) pairs, then measures how well it reconstructs ANOTHER
client's data: reconstruction MSE and the FD proxy between
reconstructions and the victim's data (the paper reports FCD).  Quality
should collapse as t_ζ grows.

The reconstructor is drawn on the CPU and trained by ``eval/convnet.fit``
(the port's AdamW, as the reference goes through its own).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from repro_torch.core import prng
from repro_torch.eval.convnet import (conv, conv_lrelu, fill_conv, fit,
                                      to_nchw)
from repro_torch.eval.fd_proxy import fd_proxy

_NAMES = ("c1", "c2", "c3", "out")


class Reconstructor(nn.Module):
    """Four bias-free 3×3 stride-1 convs under the reference's keys c1,
    c2, c3, out."""

    def __init__(self, channels: int, width: int = 32):
        super().__init__()
        self.c1 = conv(channels, width)
        self.c2 = conv(width, width)
        self.c3 = conv(width, width)
        self.out = conv(width, channels)


def _init_reconstructor(key: torch.Tensor, channels: int, width: int = 32,
                        device="cpu") -> Reconstructor:
    m = Reconstructor(channels, width)
    for name, k in zip(_NAMES, prng.split(key.cpu(), 4)):
        fill_conv(getattr(m, name), k)
    return m.to(device)


def _recon_apply(params: Reconstructor, x: torch.Tensor) -> torch.Tensor:
    """NHWC x_{t_ζ} → NHWC reconstruction in (−1, 1)."""
    h = to_nchw(x)
    for name in _NAMES[:3]:
        h = conv_lrelu(getattr(params, name), h)
    return torch.tanh(params.out(h)).permute(0, 2, 3, 1)


def _mse(params: Reconstructor, xc, x0):
    return torch.mean(torch.square(_recon_apply(params, xc) - x0))


def train_inverter(key: torch.Tensor, x_cut_own: torch.Tensor,
                   x0_own: torch.Tensor, steps: int = 400, batch: int = 64,
                   lr: float = 3e-3) -> Reconstructor:
    params = _init_reconstructor(key, x0_own.shape[-1],
                                 device=x0_own.device)
    return fit(params, _mse, x_cut_own, x0_own, key, steps, batch, lr)


@torch.no_grad()
def inversion_attack(key: torch.Tensor, x_cut_own: torch.Tensor,
                     x0_own: torch.Tensor, x_cut_victim: torch.Tensor,
                     x0_victim: torch.Tensor) -> Dict[str, float]:
    """Returns own/cross reconstruction MSE + FD-proxy of
    reconstructions."""
    inv = train_inverter(key, x_cut_own, x0_own)
    rec_own = _recon_apply(inv, x_cut_own)
    rec_victim = _recon_apply(inv, x_cut_victim)
    return {
        "mse_own": float(torch.mean(torch.square(rec_own - x0_own))),
        "mse_cross": float(torch.mean(torch.square(rec_victim -
                                                   x0_victim))),
        "fd_own": fd_proxy(x0_own, rec_own),
        "fd_cross": fd_proxy(x0_victim, rec_victim),
    }
