"""FD-proxy: Fréchet distance over fixed random-CNN features.

The port of the JAX package's ``eval/fd_proxy.py``: the same Fréchet
statistics as Heusel et al.'s FID, over the features of a frozen,
seed-deterministic 3-layer conv net instead of InceptionV3.  Lower is
better; values are comparable across runs of this repo, not against
published FID numbers.

The feature net's weights are drawn from ``PRNGKey(42)`` as the
reference draws them (equal within the ulps of ``torch.erfinv``); one
frozen set is cached per (channels, device).  Images are NHWC, as in the
reference; the strided convs pad as XLA's ``SAME`` does (the odd row and
column at the end).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn

from repro_torch.core import prng
from repro_torch.eval.convnet import conv, conv_lrelu, fill_conv, to_nchw

FEATURE_DIM = 64
_SEED = 42
_WIDTHS = (16, 32, FEATURE_DIM)
_STRIDES = (2, 2, 1)
_CACHE: Dict[Tuple[int, str], "FeatureNet"] = {}


class FeatureNet(nn.ModuleList):
    """Three bias-free 3×3 convs: the reference's tuple of three HWIO
    kernels, here OIHW (``bridge.load_params`` fills one from that
    tuple)."""

    def __init__(self, channels: int):
        cins = (channels,) + _WIDTHS[:-1]
        super().__init__(conv(ci, co, s) for ci, co, s in
                         zip(cins, _WIDTHS, _STRIDES))


def init_feature_net(channels: int = 3) -> FeatureNet:
    """The frozen feature net on the CPU, from ``split(PRNGKey(42),
    3)``."""
    net = FeatureNet(channels)
    for c, k in zip(net, prng.split(prng.PRNGKey(_SEED), 3)):
        fill_conv(c, k)
    return net.requires_grad_(False)


def _feature_params(channels: int = 3, device="cpu") -> FeatureNet:
    """The cached frozen feature net for ``channels`` on ``device``."""
    dev = torch.device(device)
    key = (channels, str(dev))
    if key not in _CACHE:
        _CACHE[key] = init_feature_net(channels).to(dev)
    return _CACHE[key]


def apply_features(net: FeatureNet, x: torch.Tensor) -> torch.Tensor:
    h = to_nchw(x)
    for c in net:
        h = conv_lrelu(c, h)
    return h.mean(dim=(2, 3))


def features(x: torch.Tensor) -> torch.Tensor:
    """x: (N, H, W, C) in [-1, 1] -> (N, FEATURE_DIM) float32."""
    return apply_features(_feature_params(x.shape[-1], x.device), x)


def _stats(f: torch.Tensor):
    mu = f.mean(dim=0)
    d = f - mu
    cov = d.T @ d / max(f.shape[0] - 1, 1)
    return mu, cov


def frechet_distance(f_a: torch.Tensor, f_b: torch.Tensor,
                     eps: float = 1e-6) -> float:
    """Squared Fréchet distance between feature sets (N_a, D), (N_b, D):
    |mu1 − mu2|² + tr C1 + tr C2 − 2 Σ sqrt(max(Re eig(C1 C2), 0)), all
    float32, with the reference's algorithm (the eigenvalues of the
    non-symmetric product, not a matrix square root)."""
    mu1, c1 = _stats(f_a.float())
    mu2, c2 = _stats(f_b.float())
    diff = torch.sum((mu1 - mu2) ** 2)
    # tr sqrt(C1 C2) = Σ sqrt(eig(C1 C2)); the spectrum is real and
    # non-negative up to rounding, hence the clip.  torch computes a
    # non-symmetric eigendecomposition on the host for CUDA inputs too
    # (MAGMA's geev) and synchronises; the D×D product goes to the host
    # explicitly, so every device runs the same LAPACK routine on it.
    ev = torch.linalg.eigvals((c1 @ c2).cpu())
    tr_sqrt = torch.sum(torch.sqrt(torch.clamp(ev.real, min=0.0)))
    out = diff.cpu() + torch.trace(c1).cpu() + torch.trace(c2).cpu() - \
        2.0 * tr_sqrt
    return float(out)


@torch.no_grad()
def fd_proxy(x_real: torch.Tensor, x_gen: torch.Tensor) -> float:
    """The paper's FID/FCD role: distance between real and generated
    sets."""
    return frechet_distance(features(x_real), features(x_gen))
