"""Synthetic attribute-structured image datasets (offline stand-ins for
CelebA / CIFAR-10 / AwA2).

Each of ``n_attrs`` binary attributes adds a deterministic, attribute-
specific visual pattern (a localized blob, oriented stripes, or a radial
gradient) onto a smooth random background: attribute-conditioned
generation (y is the multi-hot attribute vector) and non-IID client
partitions by dominant attributes (paper Fig. 3).

The port of the JAX package's ``data/synthetic.py``, drawn with the
port's threefry from the same keys: labels and permutations equal JAX's
bit for bit, images agree within the few ulps of ``normal``'s erfinv and
of the 4× linear upsampling of the background (``jax.image.resize``
"linear" is half-pixel bilinear with the edges clamped, which
``F.interpolate(mode="bilinear", align_corners=False)`` computes).
Images are float32 in [-1, 1], NHWC, on the key's device.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import prng
from repro_torch.core.schedules import linspace_f32
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class SyntheticConfig:
    image_size: int = 16
    channels: int = 3
    n_attrs: int = 8
    attr_prob: float = 0.35      # IID marginal attribute frequency
    background_scale: float = 0.25
    pattern_scale: float = 0.9


def _smooth_background(key, n, cfg: SyntheticConfig) -> torch.Tensor:
    small = cfg.image_size // 4
    z = prng.normal(key, (n, small, small, cfg.channels))
    bg = F.interpolate(z.permute(0, 3, 1, 2), size=(cfg.image_size,) * 2,
                       mode="bilinear", align_corners=False)
    return bg.permute(0, 2, 3, 1) * cfg.background_scale


def attribute_patterns(cfg: SyntheticConfig, device=None) -> torch.Tensor:
    """(n_attrs, H, W, C) deterministic per-attribute patterns, drawn from
    PRNGKey(1000 + a) as in the JAX package."""
    dev = resolve_device(device)
    H = cfg.image_size
    grid = torch.from_numpy(linspace_f32(-1.0, 1.0, H)).to(dev)
    yy, xx = torch.meshgrid(grid, grid, indexing="ij")
    pats = []
    for a in range(cfg.n_attrs):
        k = prng.PRNGKey(1000 + a, device=dev)
        k1, k2, k3, _ = prng.split(k, 4)
        kind = a % 3
        color = prng.normal(k1, (cfg.channels,))
        color = color / torch.linalg.vector_norm(color)
        if kind == 0:  # localized blob
            cy, cx = prng.uniform(k2, (2,), minval=-0.6, maxval=0.6)
            s = 0.15 + 0.15 * prng.uniform(k3, ())
            field = torch.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2) /
                                (2 * s ** 2)))
        elif kind == 1:  # oriented stripes
            theta = prng.uniform(k2, (), maxval=np.pi)
            freq = 3.0 + 4.0 * prng.uniform(k3, ())
            field = torch.sin(freq * (yy * torch.cos(theta) +
                                      xx * torch.sin(theta)) * np.pi)
        else:  # radial / corner gradient
            cy, cx = prng.uniform(k2, (2,), minval=-1, maxval=1)
            field = 1.0 - torch.sqrt((yy - cy) ** 2 + (xx - cx) ** 2) / 2.0
        pats.append(field[..., None] * color[None, None, :])
    return torch.stack(pats) * cfg.pattern_scale


def render(key, y, cfg: SyntheticConfig) -> torch.Tensor:
    """y: (N, n_attrs) multi-hot -> images (N, H, W, C) in [-1, 1]."""
    bg = _smooth_background(key, y.shape[0], cfg)
    pats = attribute_patterns(cfg, key.device)
    img = bg + torch.einsum("na,ahwc->nhwc", y.float(), pats)
    return torch.tanh(img)


def sample_labels(key, n, cfg: SyntheticConfig, probs=None) -> torch.Tensor:
    p = (torch.full((cfg.n_attrs,), cfg.attr_prob, device=key.device)
         if probs is None else probs)
    return prng.bernoulli(key, p, (n, cfg.n_attrs)).float()


def make_dataset(key, n, cfg: SyntheticConfig, probs=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(images, labels) of ``n`` samples on the key's device."""
    ky, kx = prng.split(key)
    y = sample_labels(ky, n, cfg, probs)
    return render(kx, y, cfg), y


def client_attr_priors(cfg: SyntheticConfig, k: int, non_iid: bool,
                       hi: float = 0.8, lo: float = 0.05,
                       device=None) -> torch.Tensor:
    """Per-client attribute priors (k, n_attrs).  Non-IID mode mirrors
    paper Fig. 3: each client specializes in a contiguous group of
    attributes."""
    dev = resolve_device(device)
    if not non_iid:
        return torch.full((k, cfg.n_attrs), cfg.attr_prob, device=dev)
    pri = torch.full((k, cfg.n_attrs), lo, device=dev)
    per = max(cfg.n_attrs // k, 1)
    for c in range(k):
        start = (c * per) % cfg.n_attrs
        pri[c, start:start + per] = hi
    return pri


def make_client_datasets(key, cfg: SyntheticConfig, k: int, n_per_client: int,
                         non_iid: bool = True,
                         sizes: Optional[List[int]] = None, device=None
                         ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Per-client datasets on ``device`` (CUDA unless asked otherwise).
    ``sizes`` (len k) overrides ``n_per_client`` per client.  A client's
    draws depend only on its own fold_in(key, c) stream, so resizing one
    client never changes another's data."""
    if sizes is not None and len(sizes) != k:
        raise ValueError(f"sizes must have one entry per client: "
                         f"len(sizes)={len(sizes)} != k={k}")
    dev = resolve_device(device)
    key = key.to(dev)
    priors = client_attr_priors(cfg, k, non_iid, device=dev)
    out = []
    for c in range(k):
        kc = prng.fold_in(key, c)
        n = n_per_client if sizes is None else int(sizes[c])
        out.append(make_dataset(kc, n, cfg, priors[c]))
    return out


def batches(x, y, batch_size: int, key=None, drop_last: bool = True
            ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """Yield (x, y) minibatches; shuffled (``prng.permutation``) when a
    key is given.  ``drop_last=False`` also yields the trailing partial
    batch."""
    n = x.shape[0]
    idx = (prng.permutation(key, n) if key is not None
           else torch.arange(n)).to(x.device)
    for i in range(0, n - batch_size + 1, batch_size):
        sl = idx[i:i + batch_size]
        yield x[sl], y[sl]
    tail = n % batch_size
    if not drop_last and tail:
        sl = idx[n - tail:]
        yield x[sl], y[sl]
