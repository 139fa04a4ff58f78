"""Attribute-inference attack (paper Fig. 7).

The port of the JAX package's ``eval/attr_inference.py``: a small conv
classifier trained on (intermediate image, attribute) pairs, scored by
per-attribute F1 on held-out pairs; earlier (noisier) cut points should
leak less.  The classifier is drawn on the CPU (``eval/convnet.py``) and
trained by ``eval/convnet.fit`` (the port's AdamW, eager steps, batch
indices bit for bit the reference's); the train/test split is
``permutation(key, n)``, bit for bit the reference's.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from repro_torch.core import prng
from repro_torch.eval.convnet import (conv, conv_lrelu, fill_conv, fit,
                                      to_nchw)
from repro_torch.models.layers import dense, fill_dense


class Classifier(nn.Module):
    """Two bias-free stride-2 3×3 convs and a linear head under the
    reference's keys c1, c2, head."""

    def __init__(self, channels: int, n_attrs: int, width: int = 32):
        super().__init__()
        self.c1 = conv(channels, width, stride=2)
        self.c2 = conv(width, width * 2, stride=2)
        self.head = dense(width * 2, n_attrs, torch.float32)


def _init_clf(key: torch.Tensor, channels: int, n_attrs: int,
              width: int = 32, device="cpu") -> Classifier:
    m = Classifier(channels, n_attrs, width)
    k1, k2, k3 = prng.split(key.cpu(), 3)
    fill_conv(m.c1, k1)
    fill_conv(m.c2, k2)
    fill_dense(m.head, k3, scale=0.02)
    return m.to(device)


def _clf_logits(params: Classifier, x: torch.Tensor) -> torch.Tensor:
    h = to_nchw(x)
    for c in (params.c1, params.c2):
        h = conv_lrelu(c, h)
    return params.head(h.mean(dim=(2, 3)))


def _bce(params: Classifier, xb, yb):
    """Mean binary cross-entropy with logits, written as the reference
    writes it."""
    lg = _clf_logits(params, xb)
    return torch.mean(torch.clamp(lg, min=0) - lg * yb +
                      torch.log1p(torch.exp(-torch.abs(lg))))


def train_attr_classifier(key: torch.Tensor, x: torch.Tensor,
                          y: torch.Tensor, steps: int = 300,
                          batch: int = 64, lr: float = 3e-3) -> Classifier:
    """x: (N, H, W, C) intermediate images; y: (N, A) multi-hot
    attributes."""
    params = _init_clf(key, x.shape[-1], y.shape[-1], device=x.device)
    return fit(params, _bce, x, y, key, steps, batch, lr)


@torch.no_grad()
def f1_per_attribute(params: Classifier, x: torch.Tensor,
                     y: torch.Tensor) -> torch.Tensor:
    """Per-attribute F1 of the trained classifier on held-out pairs."""
    pred = (_clf_logits(params, x) > 0).float()
    tp = torch.sum(pred * y, dim=0)
    fp = torch.sum(pred * (1 - y), dim=0)
    fn = torch.sum((1 - pred) * y, dim=0)
    return 2 * tp / torch.clamp(2 * tp + fp + fn, min=1.0)


def attribute_inference_f1(key: torch.Tensor, x_intermediate: torch.Tensor,
                           y: torch.Tensor, train_frac: float = 0.8
                           ) -> torch.Tensor:
    """End-to-end Fig.-7 measurement for one cut point."""
    n = x_intermediate.shape[0]
    n_tr = int(n * train_frac)
    perm = prng.permutation(key.cpu(), n).long().to(x_intermediate.device)
    xt, yt = x_intermediate[perm[:n_tr]], y[perm[:n_tr]]
    xe, ye = x_intermediate[perm[n_tr:]], y[perm[n_tr:]]
    clf = train_attr_classifier(key, xt, yt)
    return f1_per_attribute(clf, xe, ye)
