"""What the three evaluation nets share: He-scaled 3×3 HWIO kernels drawn
as the JAX package's ``eval/`` modules draw them, bias-free convs with
XLA's ``SAME`` padding applied to NHWC images, and the trainer of the
reconstructor and the classifier.

Every net is drawn on the CPU from a CPU copy of its key and then moved
to the images' device, so a net holds the same bits on every device (the
card's ``erfinv`` may differ from the CPU's by an ulp).

``fit`` goes through the port's ``optim/adamw.py`` as the reference's
trainers go through its own, with ``torch.autograd.grad`` in place of
``jax.value_and_grad`` and an eager step in place of ``jax.jit``.  The
batch indices of all steps are drawn at once on the CPU —
``randint(fold_in(key, i), (min(batch, n),), 0, n)`` for every i, bit
for bit the reference's per-step draws.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.core import prng
from repro_torch.core.unet import Conv2dSame
from repro_torch.models.layers import fill
from repro_torch.optim.adamw import AdamWConfig, adamw_update, init_opt_state


def conv(cin: int, cout: int, stride: int = 1) -> Conv2dSame:
    """An uninitialised bias-free 3×3 conv with XLA's SAME padding."""
    return Conv2dSame(cin, cout, 3, stride=stride, bias=False)


def fill_conv(c: Conv2dSame, key: torch.Tensor) -> None:
    """``normal(key, (3, 3, cin, cout)) · sqrt(2 / (9·cin))`` (HWIO, the
    reference's draw) into the conv's OIHW weight."""
    cin = c.in_channels
    w = prng.normal(key, (3, 3, cin, c.out_channels)) * math.sqrt(
        2.0 / (9 * cin))
    fill(c.weight, w.permute(3, 2, 0, 1))


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC images → float32 NCHW."""
    return x.float().permute(0, 3, 1, 2)


def conv_lrelu(c: Conv2dSame, h: torch.Tensor) -> torch.Tensor:
    """conv, then leaky ReLU of slope 0.1 (``jax.nn.leaky_relu(h, 0.1)``)."""
    return F.leaky_relu(c(h), 0.1)


def batch_indices(key: torch.Tensor, steps: int, batch: int,
                  n: int) -> torch.Tensor:
    """(steps, min(batch, n)) int64: row i is ``randint(fold_in(key, i),
    (min(batch, n),), 0, n)``, drawn on the CPU in one batched call."""
    k = prng.fold_in(key.cpu(), torch.arange(steps))
    return prng.randint(k, (min(batch, n),), 0, n).long()


def fit(params: nn.Module, loss_fn, xs: torch.Tensor, ys: torch.Tensor,
        key: torch.Tensor, steps: int, batch: int, lr: float) -> nn.Module:
    """``steps`` AdamW updates (``clip_norm`` 0) of ``loss_fn(params, xb,
    yb)`` on the batches of ``batch_indices(key, ...)``, in place."""
    opt = init_opt_state(params)
    cfg = AdamWConfig(lr=lr, clip_norm=0.0)
    names, ps = zip(*params.named_parameters())
    idx = batch_indices(key, steps, batch, xs.shape[0]).to(xs.device)
    for i in range(steps):
        with torch.enable_grad():
            loss = loss_fn(params, xs[idx[i]], ys[idx[i]])
            grads = torch.autograd.grad(loss, ps)
        adamw_update(params, dict(zip(names, grads)), opt, cfg)
    return params
