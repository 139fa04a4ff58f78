"""Threefry-2x32 keys and draws, bit for bit with ``jax.random``.

The serve path addresses its randomness by key rather than drawing from a
sequential generator: ``fold_in(key, seed)`` per group and per request,
``fold_in(key, i)`` per batch row, chained ``split`` in the per-request
samplers.  Warm==cold, fifo==depth and padding invariance rest on that
addressing, so the port keeps JAX's counter-based generator instead of a
``torch.Generator``.

A key is an int64 tensor of shape ``(..., 2)`` holding two uint32 words;
every word op is done in int64 and masked to 32 bits, which runs the same
on the CPU and on CUDA.  The layout follows jax 0.9.0 with
``jax_threefry_partitionable=True`` (the default there):

* ``split(key, n)[i]`` and ``fold_in(key, i)`` both hash the counter pair
  ``(0, i)`` under the key;
* ``random_bits`` hashes ``(hi32(j), lo32(j))`` for the flat index j of
  every element and XORs the two output words;
* ``uniform`` puts the top 23 bits into the mantissa of a float in [1, 2);
* ``normal`` is ``sqrt(2)·erfinv(uniform(nextafter(-1, 0), 1))``.  Bits,
  keys and uniforms equal JAX's exactly; ``torch.erfinv`` may differ from
  XLA's by a few ulps.

Each draw is ~170 elementwise launches on a card (a later candidate for a
fused kernel).
"""
from __future__ import annotations

import math
from typing import Sequence, Union

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_SQRT2 = np.float32(np.sqrt(2.0))
_NORMAL_LO = np.nextafter(np.float32(-1.0), np.float32(0.0))

Data = Union[int, torch.Tensor]


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block (20 rounds) on broadcastable int64 tensors
    holding uint32 words.  Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + k1) & MASK
    x2 = (x2 + k2) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x1, x2


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: the pair
    (0, seed mod 2^32)."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} is outside the int32 range")
    return torch.tensor([0, seed & MASK], dtype=torch.int64, device=device)


def key_data(key: torch.Tensor) -> np.ndarray:
    """The key words as a host uint32 array (JAX's ``key_data`` layout)."""
    return key.detach().cpu().numpy().astype(np.uint32)


def _as_words(data: Data, device) -> torch.Tensor:
    if isinstance(data, torch.Tensor):
        return data.to(device=device, dtype=torch.int64) & MASK
    return torch.tensor(int(data) & MASK, dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data: Data) -> torch.Tensor:
    """``jax.random.fold_in``: hash the counter pair (0, data) under key.
    ``key`` is (..., 2); ``data`` an int or an integer tensor that
    broadcasts against ``key[..., 0]``."""
    d = _as_words(data, key.device)
    b1, b2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(b1, b2), dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` of one (2,) key into (num, 2) keys."""
    if key.shape != (2,):
        raise ValueError(f"split takes one (2,) key, got {tuple(key.shape)}")
    return fold_in(key, torch.arange(num, device=key.device))


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits per element (int64 in [0, 2^32)).  A batched key
    (..., 2) gives (..., *shape), each key drawing its own ``shape``."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    hi, lo = (idx >> 32).reshape(shape), (idx & MASK).reshape(shape)
    lead = key.shape[:-1]
    expand = lead + (1,) * len(shape)
    k1 = key[..., 0].reshape(expand)
    k2 = key[..., 1].reshape(expand)
    b1, b2 = threefry2x32(k1, k2, hi, lo)
    return b1 ^ b2


def uniform(key: torch.Tensor, shape: Sequence[int] = (),
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32 on [minval, maxval)."""
    bits = random_bits(key, shape)
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = mant.view(torch.float32) - 1.0
    lo = np.float32(minval)
    scale = np.float32(maxval) - lo
    lo_t = torch.tensor(lo, dtype=torch.float32, device=key.device)
    out = floats * torch.tensor(scale, dtype=torch.float32,
                                device=key.device) + lo_t
    return torch.maximum(lo_t, out)


def normal(key: torch.Tensor, shape: Sequence[int] = ()) -> torch.Tensor:
    """``jax.random.normal`` in float32 (erfinv of a symmetric uniform)."""
    u = uniform(key, shape, float(_NORMAL_LO), 1.0)
    return torch.erfinv(u) * torch.tensor(_SQRT2, device=key.device)
