"""Threefry-2x32 keys and draws in plain PyTorch, bit for bit with
``jax.random`` under ``jax_threefry_partitionable=True``.

A frozen copy for the benchmark's reference: the serving path addresses
its randomness by key (``fold_in`` per group, request, client and row),
so the reference re-derives every draw from the run's seed rather than
reading the program's.  A key is an int64 tensor of
shape ``(..., 2)`` holding two uint32 words; every word op is done in
int64 and masked to 32 bits, the same on the CPU and on CUDA.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_SQRT2 = np.float32(np.sqrt(2.0))
_NORMAL_LO = np.nextafter(np.float32(-1.0), np.float32(0.0))


def _rotl(x, r: int):
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """20 rounds of Threefry-2x32 on broadcastable int64 word tensors."""
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


def key_from_seed(seed: int, device=None) -> torch.Tensor:
    """The (2,) key of a seed of up to 64 bits: its high and low words."""
    seed = int(seed)
    if not 0 <= seed < 2 ** 64:
        raise ValueError(f"seed {seed} is outside [0, 2**64)")
    return torch.tensor([(seed >> 32) & MASK, seed & MASK],
                        dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """Hash the counter pair (0, data) under ``key`` (..., 2)."""
    if isinstance(data, torch.Tensor):
        d = data.to(device=key.device, dtype=torch.int64) & MASK
    else:
        d = torch.tensor(int(data) & MASK, dtype=torch.int64,
                         device=key.device)
    b1, b2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(b1, b2), dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """(num, 2) keys of one (2,) key."""
    return fold_in(key, torch.arange(num, device=key.device))


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32 bits per element; a batched key (..., 2) gives (..., *shape)."""
    shape = tuple(int(s) for s in shape)
    idx = torch.arange(math.prod(shape), dtype=torch.int64,
                       device=key.device).reshape(shape)
    expand = key.shape[:-1] + (1,) * idx.ndim
    b1, b2 = threefry2x32(key[..., 0].reshape(expand),
                          key[..., 1].reshape(expand), idx >> 32, idx & MASK)
    return b1 ^ b2


def _uniform_from_bits(bits, minval: float, maxval: float):
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = mant.view(torch.float32) - 1.0
    lo = torch.tensor(np.float32(minval), device=bits.device)
    scale = torch.tensor(np.float32(maxval) - np.float32(minval),
                         device=bits.device)
    return torch.maximum(lo, floats * scale + lo)


def normal(key, shape=()) -> torch.Tensor:
    """sqrt(2)·erfinv(uniform on [nextafter(-1, 0), 1)), float32."""
    u = _uniform_from_bits(random_bits(key, shape), float(_NORMAL_LO), 1.0)
    return torch.erfinv(u) * torch.tensor(_SQRT2, device=key.device)


def row_keys(key: torch.Tensor, rows) -> torch.Tensor:
    """fold_in(key, i) for each row index i (an int count or a tensor of
    indices); a batched key (..., 2) gives (..., n, 2)."""
    if isinstance(rows, int):
        rows = torch.arange(rows, device=key.device)
    return fold_in(key.unsqueeze(-2), rows.to(key.device))


def rowwise_normal(key, shape, rows=None) -> torch.Tensor:
    """Row-keyed normals: row i of ``shape[0]`` rows is normal(fold_in(key,
    i), shape[1:]); ``rows`` picks a subset of the row indices."""
    idx = torch.arange(shape[0], device=key.device) if rows is None \
        else rows
    return normal(row_keys(key, idx), tuple(shape[1:]))

