"""Shared building blocks: the sinusoidal timestep embedding and the
dense-weight initialiser (threefry-keyed, equal to the JAX package's for
the same key)."""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core import prng


def dense_init(key: torch.Tensor, d_in: int, d_out: int,
               dtype=torch.float32, scale: Optional[float] = None
               ) -> torch.Tensor:
    """(d_in, d_out) weight ~ N(0, scale²), scale = 1/sqrt(d_in) by
    default — JAX's (in, out) layout."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return (prng.normal(key, (d_in, d_out)) * scale).to(dtype)


def sinusoidal_embedding(positions: torch.Tensor, dim: int,
                         max_period: float = 10_000.0) -> torch.Tensor:
    """(...,) positions -> (..., dim) sinusoidal embedding (float32)."""
    half = dim // 2
    idx = torch.arange(half, dtype=torch.float32, device=positions.device)
    freqs = torch.exp(-math.log(max_period) * idx / half)
    args = positions.float()[..., None] * freqs
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.nn.functional.pad(emb, (0, 1))
    return emb
