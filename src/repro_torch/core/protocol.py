"""Row-keyed noise of the collaborative protocol (paper Alg. 1/2).

Only ``rowwise_normal`` is ported in this slice: the serve path's every
noise draw goes through it.  The training step of Alg. 1 comes with the
training slice.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core import prng
from repro_torch.core.splitting import row_keys


def rowwise_normal(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """(B, ...) standard normals with row-keyed draws: row i depends only
    on (key, i), never on B.  A batched key (..., 2) gives (..., B, ...)
    — one independent row-keyed draw per key, as ``vmap`` over keys gives
    in the JAX package."""
    return prng.normal(row_keys(key, shape[0]), tuple(shape[1:]))
