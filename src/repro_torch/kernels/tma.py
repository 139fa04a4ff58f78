"""Geometry of the TMA tensor maps that the port's wgmma kernels load
through (csrc/hopper.cuh ``encode_map``).

The wrappers compute each map here, in Python, and hand it to the CUDA
side packed into ten integers, so the geometry of every load is pinned by
CPU tests without a card.  A map is bf16: ``dims`` in elements, innermost
first; ``strides`` in bytes, of dims 1 and up (multiples of 16); ``box``,
the tile one load brings, in elements (each at most 256, the innermost at
most ``swizzle`` bytes); ``swizzle``, the width in bytes (32, 64 or 128)
of the shared-memory swizzle that the wgmma descriptors match.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Tuple

BF16_BYTES = 2
MAP_WORDS = 10          # hopper.cuh kMapWords


@dataclass(frozen=True)
class TmaMap:
    dims: Tuple[int, ...]
    strides: Tuple[int, ...]
    box: Tuple[int, ...]
    swizzle: int

    def packed(self) -> Tuple[int, ...]:
        """rank, dims[3], strides[2], box[3], swizzle; unused dims and
        boxes are 1, unused strides 0."""
        pad = 3 - len(self.dims)
        return (len(self.dims), *self.dims, *(1,) * pad, *self.strides,
                *(0,) * (2 - len(self.strides)), *self.box, *(1,) * pad,
                self.swizzle)


@functools.lru_cache(maxsize=64)
def as_ctypes(m: TmaMap):
    """The packed geometry as a C array of long long, built once per map
    and kept alive by the cache."""
    return (ctypes.c_longlong * MAP_WORDS)(*m.packed())
