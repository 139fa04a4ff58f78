"""The work of one DDPM-step launch, from its shapes alone: the bytes it
must move and its operations.  ``chip_smoke.py`` divides them by the
card's rates for a launch's bound; the launches add their floating-point
operations to ``kernels.FLOPS`` (on the card and on the meta device
alike), which the dry run adds to the aten count.

The keyed variants draw their noise in the launch (csrc/threefry.cuh): a
Threefry-2x32 block is 2 + 5 × (4 × 3) + 5 × 3 = 77 integer operations;
an element takes one block, its counter's split, the XOR of the words and
the mantissa (+5), and in float the uniform (4), erfinvf (~25: CUDA's
single-precision erfinvf is a log and a polynomial), the sqrt(2) scale (1)
and the step (5).
"""
from __future__ import annotations

from typing import Tuple

STEP_FLOPS = 5                  # (x - coef·eps)·inv_sqrt_alpha + sigma·n
THREEFRY_INT_OPS = 77
DRAW_INT_OPS = THREEFRY_INT_OPS + 5
DRAW_FLOAT_OPS = 4 + 25 + 1 + STEP_FLOPS


def cost(K: int, per: int, itemsize: int) -> Tuple[int, int]:
    """(bytes, flops) of the given-noise step over K slabs of ``per``
    elements: x, eps and the noise read and the output written, a (K, 3)
    float32 coefficient table read; STEP_FLOPS an element."""
    return 4 * K * per * itemsize + 12 * K, STEP_FLOPS * K * per


def cost_keyed(elements: int, itemsize: int, derivations: int,
               extra_bytes: int, passed: int = 0) -> Tuple[int, int, int]:
    """(bytes, integer ops, flops) of a keyed step: x and eps read and
    the output written for the ``elements`` that step, x read and written
    for the ``passed`` ones of masked slabs, plus keys, coefficients and
    mask (``extra_bytes``); the draw's integer operations (DRAW_INT_OPS an
    element and a Threefry block per key ``derivations``) and its float
    ones with the step's (DRAW_FLOAT_OPS an element)."""
    nbytes = (3 * elements + 2 * passed) * itemsize + extra_bytes
    return nbytes, elements * DRAW_INT_OPS + \
        derivations * THREEFRY_INT_OPS, elements * DRAW_FLOAT_OPS
