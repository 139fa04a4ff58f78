"""The work of one SSD-scan launch, from its shapes alone: the bytes it
must move (each input read once, each output written once) and its
floating-point operations.  ``chip_smoke.py`` divides them by the card's
rates for a launch's bound; the launches add their operations to
``kernels.FLOPS`` (on the card and on the meta device alike), which the
dry run adds to the aten count.
"""
from __future__ import annotations

from typing import Sequence, Tuple


def cost(x_shape: Sequence[int], n: int, chunk: int,
         itemsize: int) -> Tuple[int, int]:
    """(bytes, flops) of the forward on x (b, s, h, p) with state n: x,
    dt, A, B, C read once, y and the float32 state written once; per
    (batch, head, tile of q steps) the kernel's products: C·B and the
    scores times dt·x on and below the diagonal, C·state and dt·xᵀB."""
    b, s, h, p = x_shape
    q = min(chunk, 64)
    tiles = -(-s // q)
    x_n, b_n = b * s * h * p, b * s * n
    nbytes = (2 * x_n + 2 * b_n) * itemsize + (b * s * h + h) * 4 + \
        b * h * p * n * 4
    return nbytes, b * h * tiles * ((n + p) * q * (q + 1) + 4 * q * p * n)


def cost_backward(x_shape: Sequence[int], n: int, chunk: int,
                  itemsize: int) -> Tuple[int, int]:
    """(bytes, flops) of the backward: x and dy read and dx written, B and
    C read and dB and dC written (x's type), dt read and ddt written
    (float32), A read and dA written; the products of the backward's
    algorithm done once: per (batch, chunk) C·B over the q(q+1)/2 pairs
    on and below the diagonal (shared by the heads), per head dy·dtx,
    d(dtx), dB and dC over those pairs, and per step the two chunk sums,
    G B, Gᵀ dtx and hᵀ dy."""
    b, s, h, p = x_shape
    q = min(chunk, s)
    nc = -(-s // q)
    pairs = q * (q + 1) // 2
    x_n, b_n = b * s * h * p, b * s * n
    nbytes = (3 * x_n + 4 * b_n) * itemsize + 2 * b * s * h * 4 + 2 * h * 4
    return nbytes, b * nc * (pairs * 2 * n + h * (
        pairs * (4 * p + 4 * n) + q * 10 * p * n))
