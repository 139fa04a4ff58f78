"""The work of one launch of the Mamba2 mixer's fused glue kernels, from
their shapes alone: the bytes each must move (each input read once, each
output written once) and its floating-point operations, counted in
``kernels.FLOPS`` on the card and on the meta device alike.
"""
from __future__ import annotations

from typing import Tuple


def conv_silu_cost(rows: int, channels: int, width: int,
                   itemsize: int) -> Tuple[int, int]:
    """(bytes, flops) of the conv + bias + SiLU over ``rows`` tokens of
    ``channels`` (d_inner + 2n: x and B/C in one launch): the input read
    and the output written once, the (width, channels) weights and the
    bias read once; 2·width + 4 flops an output (the conv's products and
    sums, the bias, SiLU's exponential, sum and division)."""
    nbytes = (2 * rows * channels + (width + 1) * channels) * itemsize
    return nbytes, rows * channels * (2 * width + 4)


def rmsnorm_cost(rows: int, d: int, itemsize: int, heads: int = 0
                 ) -> Tuple[int, int]:
    """(bytes, flops) of the row norm over ``rows`` rows of ``d``; with
    ``heads`` > 0 the gated form (y, xs and z read, D float32 a head).
    Each input read and the output written once, the scale read once; 4
    flops a value (the square, the sum, the two products) and 3 a row (the
    mean, eps, the rsqrt), and gated 6 more a value (xs·D, the skip's sum,
    SiLU's 3, the gate's product)."""
    reads = 3 if heads else 1
    nbytes = ((reads + 1) * rows * d + d) * itemsize + 4 * heads
    return nbytes, rows * (d * (10 if heads else 4) + 3)
