"""The work of one grouped-matmul launch, from its shapes alone: the
bytes it must move (each input read once, each output written once) and
its floating-point operations.  ``chip_smoke.py`` divides them by the
card's rates for a launch's bound; the launches add their operations to
``kernels.FLOPS`` (on the card and on the meta device alike), which the
dry run adds to the aten count.
"""
from __future__ import annotations

from typing import Tuple


def cost(E: int, C: int, D: int, F: int, itemsize: int,
         shared_tokens: bool) -> Tuple[int, int]:
    """(bytes, flops) of (E, C, D) @ (E, D, F): the tokens read once (one
    (C, D) set when they are broadcast to every expert), the weights read
    once, the output written once; 2·E·C·D·F flops."""
    tokens = (1 if shared_tokens else E) * C * D
    return (tokens + E * D * F + E * C * F) * itemsize, 2 * E * C * D * F


def cost_backward(E: int, C: int, D: int, F: int, itemsize: int,
                  shared_tokens: bool) -> Tuple[int, int]:
    """(bytes, flops) of the backward for dout (E, C, F): the tokens (one
    (C, D) set when broadcast), the weights and dout read once, dtokens
    (one (C, D) sum over the experts when the tokens are broadcast) and
    dweights written once; 4·E·C·D·F flops (dY·Wᵀ and Xᵀ·dY)."""
    tokens = (1 if shared_tokens else E) * C * D
    return (2 * tokens + 2 * E * D * F + E * C * F) * itemsize, \
        4 * E * C * D * F
