"""The work of one flash-attention launch, from its shapes alone: the
bytes it must move (each input read once, each output written once) and
its floating-point operations.  ``chip_smoke.py`` divides them by the
card's rates for a launch's bound; the launches add their operations to
``kernels.FLOPS`` (on the card and on the meta device alike), which the
dry run adds to the aten count.
"""
from __future__ import annotations

from typing import Sequence, Tuple


def keep_count(S: int, causal: bool, window: int) -> int:
    """The (query, key) pairs that the masks keep at length S: key j of
    query i is kept when j <= i (causal) and i - j < window (window >
    0)."""
    if window <= 0:
        return S * (S + 1) // 2 if causal else S * S
    if causal:                   # sum over i of min(i + 1, window)
        m = min(S, window)
        return m * (m + 1) // 2 + (S - m) * window
    n = max(S - window, 0)       # keys j <= i - window are cut
    return S * S - n * (n + 1) // 2


def cost(q_shape: Sequence[int], k_shape: Sequence[int], causal: bool,
         window: int, itemsize: int) -> Tuple[int, int]:
    """(bytes, flops) of the forward: q, k, v read once, out written
    once; 4·dh flops per (query, key) pair that the masks keep."""
    B, H, S, dh = q_shape
    q_n, k_n = B * H * S * dh, B * k_shape[1] * S * dh
    return (2 * q_n + 2 * k_n) * itemsize, \
        4 * B * H * dh * keep_count(S, causal, window)


def cost_backward(q_shape: Sequence[int], k_shape: Sequence[int],
                  causal: bool, window: int,
                  itemsize: int) -> Tuple[int, int]:
    """(bytes, flops) of the backward: q, k, v, out, dout and the float32
    lse read once, dq, dk, dv written once; 10·dh flops per kept pair
    (the five products S = q kᵀ, dP = dO vᵀ, dV, dK and dQ)."""
    B, H, S, dh = q_shape
    q_n, k_n = B * H * S * dh, B * k_shape[1] * S * dh
    return (4 * q_n + 4 * k_n) * itemsize + B * H * S * 4, \
        10 * B * H * dh * keep_count(S, causal, window)
