"""The benchmark's own yardstick arithmetic: the published peaks of one
NVIDIA H100, the work of the port's hand-written kernels from their
shapes, and the bound that a kernel's time is held against.

Copied from the program (``kernels/{ddpm_step,flash_attention,ssd_scan}/
cost.py`` and the card's rates of ``launch/mesh.py`` and
``chip_smoke.py``) so that a change to the program cannot move the
yardstick.
"""
from __future__ import annotations

from typing import Sequence, Tuple

# NVIDIA H100 SXM5 80GB data sheet: dense rates at the full 700 W limit
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = PEAK_FLOPS["float32"]
# a single fmul or fadd (the DDPM step forbids FMAs) runs at half the FMA
# rate; 32-bit integer add, xor and shift at a quarter of it (the CUDA
# C++ arithmetic instruction throughput table, compute capability 9.0)
FP32_INSTR_PER_S = FP32_FLOPS_PER_S / 2
INT32_OPS_PER_S = FP32_FLOPS_PER_S / 4

# the DDPM step (kernels/ddpm_step/cost.py)
STEP_FLOPS = 5
THREEFRY_INT_OPS = 77
DRAW_INT_OPS = THREEFRY_INT_OPS + 5
DRAW_FLOAT_OPS = 4 + 25 + 1 + STEP_FLOPS


def ddpm_keyed_cost(elements: int, itemsize: int, derivations: int,
                    extra_bytes: int, passed: int = 0
                    ) -> Tuple[int, int, int]:
    """(bytes, integer ops, flops) of a keyed DDPM step: x and ε read and
    the output written for the ``elements`` that step, x read and written
    for the ``passed`` ones of masked slabs, plus keys, coefficients and
    mask; the draw's integer operations (DRAW_INT_OPS an element and a
    Threefry block per key ``derivations``) and its float ones."""
    nbytes = (3 * elements + 2 * passed) * itemsize + extra_bytes
    return nbytes, elements * DRAW_INT_OPS + \
        derivations * THREEFRY_INT_OPS, elements * DRAW_FLOAT_OPS


def bound_s(nbytes: float, ops: float, ops_per_s: float) -> float:
    """The least time the card could take: bytes at the HBM rate or
    operations at ``ops_per_s``, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, ops / ops_per_s)


def rowwise_launch_bound_s(slabs: int, per_slab: int, rows: int,
                           itemsize: int = 4) -> float:
    """Least time of one rowwise DDPM-step launch over ``slabs`` active
    slabs of ``rows`` rows and ``per_slab`` elements each: the integer
    ops at INT32_OPS_PER_S, or all ops in the integer slots at one a lane
    a clock, or the bytes, whichever is longest."""
    nbytes, int_ops, flops = ddpm_keyed_cost(
        slabs * per_slab, itemsize, slabs + slabs * rows,
        slabs * (16 + 12 + 4))
    slots = max(int_ops, (int_ops + flops) * INT32_OPS_PER_S /
                FP32_INSTR_PER_S)
    return bound_s(nbytes, slots, INT32_OPS_PER_S)


def flash_cost(q_shape: Sequence[int], kv_heads: int, itemsize: int,
               causal: bool = False) -> Tuple[int, int]:
    """(bytes, flops) of flash attention's forward without a window:
    q, k, v read and out written once; 4·dh flops a kept (query, key)."""
    B, H, S, dh = q_shape
    q_n, k_n = B * H * S * dh, B * kv_heads * S * dh
    keep = S * (S + 1) // 2 if causal else S * S
    return (2 * q_n + 2 * k_n) * itemsize, 4 * B * H * dh * keep


def ssd_cost(x_shape: Sequence[int], n: int, chunk: int,
             itemsize: int) -> Tuple[int, int]:
    """(bytes, flops) of the SSD scan's forward on x (b, s, h, p) with
    state size n (kernels/ssd_scan/cost.py)."""
    b, s, h, p = x_shape
    q = min(chunk, 64)
    tiles = -(-s // q)
    x_n, b_n = b * s * h * p, b * s * n
    nbytes = (2 * x_n + 2 * b_n) * itemsize + (b * s * h + h) * 4 + \
        b * h * p * n * 4
    return nbytes, b * h * tiles * ((n + p) * q * (q + 1) + 4 * q * p * n)


def share_pct(work: float, seconds: float, rate: float) -> float:
    """Work done in ``seconds`` as a percentage of ``rate`` (a peak)."""
    return 100.0 * work / (seconds * rate)
