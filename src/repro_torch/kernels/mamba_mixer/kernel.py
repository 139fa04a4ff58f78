"""Loader and launch of the Mamba2 mixer's fused glue kernels
(csrc/mamba_mixer.cu), built with nvcc on first use (kernels/build.py).

``launch_conv_silu``: the causal depthwise conv + bias + SiLU of x and of
B/C in one launch, B and C as two contiguous outputs.  ``launch_rmsnorm``:
the mixer's input RMSNorm, or with ``xs``, ``D`` and ``z`` its output
RMSNorm with the D skip and the SiLU gate folded in, its row sum added up
in the order of aten's reduction, so its bits are the eager route's.
Each takes contiguous tensors of one activation type (float32 or
bfloat16), checks
shapes, types and contiguity first and the device last (so the checks run
on the CPU), refuses an input that needs a gradient (no backward: autograd
keeps the eager route, ops.py), and on the meta device (the dry run)
returns empty outputs of the card's shapes and types, its operations
counted in ``kernels.FLOPS``.

The plain versions are the eager route itself, ``models/ssm._causal_conv``
and ``models/layers.rmsnorm`` with the mixer's D skip and gate around it,
which the CPU tests hold against the JAX package.

``COUNTS`` is bumped only where a kernel is launched, so a run can show
that its mixers went through the kernels.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import add_flops, build, raw_stream, refuse_grad
from repro_torch.kernels.mamba_mixer import cost

SOURCE = "mamba_mixer.cu"
COUNTS: Dict[str, int] = {"mamba_conv_silu": 0, "mamba_rmsnorm": 0,
                          "mamba_rmsnorm_gated": 0}
MAX_WIDTH = 4               # the widest conv the configurations carry
# the norm's row widths (csrc kNormMinWidth, kNormMaxWidth): multiples of
# 4 that aten sums as 4-value vectors without splitting a row across warps
NORM_WIDTHS = (128, 7936)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# x, bc, w_x, b_x, w_bc, b_bc, xc, B, C, batch, S, Cx, n, K, dtype, vec,
# stream
_CONV_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + \
    [ctypes.c_void_p]
# x, scale, xs, D, z, out, rows, d, p, rdiv, eps, dtype, stream
_NORM_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + \
    [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p]


def reset_counts() -> None:
    for name in COUNTS:
        COUNTS[name] = 0


def _check(what: str, tensors: Dict[str, torch.Tensor],
           dtype: torch.dtype) -> None:
    """Contiguity, and every tensor of ``dtype`` (float32 or bfloat16)."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"{what} takes float32 or bfloat16, got {dtype}")
    for name, a in tensors.items():
        if not a.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
        if a.dtype != dtype:
            raise TypeError(f"{what}: {name} is {a.dtype}, not {dtype}")


def _check_device(what: str, tensors: Dict[str, torch.Tensor]
                  ) -> torch.device:
    """The CUDA device that every tensor must share; checked after the
    shapes and types, so those checks run on the CPU."""
    dev = next(iter(tensors.values())).device
    for name, a in tensors.items():
        if a.device != dev or dev.type != "cuda":
            raise ValueError(f"{what}: {name} on {a.device}, expected one "
                             f"CUDA device ({dev})")
    return dev


def _vectorised(tensors, *widths: int) -> bool:
    """Whether the kernels may move 16-byte vectors: every pointer 16-byte
    aligned and every row width a multiple of a vector's values."""
    per = 16 // next(iter(tensors)).element_size()
    return all(t.data_ptr() % 16 == 0 for t in tensors) and \
        all(w % per == 0 for w in widths)


def launch_conv_silu(x: torch.Tensor, bc: torch.Tensor, w_x: torch.Tensor,
                     b_x: torch.Tensor, w_bc: torch.Tensor,
                     b_bc: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """SiLU(causal depthwise conv + bias) of x (b, s, Cx) with w_x (K, Cx)
    and b_x (Cx,), and of bc (b, s, 2n) with w_bc (K, 2n) and b_bc (2n,),
    K <= MAX_WIDTH, as ``models/ssm._causal_conv`` computes each.  Returns
    (x's output (b, s, Cx), B (b, s, n), C (b, s, n)), all contiguous."""
    what = "mamba conv_silu kernel"
    tensors = dict(x=x, bc=bc, w_x=w_x, b_x=b_x, w_bc=w_bc, b_bc=b_bc)
    refuse_grad("mamba_conv_silu", *tensors.values())
    _check(what, tensors, x.dtype)
    if x.ndim != 3 or bc.ndim != 3 or w_x.ndim != 2:
        raise ValueError(f"{what}: x {tuple(x.shape)}, bc "
                         f"{tuple(bc.shape)}, w_x {tuple(w_x.shape)}")
    b, s, cx = x.shape
    k, cb = w_x.shape[0], bc.shape[-1]
    if bc.shape[:2] != (b, s) or cb % 2 or w_x.shape != (k, cx) or \
            b_x.shape != (cx,) or w_bc.shape != (k, cb) or \
            b_bc.shape != (cb,):
        raise ValueError(
            f"{what}: x {tuple(x.shape)}, bc {tuple(bc.shape)}, w_x "
            f"{tuple(w_x.shape)}, b_x {tuple(b_x.shape)}, w_bc "
            f"{tuple(w_bc.shape)}, b_bc {tuple(b_bc.shape)}")
    if not 1 <= k <= MAX_WIDTH:
        raise ValueError(f"{what}: conv width {k} not in [1, {MAX_WIDTH}]")
    n = cb // 2
    flops = cost.conv_silu_cost(b * s, cx + cb, k, x.element_size())[1]
    out_bc = lambda dev: tuple(torch.empty((b, s, n), dtype=x.dtype,
                                           device=dev) for _ in range(2))
    if x.is_meta:               # the dry run: shapes alone, nothing computed
        add_flops("mamba_conv_silu", flops)
        return (torch.empty_like(x), *out_bc("meta"))
    dev = _check_device(what, tensors)
    xo = torch.empty_like(x)
    bo, co = out_bc(dev)
    if xo.numel() == 0 or n == 0:
        return xo, bo, co
    vec = _vectorised(tensors.values(), cx, n)
    rc = build.bind(SOURCE, "mamba_conv_silu_launch", _CONV_ARGTYPES)(
        x.data_ptr(), bc.data_ptr(), w_x.data_ptr(), b_x.data_ptr(),
        w_bc.data_ptr(), b_bc.data_ptr(), xo.data_ptr(), bo.data_ptr(),
        co.data_ptr(), b, s, cx, n, k, _DTYPE_CODES[x.dtype], int(vec),
        raw_stream(dev.index))
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {rc}")
    COUNTS["mamba_conv_silu"] += 1
    add_flops("mamba_conv_silu", flops)
    return xo, bo, co


def norm_width_ok(d: int) -> bool:
    """Whether ``launch_rmsnorm`` takes rows of ``d`` values."""
    return d % 4 == 0 and NORM_WIDTHS[0] <= d <= NORM_WIDTHS[1]


def _mean_factor(rows: int, d: int, dtype: torch.dtype) -> float:
    """The float32 factor that takes the eager route's row sum of squares
    to its mean: bf16's ``sum / d`` multiplies by 1/d in float32, float32's
    ``torch.mean`` by rows / (rows · d) in float32."""
    f = np.float32
    return float(f(1) / f(d) if dtype == torch.bfloat16 else
                 f(rows) / f(rows * d))


def launch_rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float,
                   xs: Optional[torch.Tensor] = None,
                   D: Optional[torch.Tensor] = None,
                   z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """RMSNorm over the last dim d of x with ``scale`` (d,) cast to x's
    type, as ``models/layers.rmsnorm`` computes it, bitwise.  With ``xs``
    and ``z`` (x's shape and type) and ``D`` (h,) float32, h dividing d:
    the norm of u = (x + xs·D[head]) · SiLU(z), a head being d / h
    consecutive values, D rounded to x's type as the mixer rounds it (the
    mixer's output norm).  d must pass ``norm_width_ok``, and each tensor
    lie aligned to 4 values.  Returns the output in x's shape and type."""
    gated = xs is not None
    what = "mamba rmsnorm kernel"
    scale = scale.to(x.dtype)
    tensors = dict(x=x, scale=scale)
    if gated:
        tensors.update(xs=xs, z=z)
    refuse_grad("mamba_rmsnorm", *tensors.values(), D)
    _check(what, tensors, x.dtype)
    d = x.shape[-1] if x.ndim else 0
    if x.ndim < 1 or scale.shape != (d,) or (gated and (
            xs.shape != x.shape or z.shape != x.shape or D is None or
            D.ndim != 1 or D.dtype != torch.float32 or
            not D.is_contiguous() or D.shape[0] < 1 or d % D.shape[0])):
        raise ValueError(
            f"{what}: x {tuple(x.shape)}, scale {tuple(scale.shape)}"
            + (f", xs {tuple(xs.shape)}, z {tuple(z.shape)}, D "
               f"{None if D is None else (tuple(D.shape), D.dtype)}"
               if gated else ""))
    if not norm_width_ok(d):
        raise ValueError(f"{what}: a row of {d} values, not a multiple of 4 "
                         f"in [{NORM_WIDTHS[0]}, {NORM_WIDTHS[1]}]")
    heads = D.shape[0] if gated else 0
    name = "mamba_rmsnorm_gated" if gated else "mamba_rmsnorm"
    rows = x.numel() // d
    flops = cost.rmsnorm_cost(rows, d, x.element_size(), heads)[1]
    if x.is_meta:
        add_flops(name, flops)
        return torch.empty_like(x)
    if gated:
        tensors["D"] = D
    dev = _check_device(what, tensors)
    out = torch.empty_like(x)
    if rows == 0:
        return out
    # the kernel moves 4 values at a time (a fresh tensor lies aligned)
    odd = [n for n, t in tensors.items()
           if n != "D" and t.data_ptr() % (4 * t.element_size())]
    if odd:
        raise ValueError(f"{what}: {odd} not aligned to 4 values")
    rc = build.bind(SOURCE, "mamba_rmsnorm_launch", _NORM_ARGTYPES)(
        x.data_ptr(), scale.data_ptr(), xs.data_ptr() if gated else None,
        D.data_ptr() if gated else None, z.data_ptr() if gated else None,
        out.data_ptr(), rows, d, d // heads if gated else 1,
        _mean_factor(rows, d, x.dtype), eps, _DTYPE_CODES[x.dtype],
        raw_stream(dev.index))
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {rc}")
    COUNTS[name] += 1
    add_flops(name, flops)
    return out
