"""Loader and launches of the CUDA DDPM-step kernel (csrc/ddpm_step.cu).

One source serves both entry points of the JAX package's Pallas kernel,
each in two variants:

* ``launch`` (variant ``given``): the Pallas kernel's interface, noise
  given, K slabs each with its row of a (K, 3) fp32 coefficient table
  (inv_sqrt_alpha, coef, sigma); the scalar entry is K = 1;
* ``launch_keyed`` (``ddpm_step/keyed``): the per-request samplers' step,
  which draws ``normal(split(k)[1], x.shape)`` in the kernel and writes
  ``split(k)[0]`` to a second key buffer;
* ``launch_rowwise`` (``ddpm_step_batched/rowwise``): the batched engine's
  step, which draws row b of slab k from ``fold_in(fold_in(key_k, d), b)``
  and passes a slab whose ``active`` entry is not > 0 through unchanged.

The library is built with nvcc on first use (kernels/build.py).

``COUNTS`` holds one launch counter per entry point and one per entry and
variant (``<entry>/<variant>``); each is bumped only where that variant
launches the kernel, so a run can show that its path went through it.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import add_flops, build, raw_stream, refuse_grad
from repro_torch.kernels.ddpm_step import cost

SOURCE = "ddpm_step.cu"
VARIANTS = {"ddpm_step": ("given", "keyed"),
            "ddpm_step_batched": ("given", "rowwise")}
COUNTS: Dict[str, int] = {
    key: 0 for entry, variants in VARIANTS.items()
    for key in (entry, *(f"{entry}/{v}" for v in variants))}
_GIVEN = {entry: f"{entry}/given" for entry in VARIANTS}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_YZ = 65535
_P, _I = ctypes.c_void_p, ctypes.c_int64
_ARGTYPES = [_P] * 5 + [_I] * 3 + [_P]
_KEYED_ARGTYPES = [_P] * 6 + [_I] * 2 + [_P]
_ROWWISE_ARGTYPES = [_P] * 3 + [_I, _P, _I, _P, _I, _P] + [_I] * 4 + [_P]


def reset_counts() -> None:
    for name in COUNTS:
        COUNTS[name] = 0


def _count(entry: str, variant_key: str) -> None:
    COUNTS[entry] += 1
    COUNTS[variant_key] += 1


def _meta_step(x_t: torch.Tensor, entry: str, flops: int) -> torch.Tensor:
    """The meta route (the dry run): count the launch's operations and
    return an empty output of the card's shape and type."""
    add_flops(entry, flops)
    return torch.empty_like(x_t)


def _check_operands(x_t: torch.Tensor, eps_pred: torch.Tensor) -> None:
    """x_t and eps_pred: one shape and dtype, float32 or bfloat16, both
    contiguous."""
    if x_t.dtype not in _DTYPE_CODES:
        raise TypeError(f"ddpm_step kernel takes float32 or bfloat16, "
                        f"got {x_t.dtype}")
    if eps_pred.shape != x_t.shape or eps_pred.dtype != x_t.dtype:
        raise ValueError(
            f"ddpm_step kernel: eps_pred is {tuple(eps_pred.shape)} "
            f"{eps_pred.dtype}, x_t is {tuple(x_t.shape)} {x_t.dtype}")
    if not (x_t.is_contiguous() and eps_pred.is_contiguous()):
        raise ValueError("ddpm_step kernel: x_t and eps_pred must be "
                         "contiguous")


def _check_key(name: str, key: torch.Tensor, shape) -> None:
    if key.dtype != torch.int64 or tuple(key.shape) != shape or \
            not key.is_contiguous():
        raise ValueError(f"ddpm_step kernel: {name} is {tuple(key.shape)} "
                         f"{key.dtype}, expected contiguous {shape} int64 "
                         "words")


def _check_device(names, *tensors: torch.Tensor) -> int:
    """Every tensor on the CUDA device of the first (x_t), by index (no
    torch.device objects: this runs at every denoising step); returns
    the index.  Checked after the shapes, so that on the CPU each shape
    check is reachable."""
    index = tensors[0].get_device()          # -1 on the CPU
    for name, a in zip(names, tensors):
        if index < 0 or a.get_device() != index:
            raise ValueError(f"ddpm_step kernel: {name} on {a.device}, "
                             "expected the CUDA device of x_t "
                             f"({tensors[0].device})")
    return index


def launch(x_t: torch.Tensor, eps_pred: torch.Tensor, noise: torch.Tensor,
           coef: torch.Tensor, entry: str) -> torch.Tensor:
    """The given-noise variant on CUDA tensors: x_t/eps_pred/noise share
    one shape (K, ...) and dtype (float32 or bfloat16), ``coef`` is a
    contiguous (K, 3) float32 table on the same device.  Returns a new
    tensor of x_t's dtype.  Refuses inputs that need a gradient (no
    backward yet)."""
    refuse_grad("ddpm_step", x_t, eps_pred, noise, coef)
    if entry not in VARIANTS:
        raise ValueError(f"unknown entry {entry!r}")
    _check_operands(x_t, eps_pred)
    if noise.shape != x_t.shape or noise.dtype != x_t.dtype or \
            not noise.is_contiguous():
        raise ValueError(
            f"ddpm_step kernel: noise is {tuple(noise.shape)} {noise.dtype},"
            f" x_t is {tuple(x_t.shape)} {x_t.dtype}")
    K = coef.shape[0]
    if coef.dtype != torch.float32 or coef.shape != (K, 3) or \
            not coef.is_contiguous() or not 1 <= K <= _MAX_GRID_YZ or \
            x_t.numel() % K:
        raise ValueError(f"ddpm_step kernel: coef {tuple(coef.shape)} "
                         f"{coef.dtype} does not fit x_t {tuple(x_t.shape)}")
    per = x_t.numel() // K
    flops = cost.cost(K, per, x_t.element_size())[1]
    if x_t.is_meta:
        return _meta_step(x_t, entry, flops)
    dev = _check_device(("x_t", "eps_pred", "noise", "coef"), x_t, eps_pred,
                        noise, coef)
    out = torch.empty_like(x_t)
    if per == 0:
        return out
    rc = build.bind(SOURCE, "ddpm_step_launch", _ARGTYPES)(
        x_t.data_ptr(), eps_pred.data_ptr(), noise.data_ptr(),
        coef.data_ptr(), out.data_ptr(), K, per, _DTYPE_CODES[x_t.dtype],
        raw_stream(dev))
    if rc != 0:
        raise RuntimeError(f"ddpm_step kernel launch failed: cudaError {rc}")
    _count(entry, _GIVEN[entry])
    add_flops(entry, flops)
    return out


def launch_keyed(x_t: torch.Tensor, eps_pred: torch.Tensor,
                 key: torch.Tensor, coef: torch.Tensor,
                 key_out: torch.Tensor) -> torch.Tensor:
    """The per-request step on CUDA tensors: ``key`` is the (2,) int64
    chain key, ``coef`` a contiguous (3,) float32 coefficient row, and
    ``key_out`` a (2,) int64 buffer that receives ``split(key)[0]`` and
    must not overlap ``key``.  Returns x_{t-1} drawn with
    ``normal(split(key)[1], x_t.shape)``."""
    refuse_grad("ddpm_step", x_t, eps_pred, coef)
    _check_operands(x_t, eps_pred)
    _check_key("key", key, (2,))
    _check_key("key_out", key_out, (2,))
    flops = x_t.numel() * cost.DRAW_FLOAT_OPS
    if x_t.is_meta:
        return _meta_step(x_t, "ddpm_step", flops)
    if abs(key.data_ptr() - key_out.data_ptr()) < 16:
        raise ValueError("ddpm_step kernel: key_out overlaps key (the "
                         "sampler alternates two key buffers)")
    if coef.dtype != torch.float32 or tuple(coef.shape) != (3,) or \
            not coef.is_contiguous():
        raise ValueError(f"ddpm_step kernel: coef {tuple(coef.shape)} "
                         f"{coef.dtype} is not a contiguous (3,) float32 "
                         "row")
    dev = _check_device(("x_t", "eps_pred", "key", "coef", "key_out"), x_t,
                        eps_pred, key, coef, key_out)
    out = torch.empty_like(x_t)
    rc = build.bind(SOURCE, "ddpm_step_keyed_launch", _KEYED_ARGTYPES)(
        x_t.data_ptr(), eps_pred.data_ptr(), key.data_ptr(),
        coef.data_ptr(), key_out.data_ptr(), out.data_ptr(), x_t.numel(),
        _DTYPE_CODES[x_t.dtype], raw_stream(dev))
    if rc != 0:
        raise RuntimeError(f"ddpm_step kernel launch failed: cudaError {rc}")
    _count("ddpm_step", "ddpm_step/keyed")
    add_flops("ddpm_step", flops)
    return out


def launch_rowwise(x_t: torch.Tensor, eps_pred: torch.Tensor,
                   keys: torch.Tensor, datum: int, coef: torch.Tensor,
                   active: torch.Tensor) -> torch.Tensor:
    """The batched engine's step on CUDA tensors: x_t/eps_pred are (K, B,
    ...), ``keys`` the (K, 2) int64 slab keys, ``datum`` the fold-in
    datum, ``coef`` a (K, 3) float32 view whose rows may be strided (a
    step's column of a (K, S, 3) table) and ``active`` a (K,) float32
    view (any stride).  Returns where(active > 0, step, x_t)."""
    refuse_grad("ddpm_step", x_t, eps_pred, coef, active)
    _check_operands(x_t, eps_pred)
    if x_t.ndim < 2 or x_t.numel() == 0:
        raise ValueError(f"ddpm_step kernel: x_t {tuple(x_t.shape)} is not "
                         "a non-empty (K, B, ...) stack")
    K, B = x_t.shape[0], x_t.shape[1]
    if K > _MAX_GRID_YZ or B > _MAX_GRID_YZ:
        raise ValueError(f"ddpm_step kernel: (K, B) = ({K}, {B}) exceeds "
                         f"{_MAX_GRID_YZ}")
    _check_key("keys", keys, (K, 2))
    if coef.dtype != torch.float32 or tuple(coef.shape) != (K, 3) or \
            coef.stride(1) != 1:
        raise ValueError(f"ddpm_step kernel: coef {tuple(coef.shape)} "
                         f"{coef.dtype} stride {coef.stride()} is not a "
                         f"({K}, 3) float32 table with unit column stride")
    if active.dtype != torch.float32 or tuple(active.shape) != (K,):
        raise ValueError(f"ddpm_step kernel: active {tuple(active.shape)} "
                         f"{active.dtype} is not a ({K},) float32 mask")
    flops = x_t.numel() * cost.DRAW_FLOAT_OPS    # the mask is not read
    if x_t.is_meta:
        return _meta_step(x_t, "ddpm_step_batched", flops)
    dev = _check_device(("x_t", "eps_pred", "keys", "coef", "active"), x_t,
                        eps_pred, keys, coef, active)
    out = torch.empty_like(x_t)
    rc = build.bind(SOURCE, "ddpm_step_rowwise_launch", _ROWWISE_ARGTYPES)(
        x_t.data_ptr(), eps_pred.data_ptr(), keys.data_ptr(),
        int(datum) & 0xFFFFFFFF, coef.data_ptr(), coef.stride(0),
        active.data_ptr(), active.stride(0), out.data_ptr(), K, B,
        x_t.numel() // (K * B), _DTYPE_CODES[x_t.dtype], raw_stream(dev))
    if rc != 0:
        raise RuntimeError(f"ddpm_step kernel launch failed: cudaError {rc}")
    _count("ddpm_step_batched", "ddpm_step_batched/rowwise")
    add_flops("ddpm_step_batched", flops)
    return out
