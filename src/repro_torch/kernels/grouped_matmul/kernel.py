"""Loader and launch of the CUDA grouped-matmul kernels
(csrc/grouped_matmul.cu), built with nvcc on first use (kernels/build.py).

``choose_variant`` picks the kernel from dtype, shape, strides and
alignment alone: ``wgmma`` (bf16 through TMA and wgmma, warp-specialised
and persistent) wherever its loads can be described by tensor maps,
``wmma`` (the first bf16 design) for the other bf16 operands, ``simt``
(CUDA cores) for float32.  ``tma_maps`` computes the wgmma variant's
tensor maps.

``COUNTS["grouped_matmul"]`` and the variant's
``COUNTS["grouped_matmul/<variant>"]`` are bumped only where a kernel is
launched, so a run can show that its path went through the kernel, and
through which one.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import build, raw_stream, refuse_grad
from repro_torch.kernels.tma import BF16_BYTES, TmaMap, as_ctypes

SOURCE = "grouped_matmul.cu"
VARIANTS = ("wgmma", "wmma", "simt")
COUNTS: Dict[str, int] = {"grouped_matmul": 0,
                          **{f"grouped_matmul/{v}": 0 for v in VARIANTS}}
_VARIANT_CODES = {"simt": 0, "wmma": 1, "wgmma": 2}
# the wgmma variant's tile (csrc/grouped_matmul.cu, namespace wg): all of
# C = 256 token rows, 64 of depth a stage, weights in boxes of 64 columns
TILE_C, TILE_D, BOX_F = 256, 64, 64
SWIZZLE = 128           # bytes: TILE_D and BOX_F bf16 make one swizzle row
_MAX_GRID_YZ = 65535
_TILE_F = 64            # the smaller of the older variants' F-tiles
# tokens, weights, out, E, C, D, F, stride_e, stride_c, variant,
# tokens map, weights map, stream
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + \
    [ctypes.c_longlong] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 3


def reset_counts() -> None:
    for name in COUNTS:
        COUNTS[name] = 0


def token_strides(tokens: torch.Tensor) -> Tuple[int, int]:
    """(expert, row) element strides of tokens (E, C, D) as the kernels
    read them: 0 for a single expert, D for a single row."""
    E, C, D = tokens.shape
    return (tokens.stride(0) if E > 1 else 0,
            tokens.stride(1) if C > 1 else D)


def choose_variant(tokens: torch.Tensor, weights: torch.Tensor) -> str:
    """The kernel for tokens (E, C, D) and weights (E, D, F), from dtype,
    shape, strides and alignment alone.  wgmma takes bf16 when D, F and
    the token strides are multiples of 8 elements (TMA's 16-byte strides),
    token rows and experts do not overlap (or the expert stride is 0, the
    MoE's broadcast), and both pointers are 16-byte aligned."""
    if tokens.dtype != torch.bfloat16:
        return "simt"
    E, C, D = tokens.shape
    F = weights.shape[-1]
    se, sc = token_strides(tokens)
    if (D % 8 == 0 and F % 8 == 0 and se % 8 == 0 and sc % 8 == 0
            and sc >= D and (se == 0 or se >= C * sc)
            and tokens.data_ptr() % 16 == 0
            and weights.data_ptr() % 16 == 0):
        return "wgmma"
    return "wmma"


def tma_maps(E: int, C: int, D: int, F: int, se: int,
             sc: int) -> Tuple[TmaMap, TmaMap]:
    """(tokens map, weights map) of the wgmma variant.  Tokens: 3-D over
    (D, C, E) at their strides, or, with expert stride 0, 2-D over (D, C),
    read at the same coordinates for every expert; a box is TILE_C rows of
    TILE_D.  Weights: 3-D over (F, D, E), boxes of TILE_D rows of BOX_F."""
    if se == 0:
        tok = TmaMap((D, C), (sc * BF16_BYTES,), (TILE_D, TILE_C), SWIZZLE)
    else:
        tok = TmaMap((D, C, E), (sc * BF16_BYTES, se * BF16_BYTES),
                     (TILE_D, TILE_C, 1), SWIZZLE)
    w = TmaMap((F, D, E), (F * BF16_BYTES, D * F * BF16_BYTES),
               (BOX_F, TILE_D, 1), SWIZZLE)
    return tok, w


def launch(tokens: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Run a kernel on CUDA tensors tokens (E, C, D) — any expert and
    row strides (0 for tokens broadcast to every expert), unit inner
    stride — and contiguous weights (E, D, F) of the same dtype (float32
    or bfloat16).  Returns a new contiguous (E, C, F) tensor of that
    dtype.  Refuses inputs that need a gradient (no backward yet)."""
    refuse_grad("grouped_matmul", tokens, weights)
    if tokens.ndim != 3 or weights.ndim != 3:
        raise ValueError(f"grouped_matmul kernel: tokens "
                         f"{tuple(tokens.shape)} and weights "
                         f"{tuple(weights.shape)} need 3 dimensions")
    if tokens.dtype not in (torch.float32, torch.bfloat16) or \
            weights.dtype != tokens.dtype:
        raise TypeError(f"grouped_matmul kernel takes float32 or bfloat16 "
                        f"of one dtype, got {tokens.dtype} and "
                        f"{weights.dtype}")
    E, C, D = tokens.shape
    F = weights.shape[-1]
    if weights.shape != (E, D, F):
        raise ValueError(f"grouped_matmul kernel: tokens "
                         f"{tuple(tokens.shape)} do not fit weights "
                         f"{tuple(weights.shape)}")
    if not weights.is_contiguous():
        raise ValueError("grouped_matmul kernel: weights are not contiguous")
    if D > 1 and tokens.stride(2) != 1:
        raise ValueError("grouped_matmul kernel: tokens need a unit inner "
                         f"stride, got strides {tokens.stride()}")
    if E > _MAX_GRID_YZ or -(-F // _TILE_F) > _MAX_GRID_YZ:
        raise ValueError(f"grouped_matmul kernel: grid over "
                         f"{_MAX_GRID_YZ} for E {E}, F {F}")
    for name, a in (("tokens", tokens), ("weights", weights)):
        if a.device.type != "cuda" or a.device != tokens.device:
            raise ValueError(f"grouped_matmul kernel: {name} on {a.device}, "
                             "expected one CUDA device")
    out = torch.empty((E, C, F), dtype=tokens.dtype, device=tokens.device)
    if out.numel() == 0:
        return out
    se, sc = token_strides(tokens)
    variant = choose_variant(tokens, weights)
    maps = [None, None]
    if variant == "wgmma":
        maps = [as_ctypes(m) for m in tma_maps(E, C, D, F, se, sc)]
    rc = build.bind(SOURCE, "grouped_matmul_launch", _ARGTYPES)(
        tokens.data_ptr(), weights.data_ptr(), out.data_ptr(), E, C, D, F,
        se, sc, _VARIANT_CODES[variant], *maps,
        raw_stream(tokens.device.index))
    if rc != 0:
        raise RuntimeError(f"grouped_matmul kernel ({variant}) launch "
                           f"failed: cudaError {rc}")
    COUNTS["grouped_matmul"] += 1
    COUNTS[f"grouped_matmul/{variant}"] += 1
    return out
