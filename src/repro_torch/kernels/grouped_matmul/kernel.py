"""Loader and launch of the CUDA grouped-matmul kernels
(csrc/grouped_matmul.cu) and of their backward
(csrc/grouped_matmul_bwd.cu), built with nvcc on first use
(kernels/build.py).

``choose_variant`` picks the kernel from dtype, shape, strides and
alignment alone: ``wgmma`` (bf16 through TMA and wgmma, warp-specialised
and persistent) wherever its loads can be described by tensor maps,
``wmma`` (the first bf16 design) for the other bf16 operands, ``simt``
(CUDA cores) for float32.  ``tma_maps`` computes the wgmma variant's
tensor maps.

``launch_backward`` runs the backward's two products (dX = dY·Wᵀ and
dW = Xᵀ·dY) in the variant that ``choose_variant_backward`` picks the
same way: ``wgmma`` (bf16 through TMA and wgmma, warp-specialised and
persistent) wherever tensor maps describe every load (and the pointers
of the outputs it stores are 16-byte aligned), ``wmma`` for the other
bf16 operands, ``simt`` for float32; ``bwd_tma_maps`` computes the
wgmma variant's three tensor maps.

``COUNTS["grouped_matmul"]`` and the variant's
``COUNTS["grouped_matmul/<variant>"]`` are bumped only where a kernel is
launched, ``COUNTS["grouped_matmul_bwd"]`` and
``COUNTS["grouped_matmul_bwd/<variant>"]`` where the backward is, so a
run can show that its path went through the kernels, and through which
ones.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import add_flops, build, raw_stream, refuse_grad
from repro_torch.kernels.grouped_matmul import cost
from repro_torch.kernels.tma import BF16_BYTES, TmaMap, as_ctypes

SOURCE = "grouped_matmul.cu"
BWD_SOURCE = "grouped_matmul_bwd.cu"
VARIANTS = ("wgmma", "wmma", "simt")
BWD_VARIANTS = ("wgmma", "wmma", "simt")
COUNTS: Dict[str, int] = {"grouped_matmul": 0,
                          **{f"grouped_matmul/{v}": 0 for v in VARIANTS},
                          "grouped_matmul_bwd": 0,
                          **{f"grouped_matmul_bwd/{v}": 0
                             for v in BWD_VARIANTS}}
_VARIANT_CODES = {"simt": 0, "wmma": 1, "wgmma": 2}
_BWD_CODES = {"simt": 0, "wmma": 1, "wgmma": 2}
# the wgmma variant's tile (csrc/grouped_matmul.cu, namespace wg): all of
# C = 256 token rows, 64 of depth a stage, weights in boxes of 64 columns
TILE_C, TILE_D, BOX_F = 256, 64, 64
SWIZZLE = 128           # bytes: TILE_D and BOX_F bf16 make one swizzle row
# the backward's wgmma variant (csrc/grouped_matmul_bwd.cu, namespace wg)
# loads every operand in boxes of BWD_BOX x BWD_BOX values
BWD_BOX = 64
_MAX_GRID_YZ = 65535
_TILE_F = 64            # the smaller of the older variants' F-tiles
# tokens, weights, out, E, C, D, F, stride_e, stride_c, variant,
# tokens map, weights map, stream
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + \
    [ctypes.c_longlong] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 3
# tokens, weights, dout, dtokens, dweights, E, C, D, F, stride_e,
# stride_c, variant, tokens map, weights map, dout map, stream
_BWD_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + \
    [ctypes.c_longlong] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 4


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


def _check_operands(what: str, tokens: torch.Tensor,
                    weights: torch.Tensor) -> Tuple[int, int, int, int]:
    """(E, C, D, F) of tokens (E, C, D) with a unit inner stride and
    contiguous weights (E, D, F) of one dtype, float32 or bfloat16;
    raises otherwise."""
    if tokens.ndim != 3 or weights.ndim != 3:
        raise ValueError(f"{what}: tokens {tuple(tokens.shape)} and weights "
                         f"{tuple(weights.shape)} need 3 dimensions")
    if tokens.dtype not in (torch.float32, torch.bfloat16) or \
            weights.dtype != tokens.dtype:
        raise TypeError(f"{what} takes float32 or bfloat16 of one dtype, "
                        f"got {tokens.dtype} and {weights.dtype}")
    E, C, D = tokens.shape
    F = weights.shape[-1]
    if weights.shape != (E, D, F):
        raise ValueError(f"{what}: tokens {tuple(tokens.shape)} do not fit "
                         f"weights {tuple(weights.shape)}")
    if not weights.is_contiguous():
        raise ValueError(f"{what}: weights are not contiguous")
    if D > 1 and tokens.stride(2) != 1:
        raise ValueError(f"{what}: tokens need a unit inner stride, got "
                         f"strides {tokens.stride()}")
    return E, C, D, F


def _check_device(what: str, tensors: Dict[str, torch.Tensor]) -> None:
    dev = next(iter(tensors.values())).device
    for name, a in tensors.items():
        if a.device.type != "cuda" or a.device != dev:
            raise ValueError(f"{what}: {name} on {a.device}, expected one "
                             "CUDA device")


def launch(tokens: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Run a kernel on CUDA tensors tokens (E, C, D) — any expert and
    row strides (0 for tokens broadcast to every expert), unit inner
    stride — and contiguous weights (E, D, F) of the same dtype (float32
    or bfloat16).  Returns a new contiguous (E, C, F) tensor of that
    dtype.  Refuses inputs that need a gradient: ``ops.GroupedMatmulFn``
    is the autograd route, with ``launch_backward`` in its backward."""
    refuse_grad("grouped_matmul", tokens, weights)
    E, C, D, F = _check_operands("grouped_matmul kernel", tokens, weights)
    if E > _MAX_GRID_YZ or -(-F // _TILE_F) > _MAX_GRID_YZ:
        raise ValueError(f"grouped_matmul kernel: grid over "
                         f"{_MAX_GRID_YZ} for E {E}, F {F}")
    flops = cost.cost(E, C, D, F, tokens.element_size(),
                      token_strides(tokens)[0] == 0)[1]
    if tokens.is_meta:          # the dry run: shapes alone, nothing computed
        add_flops("grouped_matmul", flops)
        return torch.empty((E, C, F), dtype=tokens.dtype, device="meta")
    _check_device("grouped_matmul kernel", dict(tokens=tokens,
                                                weights=weights))
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
    add_flops("grouped_matmul", flops)
    return out


def choose_variant_backward(tokens: torch.Tensor, weights: torch.Tensor,
                            dout: torch.Tensor, *outputs: torch.Tensor
                            ) -> str:
    """The backward kernel for these operands, from dtype, shape, strides
    and alignment alone: ``wgmma`` for bfloat16 where tensor maps can
    describe every load (``choose_variant``'s rule for the tokens and
    weights, ``dout`` 16-byte aligned) and the ``outputs`` given, dtokens
    and dweights, are 16-byte aligned for its 16-byte stores; ``wmma``
    for other bfloat16 operands; ``simt`` for float32."""
    if tokens.dtype != torch.bfloat16:
        return "simt"
    if choose_variant(tokens, weights) == "wgmma" and \
            all(t.data_ptr() % 16 == 0 for t in (dout, *outputs)):
        return "wgmma"
    return "wmma"


def bwd_tma_maps(E: int, C: int, D: int, F: int, se: int,
                 sc: int) -> Tuple[TmaMap, TmaMap, TmaMap]:
    """(tokens, weights, dout) maps of the backward's wgmma variant,
    every box BWD_BOX x BWD_BOX values.  Tokens, read along D as dW's
    MN-major A: 3-D over (D, C, E) at their strides, or, with expert
    stride 0, 2-D over (D, C), read at the same coordinates for every
    expert.  Weights (dX's K-major B): 3-D over (F, D, E).  dout (dX's
    K-major A, dW's MN-major B): 3-D over (F, C, E)."""
    b = BWD_BOX
    if se == 0:
        tok = TmaMap((D, C), (sc * BF16_BYTES,), (b, b), SWIZZLE)
    else:
        tok = TmaMap((D, C, E), (sc * BF16_BYTES, se * BF16_BYTES),
                     (b, b, 1), SWIZZLE)
    per_expert = lambda inner, outer: TmaMap(
        (inner, outer, E), (inner * BF16_BYTES, outer * inner * BF16_BYTES),
        (b, b, 1), SWIZZLE)
    return tok, per_expert(F, D), per_expert(F, C)


def launch_backward(tokens: torch.Tensor, weights: torch.Tensor,
                    dout: torch.Tensor, variant: Optional[str] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward kernels (csrc/grouped_matmul_bwd.cu) of ``launch``
    for the gradient ``dout`` (E, C, F) of its output: tokens and weights
    as for ``launch``, ``dout`` contiguous in their dtype.  Returns
    (dtokens, dweights): dY·Wᵀ as a new contiguous (E, C, D) tensor (one
    slab per expert, also for tokens broadcast with expert stride 0) and
    Xᵀ·dY as a new contiguous (E, D, F) tensor, in the inputs' dtype.
    ``variant`` defaults to ``choose_variant_backward``'s; ``wmma`` may be
    asked for at any bfloat16 input and ``simt`` at any float32 one (so
    the older designs can be timed beside the chosen one), and any other
    value is refused.  Shapes, types, strides and the variant are checked
    first, the device last."""
    what = "grouped_matmul backward kernel"
    E, C, D, F = _check_operands(what, tokens, weights)
    if dout.shape != (E, C, F) or dout.dtype != tokens.dtype or \
            not dout.is_contiguous():
        raise ValueError(f"{what}: dout is {tuple(dout.shape)} "
                         f"{dout.dtype}, expected a contiguous {(E, C, F)} "
                         f"{tokens.dtype}")
    if E > _MAX_GRID_YZ or -(-max(D, F) // _TILE_F) > _MAX_GRID_YZ:
        raise ValueError(f"{what}: grid over {_MAX_GRID_YZ} for E {E}, D "
                         f"{D}, F {F}")
    if variant is not None and variant != (
            "wmma" if tokens.dtype == torch.bfloat16 else "simt"):
        raise ValueError(f"{what}: variant {variant!r} does not take "
                         f"{tokens.dtype} (None, or wmma for bfloat16, simt "
                         "for float32)")
    flops = cost.cost_backward(E, C, D, F, tokens.element_size(),
                               token_strides(tokens)[0] == 0)[1]
    if tokens.is_meta:
        add_flops("grouped_matmul_bwd", flops)
        return (torch.empty((E, C, D), dtype=tokens.dtype, device="meta"),
                torch.empty((E, D, F), dtype=tokens.dtype, device="meta"))
    _check_device(what, dict(tokens=tokens, weights=weights, dout=dout))
    dtok = torch.empty((E, C, D), dtype=tokens.dtype, device=tokens.device)
    dw = torch.empty((E, D, F), dtype=tokens.dtype, device=tokens.device)
    if dtok.numel() == 0 or dw.numel() == 0 or C == 0 or F == 0:
        return dtok.zero_(), dw.zero_()
    if variant is None:
        variant = choose_variant_backward(tokens, weights, dout, dtok, dw)
    se, sc = token_strides(tokens)
    maps = [None] * 3
    if variant == "wgmma":
        maps = [as_ctypes(m) for m in bwd_tma_maps(E, C, D, F, se, sc)]
    rc = build.bind(BWD_SOURCE, "grouped_matmul_bwd_launch", _BWD_ARGTYPES)(
        tokens.data_ptr(), weights.data_ptr(), dout.data_ptr(),
        dtok.data_ptr(), dw.data_ptr(), E, C, D, F, se, sc,
        _BWD_CODES[variant], *maps, raw_stream(tokens.device.index))
    if rc != 0:
        raise RuntimeError(f"grouped_matmul backward kernel ({variant}) "
                           f"launch failed: cudaError {rc}")
    COUNTS["grouped_matmul_bwd"] += 1
    COUNTS[f"grouped_matmul_bwd/{variant}"] += 1
    add_flops("grouped_matmul_bwd", flops)
    return dtok, dw
