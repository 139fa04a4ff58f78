"""Loader and launch of the CUDA SSD-scan kernels (csrc/ssd_scan.cu) and of
their backward (csrc/ssd_scan_bwd.cu), built with nvcc on first use
(kernels/build.py).

``choose_variant`` picks the kernel from dtype, shape and alignment alone:
``wgmma`` (bf16 through TMA and wgmma, two heads a block) at head dim 64
and states of 64 or 128, ``simt`` (float32 products on the CUDA cores,
the first design) otherwise.  ``tma_maps`` computes the wgmma variant's
tensor maps.

``launch_backward`` runs the backward's passes in the variant that
``choose_variant_backward`` picks the same way: ``wgmma`` (bf16 through
TMA and wgmma at the forward's head dim and states, chunks up to
``BWD_WGMMA_MAX_CHUNK``) or ``simt`` (float32 products on the CUDA cores,
the first design, in tiles of ``bwd_tile`` steps, which the CUDA side
picks from its own shared-memory layout).

``COUNTS["ssd_scan"]`` and the variant's ``COUNTS["ssd_scan/<variant>"]``
are bumped only where a kernel is launched, ``COUNTS["ssd_scan_bwd"]`` and
``COUNTS["ssd_scan_bwd/<variant>"]`` where the backward is, so a run can
show that its path went through the kernels, and through which ones.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import add_flops, build, raw_stream, refuse_grad
from repro_torch.kernels.ssd_scan import cost
from repro_torch.kernels.tma import BF16_BYTES, TmaMap, as_ctypes

SOURCE = "ssd_scan.cu"
BWD_SOURCE = "ssd_scan_bwd.cu"
VARIANTS = ("wgmma", "simt")
BWD_VARIANTS = ("wgmma", "simt")
COUNTS: Dict[str, int] = {"ssd_scan": 0,
                          **{f"ssd_scan/{v}": 0 for v in VARIANTS},
                          "ssd_scan_bwd": 0,
                          **{f"ssd_scan_bwd/{v}": 0 for v in BWD_VARIANTS}}
MAX_TILE = 64               # steps per tile inside the kernels
SMEM_BYTES = 232448         # shared memory one block can hold (227 KB)
# the wgmma variant (csrc/ssd_scan.cu, namespace wg): 64-step tiles of a
# 64-wide head, two heads a block, TMA boxes of 64 x 64 bf16 (128 bytes a
# row, the swizzle width)
WGMMA_HEAD_DIM = 64
WGMMA_STATES = (64, 128)
HEADS_PER_BLOCK = 2
TILE = 64
SWIZZLE = 128
_MAX_GRID_Y = 65535
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_WGMMA_CODE = 2
# x, dt, A, B, C, y, fs, batch, S, H, P, N, tq, variant, x/y map, B/C map,
# final-state map, stream
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + \
    [ctypes.c_void_p] * 4
# x, dt, A, B, C, dy, dfs, dx, ddt, dA, dB, dC, six scratch buffers, b, S,
# h, p, n, chunk, variant, x/dy map, B/C map, stream
_BWD_ARGTYPES = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 7 + \
    [ctypes.c_void_p] * 3
BWD_MAX_DIM = 128           # head dim and state of the backward
# the backward's wgmma variant (csrc/ssd_scan_bwd.cu, namespace wg) keeps
# L, dt and four per-step sums of a chunk in shared memory
BWD_WGMMA_MAX_CHUNK = 1024


def reset_counts() -> None:
    for name in COUNTS:
        COUNTS[name] = 0


def smem_bytes(tq: int, p: int, n: int) -> int:
    """The simt kernel's shared memory for tiles of tq steps (csrc
    smem_floats)."""
    return 4 * (4 * tq + tq * (p + 1) + 2 * tq * (n + 1) + tq * (tq + 1) +
                p * (n + 1))


def wgmma_smem_bytes(n: int) -> int:
    """The wgmma kernel's shared memory at state n (csrc ``wg::Geo``):
    1024 bytes of alignment slack, two ring stages of B, C and each head's
    x, each head's bf16 state and y tile, its L and dt (64 floats each),
    two mbarriers.  The float32 final states are staged in the ring."""
    box = TILE * SWIZZLE
    bc = n // 64 * box
    stage = 2 * bc + HEADS_PER_BLOCK * box
    return 1024 + 2 * stage + HEADS_PER_BLOCK * (bc + box) + \
        HEADS_PER_BLOCK * 2 * TILE * 4 + 2 * 8


def bwd_wgmma_smem_bytes(n: int, chunk: int) -> Tuple[int, int]:
    """Shared memory of the wgmma backward's two blocks at state n and
    chunk q (csrc ``wg::Geo`` smem1, smem3): 1024 bytes of alignment slack
    each; pass 1 two ring stages of x, dy, B and C, L and dt; pass 3 the s
    tile (x, B), two stages of (C, dy), G and h as bf16 hi and lo parts,
    (W o DD)^T as hi and lo, L, dt, two halves of dL, x.d(dtx) and Q (q
    floats each), four warps' 64 column sums and 8 floats; three
    mbarriers each."""
    box = TILE * SWIZZLE
    bc = n // 64 * box
    states = 1024 + 2 * (2 * box + 2 * bc) + 2 * chunk * 4 + 3 * 8
    fixed = (box + bc) + 2 * (bc + box) + 4 * bc + 2 * box
    chunk_ = 1024 + fixed + (6 * chunk + 4 * 64 + 8) * 4 + 3 * 8
    return states, chunk_


def choose_variant_backward(x: torch.Tensor, B: torch.Tensor,
                            C: torch.Tensor, dy: torch.Tensor,
                            chunk: int) -> str:
    """The backward kernel for contiguous x / dy (b, s, h, p) and B/C (b,
    s, n), from dtype, shape and alignment alone: wgmma where the forward
    takes it (bf16, p = 64, n in WGMMA_STATES, 16-byte aligned x, B and
    C), dy's pointer aligned too (TMA loads it with x's map) and the chunk
    at most BWD_WGMMA_MAX_CHUNK."""
    if (choose_variant(x, B, C) == "wgmma" and dy.data_ptr() % 16 == 0
            and chunk <= BWD_WGMMA_MAX_CHUNK):
        return "wgmma"
    return "simt"


def bwd_tile(q: int, p: int, n: int) -> int:
    """The backward's tile on the current CUDA device at chunk q, head dim
    p and state n (csrc/ssd_scan_bwd.cu ``pick_tile``: the largest of 64,
    32, 16 and 8 steps, at most max(q, 8), whose shared memory fits a
    block); 0 when none fits.  Builds the kernel's library."""
    return build.bind(BWD_SOURCE, "ssd_scan_bwd_tile", [ctypes.c_int] * 3)(
        q, p, n)


def _check_inputs(what: str, x: torch.Tensor, dt: torch.Tensor,
                  A: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                  chunk: int, **more: torch.Tensor) -> None:
    """Shape, type and contiguity of x (b, s, h, p), dt (b, s, h), A (h,)
    and B/C (b, s, n), and the contiguity of ``more``; the device is
    checked by the caller, last."""
    for name, a in (("x", x), ("dt", dt), ("A", A), ("B", B), ("C", C),
                    *more.items()):
        if not a.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{what} takes float32 or bfloat16, got {x.dtype}")
    if x.ndim != 4 or B.ndim != 3:
        raise ValueError(f"{what}: x {tuple(x.shape)}, B {tuple(B.shape)}")
    b, s, h, p = x.shape
    n = B.shape[-1]
    if dt.shape != (b, s, h) or A.shape != (h,) or B.shape != (b, s, n) or \
            C.shape != B.shape or dt.dtype != torch.float32 or \
            A.dtype != torch.float32 or B.dtype != x.dtype or \
            C.dtype != x.dtype:
        raise ValueError(
            f"{what}: x {tuple(x.shape)} {x.dtype}, dt {tuple(dt.shape)} "
            f"{dt.dtype}, A {tuple(A.shape)} {A.dtype}, B {tuple(B.shape)} "
            f"{B.dtype}, C {tuple(C.shape)} {C.dtype}")
    if chunk < 1:
        raise ValueError(f"{what}: chunk {chunk} < 1")


def _check_device(what: str, tensors: Dict[str, torch.Tensor]
                  ) -> torch.device:
    """The CUDA device of ``tensors["x"]``, which every tensor must share;
    checked after the shapes and types, so those checks run on the CPU."""
    dev = tensors["x"].device
    for name, a in tensors.items():
        if a.device != dev or dev.type != "cuda":
            raise ValueError(f"{what}: {name} on {a.device}, expected the "
                             f"CUDA device of x ({dev})")
    return dev


def choose_variant(x: torch.Tensor, B: torch.Tensor, C: torch.Tensor) -> str:
    """The kernel for contiguous x (b, s, h, p) and B/C (b, s, n), from
    dtype, shape and alignment alone: wgmma for bf16 at p = 64 and n in
    WGMMA_STATES with 16-byte aligned pointers.  The chunk does not enter:
    the wgmma variant walks 64-step tiles whatever the chunk."""
    if (x.dtype == torch.bfloat16 and x.shape[-1] == WGMMA_HEAD_DIM
            and B.shape[-1] in WGMMA_STATES and x.data_ptr() % 16 == 0
            and B.data_ptr() % 16 == 0 and C.data_ptr() % 16 == 0):
        return "wgmma"
    return "simt"


@functools.lru_cache(maxsize=64)
def tma_maps(b: int, s: int, h: int, n: int
             ) -> Tuple[TmaMap, TmaMap, TmaMap]:
    """(x map, B/C map, final-state map) of the wgmma variant, boxes of 64
    bf16 values (128 bytes, the swizzle width) x 64 rows.  x, and y with
    the same geometry: 3-D over (h·64, s, b), a head's tile the box at
    column h·64; B and C over (n, s, b), a state of 128 two boxes; the
    float32 final state (b, h, p, n) as bf16 pairs over (2n, p, b·h), a
    head's state n/32 boxes of 32 floats."""
    p = WGMMA_HEAD_DIM
    box = (SWIZZLE // BF16_BYTES, TILE, 1)
    return (TmaMap((h * p, s, b), (h * p * BF16_BYTES, s * h * p * BF16_BYTES),
                   box, SWIZZLE),
            TmaMap((n, s, b), (n * BF16_BYTES, s * n * BF16_BYTES), box,
                   SWIZZLE),
            TmaMap((2 * n, p, b * h), (n * 4, p * n * 4), box, SWIZZLE))


def launch(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
           B: torch.Tensor, C: torch.Tensor, chunk: int,
           variant: Optional[str] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run a kernel on contiguous CUDA tensors: x (b, s, h, p) float32 or
    bfloat16, dt (b, s, h) and A (h,) float32, B/C (b, s, n) of x's dtype.
    ``variant`` defaults to ``choose_variant``'s; ``simt`` may be asked
    for at any input (to time the first design beside the second), wgmma
    only where it is the choice.  The simt kernel walks chunks of
    ``chunk`` steps in tiles of at most 64, the wgmma kernel 64-step tiles.
    Returns (y (b, s, h, p) of x's dtype, final state (b, h, p, n)
    float32).  Refuses inputs that need a gradient: the raw launch has no
    backward (the autograd route is ops.ssd_scan)."""
    what = "ssd_scan kernel"
    refuse_grad("ssd_scan", x, dt, A, B, C)
    _check_inputs(what, x, dt, A, B, C, chunk)
    b, s, h, p = x.shape
    n = B.shape[-1]
    chosen = choose_variant(x, B, C)
    variant = chosen if variant is None else variant
    if variant not in (chosen, "simt"):
        raise ValueError(f"{what}: variant {variant!r} does not "
                         f"take these inputs (choice: {chosen!r})")
    tq = min(chunk, MAX_TILE)
    if variant == "simt" and smem_bytes(tq, p, n) > SMEM_BYTES:
        raise ValueError(f"{what}: head dim {p} and state {n} need "
                         f"{smem_bytes(tq, p, n)} bytes of shared memory, "
                         f"over {SMEM_BYTES}")
    if b > _MAX_GRID_Y or (variant == "simt" and h > _MAX_GRID_Y):
        raise ValueError(f"{what}: grid (., {b}) or {h} heads "
                         f"over {_MAX_GRID_Y}")
    flops = cost.cost(x.shape, n, chunk, x.element_size())[1]
    if x.is_meta:               # the dry run: shapes alone, nothing computed
        add_flops("ssd_scan", flops)
        return torch.empty_like(x), torch.empty((b, h, p, n),
                                                dtype=torch.float32,
                                                device="meta")
    dev = _check_device(what, {"x": x, "dt": dt, "A": A, "B": B, "C": C})
    y = torch.empty_like(x)
    fs = torch.empty((b, h, p, n), dtype=torch.float32, device=dev)
    if y.numel() == 0:
        return y, fs.zero_()
    if variant == "wgmma":
        code = _WGMMA_CODE
        maps = [as_ctypes(m) for m in tma_maps(b, s, h, n)]
    else:
        code, maps = _DTYPE_CODES[x.dtype], (None, None, None)
    rc = build.bind(SOURCE, "ssd_scan_launch", _ARGTYPES)(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), y.data_ptr(), fs.data_ptr(), b, s, h, p, n, tq, code,
        *maps, raw_stream(dev.index))
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel ({variant}) launch failed: "
                           f"cudaError {rc}")
    COUNTS["ssd_scan"] += 1
    COUNTS[f"ssd_scan/{variant}"] += 1
    add_flops("ssd_scan", flops)
    return y, fs


def launch_backward(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    B: torch.Tensor, C: torch.Tensor, chunk: int,
                    dy: torch.Tensor, dfinal: Optional[torch.Tensor] = None,
                    variant: Optional[str] = None
                    ) -> Tuple[torch.Tensor, ...]:
    """The backward kernel (csrc/ssd_scan_bwd.cu) of ``launch(x, dt, A,
    B, C, chunk)`` on contiguous CUDA tensors of ``launch``'s types, for
    ``dy`` (x's shape and dtype) and ``dfinal`` (None: zero, or a (b, h,
    p, n) float32 gradient of the final state).  ``variant`` defaults to
    ``choose_variant_backward``'s; ``simt`` may be asked for at any input
    (to time and check the first design beside the second), wgmma only
    where it is the choice.  Returns (dx, ddt, dA, dB, dC): dx, dB and dC
    in x's dtype, ddt and dA float32.  p and n at most BWD_MAX_DIM.
    Shapes, types, contiguity and the variant are checked first, the
    device last."""
    what = "ssd_scan backward kernel"
    more = {"dy": dy} if dfinal is None else {"dy": dy, "dfinal": dfinal}
    _check_inputs(what, x, dt, A, B, C, chunk, **more)
    b, s, h, p = x.shape
    n = B.shape[-1]
    if dy.shape != x.shape or dy.dtype != x.dtype or (
            dfinal is not None and (dfinal.shape != (b, h, p, n) or
                                    dfinal.dtype != torch.float32)):
        raise ValueError(
            f"{what}: x {tuple(x.shape)} {x.dtype}, dy {tuple(dy.shape)} "
            f"{dy.dtype}, dfinal "
            f"{None if dfinal is None else tuple(dfinal.shape)} "
            f"{None if dfinal is None else dfinal.dtype}")
    if not (1 <= p <= BWD_MAX_DIM and 1 <= n <= BWD_MAX_DIM):
        raise ValueError(f"{what}: head dim {p} or state {n} not in [1, "
                         f"{BWD_MAX_DIM}]")
    if b > _MAX_GRID_Y or h > _MAX_GRID_Y:
        raise ValueError(f"{what}: grid (., {h}, {b}) over {_MAX_GRID_Y}")
    chosen = choose_variant_backward(x, B, C, dy, chunk)
    variant = chosen if variant is None else variant
    if variant not in (chosen, "simt"):
        raise ValueError(f"{what}: variant {variant!r} does not take these "
                         f"inputs (choice: {chosen!r})")
    flops = cost.cost_backward(x.shape, n, chunk, x.element_size())[1]
    if x.is_meta:
        add_flops("ssd_scan_bwd", flops)
        return tuple(torch.empty_like(t) for t in (x, dt, A, B, C))
    dev = _check_device(what, {"x": x, "dt": dt, "A": A, "B": B, "C": C,
                               **more})
    dx, dB, dC = (torch.empty_like(t) for t in (x, B, C))
    ddt = torch.empty_like(dt)
    dA = torch.empty_like(A)
    if x.numel() == 0 or B.numel() == 0:
        return dx.zero_(), ddt.zero_(), dA.zero_(), dB.zero_(), dC.zero_()
    nc = -(-s // chunk)
    f32 = dict(dtype=torch.float32, device=dev)
    st_s = torch.empty((b, nc, h, p, n), **f32)
    st_u = torch.empty_like(st_s)
    lend, dap = (torch.empty((b, nc, h), **f32) for _ in range(2))
    dbp, dcp = (torch.empty((b, s, h, n), **f32) for _ in range(2))
    if variant == "wgmma":
        code = _WGMMA_CODE
        maps = [as_ctypes(m) for m in tma_maps(b, s, h, n)[:2]]
    else:
        code, maps = _DTYPE_CODES[x.dtype], (None, None)
    rc = build.bind(BWD_SOURCE, "ssd_scan_bwd_launch", _BWD_ARGTYPES)(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), dy.data_ptr(),
        None if dfinal is None else dfinal.data_ptr(), dx.data_ptr(),
        ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(), dC.data_ptr(),
        st_s.data_ptr(), st_u.data_ptr(), lend.data_ptr(), dbp.data_ptr(),
        dcp.data_ptr(), dap.data_ptr(), b, s, h, p, n, chunk, code, *maps,
        raw_stream(dev.index))
    if rc != 0:
        tile = "" if variant == "wgmma" else \
            f": tile {bwd_tile(chunk, p, n)}, 0 where none fits"
        raise RuntimeError(f"{what} ({variant}) launch failed: cudaError "
                           f"{rc} (chunk {chunk}, head dim {p}, state {n}"
                           f"{tile})")
    COUNTS["ssd_scan_bwd"] += 1
    COUNTS[f"ssd_scan_bwd/{variant}"] += 1
    add_flops("ssd_scan_bwd", flops)
    return dx, ddt, dA, dB, dC
