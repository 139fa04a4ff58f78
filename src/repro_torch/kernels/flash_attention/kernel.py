"""Loader and launch of the CUDA flash-attention kernels
(csrc/flash_attention.cu) and of their backward
(csrc/flash_attention_bwd.cu), built with nvcc on first use
(kernels/build.py).

``choose_variant`` picks the kernel from dtype, shape and alignment
alone: ``wgmma`` (bf16 through TMA and wgmma) at head dims 16, 32, 64 and
128, ``simt`` (float32 products on the CUDA cores, the first design)
otherwise.  ``tma_maps`` computes the wgmma variant's tensor maps.

``launch`` optionally writes each row's log-sum-exp for the backward;
``launch_backward`` runs the backward's three passes in the variant that
``choose_variant_backward`` picks the same way: ``wgmma`` (bf16 through
TMA and wgmma, the forward's head dims and tensor maps) or ``simt``
(float32 products on the CUDA cores, the first design).

``COUNTS["flash_attention"]`` and the variant's
``COUNTS["flash_attention/<variant>"]`` are bumped only where a kernel is
launched, ``COUNTS["flash_attention_bwd"]`` and
``COUNTS["flash_attention_bwd/<variant>"]`` where the backward is, so a
run can show that its path went through the kernels, and through which
ones.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import add_flops, build, raw_stream, refuse_grad
from repro_torch.kernels.flash_attention import cost
from repro_torch.kernels.tma import BF16_BYTES, TmaMap, as_ctypes

SOURCE = "flash_attention.cu"
BWD_SOURCE = "flash_attention_bwd.cu"
VARIANTS = ("wgmma", "simt")
BWD_VARIANTS = ("wgmma", "simt")
COUNTS: Dict[str, int] = {"flash_attention": 0,
                          **{f"flash_attention/{v}": 0 for v in VARIANTS},
                          "flash_attention_bwd": 0,
                          **{f"flash_attention_bwd/{v}": 0
                             for v in BWD_VARIANTS}}
MAX_HEAD_DIM = 128          # the simt kernel's register accumulator
WGMMA_HEAD_DIMS = (16, 32, 64, 128)
TILE = 64                   # query rows a block, keys a K/V tile
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_WGMMA_CODE = 2
# q, k, v, out, lse, B, H, Hkv, S, dh, causal, window, scale, variant,
# q map, k/v map, stream
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + \
    [ctypes.c_float, ctypes.c_int] + [ctypes.c_void_p] * 3
# q, k, v, out, dout, lse, delta, dq, dk, dv, B, H, Hkv, S, dh, causal,
# window, scale, variant, q map, k/v map, stream
_BWD_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + \
    [ctypes.c_float, ctypes.c_int] + [ctypes.c_void_p] * 3


def reset_counts() -> None:
    for name in COUNTS:
        COUNTS[name] = 0


def choose_variant(q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> str:
    """The kernel for contiguous q (B, H, S, dh) and k/v (B, Hkv, S, dh),
    from dtype, head dim and alignment alone: wgmma for bf16 at a head dim
    in WGMMA_HEAD_DIMS with 16-byte aligned pointers."""
    if (q.dtype == torch.bfloat16 and q.shape[-1] in WGMMA_HEAD_DIMS
            and q.data_ptr() % 16 == 0 and k.data_ptr() % 16 == 0
            and v.data_ptr() % 16 == 0):
        return "wgmma"
    return "simt"


def choose_variant_backward(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, dout: torch.Tensor) -> str:
    """The backward kernel for contiguous q / dout (B, H, S, dh) and k/v
    (B, Hkv, S, dh), from dtype, head dim and alignment alone: wgmma
    where the forward takes it (bf16, a head dim in WGMMA_HEAD_DIMS) and
    dout's pointer is 16-byte aligned too (TMA loads it with q's map)."""
    if choose_variant(q, k, v) == "wgmma" and dout.data_ptr() % 16 == 0:
        return "wgmma"
    return "simt"


def bwd_smem_bytes(dh: int) -> int:
    """Shared memory of each wgmma backward block (csrc
    flash_attention_bwd.cu ``wg::Geo``): 1024 bytes of alignment slack,
    the two tiles the block holds, a ring of two stages of two tiles (64
    rows of dh bf16 each), three mbarriers."""
    return 1024 + 6 * TILE * dh * BF16_BYTES + 3 * 8


@functools.lru_cache(maxsize=64)
def tma_maps(B: int, H: int, Hkv: int, S: int,
             dh: int) -> Tuple[TmaMap, TmaMap]:
    """(q map, k/v map) of the wgmma variant: 3-D over (dh, S, B*H) and
    (dh, S, B*Hkv), boxes of TILE rows and min(dh, 64) columns, swizzled
    that many bytes times two (a head dim of 128 takes two boxes)."""
    w = min(dh, 64)
    strides = (dh * BF16_BYTES, S * dh * BF16_BYTES)
    box = (w, TILE, 1)
    return (TmaMap((dh, S, B * H), strides, box, w * BF16_BYTES),
            TmaMap((dh, S, B * Hkv), strides, box, w * BF16_BYTES))


def _check_qkv(what: str, q: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor, window: int) -> None:
    """Shape, type and contiguity of q (B, H, S, dh) and k/v (B, Hkv, S,
    dh); the device is checked by the caller, last."""
    for name, a in (("q", q), ("k", k), ("v", v)):
        if not a.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
        if a.dtype != q.dtype or a.ndim != 4:
            raise ValueError(f"{what}: {name} is {tuple(a.shape)} "
                             f"{a.dtype}, q is {tuple(q.shape)} {q.dtype}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{what} takes float32 or bfloat16, got {q.dtype}")
    B, H, S, dh = q.shape
    Hkv = k.shape[1]
    if k.shape != (B, Hkv, S, dh) or v.shape != k.shape or Hkv == 0 or \
            H % Hkv:
        raise ValueError(f"{what}: q {tuple(q.shape)} does not fit k "
                         f"{tuple(k.shape)} / v {tuple(v.shape)}")
    if not 1 <= dh <= MAX_HEAD_DIM:
        raise ValueError(f"{what}: head dim {dh} not in [1, "
                         f"{MAX_HEAD_DIM}]")
    if B > 65535 or H > 65535:
        raise ValueError(f"{what}: grid (., {H}, {B}) over 65535")
    if window < 0:
        raise ValueError(f"{what}: window {window} < 0")


def _check_device(what: str, tensors: Dict[str, torch.Tensor]
                  ) -> torch.device:
    """The CUDA device of ``tensors["q"]``, which every tensor must share;
    checked after the shapes and types, so those checks run on the CPU."""
    dev = tensors["q"].device
    for name, a in tensors.items():
        if a.device != dev or dev.type != "cuda":
            raise ValueError(f"{what}: {name} on {a.device}, expected the "
                             f"CUDA device of q ({dev})")
    return dev


def _check_lse(what: str, lse: torch.Tensor, q: torch.Tensor) -> None:
    if lse.dtype != torch.float32 or tuple(lse.shape) != q.shape[:3] or \
            not lse.is_contiguous():
        raise ValueError(f"{what}: lse {tuple(lse.shape)} {lse.dtype} is "
                         f"not a contiguous {tuple(q.shape[:3])} float32 "
                         "buffer")


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool, window: int,
           lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Run a kernel on contiguous CUDA tensors q (B, H, S, dh) and k/v
    (B, Hkv, S, dh) of one dtype (float32 or bfloat16), H % Hkv == 0,
    dh <= 128.  Returns a new (B, H, S, dh) tensor of q's dtype.  With
    ``lse``, a contiguous (B, H, S) float32 buffer, the kernel also
    writes each row's log-sum-exp there (ops.FlashAttentionFn's forward);
    the output's bits are the same with or without it.  Refuses inputs
    that need a gradient: the raw launch has no backward (the autograd
    route is ops.flash_attention)."""
    what = "flash_attention kernel"
    refuse_grad("flash_attention", q, k, v)
    _check_qkv(what, q, k, v, window)
    tensors = {"q": q, "k": k, "v": v}
    if lse is not None:
        _check_lse(what, lse, q)
        tensors["lse"] = lse
    flops = cost.cost(q.shape, k.shape, causal, window, q.element_size())[1]
    if q.is_meta:               # the dry run: shapes alone, nothing computed
        add_flops("flash_attention", flops)
        return torch.empty_like(q)
    dev = _check_device(what, tensors)
    B, H, S, dh = q.shape
    Hkv = k.shape[1]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    variant = choose_variant(q, k, v)
    if variant == "wgmma":
        code = _WGMMA_CODE
        maps = [as_ctypes(m) for m in tma_maps(B, H, Hkv, S, dh)]
    else:
        code, maps = _DTYPE_CODES[q.dtype], (None, None)
    rc = build.bind(SOURCE, "flash_attention_launch", _ARGTYPES)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), B, H, Hkv, S, dh,
        int(causal), int(window), 1.0 / math.sqrt(dh), code, *maps,
        raw_stream(dev.index))
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel ({variant}) launch "
                           f"failed: cudaError {rc}")
    COUNTS["flash_attention"] += 1
    COUNTS[f"flash_attention/{variant}"] += 1
    add_flops("flash_attention", flops)
    return out


def launch_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    out: torch.Tensor, dout: torch.Tensor, lse: torch.Tensor,
                    causal: bool, window: int, variant: Optional[str] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel (csrc/flash_attention_bwd.cu) on contiguous
    CUDA tensors: q, k, v as for ``launch``, ``out`` the forward's output
    and ``dout`` its gradient (q's shape and dtype), ``lse`` the
    forward's (B, H, S) float32 log-sum-exp.  ``variant`` defaults to
    ``choose_variant_backward``'s; ``simt`` may be asked for at any input
    (to time and check the first design beside the second), wgmma only
    where it is the choice.  Returns (dq, dk, dv) in the inputs' dtype.
    Shapes, types, contiguity and the variant are checked first, the
    device last."""
    what = "flash_attention backward kernel"
    _check_qkv(what, q, k, v, window)
    for name, a in (("out", out), ("dout", dout)):
        if a.shape != q.shape or a.dtype != q.dtype or not a.is_contiguous():
            raise ValueError(f"{what}: {name} is {tuple(a.shape)} {a.dtype}"
                             f", expected a contiguous {tuple(q.shape)} "
                             f"{q.dtype}")
    _check_lse(what, lse, q)
    chosen = choose_variant_backward(q, k, v, dout)
    variant = chosen if variant is None else variant
    if variant not in (chosen, "simt"):
        raise ValueError(f"{what}: variant {variant!r} does not take these "
                         f"inputs (choice: {chosen!r})")
    flops = cost.cost_backward(q.shape, k.shape, causal, window,
                               q.element_size())[1]
    if q.is_meta:
        add_flops("flash_attention_bwd", flops)
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dev = _check_device(what, dict(q=q, k=k, v=v, out=out, dout=dout,
                                   lse=lse))
    B, H, S, dh = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty((B, H, S), dtype=torch.float32, device=dev)
    if variant == "wgmma":
        code = _WGMMA_CODE
        maps = [as_ctypes(m) for m in tma_maps(B, H, k.shape[1], S, dh)]
    else:
        code, maps = _DTYPE_CODES[q.dtype], (None, None)
    rc = build.bind(BWD_SOURCE, "flash_attention_bwd_launch", _BWD_ARGTYPES)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, H, k.shape[1], S, dh, int(causal),
        int(window), 1.0 / math.sqrt(dh), code, *maps,
        raw_stream(dev.index))
    if rc != 0:
        raise RuntimeError(f"flash_attention backward kernel ({variant}) "
                           f"launch failed: cudaError {rc}")
    COUNTS["flash_attention_bwd"] += 1
    COUNTS[f"flash_attention_bwd/{variant}"] += 1
    add_flops("flash_attention_bwd", flops)
    return dq, dk, dv
