"""Loader and launch of the CUDA flash-attention kernels
(csrc/flash_attention.cu), built with nvcc on first use (kernels/build.py).

``choose_variant`` picks the kernel from dtype, shape and alignment
alone: ``wgmma`` (bf16 through TMA and wgmma) at head dims 16, 32, 64 and
128, ``simt`` (float32 products on the CUDA cores, the first design)
otherwise.  ``tma_maps`` computes the wgmma variant's tensor maps.

``COUNTS["flash_attention"]`` and the variant's
``COUNTS["flash_attention/<variant>"]`` are bumped only where a kernel is
launched, so a run can show that its path went through the kernel, and
through which one.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Tuple

import torch

from repro_torch.kernels import build, raw_stream, refuse_grad
from repro_torch.kernels.tma import BF16_BYTES, TmaMap, as_ctypes

SOURCE = "flash_attention.cu"
VARIANTS = ("wgmma", "simt")
COUNTS: Dict[str, int] = {"flash_attention": 0,
                          **{f"flash_attention/{v}": 0 for v in VARIANTS}}
MAX_HEAD_DIM = 128          # the simt kernel's register accumulator
WGMMA_HEAD_DIMS = (16, 32, 64, 128)
TILE = 64                   # query rows a block, keys a K/V tile
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_WGMMA_CODE = 2
# q, k, v, out, B, H, Hkv, S, dh, causal, window, scale, variant,
# q map, k/v map, stream
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + \
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


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool, window: int) -> torch.Tensor:
    """Run a kernel on contiguous CUDA tensors q (B, H, S, dh) and k/v
    (B, Hkv, S, dh) of one dtype (float32 or bfloat16), H % Hkv == 0,
    dh <= 128.  Returns a new (B, H, S, dh) tensor of q's dtype.
    Refuses inputs that need a gradient (no backward yet)."""
    refuse_grad("flash_attention", q, k, v)
    dev = q.device
    for name, a in (("q", q), ("k", k), ("v", v)):
        if a.device != dev or dev.type != "cuda":
            raise ValueError(f"flash_attention kernel: {name} on {a.device}, "
                             f"expected the CUDA device of q ({dev})")
        if not a.is_contiguous():
            raise ValueError(f"flash_attention kernel: {name} is not "
                             "contiguous")
        if a.dtype != q.dtype or a.ndim != 4:
            raise ValueError(f"flash_attention kernel: {name} is "
                             f"{tuple(a.shape)} {a.dtype}, q is "
                             f"{tuple(q.shape)} {q.dtype}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    B, H, S, dh = q.shape
    Hkv = k.shape[1]
    if k.shape != (B, Hkv, S, dh) or v.shape != k.shape or Hkv == 0 or \
            H % Hkv:
        raise ValueError(f"flash_attention kernel: q {tuple(q.shape)} does "
                         f"not fit k {tuple(k.shape)} / v {tuple(v.shape)}")
    if not 1 <= dh <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention kernel: head dim {dh} not in "
                         f"[1, {MAX_HEAD_DIM}]")
    if B > 65535 or H > 65535:
        raise ValueError(f"flash_attention kernel: grid (., {H}, {B}) over "
                         "65535")
    if window < 0:
        raise ValueError(f"flash_attention kernel: window {window} < 0")
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
        B, H, Hkv, S, dh, int(causal), int(window), 1.0 / math.sqrt(dh),
        code, *maps, raw_stream(dev.index))
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel ({variant}) launch "
                           f"failed: cudaError {rc}")
    COUNTS["flash_attention"] += 1
    COUNTS[f"flash_attention/{variant}"] += 1
    return out
