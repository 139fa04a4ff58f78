"""Loader and launch of the CUDA flash-attention kernel
(csrc/flash_attention.cu), built with nvcc on first use (kernels/build.py).

``COUNTS["flash_attention"]`` is bumped only where the kernel is launched,
so a run can show that its path went through the kernel.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict

import torch

from repro_torch.kernels import build

SOURCE = "flash_attention.cu"
COUNTS: Dict[str, int] = {"flash_attention": 0}
MAX_HEAD_DIM = 128          # the kernel's register accumulator
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# q, k, v, out, B, H, Hkv, S, dh, causal, window, scale, dtype, stream
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + \
    [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def reset_counts() -> None:
    for name in COUNTS:
        COUNTS[name] = 0


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool, window: int) -> torch.Tensor:
    """Run the kernel on contiguous CUDA tensors q (B, H, S, dh) and k/v
    (B, Hkv, S, dh) of one dtype (float32 or bfloat16), H % Hkv == 0,
    dh <= 128.  Returns a new (B, H, S, dh) tensor of q's dtype."""
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
    rc = build.bind(SOURCE, "flash_attention_launch", _ARGTYPES)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, H, Hkv, S, dh, int(causal), int(window), 1.0 / math.sqrt(dh),
        _DTYPE_CODES[q.dtype], torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {rc}")
    COUNTS["flash_attention"] += 1
    return out
