"""Public attention op for full-sequence attention.

Routing follows the tensors' device and nothing else: CPU tensors take
the plain version (ref.py); CUDA tensors take the hand-written kernel
(kernel.py, csrc/flash_attention.cu) or raise.  Same contract as the JAX
package's ``kernels/flash_attention/ops.flash_attention``: ``window``
applies whether or not ``causal`` is set.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ref import attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, H, S, dh); k/v: (B, Hkv, S, dh).  Returns (B, H, S, dh) in
    q's type."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not "
                         f"{q.device}")
    return kernel.launch(q.contiguous(), k.contiguous(), v.contiguous(),
                         causal, window)
