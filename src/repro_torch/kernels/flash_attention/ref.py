"""Plain PyTorch version of the flash-attention kernel: materialised
QKᵀ softmax attention with GQA head grouping and causal and sliding-window
masks, all in float32, cast back to q's type.  The port of the JAX
package's ``kernels/flash_attention/ref.attention_ref``: ``window`` applies
whether or not ``causal`` is set (``rows − cols < window``).  The wrapper
(ops.py) takes it for CPU tensors; chip_smoke.py holds the CUDA kernel
against it on the card."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, causal: bool = True, window: int = 0):
    """q: (B, H, S, dh); k/v: (B, Hkv, S, dh) with H % Hkv == 0."""
    B, H, S, dh = q.shape
    Hkv = k.shape[1]
    g = H // Hkv
    qg = q.float().reshape(B, Hkv, g, S, dh)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) / math.sqrt(dh)
    if causal or window > 0:
        i = torch.arange(S, device=q.device)[:, None]
        j = torch.arange(S, device=q.device)[None, :]
        m = (j <= i) if causal else torch.ones(S, S, dtype=torch.bool,
                                               device=q.device)
        if window > 0:
            m = m & ((i - j) < window)
        logits = torch.where(m, logits, torch.full_like(logits, NEG_INF))
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", w, v.float())
    return out.reshape(B, H, S, dh).to(q.dtype)
