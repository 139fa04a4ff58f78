"""Plain PyTorch versions of the flash-attention kernels.

``attention_ref``: materialised QKᵀ softmax attention with GQA head
grouping and causal and sliding-window masks, all in float32, cast back to
q's type.  The port of the JAX package's
``kernels/flash_attention/ref.attention_ref``: ``window`` applies whether
or not ``causal`` is set (``rows − cols < window``).  The wrapper (ops.py)
takes it for CPU tensors; chip_smoke.py holds the CUDA kernel against it
on the card.

``attention_lse`` is the forward kernel's optional log-sum-exp output and
``flash_attention_bwd_ref`` the backward kernel's algorithm
(csrc/flash_attention_bwd.cu), written out step by step in float32: the
probabilities recomputed from the log-sum-exp, D = rowsum(dO∘O), dS =
P∘(dP − D).  The tests hold it against autograd of ``attention_ref`` and
``jax.vjp`` of the JAX package's attention; chip_smoke.py holds the CUDA
backward against it on the card."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def keep_mask(S: int, causal: bool, window: int, device=None):
    """(S, S) bool, True where query row i attends to key column j: j <= i
    when causal, i − j < window when window > 0 (whether or not causal)."""
    i = torch.arange(S, device=device)[:, None]
    j = torch.arange(S, device=device)[None, :]
    m = (j <= i) if causal else torch.ones(S, S, dtype=torch.bool,
                                           device=device)
    if window > 0:
        m = m & ((i - j) < window)
    return m


def _logits(q, k, causal: bool, window: int):
    """The masked float32 logits (B, Hkv, G, S, S), −1e30 where masked."""
    B, H, S, dh = q.shape
    Hkv = k.shape[1]
    qg = q.float().reshape(B, Hkv, H // Hkv, S, dh)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) / math.sqrt(dh)
    if causal or window > 0:
        m = keep_mask(S, causal, window, q.device)
        logits = torch.where(m, logits, torch.full_like(logits, NEG_INF))
    return logits


def attention_ref(q, k, v, causal: bool = True, window: int = 0):
    """q: (B, H, S, dh); k/v: (B, Hkv, S, dh) with H % Hkv == 0."""
    B, H, S, dh = q.shape
    w = torch.softmax(_logits(q, k, causal, window), dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", w, v.float())
    return out.reshape(B, H, S, dh).to(q.dtype)


def attention_lse(q, k, causal: bool = True, window: int = 0):
    """The log-sum-exp over the kept keys of each query row, (B, H, S)
    float32: what the forward kernel writes for its backward."""
    B, H, S, _ = q.shape
    return torch.logsumexp(_logits(q, k, causal, window),
                           dim=-1).reshape(B, H, S)


def flash_attention_bwd_ref(q, k, v, out, dout, lse, causal: bool = True,
                            window: int = 0):
    """(dq, dk, dv) of ``attention_ref`` at (q, k, v) for the output
    gradient ``dout``, given the forward's output ``out`` and its
    log-sum-exp ``lse`` (B, H, S): the backward kernel's three passes.

    1. D_i = Σ_d dO_id · O_id;
    2. per key j: P_ij = exp(scale·q_i·k_j − lse_i) where kept, else 0;
       dV_j = Σ_i P_ij dO_i and, with dP_ij = dO_i·v_j and
       dS_ij = P_ij (dP_ij − D_i), dK_j = scale Σ_i dS_ij q_i, summed
       over the G query heads of the key's head;
    3. per query i: dQ_i = scale Σ_j dS_ij k_j.
    Float32 throughout; each gradient in its input's type."""
    B, H, S, dh = q.shape
    Hkv = k.shape[1]
    G = H // Hkv
    scale = 1.0 / math.sqrt(dh)
    f = lambda t: t.float().reshape(B, Hkv, G, S, dh)
    qf, of, dof = f(q), f(out), f(dout)
    kf, vf = k.float(), v.float()
    lse = lse.float().reshape(B, Hkv, G, S)
    # 1. D = rowsum(dO ∘ O)
    D = (dof * of).sum(-1)                                   # (B,Hkv,G,S)
    # 2./3. the probabilities from the log-sum-exp, zero where masked
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kf) * scale
    keep = keep_mask(S, causal, window, q.device)
    p = torch.where(keep, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dof, vf)
    ds = p * (dp - D[..., None])
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, dof)
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, qf) * scale
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, kf) * scale
    return (dq.reshape(B, H, S, dh).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
