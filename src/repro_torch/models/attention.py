"""GQA self-attention with RoPE (full or fractional) for full sequences.

The port of the JAX package's ``models/attention.py`` for the DiT path:
``rope_freqs``, ``apply_rope``, ``attend``, ``causal_mask``, ``attn_init``
and ``self_attention``.  The full-sequence product in ``self_attention``
goes through ``kernels.flash_attention.ops`` (the CUDA kernel on the card,
its plain version on the CPU); ``attend`` is the model's generic core,
kept for tests and callers with an arbitrary mask.  Decode, cross-attention
and the KV cache come with the LM slice.

RoPE rotates interleaved pairs (``x[..., ::2]``, ``x[..., 1::2]``) as JAX
does, not the half-split ``rotate_half`` of common PyTorch code.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from repro_torch.core import prng
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models.layers import dense, fill_dense

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, fraction: float = 1.0,
               device=None):
    """Inverse frequencies for the rotary fraction of the head dim, and
    that fraction's (even) width."""
    rot = int(head_dim * fraction)
    rot -= rot % 2
    idx = torch.arange(0, rot, 2, device=device).float()
    return 1.0 / (theta ** (idx / rot)), rot


def apply_rope(x, positions, theta: float, fraction: float = 1.0):
    """x: (B, H, S, dh); positions: (B, S) or (S,)."""
    dh = x.shape[-1]
    inv_freq, rot = rope_freqs(dh, theta, fraction, x.device)
    if rot == 0:
        return x
    pos = positions.float()
    if pos.ndim == 1:
        pos = pos[None, :]
    ang = pos[:, None, :, None] * inv_freq           # (B, 1, S, rot/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    x1, x2 = x_rot[..., ::2], x_rot[..., 1::2]
    y1 = x1 * cos - x2 * sin                         # float32, as in JAX
    y2 = x2 * cos + x1 * sin
    y = torch.stack([y1, y2], dim=-1).reshape(x_rot.shape)
    return torch.cat([y.to(x.dtype), x_pass], dim=-1)


# ---------------------------------------------------------------------------
# Core attention
# ---------------------------------------------------------------------------


def attend(q, k, v, mask=None, scale: Optional[float] = None):
    """q: (B, H, Sq, dh), k/v: (B, Hkv, Skv, dh) with H % Hkv == 0.
    mask broadcasts to (B, H, Sq, Skv), True = attend."""
    B, H, Sq, dh = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    group = H // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    qg = q.reshape(B, Hkv, group, Sq, dh)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg, k).float() * scale
    if mask is not None:
        m = torch.broadcast_to(mask, (B, H, Sq, Skv)).reshape(
            B, Hkv, group, Sq, Skv)
        logits = torch.where(m, logits, torch.full_like(logits, NEG_INF))
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bhkd->bhgqd", w, v)
    return out.reshape(B, H, Sq, dh)


def causal_mask(seq: int, window: int = 0, device=None):
    i = torch.arange(seq, device=device)[:, None]
    j = torch.arange(seq, device=device)[None, :]
    m = j <= i
    if window > 0:
        m = m & ((i - j) < window)
    return m                                         # (S, S)


# ---------------------------------------------------------------------------
# Self-attention layer (projections + RoPE)
# ---------------------------------------------------------------------------


class Attention(nn.Module):
    """The projections of one attention layer (JAX keys wq, wk, wv, wo)."""

    def __init__(self, d_model: int, n_heads: int, n_kv_heads: int,
                 head_dim: int, dtype, device=None):
        super().__init__()
        self.wq = dense(d_model, n_heads * head_dim, dtype, device)
        self.wk = dense(d_model, n_kv_heads * head_dim, dtype, device)
        self.wv = dense(d_model, n_kv_heads * head_dim, dtype, device)
        self.wo = dense(n_heads * head_dim, d_model, dtype, device)


def fill_attn(m: Attention, key: torch.Tensor) -> None:
    kq, kk, kv, ko = prng.split(key, 4)
    for lin, k in ((m.wq, kq), (m.wk, kk), (m.wv, kv), (m.wo, ko)):
        fill_dense(lin, k)


def attn_init(key: torch.Tensor, d_model: int, n_heads: int,
              n_kv_heads: int, head_dim: int, dtype) -> Attention:
    m = Attention(d_model, n_heads, n_kv_heads, head_dim, dtype, key.device)
    fill_attn(m, key)
    return m


def _split_heads(x, n_heads: int, head_dim: int):
    B, S, _ = x.shape
    return x.reshape(B, S, n_heads, head_dim).transpose(1, 2)


def _merge_heads(x):
    B, H, S, dh = x.shape
    return x.transpose(1, 2).reshape(B, S, H * dh)


def qkv(params: Attention, x, n_heads, n_kv_heads, head_dim, positions,
        theta, fraction, use_rope=True):
    q = _split_heads(params.wq(x), n_heads, head_dim)
    k = _split_heads(params.wk(x), n_kv_heads, head_dim)
    v = _split_heads(params.wv(x), n_kv_heads, head_dim)
    if use_rope:
        q = apply_rope(q, positions, theta, fraction)
        k = apply_rope(k, positions, theta, fraction)
    return q, k, v


def self_attention(params: Attention, x, *, n_heads, n_kv_heads, head_dim,
                   positions, theta=10_000.0, fraction=1.0, causal=True,
                   window=0, use_rope=True, return_kv=False):
    """Full-sequence attention, x: (B, S, D).  As in JAX, the window
    applies only to causal attention: a bidirectional call attends to the
    whole sequence whatever ``window`` says (the kernel would apply it)."""
    q, k, v = qkv(params, x, n_heads, n_kv_heads, head_dim, positions, theta,
                  fraction, use_rope)
    a = flash_ops.flash_attention(q, k, v, causal=causal,
                                  window=window if causal else 0)
    out = params.wo(_merge_heads(a))
    if return_kv:
        return out, (k, v)
    return out
