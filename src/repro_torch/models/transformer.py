"""One pre-norm transformer block (attention + MLP or MoE) and the stack
of them.

The port of the JAX package's ``models/transformer.py`` for the DiT path:
``block_init``, ``block_apply``, ``stacked_init`` and ``_scan_blocks``
(a Python loop where JAX scans).  JAX's ``Runtime`` carries the mesh,
remat, unroll and Pallas switches; this path reads none of them (one
device, no tracing, kernels chosen by the tensors' device), so the port
has no ``Runtime``.  A block of an MoE architecture (``n_experts`` set)
holds ``moe`` where the others hold ``mlp``, and runs it as JAX's
``moe_apply`` does on one device (``models/moe.moe_dense``).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn as nn

from repro_torch.configs.base import ArchConfig
from repro_torch.core import prng
from repro_torch.models import attention as attn
from repro_torch.models.layers import (fill_mlp, make_mlp, mlp_apply,
                                       rmsnorm, rmsnorm_init)
from repro_torch.models.moe import MoE, fill_moe, moe_apply


class Block(nn.Module):
    """norm1 → attention → residual, norm2 → MLP or MoE → residual (JAX
    keys norm1, attn, norm2, and mlp or moe)."""

    def __init__(self, cfg: ArchConfig, dtype, device=None):
        super().__init__()
        self.norm1 = rmsnorm_init(cfg.d_model, dtype, device)
        self.attn = attn.Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                   cfg.head_dim_, dtype, device)
        self.norm2 = rmsnorm_init(cfg.d_model, dtype, device)
        if cfg.n_experts:
            self.moe = MoE(cfg, dtype, device)
        else:
            self.mlp = make_mlp(cfg.d_model, cfg.d_ff, dtype, cfg.mlp_type,
                                device)


def fill_block(m: Block, key: torch.Tensor) -> None:
    ka, km = prng.split(key)
    attn.fill_attn(m.attn, ka)
    if hasattr(m, "moe"):
        fill_moe(m.moe, km)
    else:
        fill_mlp(m.mlp, km)


def block_init(key: torch.Tensor, cfg: ArchConfig, dtype) -> Block:
    m = Block(cfg, dtype, key.device)
    fill_block(m, key)
    return m


def block_apply(params: Block, x, cfg: ArchConfig, positions,
                window: Optional[int] = None, causal: bool = True):
    """Full-sequence block.  Returns (x, (k, v)); an MoE block's aux loss
    is dropped, as ``dit_apply`` drops it in JAX."""
    w = cfg.sliding_window if window is None else window
    h = rmsnorm(params.norm1, x, cfg.norm_eps)
    a, kv = attn.self_attention(
        params.attn, h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim_, positions=positions, theta=cfg.rope_theta,
        fraction=cfg.rope_fraction, causal=causal, window=w, return_kv=True)
    x = x + a
    h = rmsnorm(params.norm2, x, cfg.norm_eps)
    if cfg.n_experts:
        m, _ = moe_apply(params.moe, h, cfg)
    else:
        m = mlp_apply(params.mlp, h, cfg.mlp_type)
    return x + m, kv


def stacked_init(key: torch.Tensor, layers: Sequence[nn.Module],
                 fill_fn: Callable[[nn.Module, torch.Tensor], None]) -> None:
    """Draw a stack in place: layer i from ``split(key, n)[i]``, the keys
    JAX's ``stacked_init`` vmaps its init over."""
    for layer, k in zip(layers, prng.split(key, len(layers))):
        fill_fn(layer, k)


def _scan_blocks(layers, x, cfg: ArchConfig, positions, window=None,
                 causal: bool = True):
    for layer in layers:
        x, _ = block_apply(layer, x, cfg, positions, window, causal)
    return x
