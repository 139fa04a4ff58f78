"""One pre-norm transformer block (attention + MLP) and the stack of them.

The port of the JAX package's ``models/transformer.py`` for the DiT path:
``block_init``, ``block_apply``, ``stacked_init`` and ``_scan_blocks``
(a Python loop where JAX scans).  JAX's ``Runtime`` carries the mesh,
remat, unroll and Pallas switches; this path reads none of them (one
device, no tracing, kernels chosen by the tensors' device), so the port
has no ``Runtime``.  MoE blocks wait for the grouped-matmul slice.
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


def _refuse_moe(cfg: ArchConfig) -> None:
    if cfg.n_experts:
        raise NotImplementedError(
            f"{cfg.name}: MoE blocks (n_experts={cfg.n_experts}) are not "
            "ported yet; they come with the grouped-matmul slice "
            "(kernels/grouped_matmul)")


class Block(nn.Module):
    """norm1 → attention → residual, norm2 → MLP → residual (JAX keys
    norm1, attn, norm2, mlp)."""

    def __init__(self, cfg: ArchConfig, dtype, device=None):
        super().__init__()
        _refuse_moe(cfg)
        self.norm1 = rmsnorm_init(cfg.d_model, dtype, device)
        self.attn = attn.Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                   cfg.head_dim_, dtype, device)
        self.norm2 = rmsnorm_init(cfg.d_model, dtype, device)
        self.mlp = make_mlp(cfg.d_model, cfg.d_ff, dtype, cfg.mlp_type,
                            device)


def fill_block(m: Block, key: torch.Tensor) -> None:
    ka, km = prng.split(key)
    attn.fill_attn(m.attn, ka)
    fill_mlp(m.mlp, km)


def block_init(key: torch.Tensor, cfg: ArchConfig, dtype) -> Block:
    m = Block(cfg, dtype, key.device)
    fill_block(m, key)
    return m


def block_apply(params: Block, x, cfg: ArchConfig, positions,
                window: Optional[int] = None, causal: bool = True):
    """Full-sequence block.  Returns (x, (k, v)); the JAX function's aux
    loss is MoE-only."""
    w = cfg.sliding_window if window is None else window
    h = rmsnorm(params.norm1, x, cfg.norm_eps)
    a, kv = attn.self_attention(
        params.attn, h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim_, positions=positions, theta=cfg.rope_theta,
        fraction=cfg.rope_fraction, causal=causal, window=w, return_kv=True)
    x = x + a
    h = rmsnorm(params.norm2, x, cfg.norm_eps)
    x = x + mlp_apply(params.mlp, h, cfg.mlp_type)
    return x, kv


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
