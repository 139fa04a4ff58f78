"""Mixture-of-Experts layer, the one-device part.

The port of the JAX package's ``models/moe.py`` for the DiT path:
``moe_init`` (here the ``MoE`` module and ``fill_moe``), ``_router``,
``_aux_loss``, ``_expert_ffn``, ``moe_dense`` and ``moe_apply``.  On one
device JAX's ``moe_apply`` is ``moe_dense``: every expert on every token,
combined with the router's top-k weights, with no capacity and no drops.
Its three expert products are the grouped matmul applied to the tokens
broadcast to every expert, so here they run through
``kernels.grouped_matmul.ops`` (the hand-written CUDA kernel on the card)
on an ``expand`` of the tokens, which costs no copy.

The expert-parallel modes (``moe_ep``, ``moe_ep2d`` with
``_dispatch_local`` / ``_combine_local`` over ``all_to_all``) are not
ported yet.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core import prng
from repro_torch.kernels.grouped_matmul import ops as gmm_ops
from repro_torch.models.layers import dense_init, fill


class MoE(nn.Module):
    """The JAX keys: ``router`` (d, E) kept in float32 whatever the
    model's type, ``w_gate`` / ``w_up`` (E, d, F) and ``w_down`` (E, F, d)
    in the model's type — JAX's layouts, not ``nn.Linear``'s."""

    def __init__(self, cfg: ArchConfig, dtype, device=None):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts

        def empty(*shape, dt=dtype):
            return nn.Parameter(torch.empty(shape, dtype=dt, device=device))

        self.router = empty(d, e, dt=torch.float32)
        self.w_gate = empty(e, d, f)
        self.w_up = empty(e, d, f)
        self.w_down = empty(e, f, d)


def fill_moe(m: MoE, key: torch.Tensor) -> None:
    """``moe_init``'s draws in its key order: the router through
    ``dense_init`` in float32, each expert tensor a float32 normal times
    1/sqrt(d) (gate, up) or over sqrt(F) (down), cast to the model's type
    window by window (``prng.fill_normal_``)."""
    d, e = m.router.shape
    f = m.w_gate.shape[-1]
    kr, kg, ku, kd = prng.split(key, 4)
    fill(m.router, dense_init(kr, d, e, torch.float32))
    prng.fill_normal_(m.w_gate, kg, scale=1.0 / math.sqrt(d))
    prng.fill_normal_(m.w_up, ku, scale=1.0 / math.sqrt(d))
    prng.fill_normal_(m.w_down, kd, divisor=math.sqrt(f))


def moe_init(key: torch.Tensor, cfg: ArchConfig, dtype) -> MoE:
    m = MoE(cfg, dtype, key.device)
    fill_moe(m, key)
    return m


def _router(params: MoE, x: torch.Tensor, top_k: int):
    """x: (N, D) -> (probs (N, E) f32, topk_w (N, k) f32, topk_idx (N, k)
    int64).  The k largest probabilities in descending order, renormalised
    to sum to one (``lax.top_k``; on exact ties JAX takes the lower index
    first, which ``torch.topk`` does not promise)."""
    logits = x.float() @ params.router
    probs = torch.softmax(logits, dim=-1)
    topk_w, topk_idx = torch.topk(probs, top_k, dim=-1, largest=True,
                                  sorted=True)
    topk_w = topk_w / torch.clamp(topk_w.sum(-1, keepdim=True), min=1e-9)
    return probs, topk_w, topk_idx


def _aux_loss(probs: torch.Tensor, topk_idx: torch.Tensor,
              n_experts: int) -> torch.Tensor:
    """Switch-style load-balance loss: E * sum_e f_e * P_e."""
    counts = torch.bincount(topk_idx.reshape(-1),
                            minlength=n_experts).float()
    f = counts / torch.clamp(counts.sum(), min=1.0)
    p = probs.mean(dim=0)
    return n_experts * torch.sum(f * p)


def _expert_ffn(w_gate, w_up, w_down, tokens: torch.Tensor) -> torch.Tensor:
    """tokens: (E, C, D) grouped per expert -> (E, C, D): SwiGLU per
    expert, each product one grouped-matmul launch on the card."""
    g = F.silu(gmm_ops.grouped_matmul(tokens, w_gate))
    u = gmm_ops.grouped_matmul(tokens, w_up)
    return gmm_ops.grouped_matmul(g * u, w_down)


def moe_dense(params: MoE, x: torch.Tensor, cfg: ArchConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D).  Every expert on every token, combined with the
    router's top-k weights.  Returns (y (B, S, D), aux loss)."""
    B, S, D = x.shape
    xt = x.reshape(-1, D)
    probs, topk_w, topk_idx = _router(params, xt, cfg.top_k)
    combine = torch.zeros_like(probs).scatter_(1, topk_idx, topk_w)
    y_e = _expert_ffn(params.w_gate, params.w_up, params.w_down,
                      xt.unsqueeze(0).expand(cfg.n_experts, -1, -1))
    y = torch.einsum("end,ne->nd", y_e, combine.to(y_e.dtype))
    aux = _aux_loss(probs, topk_idx, cfg.n_experts)
    return y.reshape(B, S, D), aux


def moe_apply(params: MoE, x: torch.Tensor, cfg: ArchConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """JAX's ``moe_apply`` on one device (no mesh): ``moe_dense``."""
    return moe_dense(params, x, cfg)
