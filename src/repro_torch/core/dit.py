"""DiT bridge: an architecture of the zoo as a CollaFuse denoiser.

The port of the JAX package's ``core/dit.py``.  Images are cut into
patches (tokens, raster order); the timestep and label conditioning is
added to every token; the backbone runs the token sequence; a linear head
predicts the noise of each patch.

* dense / moe / vlm families: bidirectional attention blocks
  (``causal=False``; the model then ignores any sliding window, as in
  JAX); an MoE block runs in the mode the ``runtime`` picks
  (models/transformer.py ``Runtime``; the default ``CPU`` gives
  ``moe_dense``, every expert on every token, and a mesh ``moe_ep`` or
  ``moe_ep2d``), with its expert products through the hand-written CUDA
  grouped-matmul kernels on the card (the backward kernel under grad);
* ssm / hybrid families: Mamba2 layers, a causal scan over the raster
  order, and for the hybrid (Zamba2) one shared attention+MLP block,
  bidirectional, after every ``shared_attn_every`` layers.  The SSD scan
  and the attention run through the hand-written CUDA kernels on the card.
* the audio family is refused by ``core/collab.build_denoiser``.

``DiT`` holds the parameters under the JAX package's keys (``patch_in``,
``pos``, ``time_mlp.w1`` …, ``mamba[i]``, ``shared``, ``layers[i]``), so
``bridge.load_dit`` fills one from a JAX tree; ``init_dit`` draws the
weights with the port's threefry in JAX's key order, so both packages
hold the same weights for the same key.  ``dit_apply(params, x, t, y,
arch, dit, runtime)`` is the denoiser signature of core/protocol.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core import prng
from repro_torch.device import resolve_device
from repro_torch.models.hybrid import _grouping, _split_groups
from repro_torch.models.layers import (dense, fill, fill_dense, rmsnorm,
                                       rmsnorm_init, sinusoidal_embedding)
from repro_torch.models.ssm import Mamba, fill_mamba, mamba_forward
from repro_torch.models.transformer import (CPU, Block, Runtime, _scan_blocks,
                                            block_apply, fill_block,
                                            stacked_init)


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    image_size: int = 16
    channels: int = 3
    patch_size: int = 4
    n_classes: int = 8

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def patch_dim(self) -> int:
        return self.patch_size ** 2 * self.channels


def _is_ssm(arch: ArchConfig) -> bool:
    return arch.family in ("ssm", "hybrid")


def patchify(x, p: int):
    """(B, H, W, C) -> (B, N, p·p·C), raster order."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // p, p, W // p, p, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, (H // p) * (W // p),
                                               p * p * C)


def unpatchify(t, p: int, H: int, W: int, C: int):
    B = t.shape[0]
    x = t.reshape(B, H // p, W // p, p, p, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, C)


class DiT(nn.Module):
    """The DiT's parameters (uninitialised until ``init_dit`` or
    ``bridge.load_dit`` fills them); ``forward`` is ``dit_apply``."""

    def __init__(self, arch: ArchConfig, dit: DiTConfig, device=None):
        super().__init__()
        self.arch, self.dit = arch, dit
        dtype, d = arch.torch_dtype, arch.d_model
        self.patch_in = dense(dit.patch_dim, d, dtype, device)
        self.pos = nn.Parameter(torch.empty(dit.n_patches, d, dtype=dtype,
                                            device=device))
        self.time_mlp = nn.ModuleDict({"w1": dense(d, d, dtype, device),
                                       "w2": dense(d, d, dtype, device)})
        self.label_proj = dense(dit.n_classes, d, dtype, device)
        self.final_norm = rmsnorm_init(d, dtype, device)
        self.patch_out = dense(d, dit.patch_dim, dtype, device)
        if _is_ssm(arch):
            self.mamba = nn.ModuleList(Mamba(arch, dtype, device)
                                       for _ in range(arch.n_layers))
            if arch.shared_attn_every > 0:
                self.shared = Block(arch, dtype, device)
        else:
            self.layers = nn.ModuleList(Block(arch, dtype, device)
                                        for _ in range(arch.n_layers))

    def forward(self, x, t, y):
        return dit_apply(self, x, t, y, self.arch, self.dit)


def init_dit(key: torch.Tensor, arch: ArchConfig, dit: DiTConfig,
             device=None) -> DiT:
    """A DiT on ``device`` (CUDA unless asked otherwise) whose weights
    equal ``repro.core.dit.init_dit(key, arch, dit)``'s (normals within
    the few ulps of ``torch.erfinv``).  Draws run on the device."""
    dev = resolve_device(device)
    key = key.to(dev)
    model = DiT(arch, dit, dev)
    ki, kp, kt, kl, kb, ko = prng.split(key, 6)
    fill_dense(model.patch_in, ki)
    fill(model.pos, prng.normal(kp, (dit.n_patches, arch.d_model)) * 0.02)
    fill_dense(model.time_mlp["w1"], kt)
    fill_dense(model.time_mlp["w2"], prng.fold_in(kt, 1))
    fill_dense(model.label_proj, kl)
    fill_dense(model.patch_out, ko, scale=1e-3)
    if _is_ssm(arch):
        stacked_init(kb, model.mamba, lambda m, k: fill_mamba(m, k, arch))
        if arch.shared_attn_every > 0:
            fill_block(model.shared, prng.fold_in(kb, 1))
    else:
        stacked_init(kb, model.layers, fill_block)
    return model


def _backbone(params: DiT, h, arch: ArchConfig, runtime: Runtime = CPU):
    N = h.shape[1]
    positions = torch.arange(N, device=h.device)[None]
    if not _is_ssm(arch):
        return _scan_blocks(params.layers, h, arch, positions,
                            causal=False, runtime=runtime)[0]
    g, G, _ = _grouping(arch)
    head, tail = _split_groups(params.mamba, g, G)
    for group in head:
        for layer in group:
            h = mamba_forward(layer, h, arch)
        h, _, _ = block_apply(params.shared, h, arch, positions,
                              causal=False, runtime=runtime)
    for layer in tail:
        h = mamba_forward(layer, h, arch)
    return h


def dit_apply(params: DiT, x, t, y, arch: ArchConfig, dit: DiTConfig,
              runtime: Runtime = CPU):
    """x: (B, H, W, C); t: (B,) real timesteps; y: (B, n_classes)
    multi-hot.  Returns ε̂ (B, H, W, C) in float32."""
    B, H, W, C = x.shape
    tok = patchify(x.to(params.patch_in.weight.dtype), dit.patch_size)
    h = params.patch_in(tok) + params.pos[None]
    temb = sinusoidal_embedding(torch.as_tensor(t, dtype=torch.float32),
                                arch.d_model).to(h.dtype)
    tm = params.time_mlp
    cond = tm["w2"](F.silu(tm["w1"](temb)))
    cond = cond + params.label_proj(y.to(cond.dtype))
    h = h + cond[:, None, :]
    h = _backbone(params, h, arch, runtime)
    h = rmsnorm(params.final_norm, h, arch.norm_eps)
    out = params.patch_out(h)
    return unpatchify(out.float(), dit.patch_size, H, W, C).contiguous()


def make_dit_apply(arch: ArchConfig, dit: DiTConfig, runtime: Runtime = CPU):
    """The samplers' ``apply_fn(params, x_t, t, y)``."""
    def f(params, x_t, t, y):
        return dit_apply(params, x_t, t, y, arch, dit, runtime)
    return f
