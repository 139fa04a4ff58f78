"""The paper's own model: DDPM U-Net denoiser [Ho et al. 2020; CollaFuse §4.1].

This is NOT one of the assigned pool architectures — it is the model the
paper itself trains (32x32 .. 512x512 RGB). ``UNetConfig`` lives here so the
CollaFuse entry points, examples and benchmarks share one source of truth.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    name: str = "ddpm-unet"
    image_size: int = 32
    channels: int = 3
    base_width: int = 64
    width_mults: Tuple[int, ...] = (1, 2, 2)
    n_res_blocks: int = 2
    attn_resolutions: Tuple[int, ...] = (16,)  # apply self-attn at these H/W
    n_heads: int = 4
    time_dim: int = 256
    n_classes: int = 8          # attribute-conditioning vocabulary
    groupnorm_groups: int = 8
    dropout: float = 0.0
    dtype: str = "float32"


CONFIG = UNetConfig()

# Reduced variant for CPU tests / the end-to-end example.
SMALL = UNetConfig(
    name="ddpm-unet-small",
    image_size=16,
    base_width=32,
    width_mults=(1, 2),
    n_res_blocks=1,
    attn_resolutions=(8,),
    n_heads=2,
    time_dim=64,
    groupnorm_groups=4,
)
