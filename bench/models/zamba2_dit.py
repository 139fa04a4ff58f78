"""The Zamba2 DiT family: weights drawn from the seed on the device, the
program's ``core/dit.DiT`` built around them, and the plain reference
(``reference/zamba2_dit.py``) that reads the same weights.

A configuration file of this family (``"model_code": "zamba2_dit"``) holds the
program's ``ArchConfig`` fields and the DiT's image, patch and label
sizes.  One normal draw a model in the weights' type on the device, then
each leaf scaled: weights std 1/sqrt(fan in), conv kernels 1/sqrt(K),
positions 0.02, norm scales and D 1, conv biases 0, A_log the log of
1…16 across the heads and dt_bias softplus⁻¹(0.01), as Mamba2 sets them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch

from bench.reference import zamba2_dit as ref

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def make_weights(cfg: Dict, seed: int, index: int, device
                 ) -> Dict[str, torch.Tensor]:
    specs = ref.param_shapes(cfg)
    dtype = DTYPES[cfg["dtype"]]
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + index) % (2 ** 63))
    total = sum(torch.Size(s).numel() for _, s, _ in specs)
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    out, at = {}, 0
    for name, shape, kind in specs:
        n = torch.Size(shape).numel()
        z = flat[at:at + n].view(shape)
        at += n
        if kind.startswith("w"):
            out[name] = z.mul_(1.0 / math.sqrt(int(kind[1:])))
        elif kind == "conv":
            out[name] = z.mul_(1.0 / math.sqrt(cfg["ssm_conv_kernel"]))
        elif kind == "pos":
            out[name] = z.mul_(0.02)
        elif kind == "one":
            out[name] = torch.ones(shape, device=device, dtype=dtype)
        elif kind == "zero":
            out[name] = torch.zeros(shape, device=device, dtype=dtype)
        elif kind == "A":
            out[name] = torch.log(torch.linspace(1.0, 16.0, shape[0],
                                                 device=device))
        elif kind == "dt":
            out[name] = torch.full(shape, math.log(math.expm1(0.01)),
                                   device=device)
    return out


def _arch(cfg: Dict):
    from repro_torch.configs.base import ArchConfig
    names = {f.name for f in dataclasses.fields(ArchConfig)}
    return ArchConfig(**{k: v for k, v in cfg.items() if k in names})


def _dit(cfg: Dict):
    from repro_torch.core.dit import DiTConfig
    return DiTConfig(image_size=cfg["image_size"], channels=cfg["channels"],
                     patch_size=cfg["patch_size"],
                     n_classes=cfg["n_classes"])


def build_program(cfg: Dict, weights: Dict[str, torch.Tensor], device):
    from repro_torch.core.dit import DiT
    model = DiT(_arch(cfg), _dit(cfg), device="meta")
    model = model.to_empty(device=device)
    model.load_state_dict(weights, strict=True)
    return model


def apply_fn():
    from repro_torch.core.dit import dit_apply

    def apply(model, x, t, y):
        return dit_apply(model, x, t, y, model.arch, model.dit)
    return apply


def reference_eps(weights, cfg: Dict, x, t, y, precision: str = "fp32"):
    return ref.forward(weights, cfg, x, t, y, precision)
