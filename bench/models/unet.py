"""The DDPM U-Net family: weights drawn from the seed, the program's model
built around them, and the plain reference that reads the same weights.

A configuration file of this family (``"model_code": "unet"``) holds the
``UNetConfig`` sizes of the program.  Weights are drawn on the device
with a ``torch.Generator`` seeded from (run seed, model index), in one
normal draw a model: every weight matrix and kernel at std 1/sqrt(fan in),
biases 0, GroupNorm scales 1.  So the output layers are not near zero and
every layer shapes ε̂.  The program's ``UNet`` is built on the meta device
and filled from that dict; the reference (``reference/unet.py``) reads the
same dict.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from bench.reference import unet as ref_unet


def make_weights(cfg: Dict, seed: int, index: int, device
                 ) -> Dict[str, torch.Tensor]:
    """The weights of model ``index`` (0 the server, 1.. the clients) of
    the run with ``seed``, float32 on ``device``."""
    specs = ref_unet.param_shapes(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + index) % (2 ** 63))
    total = sum(torch.Size(s).numel() for _, s, _ in specs)
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape, fan_in in specs:
        n = torch.Size(shape).numel()
        if fan_in > 0:
            out[name] = (flat[at:at + n] / fan_in ** 0.5).reshape(shape)
        elif fan_in < 0:
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
        at += n
    return out


def program_config(cfg: Dict):
    from repro_torch.configs.ddpm_unet import UNetConfig
    names = {f.name for f in dataclasses.fields(UNetConfig)}
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in cfg.items() if k in names}
    return UNetConfig(**kw)


def build_program(cfg: Dict, weights: Dict[str, torch.Tensor], device):
    """The program's U-Net holding ``weights``."""
    from repro_torch.core.unet import UNet
    with torch.device("meta"):
        model = UNet(program_config(cfg))
    model = model.to_empty(device=device)
    model.load_state_dict(weights, strict=True)
    return model


def apply_fn():
    from repro_torch.core.unet import unet_apply
    return unet_apply


def reference_eps(weights, cfg: Dict, x, t, y, precision: str = "fp32"):
    return ref_unet.forward(weights, cfg, x, t, y, precision)
