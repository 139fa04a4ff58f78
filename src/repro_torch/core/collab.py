"""Multi-client CollaFuse: the configuration, the denoiser of a
collaboration and a client's sample (paper Alg. 2).

The port of the sampling part of the JAX package's ``core/collab.py``:
``CollabConfig``, ``build_denoiser`` and ``sample_for_client``, with a
``CollabState`` that holds the models only (the optimizer states, the
training rounds and the vectorized engine come with the training slice).
``denoiser`` is ``"unet"`` (the paper's U-Net, SMALL resized) or an
architecture id, served through the DiT bridge at the same reduced
widths as in JAX (``configs.base.reduced``): the MoE ids
(``"dbrx-132b"``, ``"kimi-k2-1t-a32b"``) give reduced MoE DiTs of 4
experts, top-2, as JAX's do.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Tuple

from repro_torch.configs.base import get_arch, reduced
from repro_torch.configs.ddpm_unet import SMALL, UNetConfig
from repro_torch.core.dit import DiTConfig, init_dit, make_dit_apply
from repro_torch.core.sampler import collaborative_sample
from repro_torch.core.schedules import DiffusionSchedule
from repro_torch.core.splitting import CutPoint
from repro_torch.core.unet import init_unet, unet_apply


@dataclasses.dataclass(frozen=True)
class CollabConfig:
    n_clients: int = 5           # paper §4
    T: int = 1000                # paper §4.1
    t_cut: int = 200
    denoiser: str = "unet"       # "unet" | an architecture id (DiT bridge)
    image_size: int = 16
    channels: int = 3
    n_classes: int = 8
    batch_size: int = 8          # paper §4.1
    lr: float = 1e-3             # paper §4.1
    schedule: str = "linear"
    unet: Optional[UNetConfig] = None       # defaults to SMALL resized
    dit_patch: int = 4

    def cut(self) -> CutPoint:
        return CutPoint(self.T, self.t_cut)

    def sched(self, device=None) -> DiffusionSchedule:
        mk = (DiffusionSchedule.linear if self.schedule == "linear"
              else DiffusionSchedule.cosine)
        return mk(self.T, device=device)

    def image_shape(self, batch: Optional[int] = None):
        b = batch or self.batch_size
        return (b, self.image_size, self.image_size, self.channels)


@dataclasses.dataclass
class CollabState:
    """The server's model and each client's."""
    server_params: Any
    client_params: List[Any]


def build_denoiser(key, cfg: CollabConfig, device=None
                   ) -> Tuple[Callable, Callable]:
    """(init_one_model_fn(key) -> model on ``device``, apply_fn)."""
    if cfg.denoiser == "unet":
        ucfg = cfg.unet or dataclasses.replace(
            SMALL, image_size=cfg.image_size, channels=cfg.channels,
            n_classes=cfg.n_classes)
        return (lambda k: init_unet(k, ucfg, device),
                lambda p, x, t, y: unet_apply(p, x, t, y, ucfg))
    arch = reduced(get_arch(cfg.denoiser))
    if arch.family == "audio":
        raise ValueError(
            "whisper-base is an enc-dec audio arch; CollaFuse's denoising "
            "split is inapplicable (DESIGN.md §Arch-applicability)")
    dit = DiTConfig(image_size=cfg.image_size, channels=cfg.channels,
                    patch_size=cfg.dit_patch, n_classes=cfg.n_classes)
    return (lambda k: init_dit(k, arch, dit, device),
            make_dit_apply(arch, dit))


def sample_for_client(state: CollabState, client: int, key, y,
                      cfg: CollabConfig, apply_fn, adjusted: bool = True,
                      batch: Optional[int] = None,
                      return_handoff: bool = False):
    """Alg. 2 for one client: the server's steps with the server model,
    then the client's with the client's own."""
    shape = cfg.image_shape(batch or y.shape[0])
    return collaborative_sample(
        state.server_params, state.client_params[client], key, y, shape,
        cfg.sched(key.device), cfg.cut(), apply_fn, adjusted=adjusted,
        return_handoff=return_handoff)
