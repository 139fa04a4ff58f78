"""Multi-client CollaFuse (paper §4: k = 5 clients, one trusted server):
the configuration, the denoiser of a collaboration, the sequential
training round of Alg. 1 and a client's sample (Alg. 2).

The port of the JAX package's ``core/collab.py`` up to its vectorized
engine: ``CollabConfig``, ``CollabState`` (models, AdamW states and the
step count), ``build_denoiser``, ``setup``, ``train_round`` and
``sample_for_client``.  ``train_round`` is Alg. 1's outer loops verbatim:
for each client, for each batch, one step, with the keys chained by
``split`` in client-major order as in the reference.  The vectorized
round (stacked clients, masks) is not ported yet.  ``denoiser`` is
``"unet"`` (the paper's U-Net, SMALL resized) or an architecture id,
served through the DiT bridge at the same reduced
widths as in JAX (``configs.base.reduced``): the MoE ids
(``"dbrx-132b"``, ``"kimi-k2-1t-a32b"``) give reduced MoE DiTs of 4
experts, top-2, as JAX's do.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import get_arch, reduced
from repro_torch.configs.ddpm_unet import SMALL, UNetConfig
from repro_torch.core import prng
from repro_torch.core.dit import DiTConfig, init_dit, make_dit_apply
from repro_torch.core.protocol import make_collab_step
from repro_torch.core.sampler import collaborative_sample
from repro_torch.core.schedules import DiffusionSchedule
from repro_torch.core.splitting import CutPoint
from repro_torch.core.unet import init_unet, unet_apply
from repro_torch.device import resolve_device
from repro_torch.optim.adamw import AdamWConfig, init_opt_state


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
    """The server's model and each client's, their AdamW states and the
    number of Alg.-1 steps taken (the reference's fields, in its order).
    A state that only samples may hold ``None`` for the optimizer
    states; ``train_round`` refuses it."""
    server_params: Any
    server_opt: Optional[Dict]
    client_params: List[Any]
    client_opt: Optional[List[Dict]]
    step: int = 0


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


def setup(key: torch.Tensor, cfg: CollabConfig, device=None
          ) -> Tuple[CollabState, Callable, Callable]:
    """(state, collab step fn, apply_fn): the server's model from
    ``split(key, k + 1)[0]`` and client c's from entry c + 1, fresh AdamW
    states, on ``device`` (CUDA unless asked otherwise)."""
    dev = resolve_device(device)
    init_one, apply_fn = build_denoiser(key, cfg, dev)
    ks, *kc = prng.split(key.to(dev), cfg.n_clients + 1)
    server_params = init_one(ks)
    client_params = [init_one(k) for k in kc]
    state = CollabState(
        server_params=server_params,
        server_opt=init_opt_state(server_params),
        client_params=client_params,
        client_opt=[init_opt_state(p) for p in client_params])
    opt_cfg = AdamWConfig(lr=cfg.lr)
    step = make_collab_step(cfg.sched(dev), cfg.cut(), apply_fn, opt_cfg)
    return state, step, apply_fn


def train_round(state: CollabState, step_fn, batches_per_client, key):
    """``batches_per_client``: a list over clients of lists of (x0, y)
    batches.  Mutates ``state`` in place; returns the metrics of the last
    step per client as floats (``{}`` for a client that contributed no
    batches this round)."""
    if state.server_opt is None or state.client_opt is None:
        raise ValueError("train_round: the state has no optimizer states; "
                         "build it with setup")
    last = {}
    for c, batches in enumerate(batches_per_client):
        m = None
        for (x0, y) in batches:
            key, k = prng.split(key)
            (state.client_params[c], state.client_opt[c],
             state.server_params, state.server_opt, m) = step_fn(
                state.client_params[c], state.client_opt[c],
                state.server_params, state.server_opt, x0, y, k)
            state.step += 1
        last[c] = {} if m is None else {k_: float(v) for k_, v in m.items()}
    return last


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
