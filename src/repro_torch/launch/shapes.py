"""Step functions for every (architecture × input shape) pair.

The port of the step builders of the JAX package's ``launch/shapes.py``:
``make_train_step`` (value and grad of ``api.loss_fn``, then AdamW),
``make_prefill_step``, ``make_decode_step``, ``step_fn`` and
``skip_reason``.  The ``ShapeDtypeStruct`` stand-ins and shardings of the
dry-run (``input_specs`` and the ``abstract_*`` builders) are not ported:
they serve a compile-only pass over a device mesh that the port does not
have yet (ROADMAP.md queue 1).  No ``Runtime``: one device.

Shape semantics (the JAX package's DESIGN.md §6):
  train_4k    -> train_step(params, opt, batch) (fwd + bwd + AdamW)
  prefill_32k -> prefill_step(params, batch) -> (logits, state)
  decode_*    -> serve_step(params, token, state, pos): ONE token against a
                 seq_len-sized KV cache / SSM state.
  long_500k   -> serve_step, sub-quadratic archs only
                 (``supports_long_decode``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig, get_shape
from repro_torch.models import api
from repro_torch.optim.adamw import AdamWConfig, adamw_update, named


def skip_reason(cfg: ArchConfig, shape: ShapeConfig) -> Optional[str]:
    """None if the pair runs; else the documented skip reason."""
    if shape.name == "long_500k" and not cfg.supports_long_decode:
        return (f"{cfg.name}: full quadratic attention; no sliding-window "
                "variant configured — sub-quadratic required for 500k decode "
                "(DESIGN.md §6)")
    if cfg.is_encoder_decoder and shape.name == "long_500k":
        return (f"{cfg.name}: enc-dec audio model; 500k-token decode is "
                "semantically undefined (max_decoder_len=448)")
    return None


def loss_and_grads(params, batch, cfg: ArchConfig):
    """(loss, {name: gradient}) of ``api.loss_fn`` at ``params`` (an
    ``nn.Module``): grad enabled here whatever the caller's mode; a
    parameter the loss does not reach gets zeros, as ``jax.grad`` gives."""
    ps = named(params)
    with torch.enable_grad():
        loss = api.loss_fn(params, batch, cfg)
        grads = torch.autograd.grad(loss, list(ps.values()),
                                    allow_unused=True)
    return loss.detach(), {n: torch.zeros_like(p) if g is None else g
                           for (n, p), g in zip(ps.items(), grads)}


def make_train_step(cfg: ArchConfig,
                    opt_cfg: AdamWConfig = AdamWConfig(lr=1e-3)):
    """train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"}): the loss and its gradients, then one AdamW
    step (optim/adamw.py) that updates the parameters and the moments in
    place."""
    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(params, batch, cfg)
        params, opt_state, gnorm = adamw_update(params, grads, opt_state,
                                                opt_cfg)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}
    return train_step


def make_prefill_step(cfg: ArchConfig):
    def prefill_step(params, batch):
        return api.prefill_fn(params, batch, cfg)
    return prefill_step


def make_decode_step(cfg: ArchConfig):
    def serve_step(params, token, state, pos):
        return api.decode_fn(params, token, state, pos, cfg)
    return serve_step


def step_fn(cfg: ArchConfig, shape_name: str):
    kind = get_shape(shape_name).kind
    if kind == "train":
        return make_train_step(cfg)
    if kind == "prefill":
        return make_prefill_step(cfg)
    return make_decode_step(cfg)
