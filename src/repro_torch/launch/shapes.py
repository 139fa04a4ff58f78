"""Step functions for every (architecture × input shape) pair.

The port of the step builders of the JAX package's ``launch/shapes.py``:
``make_runtime`` and ``runtime_for`` (the ``Runtime`` of a mesh: MoE
training and prefill expert-parallel, ``moe_ep``; MoE decode in the 2-D
inference layout, ``moe_ep2d``), ``make_train_step`` (value and grad of
``api.loss_fn``, then AdamW), ``make_prefill_step``, ``make_decode_step``,
``step_fn`` and ``skip_reason``.  Each step builder takes the
``runtime`` as its last argument, defaulting to ``CPU`` (no mesh, MoE
dense), where JAX's takes it second.  The ``ShapeDtypeStruct`` stand-ins
and shardings of the dry-run (``input_specs`` and the ``abstract_*``
builders) are not ported: they serve a compile-only pass over a
512-device mesh (ROADMAP.md queue 1, layout and dryrun).

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
from repro_torch.models.transformer import CPU, Runtime
from repro_torch.optim.adamw import AdamWConfig, adamw_update, named
from repro_torch.sharding import specs as S


def make_runtime(mesh, moe_mode: str = "ep") -> Runtime:
    """The ``Runtime`` of ``mesh`` (launch/mesh.py): the batch over its
    batch axes, MoE in ``moe_mode``."""
    return Runtime(mesh=mesh, batch_axes=S.mesh_batch_axes(mesh),
                   moe_mode=moe_mode)


def runtime_for(cfg: ArchConfig, shape_name: str, mesh) -> Runtime:
    """Decode steps of MoE archs use the 2-D inference layout (weights
    stationary, tokens move: ``moe_ep2d``); training and prefill
    ``moe_ep``."""
    kind = get_shape(shape_name).kind
    mode = "ep2d" if (cfg.n_experts and kind == "decode") else "ep"
    return make_runtime(mesh, moe_mode=mode)


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


def loss_and_grads(params, batch, cfg: ArchConfig, runtime: Runtime = CPU):
    """(loss, {name: gradient}) of ``api.loss_fn`` at ``params`` (an
    ``nn.Module``): grad enabled here whatever the caller's mode; a
    parameter the loss does not reach gets zeros, as ``jax.grad`` gives."""
    ps = named(params)
    with torch.enable_grad():
        loss = api.loss_fn(params, batch, cfg, runtime)
        grads = torch.autograd.grad(loss, list(ps.values()),
                                    allow_unused=True)
    return loss.detach(), {n: torch.zeros_like(p) if g is None else g
                           for (n, p), g in zip(ps.items(), grads)}


def make_train_step(cfg: ArchConfig,
                    opt_cfg: AdamWConfig = AdamWConfig(lr=1e-3),
                    runtime: Runtime = CPU):
    """train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"}): the loss and its gradients, then one AdamW
    step (optim/adamw.py) that updates the parameters and the moments in
    place."""
    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(params, batch, cfg, runtime)
        params, opt_state, gnorm = adamw_update(params, grads, opt_state,
                                                opt_cfg)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}
    return train_step


def make_prefill_step(cfg: ArchConfig, runtime: Runtime = CPU):
    def prefill_step(params, batch):
        return api.prefill_fn(params, batch, cfg, runtime)
    return prefill_step


def make_decode_step(cfg: ArchConfig, runtime: Runtime = CPU):
    def serve_step(params, token, state, pos):
        return api.decode_fn(params, token, state, pos, cfg, runtime)
    return serve_step


def step_fn(cfg: ArchConfig, shape_name: str, runtime: Runtime = CPU):
    kind = get_shape(shape_name).kind
    if kind == "train":
        return make_train_step(cfg, runtime=runtime)
    if kind == "prefill":
        return make_prefill_step(cfg, runtime)
    return make_decode_step(cfg, runtime)
