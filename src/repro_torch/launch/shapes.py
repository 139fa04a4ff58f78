"""Step functions for every (architecture × input shape) pair.

The port of the step builders of the JAX package's ``launch/shapes.py``:
``make_runtime`` and ``runtime_for`` (the ``Runtime`` of a mesh: MoE
training and prefill expert-parallel, ``moe_ep``; MoE decode in the 2-D
inference layout, ``moe_ep2d``), ``make_train_step`` (value and grad of
``api.loss_fn``, then AdamW), ``make_prefill_step``, ``make_decode_step``,
``step_fn`` and ``skip_reason``.  Each step builder takes the
``runtime`` as its last argument, defaulting to ``CPU`` (no mesh, MoE
dense), where JAX's takes it second.

The dry run's stand-ins (``input_specs`` and the ``abstract_*``
builders, launch/dryrun.py) are meta tensors.  ``abstract_params``
builds the model on the ``meta`` device without drawing its weights
(``api.empty_params``) and attaches each parameter's sanitized spec
(sharding/specs.py) as ``.spec``; the other operands come from
``specs.with_sharding``: meta tensors of the global shapes, each with
its ``.spec``.  The dry run lays every pair's operands out from them as
``DTensor``s (sharding/specs.py ``shard_params``, ``shard_batch``,
``shard_decode_state``; launch/dryrun.py ``placed_operands``), a decode
pair's parameters in the inference layout.  Token ids are int32, as in
JAX's stand-ins.  A decode step's position is a host int, as the port's
decode steps take it.

Shape semantics (the JAX package's DESIGN.md §6):
  train_4k    -> train_step(params, opt, batch) (fwd + bwd + AdamW)
  prefill_32k -> prefill_step(params, batch) -> (logits, state)
  decode_*    -> serve_step(params, token, state, pos): ONE token against a
                 seq_len-sized KV cache / SSM state.
  long_500k   -> serve_step, sub-quadratic archs only
                 (``supports_long_decode``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

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


def shape_of(shape) -> ShapeConfig:
    """A ``ShapeConfig`` from its name, or the config itself."""
    return get_shape(shape) if isinstance(shape, str) else shape


def runtime_for(cfg: ArchConfig, shape_name, mesh) -> Runtime:
    """Decode steps of MoE archs use the 2-D inference layout (weights
    stationary, tokens move: ``moe_ep2d``); training and prefill
    ``moe_ep``."""
    kind = shape_of(shape_name).kind
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


# ---------------------------------------------------------------------------
# abstract inputs (meta tensors with their specs)
# ---------------------------------------------------------------------------


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def abstract_params(cfg: ArchConfig, mesh, inference: bool = False):
    """The model of ``cfg`` on the meta device, not drawn, each parameter
    carrying its sanitized spec as ``.spec``."""
    model = api.empty_params(cfg, "meta")
    specs = S.param_specs(model, inference)
    for name, p in model.named_parameters():
        p.spec = S.sanitize_spec(specs[name], p.shape, mesh)
    return model


def abstract_opt_state(cfg: ArchConfig, mesh, abs_params) -> Dict:
    """The AdamW state of ``abs_params`` (optim/adamw.init_opt_state:
    float32 moments, a 0-dim int32 host step) with the parameters' specs
    (the training layout)."""
    del cfg
    specs = S.param_specs(abs_params)
    moments = {n: _meta(p.shape, torch.float32)
               for n, p in abs_params.named_parameters()}
    out = S.with_sharding({"m": moments, "v": moments},
                          {"m": specs, "v": specs}, mesh)
    out["step"] = torch.zeros((), dtype=torch.int32)
    out["step"].spec = ()
    return out


def abstract_batch(cfg: ArchConfig, shape: ShapeConfig, mesh) -> Dict:
    """Training / prefill batch stand-ins: audio frames with the decoder
    tokens cut to ``max_decoder_len``; a VLM's text and vision
    embeddings."""
    B, Sq = shape.global_batch, shape.seq_len
    bs = lambda trailing: S.batch_spec_for(mesh, B, trailing)
    i32, dt = torch.int32, cfg.torch_dtype
    if cfg.family == "audio":
        dec = min(cfg.max_decoder_len, Sq)
        tree = {"frames": _meta((B, Sq, cfg.d_model), dt),
                "tokens": _meta((B, dec), i32),
                "labels": _meta((B, dec), i32)}
        specs = {"frames": bs(2), "tokens": bs(1), "labels": bs(1)}
    elif cfg.family == "vlm":
        text = Sq - cfg.n_vision_tokens
        tree = {"tokens": _meta((B, text), i32),
                "labels": _meta((B, text), i32),
                "vision_embeds": _meta((B, cfg.n_vision_tokens,
                                        cfg.d_model), dt)}
        specs = {"tokens": bs(1), "labels": bs(1), "vision_embeds": bs(2)}
    else:
        tree = {"tokens": _meta((B, Sq), i32), "labels": _meta((B, Sq), i32)}
        specs = {"tokens": bs(1), "labels": bs(1)}
    return S.with_sharding(tree, specs, mesh)


def abstract_decode_state(cfg: ArchConfig, shape: ShapeConfig, mesh):
    """The decode state of ``shape`` (the port's per-layer lists) with
    the cache and state specs."""
    B, Sq = shape.global_batch, shape.seq_len
    st = api.init_decode_state(cfg, B, Sq, device="meta")
    return S.with_sharding(st, S.decode_state_specs(mesh, cfg, B, st), mesh)


def input_specs(cfg: ArchConfig, shape_name, mesh) -> Tuple[Any, ...]:
    """Abstract arguments of the pair's step function (``step_fn``):
    train (params, opt_state, batch); prefill (params, batch); decode
    (params in the inference layout, token, state, pos), each leaf with
    the spec its placed counterpart takes: ``param_specs`` (with
    ``inference=True`` at decode: JAX's ``_drop_data``, the MoE experts
    by ``_RULES_3D_MOE_INFER``), ``batch_spec_for``,
    ``decode_state_specs``.  ``shape_name`` names a ``ShapeConfig`` or
    is one."""
    shape = shape_of(shape_name)
    if shape.kind == "train":
        params = abstract_params(cfg, mesh)
        return (params, abstract_opt_state(cfg, mesh, params),
                abstract_batch(cfg, shape, mesh))
    if shape.kind == "prefill":
        return (abstract_params(cfg, mesh), abstract_batch(cfg, shape, mesh))
    B = shape.global_batch
    params = abstract_params(cfg, mesh, inference=True)
    token = S.with_sharding(_meta((B, 1), torch.int32),
                            S.batch_spec_for(mesh, B, 1), mesh)
    return (params, token, abstract_decode_state(cfg, shape, mesh),
            shape.seq_len - 1)


def loss_and_grads(params, batch, cfg: ArchConfig, runtime: Runtime = CPU):
    """(loss, {name: gradient}) of ``api.loss_fn`` at ``params`` (an
    ``nn.Module``): grad enabled here whatever the caller's mode; a
    parameter the loss does not reach gets zeros, as ``jax.grad`` gives.
    Partitioned (``DTensor`` parameters, sharding/specs.py
    ``shard_params``, and a batch placed by ``shard_batch``), each
    gradient is redistributed to its parameter's placements (a partial
    sum over "data" reduce-scattered: FSDP's gradient) and the loss comes
    back whole, a plain tensor."""
    ps = named(params)
    with torch.enable_grad():
        loss = api.loss_fn(params, batch, cfg, runtime)
        grads = torch.autograd.grad(loss, list(ps.values()),
                                    allow_unused=True)
    out = {}
    for (n, p), g in zip(ps.items(), grads):
        if g is None:
            g = torch.zeros_like(p)
        elif isinstance(g, DTensor) and g.placements != p.placements:
            g = g.redistribute(p.device_mesh, p.placements)
        out[n] = g
    if isinstance(loss, DTensor):
        loss = loss.full_tensor()
    return loss.detach(), out


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


def step_fn(cfg: ArchConfig, shape_name, runtime: Runtime = CPU):
    kind = shape_of(shape_name).kind
    if kind == "train":
        return make_train_step(cfg, runtime=runtime)
    if kind == "prefill":
        return make_prefill_step(cfg, runtime)
    return make_decode_step(cfg, runtime)
