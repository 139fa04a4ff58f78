"""Family-dispatched model API.

The port of the JAX package's ``models/api.py``:

  init_params(key, cfg, device)                 -> the model's module
  empty_params(cfg, device)                     -> the module, not drawn
  loss_fn(params, batch, cfg, runtime)          -> scalar loss (train_4k)
  prefill_fn(params, batch, cfg, runtime, cache_len) -> (logits, state)
  init_decode_state(cfg, batch, seq, dtype, device) -> state
  decode_fn(params, token, state, pos, cfg, runtime) -> (logits, state)

for every family: dense, moe and vlm (models/transformer.py, vlm.py),
ssm and hybrid (models/hybrid.py), and audio (whisper's encoder-decoder,
models/encdec.py: ``loss_fn`` and ``prefill_fn`` take ``frames`` as
well; ``prefill_fn`` ignores ``cache_len``, the decoder's cache is
``max_decoder_len`` long; ``init_decode_state``'s ``seq_len`` is the
encoder's length).  ``runtime`` (models/transformer.py ``Runtime``,
default ``CPU``) picks the MoE family's mode as in JAX: ``moe_dense``
without a mesh, ``moe_ep`` or ``moe_ep2d`` over a ``DeviceMesh``
(launch/shapes.py ``make_runtime`` / ``runtime_for``).  The decode state
is per-layer lists (models/transformer.py, models/hybrid.py,
models/encdec.py) where JAX stacks a leading layer axis.  Partitioned
(parameters laid out by sharding/specs.py ``shard_params``, the decode
steps' in the inference layout, ``inference=True``), ``prefill_fn``
returns its state laid out for decode and ``init_decode_state`` with a
mesh lays a zero state out alike (``shard_decode_state``); ``decode_fn``
takes it placed and returns it placed.  On the card,
``loss_fn`` under grad runs attention, the SSD scan and the MoE's
grouped matmul through their kernels' autograd routes (a backward
kernel each).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import encdec, hybrid, transformer, vlm
from repro_torch.models.transformer import CPU, Runtime
from repro_torch.sharding import specs

SSM_FAMILIES = ("ssm", "hybrid")


def init_params(key: torch.Tensor, cfg: ArchConfig, device=None):
    """The model of ``cfg``'s family on ``device`` (CUDA unless asked
    otherwise), its weights drawn there from ``key`` as JAX's
    ``init_params(key, cfg)`` draws them."""
    key = key.to(resolve_device(device))
    if cfg.family in SSM_FAMILIES:
        return hybrid.init_hybrid_params(key, cfg)
    if cfg.family == "audio":
        return encdec.init_encdec_params(key, cfg)
    return transformer.init_lm_params(key, cfg)


def empty_params(cfg: ArchConfig, device=None):
    """The module of ``cfg``'s family on ``device``, its weights not drawn
    (uninitialised; ``device="meta"`` gives the shapes and dtypes alone,
    as the dry run needs them)."""
    dev = resolve_device(device)
    if cfg.family in SSM_FAMILIES:
        return hybrid.HybridLM(cfg, dev)
    if cfg.family == "audio":
        return encdec.EncDec(cfg, dev)
    return transformer.LM(cfg, dev)


def loss_fn(params, batch: Dict, cfg: ArchConfig, runtime: Runtime = CPU):
    """The training loss of ``batch`` ({tokens, labels}, and
    vision_embeds for the vlm family, frames for the audio family), a
    0-dim float32 tensor."""
    if cfg.family in SSM_FAMILIES:
        return hybrid.hybrid_loss(params, batch, cfg, runtime)
    if cfg.family == "audio":
        return encdec.encdec_loss(params, batch, cfg, runtime)
    if cfg.family == "vlm":
        return vlm.vlm_loss(params, batch, cfg, runtime)
    return transformer.lm_loss(params, batch, cfg, runtime)


def prefill_fn(params, batch: Dict, cfg: ArchConfig, runtime: Runtime = CPU,
               cache_len=None):
    """cache_len: the KV buffer's size (prompt + decode budget).  It
    defaults to the prompt's length, i.e. no decode headroom: servers pass
    prompt_len + max_new_tokens (clipped to the sliding window if any)."""
    if cfg.family in SSM_FAMILIES:
        return hybrid.hybrid_prefill(params, batch["tokens"], cfg, runtime,
                                     cache_len=cache_len)
    if cfg.family == "audio":
        return encdec.encdec_prefill(params, batch["frames"],
                                     batch["tokens"], cfg, runtime)
    if cfg.family == "vlm":
        return vlm.vlm_prefill(params, batch, cfg, runtime,
                               cache_len=cache_len)
    return transformer.lm_prefill(params, batch["tokens"], cfg, runtime,
                                  cache_len=cache_len)


def init_decode_state(cfg: ArchConfig, batch: int, seq_len: int, dtype=None,
                      device=None, runtime: Runtime = CPU):
    """A zero decode state of ``batch`` rows for ``seq_len`` positions on
    ``device``; with a mesh in ``runtime``, laid out on it for decode
    (sharding/specs.py ``shard_decode_state``)."""
    dev = resolve_device(device)
    if cfg.family in SSM_FAMILIES:
        state = hybrid.init_hybrid_state(cfg, batch, seq_len, dtype, dev)
    elif cfg.family == "audio":
        state = encdec.init_encdec_cache(cfg, batch, seq_len, dtype, dev)
    else:
        state = transformer.init_lm_cache(cfg, batch, seq_len, dtype, dev)
    if runtime is not None and runtime.mesh is not None:
        state = specs.shard_decode_state(runtime.mesh, cfg, batch, state)
    return state


def decode_fn(params, token, state, pos: int, cfg: ArchConfig,
              runtime: Runtime = CPU):
    if cfg.family in SSM_FAMILIES:
        return hybrid.hybrid_decode_step(params, token, state, pos, cfg,
                                         runtime)
    if cfg.family == "audio":
        return encdec.encdec_decode_step(params, token, state, pos, cfg,
                                         runtime)
    return transformer.lm_decode_step(params, token, state, pos, cfg,
                                      runtime)
