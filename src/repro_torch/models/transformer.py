"""Decoder-only transformer: one pre-norm block (attention + MLP or MoE),
the stack of them, and the language model over it (dense, moe and vlm
families).

The port of the JAX package's ``models/transformer.py``: ``block_init``,
``block_apply``, ``block_decode``, ``stacked_init`` and ``_scan_blocks``
(a Python loop where JAX scans), and the LM entry points
``init_lm_params``, ``lm_forward``, ``logits_of``, ``_to_ring``,
``lm_prefill``, ``init_lm_cache`` and ``lm_decode_step``, and JAX's
``Runtime`` with its default ``CPU`` and its sharding hints ``constrain``
and ``batch_spec``.  A ``Runtime`` says how the model
executes, beside the ``ArchConfig``: ``mesh`` (a ``DeviceMesh``,
launch/mesh.py), ``batch_axes``, ``model_axis`` and ``moe_mode`` pick an
MoE block's mode as JAX's ``moe_apply`` does (``moe_dense`` without a
mesh; ``moe_ep`` or ``moe_ep2d`` over the mesh's process groups,
models/moe.py); ``remat`` recomputes each block of ``_scan_blocks`` in
the backward (``torch.utils.checkpoint``, as ``jax.checkpoint``).
``use_pallas`` and ``unroll`` are accepted and change nothing: the port
always loops over the layers in Python, and a kernel follows its
tensors' device.  Every function that takes a ``runtime`` in JAX takes
one here, defaulting to ``CPU``: in JAX's position where the port's
callers pass the later arguments by keyword, and as the last keyword of
``block_apply`` and ``_scan_blocks``, whose positional arguments keep
the port's order.  A block of an MoE architecture (``n_experts`` set)
holds ``moe`` where the others hold ``mlp``.

Partitioning (every family): with
parameters laid out by sharding/specs.py ``shard_params`` and inputs by
``shard_batch`` (``DTensor``s over a ``("data", "model")`` mesh), every
function here runs on the global shapes and ``DTensor``'s sharding
propagation inserts the collectives, as XLA's SPMD pass does for JAX's
jit over ``param_specs``: Megatron tensor parallelism over "model", FSDP
over "data".  ``constrain`` pins an activation at JAX's call sites (it
redistributes a ``DTensor``; a plain tensor or a runtime without a mesh
passes through), and the kernels take their local parts through
``local_map`` (kernels/flash_attention/ops.py, kernels/ssd_scan/ops.py);
an MoE block takes its placed experts' local parts (models/moe.py).
Decode takes the inference layout (``shard_params(inference=True)``)
and a placed state: a prefill lays its state out for decode
(``decode_layout``), and each decode step pins the residual stream
where ``block_apply`` does.

Prefill runs the full-sequence blocks (attention through the flash
kernel on the card) and keeps each layer's K/V; the cache is a list of
per-layer ``{"k", "v"}`` buffers (B, Hkv, C, dh), where JAX stacks them
on a leading layer axis.
Decode is plain torch, one token against the cache, as in JAX
(models/attention.py ``decode_attention``).
Training: ``cross_entropy`` and ``lm_loss`` (the full-sequence blocks
with grad; on the card attention goes through the flash kernels' autograd
route, kernels/flash_attention/ops.py).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch import bridge
from repro_torch.configs.base import ArchConfig
from repro_torch.core import prng
from repro_torch.models import attention as attn
from repro_torch.models.layers import (dense, embed, embedding, fill_dense,
                                       fill_embedding, fill_mlp, make_mlp,
                                       mlp_apply, rmsnorm, rmsnorm_init)
from repro_torch.models.moe import MoE, fill_moe, moe_apply
from repro_torch.sharding import specs


@dataclasses.dataclass(frozen=True)
class Runtime:
    """How the model executes: JAX's ``Runtime``, field for field."""
    mesh: Any = None                  # a DeviceMesh ("data", "model") or None
    batch_axes: Any = ("data",)       # mesh axes the batch is sharded over
    model_axis: str = "model"
    moe_mode: str = "dense"           # dense | ep | ep2d (with a mesh)
    use_pallas: bool = False          # accepted; kernels follow the device
    remat: bool = False               # recompute each block in the backward
    unroll: bool = False              # accepted; the port always loops


CPU = Runtime()


def constrain(x, runtime: Optional[Runtime], spec):
    """Sharding hint, JAX's ``with_sharding_constraint``: a ``DTensor``
    and its gradient redistributed to ``spec`` sanitized against its
    shape on the runtime's mesh; a no-op for a plain tensor or
    off-mesh."""
    if runtime is None or runtime.mesh is None or \
            not isinstance(x, DTensor):
        return x
    mesh = runtime.mesh
    return specs.pin(x, specs.placements(
        specs.sanitize_spec(spec, tuple(x.shape), mesh), mesh))


def batch_spec(runtime: Runtime, extra=(None, None)):
    """The activations' spec: the batch over the runtime's batch axes,
    ``extra`` for the other dims."""
    axes = runtime.batch_axes
    return (axes if isinstance(axes, str) else tuple(axes),) + tuple(extra)


class Block(nn.Module):
    """norm1 → attention → residual, norm2 → MLP or MoE → residual (JAX
    keys norm1, attn, norm2, and mlp or moe)."""

    def __init__(self, cfg: ArchConfig, dtype, device=None):
        super().__init__()
        self.norm1 = rmsnorm_init(cfg.d_model, dtype, device)
        self.attn = attn.Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                   cfg.head_dim_, dtype, device)
        self.norm2 = rmsnorm_init(cfg.d_model, dtype, device)
        if cfg.n_experts:
            self.moe = MoE(cfg, dtype, device)
        else:
            self.mlp = make_mlp(cfg.d_model, cfg.d_ff, dtype, cfg.mlp_type,
                                device)


def fill_block(m: Block, key: torch.Tensor) -> None:
    ka, km = prng.split(key)
    attn.fill_attn(m.attn, ka)
    if hasattr(m, "moe"):
        fill_moe(m.moe, km)
    else:
        fill_mlp(m.mlp, km)


def block_init(key: torch.Tensor, cfg: ArchConfig, dtype) -> Block:
    m = Block(cfg, dtype, key.device)
    fill_block(m, key)
    return m


def block_apply(params: Block, x, cfg: ArchConfig, positions,
                window: Optional[int] = None, causal: bool = True,
                runtime: Runtime = CPU):
    """Full-sequence block (train / prefill).  Returns (x, aux, (k, v)):
    aux is the MoE router's auxiliary loss, the Python float 0.0 for an
    MLP block (no device tensor, so a dense stack adds no launch)."""
    w = cfg.sliding_window if window is None else window
    h = rmsnorm(params.norm1, x, cfg.norm_eps)
    a, kv = attn.self_attention(
        params.attn, h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim_, positions=positions, theta=cfg.rope_theta,
        fraction=cfg.rope_fraction, causal=causal, window=w, return_kv=True)
    x = constrain(x + a, runtime, batch_spec(runtime))
    h = rmsnorm(params.norm2, x, cfg.norm_eps)
    if cfg.n_experts:
        m, aux = moe_apply(params.moe, h, cfg, runtime)
    else:
        m = mlp_apply(params.mlp, h, cfg.mlp_type)
        aux = 0.0
    return constrain(x + m, runtime, batch_spec(runtime)), aux, kv


def block_decode(params: Block, x, cache, pos: int, cfg: ArchConfig,
                 runtime: Runtime = CPU):
    """One token through a block against its cache.  Returns (x, new
    cache).  Partitioned, the residual stream is pinned as in
    ``block_apply`` (where JAX leaves the layout to XLA), so the
    row-parallel outputs are all-reduced into it."""
    h = rmsnorm(params.norm1, x, cfg.norm_eps)
    a, cache = attn.decode_attention(
        params.attn, h, cache, pos, n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim_,
        theta=cfg.rope_theta, fraction=cfg.rope_fraction,
        window=cfg.sliding_window)
    x = constrain(x + a, runtime, batch_spec(runtime))
    h = rmsnorm(params.norm2, x, cfg.norm_eps)
    if cfg.n_experts:
        m, _ = moe_apply(params.moe, h, cfg, runtime)
    else:
        m = mlp_apply(params.mlp, h, cfg.mlp_type)
    return constrain(x + m, runtime, batch_spec(runtime)), cache


def stacked_init(key: torch.Tensor, layers: Sequence[nn.Module],
                 fill_fn: Callable[[nn.Module, torch.Tensor], None]) -> None:
    """Draw a stack in place: layer i from ``split(key, n)[i]``, the keys
    JAX's ``stacked_init`` vmaps its init over."""
    for layer, k in zip(layers, prng.split(key, len(layers))):
        fill_fn(layer, k)


def _scan_blocks(layers, x, cfg: ArchConfig, positions,
                 collect_kv: bool = False, window=None, causal: bool = True,
                 runtime: Runtime = CPU):
    """The blocks in order.  Returns (x, summed aux, [(k, v)] per layer
    when ``collect_kv``, else None); the aux stays the float 0.0 through
    MLP blocks.  With ``runtime.remat`` and grad enabled each block runs
    under ``checkpoint`` (its activations recomputed in the backward)."""
    aux = 0.0
    kvs = [] if collect_kv else None
    remat = runtime.remat and torch.is_grad_enabled()
    for layer in layers:
        if remat:
            x, a, kv = checkpoint(block_apply, layer, x, cfg, positions,
                                  window, causal, runtime,
                                  use_reentrant=False)
        else:
            x, a, kv = block_apply(layer, x, cfg, positions, window, causal,
                                   runtime)
        aux = aux + a
        if collect_kv:
            kvs.append(kv)
    return x, aux, kvs


# ---------------------------------------------------------------------------
# The language model
# ---------------------------------------------------------------------------


class LM(nn.Module):
    """A decoder-only LM under JAX's keys: ``embed`` (V, D), ``layers``,
    ``final_norm`` and ``unembed`` (JAX's (D, V) as an ``nn.Linear``).
    Uninitialised until ``init_lm_params`` or ``bridge.load_dit`` fills
    it."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        dtype, d = cfg.torch_dtype, cfg.d_model
        self.embed = embedding(cfg.vocab_size, d, dtype, device)
        self.layers = nn.ModuleList(Block(cfg, dtype, device)
                                    for _ in range(cfg.n_layers))
        self.final_norm = rmsnorm_init(d, dtype, device)
        self.unembed = dense(d, cfg.vocab_size, dtype, device)


def init_lm_params(key: torch.Tensor, cfg: ArchConfig) -> LM:
    """An LM on the key's device whose weights equal JAX's
    ``init_lm_params(key, cfg)`` (normals within the ulps of
    ``torch.erfinv``)."""
    ke, kl, ku = prng.split(key, 3)
    m = LM(cfg, key.device)
    fill_embedding(m.embed, ke)
    stacked_init(kl, m.layers, fill_block)
    fill_dense(m.unembed, ku)
    return m


def lm_forward(params: LM, tokens, cfg: ArchConfig, runtime: Runtime = CPU,
               embeds_prefix=None, collect_kv: bool = False):
    """tokens: (B, S) integer.  embeds_prefix: optional (B, P, D)
    prepended (VLM vision patches).  Returns (hidden (B, S[+P], D), aux,
    [(k, v)] per layer or None)."""
    x = embed(params.embed, tokens)
    if embeds_prefix is not None:
        x = torch.cat([embeds_prefix.to(x.dtype), x], dim=1)
    positions = torch.arange(x.shape[1], dtype=torch.int32,
                             device=x.device)[None]
    x = constrain(x, runtime, batch_spec(runtime))
    x, aux, kvs = _scan_blocks(params.layers, x, cfg, positions, collect_kv,
                               runtime=runtime)
    return rmsnorm(params.final_norm, x, cfg.norm_eps), aux, kvs


def logits_of(params, hidden, runtime: Runtime = CPU):
    """hidden (B, S, D) → logits (B, S, V), pinned as JAX pins them:
    batch over the batch axes, vocab over the model axis."""
    return constrain(params.unembed(hidden), runtime,
                     batch_spec(runtime, (None, runtime.model_axis)))


def _vocab_index(logits):
    """0 … V−1 laid out as the logits' last dim: cut over the mesh dims
    that cut the vocab when ``logits`` is a ``DTensor``."""
    iota = torch.arange(logits.shape[-1], device=logits.device)
    if not isinstance(logits, DTensor):
        return iota
    vocab = Shard(logits.ndim - 1)
    return specs.distribute(iota, logits.device_mesh,
                        [Shard(0) if p == vocab else Replicate()
                         for p in logits.placements])


def cross_entropy(logits, labels, mask=None):
    """logits (B, S, V), labels (B, S) integer; mask True = count (None:
    labels >= 0).  The mean of logsumexp(logits) − logits[label] over the
    counted positions, in float32, divided by max(count, 1).  The label's
    logit is taken by compare-and-sum over the vocab, which a vocab cut
    over "model" turns into a partial sum (``DTensor`` has no gather on
    a sharded dim); a sum of one value and zeros is exact, so it equals
    the gather bitwise."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    # a negative (ignored) label reads column 0; its term is masked out
    hit = labels.clamp(min=0).long()[..., None] == _vocab_index(logits)
    ll = torch.where(hit, logits, 0.0).sum(-1)
    nll = lse - ll
    mask = (labels >= 0) if mask is None else mask
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def lm_loss(params: LM, batch, cfg: ArchConfig, runtime: Runtime = CPU):
    """batch: {tokens (B, S), labels (B, S)}, labels already shifted by
    the data pipeline.  The next-token loss plus ``router_aux_coef`` times
    the MoE router's auxiliary loss."""
    hidden, aux, _ = lm_forward(params, batch["tokens"], cfg, runtime)
    loss = cross_entropy(logits_of(params, hidden, runtime),
                         batch["labels"])
    return loss + cfg.router_aux_coef * aux


def _to_ring(k, cache_len: int, seq: int):
    """Pack full-sequence K/V (B, H, S, dh) into the ring layout (B, H, C,
    dh): zero-padded when C >= S, else the last C positions rolled so
    that position p sits in slot p % C.  Placed K/V (never cut along S)
    are packed on each rank's part (``local_map``; ``DTensor``'s own pad
    fails in some torch releases' redistribution planner)."""
    if isinstance(k, DTensor):
        from torch.distributed.tensor.experimental import local_map
        return local_map(lambda t: _to_ring(t, cache_len, seq),
                         out_placements=list(k.placements),
                         in_placements=(k.placements,),
                         device_mesh=k.device_mesh)(k)
    if cache_len >= seq:
        return F.pad(k, (0, 0, 0, cache_len - seq))
    return torch.roll(k[:, :, -cache_len:, :], seq % cache_len, dims=2)


def ring_cache(kvs, cache_len: int, seq: int) -> List[dict]:
    """Per-layer (k, v) of a full sequence → the per-layer ring caches."""
    return [{"k": _to_ring(k, cache_len, seq), "v": _to_ring(v, cache_len,
                                                             seq)}
            for k, v in kvs]


def lm_prefill(params: LM, tokens, cfg: ArchConfig, runtime: Runtime = CPU,
               cache_len: Optional[int] = None, embeds_prefix=None):
    """Run the prompt; return (last-token logits (B, 1, V), the cache: a
    list of per-layer ``{"k", "v"}``)."""
    hidden, _, kvs = lm_forward(params, tokens, cfg, runtime,
                                embeds_prefix=embeds_prefix, collect_kv=True)
    S = hidden.shape[1]
    C = cache_len or attn.cache_len_for(S, cfg.sliding_window)
    return logits_of(params, hidden[:, -1:, :], runtime), \
        decode_layout(ring_cache(kvs, C, S), cfg, runtime)


def decode_layout(state, cfg: ArchConfig, runtime: Optional[Runtime]):
    """A prefill's decode state laid out for decode on the runtime's mesh
    (sharding/specs.py ``shard_decode_state``: caches by
    ``kv_cache_spec``, SSM states by ``ssm_state_specs``); a state of
    plain tensors, or off-mesh, as it is."""
    first = bridge.leaves(state)[0]
    if runtime is None or runtime.mesh is None or \
            not isinstance(first, DTensor):
        return state
    return specs.shard_decode_state(runtime.mesh, cfg, first.shape[0], state)


def init_lm_cache(cfg: ArchConfig, batch: int, seq_len: int, dtype=None,
                  device=None) -> List[dict]:
    C = attn.cache_len_for(seq_len, cfg.sliding_window)
    dtype = dtype or cfg.torch_dtype
    return [attn.init_cache(batch, cfg.n_kv_heads, C, cfg.head_dim_, dtype,
                            device) for _ in range(cfg.n_layers)]


def lm_decode_step(params: LM, token, cache, pos: int, cfg: ArchConfig,
                   runtime: Runtime = CPU):
    """token: (B, 1) integer; cache: per-layer ``{"k", "v"}``; ``pos``
    the token's position (a host int).  Returns (logits (B, 1, V), new
    cache)."""
    x = constrain(embed(params.embed, token), runtime, batch_spec(runtime))
    new_cache = []
    for layer, c in zip(params.layers, cache):
        x, c = block_decode(layer, x, c, pos, cfg, runtime)
        new_cache.append(c)
    x = rmsnorm(params.final_norm, x, cfg.norm_eps)
    return logits_of(params, x, runtime), new_cache
