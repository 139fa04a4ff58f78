"""SSM language-model stacks: pure Mamba2 (mamba2-2.7b) and the
Zamba2-style hybrid — a Mamba2 backbone with ONE shared attention+MLP
block applied after every ``shared_attn_every`` layers (shared weights,
one KV cache per application).

The port of the JAX package's ``models/hybrid.py``: ``_grouping``,
``_split_groups``, ``init_hybrid_params``, ``hybrid_forward`` (with
``collect_state``), ``init_hybrid_state``, ``hybrid_prefill`` and
``hybrid_decode_step``, and ``hybrid_loss`` for training.
``shared_attn_every = 0`` gives the pure-SSM stack.  The prefill runs
each Mamba2 layer's scan through the SSD kernel and each shared block's
attention through the flash kernel on the card; decode is plain torch.

Decode state, as lists where JAX stacks: ``head`` holds G groups of g
per-layer ``{"ssm", "conv"}`` states, ``tail`` the r remaining layers',
``shared`` the G ring KV caches ``{"k", "v"}`` of the shared block's
applications.  Partitioned, the prefill returns the state laid out by
``ssm_state_specs`` and a decode step takes and returns it placed, the
residual pinned after every layer.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from repro_torch.configs.base import ArchConfig
from repro_torch.core import prng
from repro_torch.models import attention as attn
from repro_torch.models.layers import (dense, embed, embedding, fill_dense,
                                       fill_embedding, rmsnorm, rmsnorm_init)
from repro_torch.models.ssm import (Mamba, fill_mamba, mamba_decode,
                                    mamba_forward, mamba_init_state)
from repro_torch.models.transformer import (CPU, Block, Runtime, batch_spec,
                                            block_apply, block_decode,
                                            constrain, cross_entropy,
                                            decode_layout, fill_block,
                                            logits_of, ring_cache,
                                            stacked_init)


def _grouping(cfg: ArchConfig) -> Tuple[int, int, int]:
    """(group size g, number of full groups G, remainder r)."""
    g = cfg.shared_attn_every
    if g <= 0:
        return cfg.n_layers, 0, cfg.n_layers
    return g, cfg.n_layers // g, cfg.n_layers % g


def _split_groups(layers: Sequence, g: int, G: int
                  ) -> Tuple[List[List], List]:
    """The first G·g layers as G groups of g, and the remaining tail."""
    layers = list(layers)
    head = [layers[i * g:(i + 1) * g] for i in range(G)]
    return head, layers[G * g:]


class HybridLM(nn.Module):
    """JAX's keys: ``embed`` (V, D), ``mamba`` (the stack), ``final_norm``,
    ``unembed`` and, for the hybrid, the ``shared`` block.  Uninitialised
    until ``init_hybrid_params`` or ``bridge.load_dit`` fills it."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        dtype, d = cfg.torch_dtype, cfg.d_model
        self.embed = embedding(cfg.vocab_size, d, dtype, device)
        self.mamba = nn.ModuleList(Mamba(cfg, dtype, device)
                                   for _ in range(cfg.n_layers))
        self.final_norm = rmsnorm_init(d, dtype, device)
        self.unembed = dense(d, cfg.vocab_size, dtype, device)
        if cfg.shared_attn_every > 0:
            self.shared = Block(cfg, dtype, device)


def init_hybrid_params(key: torch.Tensor, cfg: ArchConfig) -> HybridLM:
    """A model on the key's device whose weights equal JAX's
    ``init_hybrid_params(key, cfg)`` (normals within the ulps of
    ``torch.erfinv``)."""
    ke, km, ks, ku = prng.split(key, 4)
    m = HybridLM(cfg, key.device)
    fill_embedding(m.embed, ke)
    stacked_init(km, m.mamba, lambda layer, k: fill_mamba(layer, k, cfg))
    fill_dense(m.unembed, ku)
    if cfg.shared_attn_every > 0:
        fill_block(m.shared, ks)
    return m


def hybrid_forward(params: HybridLM, tokens, cfg: ArchConfig,
                   runtime: Runtime = CPU, collect_state: bool = False):
    """Returns (hidden, states | None, shared_kvs | None): with
    ``collect_state`` the Mamba2 layers' decode states ``{"head",
    "tail"}`` and each shared application's full-sequence (k, v)."""
    x = embed(params.embed, tokens)
    S = x.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None]
    x = constrain(x, runtime, batch_spec(runtime))
    g, G, _ = _grouping(cfg)
    head, tail = _split_groups(params.mamba, g, G)

    def mamba_group(x, layers):
        states = []
        for layer in layers:
            if collect_state:
                x, st = mamba_forward(layer, x, cfg, return_state=True)
                states.append(st)
            else:
                x = mamba_forward(layer, x, cfg)
        return x, states

    head_states, shared_kvs = [], []
    for group in head:
        x, st = mamba_group(x, group)
        x, _, kv = block_apply(params.shared, x, cfg, positions,
                               runtime=runtime)
        head_states.append(st)
        shared_kvs.append(kv)
    x, tail_states = mamba_group(x, tail)
    x = rmsnorm(params.final_norm, x, cfg.norm_eps)
    if not collect_state:
        return x, None, None
    return x, {"head": head_states, "tail": tail_states}, \
        (shared_kvs if G > 0 else None)


def hybrid_loss(params: HybridLM, batch, cfg: ArchConfig,
                runtime: Runtime = CPU):
    """The next-token loss of batch {tokens, labels}."""
    hidden, _, _ = hybrid_forward(params, batch["tokens"], cfg, runtime)
    return cross_entropy(logits_of(params, hidden, runtime),
                         batch["labels"])


def init_hybrid_state(cfg: ArchConfig, batch: int, seq_len: int, dtype=None,
                      device=None) -> dict:
    dtype = dtype or cfg.torch_dtype
    g, G, r = _grouping(cfg)
    one = lambda: mamba_init_state(cfg, batch, dtype, device)
    state = {"head": [[one() for _ in range(g)] for _ in range(G)],
             "tail": [one() for _ in range(r)]}
    if cfg.shared_attn_every > 0:
        C = attn.cache_len_for(seq_len, cfg.sliding_window)
        state["shared"] = [attn.init_cache(batch, cfg.n_kv_heads, C,
                                           cfg.head_dim_, dtype, device)
                           for _ in range(G)]
    return state


def hybrid_prefill(params: HybridLM, tokens, cfg: ArchConfig,
                   runtime: Runtime = CPU, cache_len: Optional[int] = None):
    """Run the prompt; return (last-token logits (B, 1, V), decode
    state)."""
    hidden, states, shared_kvs = hybrid_forward(params, tokens, cfg, runtime,
                                                collect_state=True)
    S = tokens.shape[1]
    state = dict(states)
    if cfg.shared_attn_every > 0:
        C = cache_len or attn.cache_len_for(S, cfg.sliding_window)
        state["shared"] = ring_cache(shared_kvs, C, S)
    return logits_of(params, hidden[:, -1:, :], runtime), \
        decode_layout(state, cfg, runtime)


def hybrid_decode_step(params: HybridLM, token, state, pos: int,
                       cfg: ArchConfig, runtime: Runtime = CPU):
    """token: (B, 1); ``state`` from ``init_hybrid_state`` or a prefill;
    ``pos`` the token's position (a host int).  Returns (logits (B, 1,
    V), new state); the given state is not changed."""
    x = constrain(embed(params.embed, token), runtime, batch_spec(runtime))
    g, G, _ = _grouping(cfg)
    head, tail = _split_groups(params.mamba, g, G)

    def mamba_group(x, layers, states):
        new = []
        for layer, st in zip(layers, states, strict=True):
            x, st = mamba_decode(layer, x, st, cfg)
            x = constrain(x, runtime, batch_spec(runtime))
            new.append(st)
        return x, new

    new_state = dict(state)
    if G > 0:
        hs, skv = [], []
        for group, gs, kv in zip(head, state["head"], state["shared"],
                                 strict=True):
            x, gs = mamba_group(x, group, gs)
            x, kv = block_decode(params.shared, x, kv, pos, cfg, runtime)
            hs.append(gs)
            skv.append(kv)
        new_state["head"], new_state["shared"] = hs, skv
    x, new_state["tail"] = mamba_group(x, tail, state["tail"])
    x = rmsnorm(params.final_norm, x, cfg.norm_eps)
    return logits_of(params, x, runtime), new_state
