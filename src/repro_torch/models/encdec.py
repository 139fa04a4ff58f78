"""Whisper-style encoder-decoder [arXiv:2212.04356].

The port of the JAX package's ``models/encdec.py``.  The mel-spectrogram
and conv frontend is the reference's stub: callers supply frame
embeddings (B, S_enc, d_model).  A bidirectional encoder over the frames
and a causal decoder with cross attention, LayerNorm and GELU MLPs,
absolute sinusoidal positions (no RoPE), each computed in float32 and
rounded to the activations' type before the add, as in JAX.

``EncDec`` holds the parameters under JAX's keys (``enc_layers``,
``enc_norm``, ``dec_layers``, ``dec_norm``, ``tok_embed``, ``unembed``;
per layer ``norm1``, ``attn`` or ``self_attn``, ``norm_x``,
``cross_attn``, ``norm2``, ``mlp``), the stacks as ``nn.ModuleList``s
where JAX stacks a layer axis.  Both self-attentions go through
``attention.self_attention``: the flash kernels on the card (the
encoder's non-causal, the decoder's causal; under grad their autograd
route with the backward kernel), the plain version on the CPU.  Cross
attention and the one-token decode step are plain torch on both devices,
as in the reference.

The decode state is a list of per-layer ``{"k", "v", "cross_k",
"cross_v"}`` where JAX stacks a leading layer axis: the self cache has
length C = ``max_decoder_len`` whatever the prompt (zero-padded when the
prompt is shorter, its last C positions when it is not; the reference
ignores ``cache_len`` and keeps no ring), and the cross K/V span every
encoder frame.  The entry points take JAX's ``runtime``
(models/transformer.py ``Runtime``): with a mesh, ``encode`` and
``decode_train`` pin the residual stream at JAX's call sites
(``constrain``), which is what a ``DTensor`` model needs; no MoE block
and no remat in these loops.  Partitioned, the vocabulary of 51,865
stays whole (``sanitize_spec``) and cross attention stays plain torch;
the prefill returns its cache laid out by ``kv_cache_spec`` (the self
and cross caches, cut by slots or frames where "model" does not divide
the K/V heads), and a decode step attends each where it lies.
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ArchConfig
from repro_torch.core import prng
from repro_torch.models import attention as attn
from repro_torch.models.layers import (GeluMLP, LayerNorm, dense, embed,
                                       embedding, fill_dense, fill_embedding, fill_mlp,
                                       gelu_mlp, layernorm, replicate_like,
                                       sinusoidal_embedding)
from repro_torch.models.transformer import (CPU, Runtime, batch_spec,
                                            constrain, cross_entropy,
                                            decode_layout, stacked_init)


def _attention(cfg: ArchConfig, dtype, device) -> attn.Attention:
    return attn.Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                          cfg.head_dim_, dtype, device)


class EncLayer(nn.Module):
    """norm1 → self-attention → residual, norm2 → GELU MLP → residual."""

    def __init__(self, cfg: ArchConfig, dtype, device=None):
        super().__init__()
        d = cfg.d_model
        self.norm1 = LayerNorm(d, dtype, device)
        self.attn = _attention(cfg, dtype, device)
        self.norm2 = LayerNorm(d, dtype, device)
        self.mlp = GeluMLP(d, cfg.d_ff, dtype, device)


class DecLayer(nn.Module):
    """norm1 → causal self-attention, norm_x → cross attention, norm2 →
    GELU MLP, each added to the residual."""

    def __init__(self, cfg: ArchConfig, dtype, device=None):
        super().__init__()
        d = cfg.d_model
        self.norm1 = LayerNorm(d, dtype, device)
        self.self_attn = _attention(cfg, dtype, device)
        self.norm_x = LayerNorm(d, dtype, device)
        self.cross_attn = _attention(cfg, dtype, device)
        self.norm2 = LayerNorm(d, dtype, device)
        self.mlp = GeluMLP(d, cfg.d_ff, dtype, device)


class EncDec(nn.Module):
    """The encoder-decoder under JAX's keys; the token embedding (V, D)
    and the unembedding (JAX's (D, V) as an ``nn.Linear``).
    Uninitialised until ``init_encdec_params`` or ``bridge.load_dit``
    fills it."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        dtype, d = cfg.torch_dtype, cfg.d_model
        self.enc_layers = nn.ModuleList(EncLayer(cfg, dtype, device)
                                        for _ in range(cfg.n_encoder_layers))
        self.enc_norm = LayerNorm(d, dtype, device)
        self.dec_layers = nn.ModuleList(DecLayer(cfg, dtype, device)
                                        for _ in range(cfg.n_layers))
        self.dec_norm = LayerNorm(d, dtype, device)
        self.tok_embed = embedding(cfg.vocab_size, d, dtype, device)
        self.unembed = dense(d, cfg.vocab_size, dtype, device)


def _attn_init(key: torch.Tensor, cfg: ArchConfig, dtype) -> attn.Attention:
    return attn.attn_init(key, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                          cfg.head_dim_, dtype)


def fill_enc_layer(m: EncLayer, key: torch.Tensor) -> None:
    ka, km = prng.split(key)
    attn.fill_attn(m.attn, ka)
    fill_mlp(m.mlp, km)


def fill_dec_layer(m: DecLayer, key: torch.Tensor) -> None:
    ka, kx, km = prng.split(key, 3)
    attn.fill_attn(m.self_attn, ka)
    attn.fill_attn(m.cross_attn, kx)
    fill_mlp(m.mlp, km)


def enc_layer_init(key: torch.Tensor, cfg: ArchConfig, dtype) -> EncLayer:
    m = EncLayer(cfg, dtype, key.device)
    fill_enc_layer(m, key)
    return m


def dec_layer_init(key: torch.Tensor, cfg: ArchConfig, dtype) -> DecLayer:
    m = DecLayer(cfg, dtype, key.device)
    fill_dec_layer(m, key)
    return m


def init_encdec_params(key: torch.Tensor, cfg: ArchConfig) -> EncDec:
    """An encoder-decoder on the key's device whose weights equal JAX's
    ``init_encdec_params(key, cfg)`` (normals within the ulps of
    ``torch.erfinv``)."""
    ke, kd, kt, ku = prng.split(key, 4)
    m = EncDec(cfg, key.device)
    stacked_init(ke, m.enc_layers, fill_enc_layer)
    stacked_init(kd, m.dec_layers, fill_dec_layer)
    fill_embedding(m.tok_embed, kt)
    fill_dense(m.unembed, ku)
    return m


def _positions(S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device)


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


def encode(params: EncDec, frames, cfg: ArchConfig,
           runtime: Runtime = CPU):
    """frames: (B, S_enc, D) stub embeddings → (B, S_enc, D)."""
    S = frames.shape[1]
    pos = _positions(S, frames.device)
    pe = sinusoidal_embedding(pos, cfg.d_model)[None].to(frames.dtype)
    x = constrain(frames + replicate_like(frames, pe), runtime,
                  batch_spec(runtime))
    for lp in params.enc_layers:
        h = layernorm(lp.norm1, x, cfg.norm_eps)
        x = x + attn.self_attention(
            lp.attn, h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.head_dim_, positions=pos[None], causal=False,
            use_rope=False)
        h = layernorm(lp.norm2, x, cfg.norm_eps)
        x = constrain(x + gelu_mlp(lp.mlp, h), runtime, batch_spec(runtime))
    return layernorm(params.enc_norm, x, cfg.norm_eps)


def encoder_cross_kv(params: EncDec, enc_out, cfg: ArchConfig):
    """Each decoder layer's cross K/V of the encoder's output: two lists
    of L tensors (B, Hkv, S_enc, dh), where JAX stacks (L, ...)."""
    kvs = [attn.encoder_kv(lp.cross_attn, enc_out, cfg.n_kv_heads,
                           cfg.head_dim_) for lp in params.dec_layers]
    return [k for k, _ in kvs], [v for _, v in kvs]


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------


def _dec_embed(params: EncDec, tokens, cfg: ArchConfig):
    x = embed(params.tok_embed, tokens)
    pos = sinusoidal_embedding(_positions(tokens.shape[1], x.device),
                               cfg.d_model)
    return x + replicate_like(x, pos[None].to(x.dtype))


def decode_train(params: EncDec, tokens, enc_out, cfg: ArchConfig,
                 runtime: Runtime = CPU, collect_kv: bool = False,
                 cross_kv=None):
    """Teacher-forced decoder pass.  tokens: (B, S_dec).  Returns (hidden
    (B, S_dec, D), [(k, v)] per layer when ``collect_kv``, else None).
    ``cross_kv`` (``encoder_cross_kv``'s lists) saves computing the cross
    K/V again; they are the same tensors either way."""
    S = tokens.shape[1]
    x = constrain(_dec_embed(params, tokens, cfg), runtime,
                  batch_spec(runtime))
    positions = _positions(S, x.device)[None]
    kvs = [] if collect_kv else None
    for i, lp in enumerate(params.dec_layers):
        h = layernorm(lp.norm1, x, cfg.norm_eps)
        a, kv = attn.self_attention(
            lp.self_attn, h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.head_dim_, positions=positions, causal=True,
            use_rope=False, return_kv=True)
        x = x + a
        h = layernorm(lp.norm_x, x, cfg.norm_eps)
        if cross_kv is None:
            ek, ev = attn.encoder_kv(lp.cross_attn, enc_out, cfg.n_kv_heads,
                                     cfg.head_dim_)
        else:
            ek, ev = cross_kv[0][i], cross_kv[1][i]
        x = x + attn.cross_attention(lp.cross_attn, h, ek, ev,
                                     n_heads=cfg.n_heads,
                                     n_kv_heads=cfg.n_kv_heads,
                                     head_dim=cfg.head_dim_)
        h = layernorm(lp.norm2, x, cfg.norm_eps)
        x = constrain(x + gelu_mlp(lp.mlp, h), runtime, batch_spec(runtime))
        if collect_kv:
            kvs.append(kv)
    return layernorm(params.dec_norm, x, cfg.norm_eps), kvs


def encdec_loss(params: EncDec, batch, cfg: ArchConfig,
                runtime: Runtime = CPU):
    """batch: frames (B, S_enc, D), tokens (B, S_dec), labels (B, S_dec)."""
    enc = encode(params, batch["frames"], cfg, runtime)
    hidden, _ = decode_train(params, batch["tokens"], enc, cfg, runtime)
    return cross_entropy(params.unembed(hidden), batch["labels"])


def _fit(t, C: int):
    """A layer's self K/V (B, H, S, dh) as the C-slot cache: zero-padded
    when S < C, else its last C positions (the reference's own layout, not
    the LM's ring: position p sits in slot p − (S − C)).  Placed K/V (never
    cut along S) are fitted on each rank's part (``local_map``), as
    models/transformer.py ``_to_ring`` packs them."""
    if isinstance(t, DTensor):
        from torch.distributed.tensor.experimental import local_map
        return local_map(lambda x: _fit(x, C),
                         out_placements=list(t.placements),
                         in_placements=(t.placements,),
                         device_mesh=t.device_mesh)(t)
    S = t.shape[2]
    return F.pad(t, (0, 0, 0, C - S)) if S < C else t[:, :, -C:]


def encdec_prefill(params: EncDec, frames, tokens, cfg: ArchConfig,
                   runtime: Runtime = CPU):
    """The encoder pass and the decoder prompt.  Returns (last-token
    logits (B, 1, V), the per-layer cache)."""
    enc = encode(params, frames, cfg, runtime)
    cross_k, cross_v = encoder_cross_kv(params, enc, cfg)
    hidden, kvs = decode_train(params, tokens, enc, cfg, runtime,
                               collect_kv=True,
                               cross_kv=(cross_k, cross_v))
    C = cfg.max_decoder_len
    cache = [{"k": _fit(k, C), "v": _fit(v, C), "cross_k": ck,
              "cross_v": cv}
             for (k, v), ck, cv in zip(kvs, cross_k, cross_v)]
    return params.unembed(hidden[:, -1:, :]), \
        decode_layout(cache, cfg, runtime)


def init_encdec_cache(cfg: ArchConfig, batch: int, enc_len: int,
                      dtype=None, device=None) -> List[dict]:
    dtype = dtype or cfg.torch_dtype
    C, dh, hkv = cfg.max_decoder_len, cfg.head_dim_, cfg.n_kv_heads
    z = lambda *s: torch.zeros(s, dtype=dtype, device=device)
    return [{"k": z(batch, hkv, C, dh), "v": z(batch, hkv, C, dh),
             "cross_k": z(batch, hkv, enc_len, dh),
             "cross_v": z(batch, hkv, enc_len, dh)}
            for _ in range(cfg.n_layers)]


def encdec_decode_step(params: EncDec, token, cache, pos: int,
                       cfg: ArchConfig, runtime: Runtime = CPU):
    """One decoder token (B, 1) against the self cache (slot pos % C) and
    the cross K/V over every encoder frame; ``pos`` a host int.  Returns
    (logits (B, 1, V), new cache); the given cache is not changed."""
    x = constrain(embed(params.tok_embed, token), runtime,
                  batch_spec(runtime))
    p = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    x = x + replicate_like(x, sinusoidal_embedding(p, cfg.d_model)[None]
                           .to(x.dtype))
    new_cache = []
    for lp, c in zip(params.dec_layers, cache):
        h = layernorm(lp.norm1, x, cfg.norm_eps)
        a, kv = attn.decode_attention(
            lp.self_attn, h, {"k": c["k"], "v": c["v"]}, pos,
            n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.head_dim_, use_rope=False)
        x = x + a
        h = layernorm(lp.norm_x, x, cfg.norm_eps)
        x = x + attn.cross_attention(lp.cross_attn, h, c["cross_k"],
                                     c["cross_v"], n_heads=cfg.n_heads,
                                     n_kv_heads=cfg.n_kv_heads,
                                     head_dim=cfg.head_dim_)
        h = layernorm(lp.norm2, x, cfg.norm_eps)
        x = constrain(x + gelu_mlp(lp.mlp, h), runtime, batch_spec(runtime))
        new_cache.append({**c, **kv})
    x = layernorm(params.dec_norm, x, cfg.norm_eps)
    return params.unembed(x), new_cache
