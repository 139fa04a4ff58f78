"""VLM wrapper (internvl2-76b): vision-tower stub + LM backbone.

The port of the JAX package's ``models/vlm.py``: the caller supplies
precomputed patch embeddings (B, n_vision_tokens, d_model) — the vision
tower is the reference's one allowed stub — which the dense stack of
models/transformer.py takes as a prefix.  The loss drops the P vision
positions before the logits, so labels cover the text alone.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import (CPU, Runtime, cross_entropy,
                                            lm_forward, lm_prefill, logits_of)


def vlm_loss(params, batch, cfg: ArchConfig, runtime: Runtime = CPU):
    """batch: tokens (B, S_text), vision_embeds (B, P, D), labels (B,
    S_text)."""
    hidden, aux, _ = lm_forward(params, batch["tokens"], cfg, runtime,
                                embeds_prefix=batch["vision_embeds"])
    P = batch["vision_embeds"].shape[1]
    logits = logits_of(params, hidden[:, P:, :], runtime)
    return cross_entropy(logits, batch["labels"]) + cfg.router_aux_coef * aux


def vlm_prefill(params, batch, cfg: ArchConfig, runtime: Runtime = CPU,
                cache_len=None):
    """batch: tokens (B, S_text), vision_embeds (B, P, D)."""
    return lm_prefill(params, batch["tokens"], cfg, runtime,
                      cache_len=cache_len,
                      embeds_prefix=batch["vision_embeds"])
