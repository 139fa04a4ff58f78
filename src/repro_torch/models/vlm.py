"""VLM wrapper (internvl2-76b): vision-tower stub + LM backbone.

The port of the JAX package's ``models/vlm.py`` for serving: the caller
supplies precomputed patch embeddings (B, n_vision_tokens, d_model) — the
vision tower is the reference's one allowed stub — which the dense stack
of models/transformer.py takes as a prefix.  ``vlm_loss`` comes with LM
training.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import lm_prefill


def vlm_prefill(params, batch, cfg: ArchConfig, cache_len=None):
    """batch: tokens (B, S_text), vision_embeds (B, P, D)."""
    return lm_prefill(params, batch["tokens"], cfg, cache_len=cache_len,
                      embeds_prefix=batch["vision_embeds"])
