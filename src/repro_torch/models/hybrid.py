"""Grouping of a Mamba2 stack around the hybrid's shared block.

From the JAX package's ``models/hybrid.py`` the DiT path needs only
``_grouping`` and ``_split_groups``: Zamba2 applies ONE shared
attention+MLP block after every ``shared_attn_every`` Mamba2 layers.
The hybrid language model (embedding, prefill, decode) comes with the LM
slice.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

from repro_torch.configs.base import ArchConfig


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
