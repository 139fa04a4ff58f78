"""Zamba2-1.2B — Mamba2 backbone + shared attention blocks [arXiv:2411.15242]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,          # shared-block MLP width
    vocab_size=32_000,
    head_dim=64,
    ssm_state=64,
    ssm_head_dim=64,
    shared_attn_every=6,   # one SHARED attn+MLP block applied every 6 mamba layers
    sliding_window=8192,   # shared-attention window for long-context decode
    source="Zamba2 [arXiv:2411.15242]",
)
