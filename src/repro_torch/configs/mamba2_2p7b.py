"""Mamba2-2.7B — attention-free SSD (state-space duality) [arXiv:2405.21060]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,          # attention-free
    n_kv_heads=0,
    d_ff=0,             # no MLP; the mamba mixer is the whole block
    vocab_size=50_280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    source="Mamba2 / SSD [arXiv:2405.21060]",
)
