"""Granite-8B-Code — llama-arch dense code model [arXiv:2405.04324].

Carries the sliding-window attention variant (window 8192) used to
demonstrate the dense-arch path for the ``long_500k`` decode shape
(see DESIGN.md §6).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14_336,
    vocab_size=49_152,
    head_dim=128,
    rope_theta=10_000_000.0,
    sliding_window=8192,
    source="Granite Code [arXiv:2405.04324]",
)
