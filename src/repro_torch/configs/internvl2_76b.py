"""InternVL2-76B — InternViT (stub frontend) + InternLM2/llama3-like LM
backbone [arXiv:2404.16821]. The vision tower is a STUB: ``input_specs``
supplies precomputed patch embeddings of shape (B, n_vision_tokens, d_model).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28_672,
    vocab_size=128_256,
    head_dim=128,
    rope_theta=500_000.0,
    n_vision_tokens=256,
    source="InternVL2 [arXiv:2404.16821]",
)
