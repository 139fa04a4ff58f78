"""Kimi K2 — trillion-param MoE, 384 experts top-8 [arXiv:2501.kimi2]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,          # per-expert FFN width (fine-grained experts)
    vocab_size=163_840,
    n_experts=384,
    top_k=8,
    head_dim=112,       # 7168 / 64
    rope_theta=50_000.0,
    source="Kimi K2 [arXiv:2501.kimi2] (paper-table)",
)
