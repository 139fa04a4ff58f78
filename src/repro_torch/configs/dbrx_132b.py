"""DBRX-132B — 16-expert top-4 fine-grained MoE [hf:databricks/dbrx-base]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10_752,        # per-expert FFN width
    vocab_size=100_352,
    n_experts=16,
    top_k=4,
    head_dim=128,
    rope_theta=500_000.0,
    source="DBRX [hf:databricks/dbrx-base]",
)
