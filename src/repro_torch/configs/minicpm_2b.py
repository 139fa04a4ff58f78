"""MiniCPM-2B — dense llama-like, WSD LR schedule [arXiv:2404.06395]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,      # MHA (GQA kv=36)
    d_ff=5760,
    vocab_size=122_753,
    head_dim=64,
    source="MiniCPM [arXiv:2404.06395] — WSD schedule",
)
