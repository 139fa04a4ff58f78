"""ChatGLM3-6B — 2d RoPE (half-dim rotary), GQA kv=2 [arXiv:2406.12793]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13_696,
    vocab_size=65_024,
    head_dim=128,
    rope_fraction=0.5,   # ChatGLM applies rotary to half of each head dim
    source="ChatGLM [arXiv:2406.12793]",
)
