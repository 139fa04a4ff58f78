"""Whisper-base — encoder-decoder audio model [arXiv:2212.04356].

The mel-spectrogram + conv feature-extractor frontend is a STUB:
``input_specs`` supplies precomputed frame embeddings (B, n_frames, d_model).
Whisper uses GELU MLPs and LayerNorm-style (not RMS) norms; we keep GELU and
learned-sinusoid positions on the encoder, RoPE-free absolute positions on
the decoder per the original.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,           # decoder layers
    n_encoder_layers=6,
    is_encoder_decoder=True,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=51_865,
    head_dim=64,
    mlp_type="gelu",
    max_decoder_len=448,
    source="Whisper [arXiv:2212.04356]",
)
