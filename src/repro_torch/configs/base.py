"""Architecture configurations and their registry.

The port's copy of the JAX package's ``configs/base.py`` (which imports
``jax.numpy`` and so cannot be shared): the same ``ArchConfig`` schema and
field defaults, ``get_arch`` with the same dashed aliases, ``reduced``
with the same CPU-test overrides, and the input shapes (``ShapeConfig``,
``SHAPES``, ``get_shape``).  ``torch_dtype`` takes the place of
``jnp_dtype``.  Every ``configs/<id>.py`` of the JAX package has a copy
here exporting the same ``CONFIG``; ``all_archs`` lists them, and
``n_params`` / ``n_active_params`` are the reference's analytic counts
(norms excluded).
"""
from __future__ import annotations

import dataclasses
import importlib

import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """Static architecture description (one per assigned architecture)."""

    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    source: str = ""  # citation (paper / model card)

    # --- attention ---
    head_dim: int = 0  # 0 -> d_model // n_heads
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0  # chatglm3 applies RoPE to half the head dim
    sliding_window: int = 0  # 0 = full attention
    mlp_type: str = "swiglu"  # swiglu | gelu

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # --- SSM (mamba2 / hybrid) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_kernel: int = 4
    ssm_chunk: int = 256

    # --- hybrid (zamba2) ---
    shared_attn_every: int = 0  # apply ONE shared attn+mlp block every N layers

    # --- encoder-decoder (whisper) ---
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    max_decoder_len: int = 448

    # --- VLM ---
    n_vision_tokens: int = 0  # prefix patch embeddings (frontend is a stub)

    # --- numerics ---
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5

    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32,
                "float16": torch.float16}[self.dtype]

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_n_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_decode(self) -> bool:
        """True if a 500k-token decode is sub-quadratic / bounded-memory."""
        if self.family in ("ssm", "hybrid"):
            return True     # the hybrid's shared attention has a window
        return self.sliding_window > 0

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs are decoders or enc-dec

    def n_params(self) -> int:
        """Analytic parameter count (the roofline's MODEL_FLOPS): the
        projections, MLPs or experts, embedding and unembedding, and for
        the encoder-decoder the encoder's layers and the cross
        attention; norms are not counted."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        dh, h, hkv = self.head_dim_, self.n_heads, self.n_kv_heads
        attn = d * h * dh + 2 * d * hkv * dh + h * dh * d
        if self.family in ("ssm", "hybrid"):
            per_layer = _ssm_layer_params(self)
        elif self.n_experts:
            per_layer = attn + d * self.n_experts + self.n_experts * 3 * d * f
        else:
            mlp = 3 * d * f if self.mlp_type == "swiglu" else 2 * d * f
            per_layer = attn + mlp
        total = self.n_layers * per_layer + 2 * v * d
        if self.family == "hybrid" and self.shared_attn_every:
            mlp = 3 * d * f if self.mlp_type == "swiglu" else 2 * d * f
            total += attn + mlp  # one shared block
        if self.is_encoder_decoder:
            mlp = 2 * d * f
            total += self.n_encoder_layers * (attn + mlp)
            total += self.n_layers * attn  # cross attention
        return total

    def n_active_params(self) -> int:
        """Active params per token (MoE: top_k experts instead of all)."""
        if not self.n_experts:
            return self.n_params()
        d, f = self.d_model, self.d_ff
        dh, h, hkv = self.head_dim_, self.n_heads, self.n_kv_heads
        attn = d * h * dh + 2 * d * hkv * dh + h * dh * d
        per_layer = attn + d * self.n_experts + self.top_k * 3 * d * f
        return self.n_layers * per_layer + 2 * self.vocab_size * d


def _ssm_layer_params(cfg: ArchConfig) -> int:
    d = cfg.d_model
    di = cfg.ssm_d_inner
    n = cfg.ssm_state
    h = cfg.ssm_n_heads
    # in_proj -> (z, x, B, C, dt), conv, out_proj
    in_proj = d * (2 * di + 2 * n + h)
    conv = cfg.ssm_conv_kernel * (di + 2 * n)
    out = di * d
    return in_proj + conv + out + 2 * h  # + A, D per head


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


ARCH_IDS = (
    "kimi_k2_1t_a32b",
    "minicpm_2b",
    "zamba2_1p2b",
    "internvl2_76b",
    "minitron_4b",
    "dbrx_132b",
    "whisper_base",
    "granite_8b",
    "mamba2_2p7b",
    "chatglm3_6b",
)

# accepted aliases (the dashed forms of the assignment table)
_ALIASES = {
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "minicpm-2b": "minicpm_2b",
    "zamba2-1.2b": "zamba2_1p2b",
    "internvl2-76b": "internvl2_76b",
    "minitron-4b": "minitron_4b",
    "dbrx-132b": "dbrx_132b",
    "whisper-base": "whisper_base",
    "granite-8b": "granite_8b",
    "mamba2-2.7b": "mamba2_2p7b",
    "chatglm3-6b": "chatglm3_6b",
}


def get_arch(name: str) -> ArchConfig:
    mod_name = _ALIASES.get(name, name).replace("-", "_").replace(".", "p")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def all_archs():
    return [get_arch(a) for a in ARCH_IDS]


def reduced(cfg: ArchConfig, **overrides) -> ArchConfig:
    """Reduced variant of the same family for CPU tests: 2 layers,
    d_model 128, <= 4 experts, small vocab, float32."""
    small = dict(
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2)) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        dtype="float32",
    )
    if cfg.n_experts:
        small.update(n_experts=4, top_k=2)
    if cfg.ssm_state:
        small.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=16)
    if cfg.shared_attn_every:
        small.update(shared_attn_every=1, n_layers=3)
    if cfg.is_encoder_decoder:
        small.update(n_encoder_layers=2, max_decoder_len=16)
    if cfg.n_vision_tokens:
        small.update(n_vision_tokens=8)
    if cfg.sliding_window:
        small.update(sliding_window=16)
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
