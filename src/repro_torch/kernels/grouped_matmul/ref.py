"""Plain PyTorch version of the grouped-matmul kernel: the per-expert
product (E, C, D) @ (E, D, F) as one float32 einsum, cast back to the
tokens' type.  The port of the JAX package's
``kernels/grouped_matmul/ref.grouped_matmul_ref``.  The wrapper (ops.py)
takes it for CPU tensors; chip_smoke.py holds the CUDA kernel against it
on the card."""
from __future__ import annotations

import torch


def grouped_matmul_ref(tokens: torch.Tensor,
                       weights: torch.Tensor) -> torch.Tensor:
    """tokens: (E, C, D); weights: (E, D, F) -> (E, C, F)."""
    return torch.einsum("ecd,edf->ecf", tokens.float(),
                        weights.float()).to(tokens.dtype)
