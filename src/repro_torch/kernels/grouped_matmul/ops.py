"""Public grouped-GEMM op: (E, C, D) @ (E, D, F) -> (E, C, F), the compute
core of the MoE expert FFN.

Routing follows the tensors' device and nothing else: CPU tensors take
the plain version (ref.py); CUDA tensors take the hand-written kernel
(kernel.py, csrc/grouped_matmul.cu) or raise.  Tokens broadcast to every
expert (an ``expand`` with expert stride 0) reach the kernel as they are,
without a copy.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.grouped_matmul import kernel
from repro_torch.kernels.grouped_matmul.ref import grouped_matmul_ref


def grouped_matmul(tokens: torch.Tensor,
                   weights: torch.Tensor) -> torch.Tensor:
    """tokens: (E, C, D); weights: (E, D, F) -> (E, C, F) in the tokens'
    type."""
    if tokens.device.type == "cpu":
        return grouped_matmul_ref(tokens, weights)
    if tokens.device.type != "cuda":
        raise ValueError(f"grouped_matmul runs on cpu or cuda, not "
                         f"{tokens.device}")
    if tokens.ndim == 3 and tokens.stride(-1) != 1:
        tokens = tokens.contiguous()
    return kernel.launch(tokens, weights.contiguous())
