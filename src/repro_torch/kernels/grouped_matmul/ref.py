"""Plain PyTorch versions of the grouped-matmul kernels: the per-expert
product (E, C, D) @ (E, D, F) as one float32 einsum, cast back to the
tokens' type (the port of the JAX package's
``kernels/grouped_matmul/ref.grouped_matmul_ref``), and its backward's
algorithm, ``grouped_matmul_bwd_ref``.  The wrapper (ops.py) takes the
forward for CPU tensors, where autograd differentiates it; chip_smoke.py
holds the CUDA kernels against both on the card."""
from __future__ import annotations

from typing import Tuple

import torch


def grouped_matmul_ref(tokens: torch.Tensor,
                       weights: torch.Tensor) -> torch.Tensor:
    """tokens: (E, C, D); weights: (E, D, F) -> (E, C, F)."""
    return torch.einsum("ecd,edf->ecf", tokens.float(),
                        weights.float()).to(tokens.dtype)


def grouped_matmul_bwd_ref(tokens: torch.Tensor, weights: torch.Tensor,
                           dout: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradients of ``grouped_matmul_ref`` for ``dout`` (E, C, F):
    (dtokens (E, C, D) = dY·Wᵀ per expert, one slab per expert also for
    broadcast tokens; dweights (E, D, F) = Xᵀ·dY, a sum over the C rows),
    each in float32 and cast once to the inputs' type."""
    t, w, g = tokens.float(), weights.float(), dout.float()
    dtok = torch.einsum("ecf,edf->ecd", g, w)
    dw = torch.einsum("ecd,ecf->edf", t, g)
    return dtok.to(tokens.dtype), dw.to(weights.dtype)
