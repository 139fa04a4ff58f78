"""Public grouped-GEMM op: (E, C, D) @ (E, D, F) -> (E, C, F), the compute
core of the MoE expert FFN.

Routing follows the tensors' device and nothing else: CPU tensors take
the plain version (ref.py), differentiable by autograd; CUDA tensors take
the hand-written kernel (kernel.py, csrc/grouped_matmul.cu) or raise.
On CUDA, where autograd needs a gradient of the tokens or the weights,
``GroupedMatmulFn`` runs the forward kernel and, in the backward, the
backward kernel (csrc/grouped_matmul_bwd.cu); otherwise (serving, under
``no_grad``) the forward kernel alone.  Tokens broadcast to every expert
(an ``expand`` with expert stride 0) reach the kernels as they are,
without a copy; their gradient comes back one slab per expert and the
``expand``'s own backward sums it.

A meta tensor (the dry run, launch/dryrun.py) takes the same route as a
CUDA one, through the same ``torch.autograd.Function``; the launch then
computes nothing and returns empty outputs of the card path's shapes and
types (its operations counted in ``kernels.FLOPS``), so autograd saves
on meta exactly the tensors it saves on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.grouped_matmul import kernel
from repro_torch.kernels.grouped_matmul.ref import grouped_matmul_ref


class GroupedMatmulFn(torch.autograd.Function):
    """The grouped matmul on the card with a kernel for each direction."""

    @staticmethod
    def forward(ctx, tokens, weights):
        out = kernel.launch(tokens, weights)     # grad is off in here
        ctx.save_for_backward(tokens, weights)
        return out

    @staticmethod
    def backward(ctx, dout):
        tokens, weights = ctx.saved_tensors
        dtok, dw = kernel.launch_backward(tokens, weights, dout.contiguous())
        return (dtok if ctx.needs_input_grad[0] else None,
                dw if ctx.needs_input_grad[1] else None)


def grouped_matmul(tokens: torch.Tensor,
                   weights: torch.Tensor) -> torch.Tensor:
    """tokens: (E, C, D); weights: (E, D, F) -> (E, C, F) in the tokens'
    type."""
    if tokens.device.type == "cpu":
        return grouped_matmul_ref(tokens, weights)
    if tokens.device.type not in ("cuda", "meta"):
        raise ValueError(f"grouped_matmul runs on cpu, cuda or meta, not "
                         f"{tokens.device}")
    if tokens.ndim == 3 and tokens.stride(-1) != 1:
        tokens = tokens.contiguous()
    weights = weights.contiguous()
    if torch.is_grad_enabled() and (tokens.requires_grad or
                                    weights.requires_grad):
        return GroupedMatmulFn.apply(tokens, weights)
    return kernel.launch(tokens, weights)
