"""Public attention op for full-sequence attention.

Routing follows the tensors' device and nothing else: CPU tensors take
the plain version (ref.py), differentiable by autograd; CUDA tensors take
the hand-written kernels (kernel.py, csrc/flash_attention.cu) or raise.
On CUDA, where autograd needs a gradient of q, k or v,
``FlashAttentionFn`` runs the forward kernel with its log-sum-exp output
and, in the backward, the backward kernel (csrc/flash_attention_bwd.cu);
otherwise (serving, under ``no_grad``) the forward kernel alone.  Same
contract as the JAX package's ``kernels/flash_attention/ops.
flash_attention``: ``window`` applies whether or not ``causal`` is set.

A meta tensor (the dry run, launch/dryrun.py) takes the same route as a
CUDA one, through the same ``torch.autograd.Function``; the launch then
computes nothing and returns empty outputs of the card path's shapes and
types (its operations counted in ``kernels.FLOPS``), so autograd saves
on meta exactly the tensors it saves on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ref import attention_ref


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention on the card with a kernel for each direction."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        B, H, S, _ = q.shape
        lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
        out = kernel.launch(q, k, v, causal, window, lse=lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = kernel.launch_backward(q, k, v, out, dout.contiguous(),
                                            lse, ctx.causal, ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, H, S, dh); k/v: (B, Hkv, S, dh).  Returns (B, H, S, dh) in
    q's type."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention runs on cpu, cuda or meta, not "
                         f"{q.device}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFn.apply(q, k, v, causal, window)
    return kernel.launch(q, k, v, causal, window)
