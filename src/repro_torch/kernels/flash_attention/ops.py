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

Placed operands (``DTensor``s of the partitioned families, models/
transformer.py) go through ``local_map``: the batch stays cut over the
batch axes and the heads over "model", and the route above runs on this
rank's part as plain tensors, so no ``DTensor`` reaches a launch.  Where
the query heads are cut and the K/V heads are not (GQA with fewer K/V
heads than ranks), each rank reads the K/V heads of its own query heads,
and their gradients are partial sums over the ranks.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Shard

from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.sharding import specs


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
    if isinstance(q, DTensor):
        return on_local_heads(
            lambda q, k, v: flash_attention(q, k, v, causal, window),
            q, k, v)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention runs on cpu, cuda or meta, not "
                         f"{q.device}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFn.apply(q, k, v, causal, window)
    return kernel.launch(q, k, v, causal, window)


def on_local_heads(fn, q, k, v):
    """``fn(q, k, v)``, an attention over (B, H, Sq, dh) queries and (B,
    Hkv, Sk, dh) keys and values, over placed q, k, v through
    ``local_map``: ``fn`` sees each rank's batch shard and query heads,
    with the K/V heads they read, as plain tensors, and its output is
    placed as q."""
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    kinds = specs.mesh_kinds(q, 0, 1)
    heads = [d for d, kind in enumerate(kinds) if kind == "cut"]
    kv_cut = all(k.placements[d] == Shard(1) for d in heads)
    (q_pl, _), (kv_pl, kv_grad) = specs.local_map_placements(
        kinds, (0, 1), (0, 1 if kv_cut else None))
    pick = None
    if not kv_cut:
        if len(heads) > 1:
            raise ValueError("on_local_heads: query heads cut over two "
                             "mesh dims with whole K/V heads")
        d = heads[0]
        h, g = q.shape[1] // mesh.size(d), q.shape[1] // k.shape[1]
        if g % h and h % g:
            raise ValueError(f"on_local_heads: {h} query heads a rank "
                             f"in groups of {g}")
        first = mesh.get_local_rank(d) * h
        pick = slice(first // g, (first + h - 1) // g + 1)

    def local(q, k, v):
        if pick is not None:
            k, v = k[:, pick], v[:, pick]
        return fn(q, k, v)

    return local_map(local, out_placements=q_pl,
                     in_placements=(q_pl, kv_pl, kv_pl),
                     in_grad_placements=(q_pl, kv_grad, kv_grad),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v)
