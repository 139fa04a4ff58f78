"""Public SSD scan op (Mamba2 chunked scan from a zero state).

Routing follows the tensors' device and nothing else: CPU tensors take
the plain version (ref.py, the port of ``models/ssm.ssd_chunked``),
differentiable by autograd; CUDA tensors take the hand-written kernels
(kernel.py, csrc/ssd_scan.cu) or raise.  On CUDA, where autograd needs a
gradient of any input, ``SsdScanFn`` (after the casts, which autograd
differentiates) runs the forward kernel and, in the backward, the
backward kernel (csrc/ssd_scan_bwd.cu); otherwise (serving, under
``no_grad``) the forward kernel alone.

A meta tensor (the dry run, launch/dryrun.py) takes the same route as a
CUDA one, through the same ``torch.autograd.Function``; the launch then
computes nothing and returns empty outputs of the card path's shapes and
types (its operations counted in ``kernels.FLOPS``), so autograd saves
on meta exactly the tensors it saves on the card.

Placed operands (``DTensor``s of the partitioned families, models/
ssm.py) go through ``local_map``: x and dt keep their batch cut over the
batch axes and their heads over "model", A is sliced to this rank's
heads, B and C (shared by every head) stay whole on "model", and the
route above runs on this rank's part as plain tensors, so no ``DTensor``
reaches a launch.  The gradients of A (over the batch shards) and of B
and C (over the head shards) are partial sums.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels.ssd_scan import kernel
from repro_torch.kernels.ssd_scan.ref import ssd_chunked
from repro_torch.sharding import specs


class SsdScanFn(torch.autograd.Function):
    """The SSD scan on the card with a kernel for each direction.  The
    final state's gradient may be absent (training does not use the
    state): the backward kernel takes it as zero."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk: int):
        ctx.set_materialize_grads(False)
        y, final = kernel.launch(x, dt, A, B, C, chunk)
        ctx.save_for_backward(x, dt, A, B, C)
        ctx.chunk = chunk
        return y, final

    @staticmethod
    def backward(ctx, dy, dfinal):
        x, dt, A, B, C = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        grads = kernel.launch_backward(
            x, dt, A, B, C, ctx.chunk, dy,
            None if dfinal is None else dfinal.contiguous())
        return (*grads, None)


def ssd_scan(x, dt, A, B, C, chunk: int):
    """x (b, s, h, p); dt (b, s, h); A (h,); B/C (b, s, n).  Returns
    (y (b, s, h, p) in x's type, final_state (b, h, p, n) float32)."""
    if isinstance(x, DTensor):
        return _on_shards(x, dt, A, B, C, chunk)
    if x.device.type == "cpu":
        return ssd_chunked(x, dt, A, B, C, chunk)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"ssd_scan runs on cpu, cuda or meta, not "
                         f"{x.device}")
    f32 = torch.float32
    args = (x.contiguous(), dt.to(f32).contiguous(), A.to(f32).contiguous(),
            B.to(x.dtype).contiguous(), C.to(x.dtype).contiguous())
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return SsdScanFn.apply(*args, chunk)
    return kernel.launch(*args, chunk)


def _on_shards(x, dt, A, B, C, chunk: int):
    """``ssd_scan`` over placed operands: each rank's batch shard and
    heads."""
    from torch.distributed.tensor.experimental import local_map
    (x_pl, _), (a_pl, a_grad), (bc_pl, bc_grad), (final_pl, _) = \
        specs.local_map_placements(specs.mesh_kinds(x, 0, 2), (0, 2),
                                   (None, 0), (0, None), (0, 1))

    def local(x, dt, A, B, C):
        return ssd_scan(x, dt, A, B, C, chunk)

    return local_map(
        local, out_placements=(x_pl, final_pl),
        in_placements=(x_pl, x_pl, a_pl, bc_pl, bc_pl),
        in_grad_placements=(x_pl, x_pl, a_grad, bc_grad, bc_grad),
        device_mesh=x.device_mesh, redistribute_inputs=True)(x, dt, A, B, C)
