"""The route that picks the Mamba2 mixer's fused glue kernels
(kernel.py, csrc/mamba_mixer.cu): ``models/ssm.mamba_forward`` asks
``takes_kernels`` once a mixer and then calls the kernel module's
launches or keeps its eager code.

The route follows what the tensors show and nothing else:

* plain CUDA tensors of float32 or bfloat16 where no input needs a
  gradient (the samplers and the LM prefill, under ``no_grad``) take the
  hand-written kernels, whose bits are the eager code's;
* meta tensors on the same terms take the kernels' meta route (the dry
  run): empty outputs of the card's shapes, the operations counted in
  ``kernels.FLOPS``;
* everything else keeps the eager code of ``mamba_forward``: CPU tensors
  (the plain version, which the CPU tests hold against JAX), ``DTensor``s
  (its ``local_map`` and sharding propagation), any input that needs a
  gradient (training, the DiT gradient checks: the kernels have no
  backward), and a mixer whose widths the kernels do not take (a conv
  wider than ``kernel.MAX_WIDTH``, a row that fails
  ``kernel.norm_width_ok``).
"""
from __future__ import annotations

import torch
import torch.nn as nn
from torch.distributed.tensor import DTensor

from repro_torch.kernels.mamba_mixer import kernel

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def takes_kernels(x: torch.Tensor, params: nn.Module) -> bool:
    """Whether a mixer on input ``x`` with the parameters of ``params``
    runs the fused kernels (see the module's docstring).  A partitioned
    mixer's input is a ``DTensor`` (its placed parameters meet no plain
    input), so ``x`` alone tells that case; the parameters are looked at
    for their widths, and for a gradient only with grad enabled."""
    if isinstance(x, DTensor) or x.device.type not in ("cuda", "meta") or \
            x.dtype not in _KERNEL_DTYPES:
        return False
    if params.conv_x_w.shape[0] > kernel.MAX_WIDTH or not all(
            kernel.norm_width_ok(n.scale.shape[-1])
            for n in (params.norm, params.out_norm)):
        return False
    return not (torch.is_grad_enabled() and (x.requires_grad or any(
        p.requires_grad for p in params.parameters())))
