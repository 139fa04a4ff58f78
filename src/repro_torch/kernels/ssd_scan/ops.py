"""Public SSD scan op (Mamba2 chunked scan from a zero state).

Routing follows the tensors' device and nothing else: CPU tensors take
the plain version (ref.py, the port of ``models/ssm.ssd_chunked``); CUDA
tensors take the hand-written kernel (kernel.py, csrc/ssd_scan.cu) or
raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd_scan import kernel
from repro_torch.kernels.ssd_scan.ref import ssd_chunked


def ssd_scan(x, dt, A, B, C, chunk: int):
    """x (b, s, h, p); dt (b, s, h); A (h,); B/C (b, s, n).  Returns
    (y (b, s, h, p) in x's type, final_state (b, h, p, n) float32)."""
    if x.device.type == "cpu":
        return ssd_chunked(x, dt, A, B, C, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on cpu or cuda, not {x.device}")
    f32 = torch.float32
    return kernel.launch(x.contiguous(), dt.to(f32).contiguous(),
                         A.to(f32).contiguous(), B.to(x.dtype).contiguous(),
                         C.to(x.dtype).contiguous(), chunk)
