"""Device selection for the port's entry points: CUDA unless the caller
asks for the CPU, and never a silent fall back to the CPU."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA.  Raises when CUDA is asked for (or implied) and
    no card is visible; pass ``device="cpu"`` to run on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    return dev


def deterministic_cuda() -> None:
    """Make every U-Net call's bits depend only on its own inputs and
    shape: cuDNN picks deterministic algorithms by shape alone
    (``deterministic=True``, ``benchmark=False``) and neither matmuls nor
    convolutions round through TF32.  The serve runtime's bitwise
    contracts (warm==cold==fifo, pipelined==sequential, continuous==depth)
    rest on this.  These are process-wide PyTorch flags."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
