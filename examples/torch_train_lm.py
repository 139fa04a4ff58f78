"""Train and serve an assigned architecture at smoke scale, on the
PyTorch port.

    python examples/torch_train_lm.py [arch]             # on the card
    PYTHONPATH=src python examples/torch_train_lm.py [arch] --device cpu

``examples/train_lm.py``'s steps, with its numbers, through the port's
launch drivers (``repro_torch.launch.train`` and ``.serve``, the step
builders the dry run reckons at production scale).  Runs on CUDA unless
``--device cpu`` is given, and raises without a card.  On the card a
reduced granite-8b (default) trains through flash attention's forward
and backward kernels and serves its prefill through the forward kernel.
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from repro_torch.device import resolve_device
from repro_torch.launch import serve, train


def run(arch: str = "granite-8b", device="cuda", steps: int = 30,
        batch: int = 4, seq: int = 64, serve_batch: int = 2,
        prompt_len: int = 16, new_tokens: int = 8) -> dict:
    """Train the reduced ``arch`` for ``steps`` steps, then serve it (the
    defaults are the reference's); returns the losses and the tokens."""
    dev = str(resolve_device(device))
    print(f"== training reduced {arch} ==")
    losses = train.main(["--arch", arch, "--reduced", "--steps", str(steps),
                         "--batch", str(batch), "--seq", str(seq),
                         "--device", dev])
    print(f"\n== serving reduced {arch} ==")
    tokens = serve.main(["--arch", arch, "--reduced", "--batch",
                         str(serve_batch), "--prompt-len", str(prompt_len),
                         "--new-tokens", str(new_tokens), "--device", dev])
    return dict(losses=losses, tokens=tokens)


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("arch", nargs="?", default="granite-8b")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return run(args.arch, device=args.device)


if __name__ == "__main__":
    main(sys.argv[1:])
