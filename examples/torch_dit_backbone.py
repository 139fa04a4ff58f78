"""CollaFuse with an assigned-architecture backbone (the DiT bridge), on
the PyTorch port.

    python examples/torch_dit_backbone.py [arch]         # on the card
    PYTHONPATH=src python examples/torch_dit_backbone.py [arch] --device cpu

``examples/dit_backbone.py``'s steps, with its numbers, through
``repro_torch``: the split protocol with a reduced mamba2-2.7b (default)
or any other architecture id as the denoiser.  Runs on CUDA unless
``--device cpu`` is given, and raises without a card.  On the card the
Mamba2 layers' scans go through the SSD scan kernels (forward, and the
backward kernel in training) and the sample's steps through the keyed
DDPM step.
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from repro_torch.core import prng
from repro_torch.core.collab import (CollabConfig, sample_for_client, setup,
                                     train_round)
from repro_torch.data.synthetic import (SyntheticConfig, batches,
                                        make_client_datasets)
from repro_torch.device import resolve_device
from repro_torch.eval.fd_proxy import fd_proxy


def run(arch: str = "mamba2-2.7b", device="cuda", T: int = 30,
        t_cut: int = 8, image_size: int = 8, n_per_client: int = 128,
        n_batches: int = 10, batch: int = 4, n_samples: int = 16,
        n_real: int = 64) -> dict:
    """One round and one client sample with ``arch``'s reduced DiT (the
    defaults are the reference's); returns the metrics, the samples and
    their FD proxy."""
    dev = resolve_device(device)
    key = prng.PRNGKey(0, device=dev)
    ccfg = CollabConfig(n_clients=2, T=T, t_cut=t_cut, image_size=image_size,
                        batch_size=batch, n_classes=8, denoiser=arch,
                        dit_patch=2)
    dcfg = SyntheticConfig(image_size=image_size, n_attrs=8)
    data = make_client_datasets(key, dcfg, 2, n_per_client, non_iid=True,
                                device=dev)

    state, step_fn, apply_fn = setup(key, ccfg, dev)
    per_client = [list(batches(x, y, batch, key))[:n_batches]
                  for x, y in data]
    metrics = train_round(state, step_fn, per_client, key)
    print(f"backbone={arch}: {metrics[0]}")
    samp = sample_for_client(state, 0, key, data[0][1][:n_samples], ccfg,
                             apply_fn)
    fd = fd_proxy(data[0][0][:n_real], samp)
    print("samples:", tuple(samp.shape), "FD:", round(fd, 3))
    return dict(metrics=metrics, samples=samp, fd=fd)


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("arch", nargs="?", default="mamba2-2.7b")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return run(args.arch, device=args.device)


if __name__ == "__main__":
    main(sys.argv[1:])
