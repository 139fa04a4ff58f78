"""Quickstart on the PyTorch port: train a 2-client CollaFuse system and
sample collaboratively.

    python examples/torch_quickstart.py                  # on the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

``examples/quickstart.py``'s steps, with its numbers, through
``repro_torch``: config, synthetic non-IID data, Alg.-1 training, Alg.-2
split inference and the FD proxy.  Runs on CUDA unless ``--device cpu``
is given, and raises without a card.  On the card every denoising step
of the sample is one keyed DDPM-step launch.
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


def run(device="cuda", T: int = 60, t_cut: int = 15, image_size: int = 8,
        n_per_client: int = 256, rounds: int = 2, n_batches: int = 16,
        batch: int = 8, n_samples: int = 16, n_real: int = 64) -> dict:
    """The quickstart at these sizes (the defaults are the reference's);
    returns the rounds' metrics, the samples, the server handoff and the
    two FD proxies."""
    dev = resolve_device(device)
    key = prng.PRNGKey(0, device=dev)

    # 1. T diffusion steps, cut point t_cut: the server runs the T - t_cut
    #    high-noise steps, each client only the t_cut low-noise steps.
    ccfg = CollabConfig(n_clients=2, T=T, t_cut=t_cut, image_size=image_size,
                        batch_size=batch, n_classes=8)

    # 2. Non-IID client data (each client specialises in some attributes).
    dcfg = SyntheticConfig(image_size=image_size, n_attrs=8)
    data = make_client_datasets(key, dcfg, ccfg.n_clients, n_per_client,
                                non_iid=True, device=dev)

    # 3. Collaborative training (paper Alg. 1).
    state, step_fn, apply_fn = setup(key, ccfg, dev)
    metrics = []
    for r in range(rounds):
        kr = prng.fold_in(key, r)
        per_client = [list(batches(x, y, batch, kr))[:n_batches]
                      for x, y in data]
        metrics.append(train_round(state, step_fn, per_client, kr))
        print(f"round {r}: {metrics[-1][0]}")

    # 4. Collaborative inference (paper Alg. 2): the server denoises to the
    #    cut point, the client finishes locally with the remapped schedule.
    y = data[0][1][:n_samples]
    samples, handoff = sample_for_client(state, 0, key, y, ccfg, apply_fn,
                                         return_handoff=True)
    real = data[0][0][:n_real]
    fd_samples, fd_handoff = fd_proxy(real, samples), fd_proxy(real, handoff)
    print("samples:", tuple(samples.shape))
    print("FD(real, samples):        %.3f" % fd_samples)
    print("FD(real, server handoff): %.3f  <- information the server could "
          "disclose" % fd_handoff)
    return dict(metrics=metrics, samples=samples, handoff=handoff,
                fd_samples=fd_samples, fd_handoff=fd_handoff)


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return run(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    main(sys.argv[1:])
