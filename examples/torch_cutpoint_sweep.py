"""Cut-point trade-off in one picture (paper Fig. 4, miniature), on the
PyTorch port.

    python examples/torch_cutpoint_sweep.py              # on the card
    PYTHONPATH=src python examples/torch_cutpoint_sweep.py --device cpu

``examples/cutpoint_sweep.py``'s steps, with its numbers, through
``repro_torch``: sweeps t_cut over {0, T/4, T/2, T} and prints the
fidelity / disclosure / compute triangle.  Runs on CUDA unless ``--device
cpu`` is given, and raises without a card.
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from repro_torch.core import prng
from repro_torch.core.collab import (CollabConfig, sample_for_client, setup,
                                     train_round)
from repro_torch.core.splitting import CutPoint
from repro_torch.data.synthetic import (SyntheticConfig, batches,
                                        make_client_datasets)
from repro_torch.device import resolve_device
from repro_torch.eval.fd_proxy import fd_proxy


def run(device="cuda", T: int = 40, image_size: int = 8,
        n_per_client: int = 256, n_batches: int = 16, batch: int = 8,
        n_samples: int = 32, n_real: int = 64) -> List[dict]:
    """One row per cut (the defaults are the reference's): its client
    step share and the FD proxies of the samples and of the handoff."""
    dev = resolve_device(device)
    key = prng.PRNGKey(0, device=dev)
    dcfg = SyntheticConfig(image_size=image_size, n_attrs=8)
    data = make_client_datasets(key, dcfg, 2, n_per_client, non_iid=True,
                                device=dev)
    real = data[0][0][:n_real]
    print(f"{'t_cut':>6} {'client_steps%':>14} {'FD(sample)':>11} "
          f"{'FD(handoff)':>12}")
    rows = []
    for t_cut in (0, T // 4, T // 2, T):
        ccfg = CollabConfig(n_clients=2, T=T, t_cut=t_cut,
                            image_size=image_size, batch_size=batch,
                            n_classes=8)
        state, step_fn, apply_fn = setup(key, ccfg, dev)
        kr = prng.fold_in(key, t_cut)
        per_client = [list(batches(x, y, batch, kr))[:n_batches]
                      for x, y in data]
        train_round(state, step_fn, per_client, kr)
        samp, hand = sample_for_client(state, 0, kr, data[0][1][:n_samples],
                                       ccfg, apply_fn, return_handoff=True)
        share = 100.0 * CutPoint(T, t_cut).n_client_steps / T
        row = dict(t_cut=t_cut, client_share=share,
                   fd_sample=fd_proxy(real, samp),
                   fd_handoff=fd_proxy(real, hand))
        rows.append(row)
        print(f"{t_cut:>6} {share:>13.0f}% {row['fd_sample']:>11.3f} "
              f"{row['fd_handoff']:>12.3f}")
    print("\nReading: fidelity is best at small-but-nonzero cuts; handoff FD "
          "(disclosure protection) grows with the cut; client compute share "
          "grows linearly with the cut.")
    return rows


def main(argv: Optional[List[str]] = None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return run(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    main(sys.argv[1:])
