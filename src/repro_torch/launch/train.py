"""LM training driver for the language-model architectures.

    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-1.2b \\
        --reduced --steps 20 --device cpu
    python -m repro_torch.launch.train --arch zamba2-1.2b --steps 20 \\
        --batch 4 --seq 1024

The port of the JAX package's ``launch/train.py``, with its flags plus
``--device`` (CUDA unless ``--device cpu``).  Weights come from threefry
``PRNGKey(0)`` (``api.init_params``); step i trains on
``lm_batch(fold_in(PRNGKey(0), i), ...)`` (data/tokens.py) with
``make_train_step`` (launch/shapes.py: the loss and its gradients, then
AdamW), under WSD for minicpm and cosine (warmup steps/20) otherwise.  A
VLM's stub vision embeddings and the audio family's stub frames (B, seq,
d_model) are drawn in float32 with ``prng.normal`` and cast to the
model's type (the reference draws them in that type; equal for float32
models); the audio family's tokens and labels are cut to
``min(max_decoder_len, seq)``.
On the card, attention, the SSD scan and an MoE architecture's grouped
matmul train through their backward kernels.  The runtime is the
reference's ``Runtime()``: no mesh, MoE dense.  ``--checkpoint`` saves the parameters and the AdamW state
by parameter name (checkpointing/checkpoint.py); ``restore`` reads them
back into a model.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, List, Optional

import torch

from repro_torch.checkpointing.checkpoint import load, save
from repro_torch.configs.base import ArchConfig, get_arch, reduced
from repro_torch.core import prng
from repro_torch.data.tokens import lm_batch
from repro_torch.device import resolve_device
from repro_torch.launch.shapes import make_train_step
from repro_torch.models import api
from repro_torch.optim.adamw import AdamWConfig, init_opt_state, named
from repro_torch.optim.schedules import cosine, wsd


def build_batch(key: torch.Tensor, cfg: ArchConfig, batch: int,
                seq: int) -> dict:
    """The training batch of step key ``key``, on the key's device."""
    b = lm_batch(key, batch, seq, cfg.vocab_size)
    if cfg.family == "vlm":
        b["vision_embeds"] = prng.normal(
            key, (batch, cfg.n_vision_tokens, cfg.d_model)).to(
                cfg.torch_dtype)
    if cfg.family == "audio":
        b["frames"] = prng.normal(key, (batch, seq, cfg.d_model)).to(
            cfg.torch_dtype)
        dec = min(cfg.max_decoder_len, seq)
        b["tokens"], b["labels"] = b["tokens"][:, :dec], b["labels"][:, :dec]
    return b


def parse(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def restore(path: str, cfg: ArchConfig, device=None):
    """(model, AdamW state, step) from a ``--checkpoint`` file: a model
    of ``cfg`` on ``device`` holding the saved parameters, and the saved
    moments and step counter."""
    tree = load(path)
    dev = resolve_device(device)
    to = lambda a: torch.as_tensor(a).to(dev)
    model = api.init_params(prng.PRNGKey(0), cfg, dev)
    with torch.no_grad():
        for name, p in named(model).items():
            p.copy_(to(tree["params"][name]))
    opt = {"m": {n: to(a) for n, a in tree["opt"]["m"].items()},
           "v": {n: to(a) for n, a in tree["opt"]["v"].items()},
           "step": torch.as_tensor(tree["opt"]["step"])}
    return model, opt, int(tree["step"])


def main(argv: Optional[List[str]] = None,
         on_step: Optional[Callable[..., None]] = None) -> List[float]:
    """Train; returns the per-step losses.  ``on_step(i, params, opt,
    metrics)``, if given, runs after step i (a caller's per-step
    accounting)."""
    args = parse(argv)
    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    # minicpm trains with the WSD schedule it introduced; others cosine
    sched = (wsd(args.steps) if "minicpm" in cfg.name
             else cosine(args.steps, warmup=max(args.steps // 20, 1)))
    opt_cfg = AdamWConfig(lr=args.lr, schedule=sched)

    key = prng.PRNGKey(0, device=dev)
    params = api.init_params(key, cfg, dev)
    opt = init_opt_state(params)
    step = make_train_step(cfg, opt_cfg)

    losses = []
    t0 = time.time()
    for i in range(args.steps):
        batch = build_batch(prng.fold_in(key, i), cfg, args.batch, args.seq)
        params, opt, metrics = step(params, opt, batch)
        losses.append(float(metrics["loss"]))
        if on_step is not None:
            on_step(i, params, opt, metrics)
        if i % args.log_every == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss {losses[-1]:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"({time.time() - t0:.1f}s)")
    if args.checkpoint:
        save(args.checkpoint, {"params": named(params), "opt": opt,
                               "step": args.steps})
        print("checkpoint ->", args.checkpoint)
    print(f"first-10-mean {sum(losses[:10]) / min(10, len(losses)):.4f} "
          f"last-10-mean {sum(losses[-10:]) / min(10, len(losses)):.4f}")
    return losses


if __name__ == "__main__":
    main()
