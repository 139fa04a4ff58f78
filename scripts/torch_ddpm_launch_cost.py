#!/usr/bin/env python3
"""Host cost of the port's CUDA DDPM-step launches, and the device events
of a per-request denoising step, for comparing two trees of the
repository on one card.

    python3 scripts/torch_ddpm_launch_cost.py [--tree DIR]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout), builds
its ``csrc/ddpm_step.cu`` there, and

* times ITERS back-to-back calls with CUDA events: ``kernel.launch`` (the
  given-noise variant) at the per-request shape (4, 32, 32, 3) float32 and
  at K = 4 slabs of it, and, where the tree has them, ``launch_keyed`` and
  ``launch_rowwise`` at the same shapes.  Back-to-back launches of kernels
  this small run at the host's rate, so each number is what the wrapper
  costs the host a call;
* profiles one per-request Alg.-2 sample with the full-width U-Net at
  T = 10, cut 3 (ten steps, as ``chip_smoke.py`` phase 5 does) and divides
  its device events and device time by the ten steps: the forward, the
  step and its surroundings, the x_T draw amortised.

Prints one JSON line with the card's name and power limit.  Needs one
CUDA device; exits nonzero without one.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ITERS = 2000
SAMPLE_T, SAMPLE_CUT = 10, 3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.tree).resolve() / "src"))
    import torch
    if not torch.cuda.is_available():
        print("torch_ddpm_launch_cost: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels.ddpm_step import kernel

    def time_us(fn) -> float:
        for _ in range(50):
            fn()
        start, end = torch.cuda.Event(True), torch.cuda.Event(True)
        start.record()
        for _ in range(ITERS):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / ITERS * 1e3

    torch.set_grad_enabled(False)
    g = torch.Generator(device="cuda").manual_seed(0)
    shape = (4, 32, 32, 3)
    x, e, n = (torch.randn(shape, generator=g, device="cuda")
               for _ in range(3))
    xs, es, ns = (torch.randn((4,) + shape, generator=g, device="cuda")
                  for _ in range(3))
    coef = torch.tensor([[1.01, 0.02, 0.1]], device="cuda")
    coefs = coef.repeat(4, 1)
    out = {"tree": str(Path(args.tree).resolve()),
           "given_us": time_us(lambda: kernel.launch(x, e, n, coef,
                                                     "ddpm_step")),
           "given_batched_us": time_us(lambda: kernel.launch(
               xs, es, ns, coefs, "ddpm_step_batched"))}
    if hasattr(kernel, "launch_keyed"):
        key = torch.tensor([0, 7], dtype=torch.int64, device="cuda")
        key_out = torch.empty_like(key)
        row = coef[0]
        slab_keys = torch.arange(8, dtype=torch.int64,
                                 device="cuda").reshape(4, 2)
        active = torch.ones(4, device="cuda")
        out["keyed_us"] = time_us(lambda: kernel.launch_keyed(
            x, e, key, row, key_out))
        out["rowwise_us"] = time_us(lambda: kernel.launch_rowwise(
            xs, es, slab_keys, 3, coefs, active))
    out.update(per_request_step(shape))
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps(out), flush=True)
    return 0


def per_request_step(shape) -> dict:
    """Device events and device ms a step of one per-request sample
    (torch.profiler, device rows only; the first sample warms up)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.ddpm_unet import CONFIG
    from repro_torch.core import prng
    from repro_torch.core.sampler import make_per_request_sampler
    from repro_torch.core.schedules import DiffusionSchedule
    from repro_torch.core.unet import init_unet, unet_apply
    from repro_torch.device import deterministic_cuda

    deterministic_cuda()
    key = prng.PRNGKey(0, device="cuda")
    ks, kc = prng.split(key, 2)
    sp, cp = (init_unet(k, CONFIG, "cuda") for k in (ks, kc))
    y = torch.eye(CONFIG.n_classes, device="cuda")[:shape[0]]
    sample = make_per_request_sampler(DiffusionSchedule.linear(
        SAMPLE_T, device="cuda"), unet_apply, shape)(SAMPLE_CUT)
    sample(sp, cp, prng.fold_in(key, 7), y)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        sample(sp, cp, prng.fold_in(key, 8), y)
        torch.cuda.synchronize()
    rows = [r for r in p.key_averages()
            if r.device_type == DeviceType.CUDA and
            not getattr(r, "is_user_annotation", False)]
    return {"step_device_events": sum(r.count for r in rows) / SAMPLE_T,
            "step_device_ms": sum(r.self_device_time_total
                                  for r in rows) / (SAMPLE_T * 1e3)}


if __name__ == "__main__":
    sys.exit(main())
