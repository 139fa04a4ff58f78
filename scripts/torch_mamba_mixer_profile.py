#!/usr/bin/env python3
"""The Mamba2 mixer's fused glue on one card, at the benchmark DiT's shape
(``bench/configs/zamba2-hybrid-dit.json``: 64 images of 64 tokens, d
2,048, d_inner 4,096, state 64, conv width 4, bf16).

    python3 scripts/torch_mamba_mixer_profile.py [--tree DIR]

``--tree`` imports the port from another checkout (a parent unpacked
under a gitignored directory), so two trees compare on one card; a tree
without ``kernels/mamba_mixer`` runs the forward parts alone.  Prints one
JSON line a part:

* ``card``: the card's name and power limit;
* ``build``: the library's build seconds and ptxas's lines for each
  kernel (registers, spills);
* ``kernel``: each fused kernel's time a launch (CUDA events over 50
  back-to-back launches after a warm-up), its bound (bytes at 3.35 TB/s or
  float32 operations at 67 TFLOP/s, ``kernels/mamba_mixer/cost.py``), the
  share, the eager composition's time (the plain version), and whether
  the kernel's output is bitwise the eager composition's;
* ``mixer`` and ``dit``: one ``mamba_forward`` and one DiT forward (all
  38 layers, the benchmark's weights for seed 1) under ``no_grad``: the
  host's wall time a call (10 calls ended by a synchronise), the device
  time a call (``torch.profiler``, the sum of its device activities over 3
  calls), device activities a call, and aten dispatches a call (a
  ``TorchDispatchMode`` counting every op).  With the fused kernels, also
  the eager route, forced as autograd forces it (the parameters need a
  gradient, grad enabled);
* ``dit_top``: one DiT forward's device ms by kernel and the aten op
  that launched it (``torch.profiler``).

Needs one CUDA device (and nvcc for the fused kernels); exits 2 without.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def emit(part: str, **fields) -> None:
    print(json.dumps({"part": part, **fields}), flush=True)


def events_us(fn, n: int = 50) -> float:
    import torch
    for _ in range(5):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / n


def forward_costs(fn, calls: int = 3) -> dict:
    """Wall ms a call, device ms a call, device activities and aten
    dispatches a call of ``fn``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / 10
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA]
    with Count():
        fn()
    torch.cuda.synchronize()
    return {"wall_ms": wall,
            "device_ms": sum(e.end_ns() - e.start_ns() for e in dev)
            / 1e6 / calls,
            "device_activities": len(dev) / calls, "dispatches": Count.n}


def top_kernels(fn, n: int = 14) -> list:
    """One call of ``fn`` under the profiler: device ms by (kernel, the
    aten op that launched it), largest first, after the attributed and the
    total device ms.  Kernels launched through ctypes (the hand-written
    ones) belong to no aten op: they are in the total alone."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    agg = {}
    for e in prof.events():
        for k in getattr(e, "kernels", []):
            key = (k.name[:60], e.name)
            agg[key] = agg.get(key, 0.0) + k.duration / 1e3
    total = sum(e.end_ns() - e.start_ns()
                for e in prof.profiler.kineto_results.events()
                if e.device_type() == DeviceType.CUDA) / 1e6
    rows = sorted(([round(v, 4), *key] for key, v in agg.items()),
                  reverse=True)[:n]
    return [{"attributed_ms": round(sum(agg.values()), 3),
             "kernels_ms": round(total, 3)}, *rows]


def kernel_parts() -> None:
    """Each fused kernel beside its bound and its eager composition."""
    from types import SimpleNamespace
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build
    from repro_torch.kernels.mamba_mixer import cost as mixer_cost
    from repro_torch.kernels.mamba_mixer import kernel
    from repro_torch.models import ssm
    from repro_torch.models.layers import rmsnorm
    _, seconds, log = build.load("mamba_mixer.cu")
    lines = [ln.strip() for ln in log.splitlines()
             if "mamba_" in ln or "registers" in ln or "spill" in ln]
    emit("build", seconds=seconds, ptxas=lines[:60])
    dev, bf16 = "cuda", torch.bfloat16
    rows, d, di, n, k, h, p = 64 * 64, 2048, 4096, 64, 4, 64, 64
    g = torch.Generator(device=dev).manual_seed(5)
    r = lambda *shape: torch.randn(shape, generator=g, device=dev).to(bf16)
    x, xr, bcr, y, z = (r(64, 64, d), r(64, 64, di), r(64, 64, 2 * n),
                        r(64, 64, di), r(64, 64, di))
    wx, bx, wbc, bbc = r(k, di), r(di), r(k, 2 * n), r(2 * n)
    sc_d, sc_di = r(d), r(di)
    D = torch.randn(h, generator=g, device=dev)
    xs = r(64, 64, di)
    eps = 1e-5
    norm = lambda t, s: rmsnorm(SimpleNamespace(scale=s), t, eps)

    def eager_gated():
        y4 = y.reshape(64, 64, h, p) + xs.reshape(64, 64, h, p) * \
            D[None, None, :, None].to(bf16)
        return norm(y4.reshape(64, 64, di) * F.silu(z), sc_di)

    def eager_conv():
        a = ssm._causal_conv(xr, wx, bx)
        bc = ssm._causal_conv(bcr, wbc, bbc)
        return a.reshape(64, 64, h, p), bc[..., :n].contiguous(), \
            bc[..., n:].contiguous()

    parts = {
        "mamba_conv_silu": (lambda: kernel.launch_conv_silu(xr, bcr, wx, bx,
                                                            wbc, bbc),
                            eager_conv,
                            mixer_cost.conv_silu_cost(rows, di + 2 * n, k, 2)),
        "mamba_rmsnorm": (lambda: kernel.launch_rmsnorm(x, sc_d, eps),
                          lambda: norm(x, sc_d),
                          mixer_cost.rmsnorm_cost(rows, d, 2)),
        "mamba_rmsnorm_gated": (
            lambda: kernel.launch_rmsnorm(y, sc_di, eps, xs, D, z),
            eager_gated,
            mixer_cost.rmsnorm_cost(rows, di, 2, h))}
    with torch.no_grad():
        for name, (fused, eager, (nbytes, flops)) in parts.items():
            us = events_us(fused)
            bound = max(nbytes / 3.35e12, flops / 67e12) * 1e6
            got, want = fused(), eager()
            if name == "mamba_conv_silu":
                got = (got[0].reshape(want[0].shape), *got[1:])
            else:
                got, want = (got,), (want,)
            emit("kernel", name=name, us=us, bound_us=bound,
                 share_pct=100 * bound / us, bytes=nbytes, flops=flops,
                 eager_us=events_us(eager), bitwise_eager=all(
                     torch.equal(a, b) for a, b in zip(got, want)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(ROOT))
    args = ap.parse_args(argv)
    tree = Path(args.tree).resolve()
    sys.path[:0] = [str(tree / "src"), str(ROOT)]
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        card = "unknown"
    emit("card", card=card, tree=str(tree), torch=torch.__version__)
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.models import ssm
    fused = (tree / "src/repro_torch/kernels/mamba_mixer").is_dir()
    if fused:
        kernel_parts()
    from bench.models import zamba2_dit as fam
    cfg = json.loads((ROOT / "bench/configs/zamba2-hybrid-dit.json")
                     .read_text())
    arch = fam._arch(cfg)
    dev = torch.device("cuda", 0)
    model = fam.build_program(cfg, fam.make_weights(cfg, 1, 0, dev), dev)
    apply = fam.apply_fn()
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn(64, 32, 32, 3, generator=g, device=dev)
    t = torch.full((64,), 100.0, device=dev)
    y = torch.zeros(64, 8, device=dev)
    y[:, 3] = 1.0
    h = torch.randn(64, 64, arch.d_model, generator=g, device=dev).to(
        arch.torch_dtype)
    layer = model.mamba[0]
    routes = {"fused": torch.no_grad} if fused else {"eager": torch.no_grad}
    if fused:
        routes["eager"] = torch.enable_grad
    for route, ctx in routes.items():
        model.requires_grad_(route == "eager" and fused)

        def mixer():
            with ctx():
                return ssm.mamba_forward(layer, h, arch)

        def dit():
            with ctx():
                return apply(model, x, t, y)
        emit("mixer", route=route, **forward_costs(mixer))
        emit("dit", route=route, **forward_costs(dit))
        emit("dit_top", route=route, top=top_kernels(dit))
    return 0


if __name__ == "__main__":
    sys.exit(main())
