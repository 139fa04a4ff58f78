#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout; needs one CUDA device, nvcc and nothing
beyond the repository's own sources (it imports neither JAX nor the JAX
package).  Phases, each of which fails the run on any error:

1. card: the nvidia-smi name/power-limit line, torch and CUDA versions;
2. build: nvcc builds every kernel source of the port, all started
   together;
3. kernel vs plain: each kernel entry against its plain PyTorch version on
   the card, at the JAX package's parity shapes and the serve path's
   shapes, fp32 and bf16, with times beside the byte bound;
4. the full-width U-Net (configs CONFIG) on the card against the port on
   the CPU, same threefry weights, one forward of B=4;
5. the main path: ``ServeRuntime`` on CUDA with the CONFIG U-Net, T=1000,
   3 clients at cuts 125/250/500, 6 requests x batch 4, max_wave 4, depth
   policy, cache on, 2 passes, then one per-request Alg.-2 sample
   (``make_per_request_sampler``); kernel launch counters are zeroed just
   before and read just after, and must equal the scheduled steps;
6. serve contracts at CONFIG width on the card (the CLI's ``--smoke``,
   T=20: warm==cold==fifo, pipelined==sequential, continuous==depth, obs
   on==off, all bitwise) and the batched engine against its per-request
   reference, bitwise;
7. a ``kernels`` JSON line, the card line again, and the result line.

Exits nonzero, printing no result line, without a CUDA device or outside
a checkout.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL_BF16 = dict(atol=5e-2, rtol=5e-2)   # the JAX package's kernel tolerance
FP32_ULPS = 1          # kernel vs plain in fp32 (the kernel forbids FMAs)
UNET_RTOL = 1e-4       # card vs CPU forward, relative to max |output|
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12       # H100 SXM fp32 outside the tensor cores
IMG = (32, 32, 3)
B = 4


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def time_ms(fn, iters: int = 200, warmup: int = 10) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_build():
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import build
    sources = sorted(p.name for p in build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as ex:
        results = list(ex.map(build.load, sources))
    wall = time.perf_counter() - t0
    for src, (_, secs, nvcc_log) in zip(sources, results):
        regs = [l.strip() for l in nvcc_log.splitlines()
                if "registers" in l or "spill" in l]
        log(f"build/{src}: nvcc {secs:.2f} s")
        for l in regs:
            log(f"  {l}")
    log(f"build/wall_s: {wall:.2f}")
    return wall


def _ulps(a, b):
    import torch
    return int((a.view(torch.int32).long() - b.view(torch.int32).long())
               .abs().max().item())


def phase_kernels():
    """Kernel vs plain on the card; returns per-entry records at the
    serve path's shapes."""
    import torch
    from repro_torch.core.schedules import DiffusionSchedule
    from repro_torch.kernels.ddpm_step import kernel, ops
    from repro_torch.kernels.ddpm_step.ref import ddpm_step_ref

    sched = DiffusionSchedule.linear(100, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    per_main = B * IMG[0] * IMG[1] * IMG[2]
    batched_shapes = [(5, 4, 8, 8, 3), (3, 2, 37), (1, 129),
                      (1, per_main), (2, per_main), (4, per_main)]
    scalar_shapes = [(4, 16, 16, 3), (2, 8, 8, 1), (1, 37), (B,) + IMG]
    records = {}

    def inputs(shape, dtype):
        return [torch.randn(shape, generator=g, device="cuda").to(dtype)
                for _ in range(3)]

    def check(out, ref, dtype, what):
        err = (out.float() - ref.float()).abs().max().item()
        if dtype == torch.float32:
            u = _ulps(out, ref)
            if u > FP32_ULPS:
                raise AssertionError(f"{what}: {u} ulps > {FP32_ULPS}")
        elif not torch.allclose(out.float(), ref.float(), **TOL_BF16):
            raise AssertionError(f"{what}: max abs {err} beyond TOL_BF16")
        return err

    def bound_ms(K, per, itemsize):
        nbytes = 4 * K * per * itemsize + 12 * K
        flops = 5 * K * per
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / FP32_FLOPS_PER_S * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                     else "operations")

    for dtype in (torch.float32, torch.bfloat16):
        tag = "fp32" if dtype == torch.float32 else "bf16"
        for shape in batched_shapes:
            K = shape[0]
            x, e, n = inputs(shape, dtype)
            t = torch.linspace(1.0, 99.0, K, device="cuda")
            tp = torch.clamp(t - 1.5, min=0.0)
            out = ops.ddpm_step_batched(x, e, n, sched, t, tp)
            a, c, s = ops.step_coefficients(sched, t, tp)
            bs = (K,) + (1,) * (len(shape) - 1)
            a, c, s = a.reshape(bs), c.reshape(bs), s.reshape(bs)
            ref = ddpm_step_ref(x, e, n, a, c, s)
            err = check(out, ref, dtype, f"batched {shape} {tag}")
            for k in range(K):        # each slab equals the scalar kernel
                row = ops.ddpm_step(x[k], e[k], n[k], sched, t[k], tp[k])
                if not torch.equal(row, out[k]):
                    raise AssertionError(f"slab {k} of {shape} {tag} != "
                                         "scalar kernel")
            coef = torch.stack([a.reshape(K), c.reshape(K), s.reshape(K)],
                               dim=1).contiguous()
            ms = time_ms(lambda: kernel.launch(x, e, n, coef,
                                               "ddpm_step_batched"))
            wrap = time_ms(lambda: ops.ddpm_step_batched(x, e, n, sched, t,
                                                         tp))
            plain = time_ms(lambda: ddpm_step_ref(x, e, n, a, c, s))
            per = x[0].numel()
            bnd, by = bound_ms(K, per, x.element_size())
            log(f"kernel/ddpm_step_batched {shape} {tag}: max_abs_err "
                f"{err:.3g} kernel {ms * 1e3:.2f} us (with coefficients "
                f"{wrap * 1e3:.2f} us) plain {plain * 1e3:.2f} us bound "
                f"{bnd * 1e3:.3f} us ({by})")
            if dtype == torch.float32 and shape == (4, per_main):
                records["ddpm_step_batched"] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd,
                    bound_by=by)
        for shape in scalar_shapes:
            x, e, n = inputs(shape, dtype)
            out = ops.ddpm_step(x, e, n, sched, 50.5)
            a, c, s = ops.step_coefficients(sched, 50.5)
            ref = ddpm_step_ref(x, e, n, a, c, s)
            err = check(out, ref, dtype, f"scalar {shape} {tag}")
            coef = torch.stack([a, c, s]).reshape(1, 3)
            ms = time_ms(lambda: kernel.launch(x, e, n, coef, "ddpm_step"))
            wrap = time_ms(lambda: ops.ddpm_step(x, e, n, sched, 50.5))
            plain = time_ms(lambda: ddpm_step_ref(x, e, n, a, c, s))
            bnd, by = bound_ms(1, x.numel(), x.element_size())
            log(f"kernel/ddpm_step {shape} {tag}: max_abs_err {err:.3g} "
                f"kernel {ms * 1e3:.2f} us (with coefficients "
                f"{wrap * 1e3:.2f} us) plain {plain * 1e3:.2f} us bound "
                f"{bnd * 1e3:.3f} us ({by})")
            if dtype == torch.float32 and shape == (B,) + IMG:
                records["ddpm_step"] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd,
                    bound_by=by)
    log("kernel/library_ms: null (no single PyTorch call computes "
        "(x - c*e)*a + s*n)")
    return records


def phase_unet():
    """CONFIG U-Net: card vs CPU forward on the same weights; returns the
    card's forward wall time per call (ms)."""
    import numpy as np
    import torch
    from repro_torch.configs.ddpm_unet import CONFIG
    from repro_torch.core import prng
    from repro_torch.core.unet import UNet, init_unet, unet_param_count
    from repro_torch.device import deterministic_cuda

    deterministic_cuda()          # TF32 off, deterministic cuDNN (as serving)
    gpu = init_unet(prng.PRNGKey(0), CONFIG, device="cuda")
    cpu = UNet(CONFIG)
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    log(f"unet/params: {unet_param_count(gpu)}")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B,) + IMG).astype(np.float32)
    t = rng.uniform(1.0, 1000.0, B).astype(np.float32)
    y = np.eye(CONFIG.n_classes, dtype=np.float32)[
        rng.integers(0, CONFIG.n_classes, B)]
    args = [torch.from_numpy(a) for a in (x, t, y)]
    with torch.no_grad():
        ref = cpu(*args)
        out = gpu(*[a.cuda() for a in args]).cpu()
        xs = [a.cuda() for a in args]
        fwd_ms = time_ms(lambda: gpu(*xs), iters=50, warmup=5)
    if not torch.isfinite(out).all():
        raise AssertionError("unet: non-finite output on the card")
    err = (out - ref).abs().max().item()
    scale = ref.abs().max().item()
    log(f"unet/max_abs_err: {err:.3g} (max |out| {scale:.3g}, tolerance "
        f"{UNET_RTOL:g} x max |out|)")
    if err > UNET_RTOL * scale:
        raise AssertionError(f"unet card vs cpu: {err} > {UNET_RTOL}*{scale}")
    log(f"unet/forward_ms (B={B}, wall per call, eager): {fwd_ms:.3f}")
    unet_device_ms(gpu, xs)
    return fwd_ms


def unet_device_ms(model, xs):
    """Device time of one forward from torch.profiler (summed kernel
    time), printed for the time breakdown; 'not measured' if the
    profiler reports no device time on this machine."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as p:
        for _ in range(5):
            model(*xs)
        torch.cuda.synchronize()
    total_us = sum(getattr(e, "self_device_time_total", 0.0)
                   for e in p.key_averages())
    n_dev = sum(e.count for e in p.key_averages()
                if getattr(e, "self_device_time_total", 0.0) > 0)
    if total_us > 0:
        log(f"unet/device_ms per forward (profiler): {total_us / 5e3:.3f} "
            f"over {n_dev / 5:.0f} device events")
    else:
        log("unet/device_ms per forward: not measured (profiler reported "
            "no device time)")


def phase_main_path(fwd_ms: float):
    """The serve path at full width; returns launches per kernel entry.
    ``fwd_ms`` is the U-Net's wall time per forward (phase 4)."""
    import numpy as np
    import torch
    from repro_torch.configs.ddpm_unet import CONFIG
    from repro_torch.core import prng
    from repro_torch.core.protocol import rowwise_normal
    from repro_torch.core.sampler import make_per_request_sampler
    from repro_torch.core.schedules import DiffusionSchedule
    from repro_torch.core.unet import init_unet, unet_apply
    from repro_torch.kernels.ddpm_step import kernel
    from repro_torch.kernels.ddpm_step.ops import ddpm_step_batched
    from repro_torch.launch.collab_serve import synth_queue
    from repro_torch.obs import ObsConfig
    from repro_torch.serve import ServeConfig, ServeRuntime

    T, cuts, n_req, passes = 1000, [125, 250, 500], 6, 2
    key = prng.PRNGKey(0, device="cuda")
    ks, *kc = prng.split(key, len(cuts) + 1)
    sp = init_unet(ks, CONFIG, "cuda")
    cp = [init_unet(k, CONFIG, "cuda") for k in kc]
    sched = DiffusionSchedule.linear(T, device="cuda")
    queue = synth_queue(np.random.default_rng(0), clients=len(cuts),
                        cuts=cuts, requests=n_req, batch=B,
                        n_classes=CONFIG.n_classes, zipf=1.1)
    rt = ServeRuntime(ServeConfig(T=T, image_shape=IMG, max_wave=4,
                                  policy="depth", cache=True),
                      sp, cp, unet_apply, sched, key,
                      obs=ObsConfig(enabled=True), device="cuda")
    sampler = make_per_request_sampler(sched, unet_apply, (B,) + IMG)
    y0 = torch.from_numpy(queue[0].y).cuda()
    torch.cuda.synchronize()

    steps = rt.registry.counter("scan_steps")
    steps0 = steps.value
    kernel.reset_counts()                        # --- main path starts
    reports, pass_steps = [], []
    for _ in range(passes):
        before = steps.value
        outs, rep = rt.process(queue)
        reports.append((outs, rep))
        pass_steps.append(steps.value - before)
    t0 = time.perf_counter()
    single = sampler(cuts[1])(sp, cp[1], prng.fold_in(key, 7), y0)
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    launches = dict(kernel.COUNTS)               # --- main path ends
    n_steps = steps.value - steps0

    for p, (outs, rep) in enumerate(reports, 1):
        for o in outs:
            if tuple(o.shape) != (B,) + IMG or not torch.isfinite(o).all():
                raise AssertionError(f"pass {p}: bad output {tuple(o.shape)}")
        log(f"main/pass{p}: wall_s {rep['wall_s']:.3f} req_per_s "
            f"{rep['req_per_s']:.4f} samples_per_s "
            f"{rep['samples_per_s']:.4f} waves {rep['waves']} "
            f"server_calls_physical {rep['server_calls_physical']} "
            f"client_calls_physical {rep['client_calls_physical']} "
            f"cache_hits {rep['cache_hits']}")
    if reports[1][1]["cache_hits"] < 1:
        raise AssertionError("main: no cache hit in pass 2")
    if not torch.isfinite(single).all():
        raise AssertionError("main: per-request sample not finite")
    log(f"main/per_request_sample: T={T} cut {cuts[1]} wall_s "
        f"{single_s:.3f}")
    log(f"main/launches: {launches} scheduled batched steps {n_steps} "
        f"per-request steps {T}")
    if launches["ddpm_step_batched"] != n_steps or n_steps == 0:
        raise AssertionError(f"batched launches {launches} != steps "
                             f"{n_steps}")
    if launches["ddpm_step"] != T:
        raise AssertionError(f"scalar launches {launches} != T {T}")

    # where a pass's time goes: model calls and scan steps times their
    # per-call wall cost (measured alone, at the client stage's K=4), the
    # host planning spans, and the rest (Python, indexing, key folding)
    keys = prng.fold_in(key, torch.arange(4, device="cuda"))
    shape = (B,) + IMG
    xs = [torch.randn((4,) + shape, device="cuda") for _ in range(3)]
    tk = torch.linspace(2.0, 500.0, 4, device="cuda")
    mask = torch.ones(4, 1, 1, 1, 1, device="cuda") > 0
    per_ms = {
        "noise_draw": time_ms(lambda: rowwise_normal(
            prng.fold_in(keys, 5), shape), iters=20),
        "ddpm_step": time_ms(lambda: ddpm_step_batched(
            xs[0], xs[1], xs[2], sched, tk, tk - 1.0), iters=50),
        "stack_where": time_ms(lambda: torch.where(
            mask, torch.stack(list(xs[0])), xs[1]), iters=50)}
    log("main/per_call_ms: " + json.dumps(
        {"unet_forward": round(fwd_ms, 4),
         **{k: round(v, 4) for k, v in per_ms.items()}}))
    spans = rt.obs.spans()
    for p, (_, rep) in enumerate(reports, 1):
        plan_s = sum(s.duration_s for s in spans
                     if s.frame == p - 1 and s.name == "plan")
        calls = rep["server_calls_physical"] + rep["client_calls_physical"]
        n = pass_steps[p - 1]
        parts = {"unet": calls * fwd_ms / 1e3,
                 **{k: n * v / 1e3 for k, v in per_ms.items()},
                 "plan": plan_s}
        parts["other"] = rep["wall_s"] - sum(parts.values())
        log(f"main/pass{p}/breakdown_s (wall {rep['wall_s']:.2f}, "
            f"{calls} model calls, {n} scan steps): " + json.dumps(
                {k: round(v, 3) for k, v in parts.items()}))
    return launches


def phase_contracts():
    import numpy as np
    import torch
    from repro_torch.configs.ddpm_unet import CONFIG
    from repro_torch.core import prng
    from repro_torch.core.sample_plan import (SampleRequest, plan_requests,
                                              tables_to_device)
    from repro_torch.core.sampler import (make_sample_engine,
                                          sample_plan_reference)
    from repro_torch.core.schedules import DiffusionSchedule
    from repro_torch.core.unet import init_unet, unet_apply
    from repro_torch.launch import collab_serve

    t0 = time.perf_counter()
    collab_serve.main(["--smoke", "--full-unet", "--device", "cuda"])
    log(f"contracts/smoke_s: {time.perf_counter() - t0:.1f}")

    T = 12
    key = prng.PRNGKey(3, device="cuda")
    ks, *kc = prng.split(key, 3)
    sp = init_unet(ks, CONFIG, "cuda")
    cp = [init_unet(k, CONFIG, "cuda") for k in kc]
    sched = DiffusionSchedule.linear(T, device="cuda")
    eye = np.eye(CONFIG.n_classes, dtype=np.float32)
    y = lambda l: np.broadcast_to(eye[l], (B, CONFIG.n_classes)).copy()
    reqs = [SampleRequest(0, 4, y(0)), SampleRequest(1, 0, y(0)),
            SampleRequest(1, T, y(1)), SampleRequest(0, 4, y(0))]
    plan = plan_requests(reqs, T)
    engine = make_sample_engine(sched, unet_apply, IMG)
    out, hand = engine(sp, cp, key, tables_to_device(plan.tables, "cuda"))
    rout, rhand = sample_plan_reference(sp, cp, key, plan, sched,
                                        unet_apply, IMG)
    if not (torch.equal(out, rout) and torch.equal(hand, rhand)):
        raise AssertionError("engine != per-request reference on the card")
    log("contracts/engine_vs_reference: bitwise equal (CONFIG width, "
        "GM/ICM/mid cuts)")


def main() -> int:
    src = ROOT / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        print("chip_smoke: src/repro_torch not found; run from the root of "
              "a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    phase_build()
    records = phase_kernels()
    fwd_ms = phase_unet()
    launches = phase_main_path(fwd_ms)
    phase_contracts()
    replaces = {"ddpm_step": "src/repro/kernels/ddpm_step/kernel.py:43",
                "ddpm_step_batched":
                    "src/repro/kernels/ddpm_step/kernel.py:85"}
    kernels = [dict(name=name, route="cuda",
                    source="src/repro_torch/csrc/ddpm_step.cu",
                    replaces=replaces[name], launches=launches[name],
                    library_ms=None, **records[name])
               for name in ("ddpm_step_batched", "ddpm_step")]
    log(f"total_s: {time.perf_counter() - t_start:.1f}")
    log(json.dumps({"kernels": kernels}))
    log(card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
