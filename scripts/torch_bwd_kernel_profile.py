#!/usr/bin/env python3
"""Where the wgmma backward kernels spend their time on one card: flash
attention and the SSD scan at the Zamba2-1.2B LM training step's shapes
(flash (4, 32, 1024, 64) bf16 causal; the SSD scan (4, 1024, 64, 64),
state 64, chunk 256, bf16), and the grouped matmul's backward at
DBRX-132B's expert shapes for each C of chip_smoke.GMM_BWD_CASES.

    python3 scripts/torch_bwd_kernel_profile.py            # both parts
    python3 scripts/torch_bwd_kernel_profile.py gmm        # one of them
    python3 scripts/torch_bwd_kernel_profile.py flash_ssd

Prints, for each backward launch, its time (CUDA events over 20 launches)
and the device time of each of its kernels (torch.profiler over 5
launches, each with a small torch op so that the profiler's device trace
starts); then the SSD launch timed beside a build of the same source
whose pass 3 does not form C.B (each head block's B_s C_t^T product
removed, its gradients wrong): the difference is what forming C.B again
in every head block costs, against reading it back from a table formed
once per (batch, chunk).  For the grouped matmul's backward (E 16, D
6,144, F 10,752, bf16), at each C, the chosen ``wgmma`` variant and the
older ``wmma`` one (``variant="wmma"``): the time of a launch (CUDA
events) and the device time of its dX and dW kernels apart (the
profiler over 2 launches, each with the small torch op).  The card's
name and power limit come first.  Needs one CUDA device and nvcc; exits
nonzero without them.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CB_PRODUCT = (
    "        wgmma_m64n64k16_ss_t0(bc, kmajor_desc<kRowBytes>(bs, k),\n"
    "                              kmajor_desc<kRowBytes>(cs, k));\n")


# the grouped matmul backward's kernels by variant: (dX, dW) name parts
GMM_BWD_KERNELS = {"wgmma": ("wgmma_kernel<false>", "wgmma_kernel<true>"),
                   "wmma": ("gmm_bwd_dx_kernel", "gmm_bwd_dw_kernel")}


def gmm_bwd_profile(cs) -> None:
    """The grouped matmul's backward at each case of GMM_BWD_CASES, wgmma
    and wmma: a launch's time and its dX / dW device split."""
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels.grouped_matmul import kernel as gkernel
    arch = get_arch(cs.MOE_ARCH)
    E, D, F = arch.n_experts, arch.d_model, arch.d_ff
    g = torch.Generator(device="cuda").manual_seed(23)
    rn = lambda *shape: torch.randn(shape, generator=g, device="cuda")
    small = torch.ones(8, device="cuda")
    bf16 = torch.bfloat16
    for what, C, broadcast in cs.GMM_BWD_CASES:
        tok = rn(C, D).to(bf16).unsqueeze(0).expand(E, -1, -1) \
            if broadcast else rn(E, C, D).to(bf16)
        w = (rn(E, D, F) * D ** -0.5).to(bf16)
        dy = rn(E, C, F).to(bf16)
        bound, by = cs.gmm_bwd_bound(E, C, D, F, 2, broadcast)
        times = {}
        for variant in ("wgmma", "wmma"):
            asked = None if variant == "wgmma" else variant
            fn = lambda: gkernel.launch_backward(tok, w, dy, variant=asked)
            before = dict(gkernel.COUNTS)
            fn()
            ran = cs.launched_variant(gkernel, "grouped_matmul_bwd", before)
            if ran != variant:
                raise AssertionError(f"{what}: launched {ran}, not {variant}")
            iters = 3 if C >= 1280 else 10
            times[variant] = ms = cs.time_ms(fn, iters=iters, warmup=1)
            print(f"grouped_matmul_bwd {what} {(E, C, D, F)} ({variant}): "
                  f"{ms:.4f} ms a launch (events), bound {bound:.4f} ms "
                  f"({by}): {100 * bound / ms:.2f}% of the bound's rate, "
                  f"{4 * E * C * D * F / ms / 1e9:.1f} TFLOP/s", flush=True)

            def profiled(fn=fn):
                small.add_(1)
                fn()
            dx, dw = GMM_BWD_KERNELS[variant]
            parts = cs.device_ms(f"grouped_matmul_bwd {what} ({variant})",
                                 profiled, n=2, top=3, shares=[dx, dw],
                                 per="launch")
            print(f"grouped_matmul_bwd {what} ({variant}): dX "
                  f"{parts[dx]} ms, dW {parts[dw]} ms a launch (device)",
                  flush=True)
        print(f"grouped_matmul_bwd {what}: wgmma / wmma "
              f"{times['wgmma'] / times['wmma']:.3f}", flush=True)
        del tok, w, dy
        torch.cuda.empty_cache()


def main() -> int:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    parts = sys.argv[1:] or ["flash_ssd", "gmm"]
    if not set(parts) <= {"flash_ssd", "gmm"}:
        print(f"unknown parts {parts}: flash_ssd, gmm", file=sys.stderr)
        return 2
    import torch.nn.functional as F
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.kernels.ssd_scan import kernel as skernel

    torch.set_grad_enabled(False)
    print(cs.card_line(), flush=True)
    if "gmm" in parts:
        gmm_bwd_profile(cs)
    if "flash_ssd" not in parts:
        print(cs.card_line())
        return 0
    g = torch.Generator(device="cuda").manual_seed(20)
    rn = lambda *shape: torch.randn(shape, generator=g, device="cuda")
    bf16 = torch.bfloat16
    (B, H, Hkv, S, dh), causal, window = cs.FLASH_BWD_PATH
    q, dout = rn(B, H, S, dh).to(bf16), rn(B, H, S, dh).to(bf16)
    k, v = rn(B, Hkv, S, dh).to(bf16), rn(B, Hkv, S, dh).to(bf16)
    lse = torch.empty((B, H, S), device="cuda")
    out = fkernel.launch(q, k, v, causal, window, lse=lse)
    fargs = (q, k, v, out, dout, lse, causal, window)
    b, s, h, p, n, chunk = cs.SSD_BWD_PATH
    sargs = (rn(b, s, h, p).to(bf16), F.softplus(rn(b, s, h) - 1),
             -torch.exp(rn(h)), rn(b, s, n).to(bf16), rn(b, s, n).to(bf16),
             chunk, rn(b, s, h, p).to(bf16))
    small = torch.ones(8, device="cuda")

    for name, fn, kernels in (
            ("flash_attention_bwd", lambda: fkernel.launch_backward(*fargs),
             ["flash_bwd_delta", "flash_bwd_dkdv_wg", "flash_bwd_dq_wg"]),
            ("ssd_scan_bwd", lambda: skernel.launch_backward(*sargs),
             ["ssd_bwd_states_wg", "ssd_bwd_recur", "ssd_bwd_chunk_wg",
              "ssd_bwd_reduce_bc", "ssd_bwd_reduce_a"])):
        ms = cs.time_ms(fn, iters=20, warmup=2)
        print(f"{name} (wgmma): {ms:.4f} ms a launch (events)", flush=True)

        def profiled(fn=fn):
            small.add_(1)
            fn()
        cs.device_ms(name, profiled, n=5, shares=kernels, per="launch")

    # pass 3 without C.B: the same source with the product removed
    src = (build.CSRC / skernel.BWD_SOURCE).read_text()
    if src.count(CB_PRODUCT) != 1:
        print("the C.B product's line is not in the source", file=sys.stderr)
        return 2
    out_dir = ROOT / "build" / "bwd_profile"
    out_dir.mkdir(parents=True, exist_ok=True)
    patched = out_dir / "ssd_scan_bwd_no_cb.cu"
    patched.write_text(src.replace(CB_PRODUCT, "        ;\n"))
    lib = out_dir / "ssd_scan_bwd_no_cb.so"
    done = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I",
                           str(build.CSRC), "-o", str(lib), str(patched)],
                          capture_output=True, text=True)
    if done.returncode != 0:
        print(done.stdout + done.stderr, file=sys.stderr)
        return done.returncode
    fn = getattr(ctypes.CDLL(str(lib)), "ssd_scan_bwd_launch")
    fn.argtypes, fn.restype = skernel._BWD_ARGTYPES, ctypes.c_int
    key = (skernel.BWD_SOURCE, "ssd_scan_bwd_launch")
    launch = lambda: skernel.launch_backward(*sargs)
    times = {}
    for label in ("with C.B", "without C.B", "without C.B", "with C.B"):
        real = build._BOUND[key]
        if label == "without C.B":
            build._BOUND[key] = fn
        try:
            times.setdefault(label, []).append(
                cs.time_ms(launch, iters=20, warmup=2))
        finally:
            build._BOUND[key] = real
    with_cb = sum(times["with C.B"]) / 2
    without = sum(times["without C.B"]) / 2
    print(f"ssd_scan_bwd (wgmma) with C.B formed in every head block: "
          f"{times['with C.B']} ms; without it: {times['without C.B']} ms; "
          f"forming C.B costs {with_cb - without:.4f} ms a launch "
          f"({100 * (with_cb - without) / with_cb:.1f}%)", flush=True)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
