#!/usr/bin/env python3
"""Where the two wgmma backward kernels spend their time on one card, at
the Zamba2-1.2B LM training step's shapes (flash attention (4, 32, 1024,
64) bf16 causal; the SSD scan (4, 1024, 64, 64), state 64, chunk 256,
bf16).

    python3 scripts/torch_bwd_kernel_profile.py

Prints, for each backward launch, its time (CUDA events over 20 launches)
and the device time of each of its kernels (torch.profiler over 5
launches, each with a small torch op so that the profiler's device trace
starts); then the SSD launch timed beside a build of the same source
whose pass 3 does not form C.B (each head block's B_s C_t^T product
removed, its gradients wrong): the difference is what forming C.B again
in every head block costs, against reading it back from a table formed
once per (batch, chunk).  The card's name and power limit come first.
Needs one CUDA device and nvcc; exits nonzero without them.
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


def main() -> int:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    import torch.nn.functional as F
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.kernels.ssd_scan import kernel as skernel

    torch.set_grad_enabled(False)
    print(cs.card_line(), flush=True)
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
