"""The reader of ``mamba_mixer_roofline.serve`` on synthetic traces: the
share reckoned by hand from the DiT configuration, and None where nothing
of the mixer's fused kernels was traced."""
import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from bench import spec
from bench.devtrace import TraceSummary

BENCH = Path(__file__).resolve().parent
READ = spec.reader("mamba_mixer_roofline.serve")
CONV = "void (anonymous namespace)::mamba_conv_silu_kernel<__nv_bfloat16, " \
    "4, true>(__nv_bfloat16 const*)"
NORM = "void (anonymous namespace)::mamba_rmsnorm_kernel<__nv_bfloat16, 1, " \
    "true>(__nv_bfloat16 const*)"
GATED = "void (anonymous namespace)::mamba_rmsnorm_gated_kernel<" \
    "__nv_bfloat16, 2, true>(__nv_bfloat16 const*)"


def _cfg(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def _run(cfg, kernels, rows=(64, 64)):
    return SimpleNamespace(kind="serve", config=cfg, slice_rows=list(rows),
                           trace=TraceSummary(kernels, [], 1e-3))


def test_share_by_hand_at_the_dit_shape():
    """64 rows × 64 tokens: conv 2 × 4,096 × 4,224 values plus 5 × 4,224
    of weights and bias, input norm 2 × 4,096 × 2,048 plus the scale,
    output norm 4 × 4,096 × 4,096 plus the scale and 64 float32 D, in bf16
    at 3.35 TB/s (the float32 work binds none of them); two mixers' worth
    of launches over 100 µs of their device time."""
    k = [(CONV, 0, 30_000), (NORM, 30_000, 40_000),
         (GATED, 40_000, 60_000), ("ssd_wgmma_kernel", 60_000, 70_000),
         (CONV, 70_000, 90_000), (NORM, 90_000, 95_000),
         (GATED, 95_000, 110_000)]
    conv = (2 * 4096 * 4224 + 5 * 4224) * 2 / 3.35e12
    norm = (2 * 4096 * 2048 + 2048) * 2 / 3.35e12
    gated = ((4 * 4096 * 4096 + 4096) * 2 + 4 * 64) / 3.35e12
    assert conv > 4096 * 4224 * 12 / 67e12
    assert gated > 4096 * (10 * 4096 + 3) / 67e12
    want = 100 * 2 * (conv + norm + gated) / 100e-6
    got = READ(_run(_cfg("zamba2-hybrid-dit"), k))
    assert got == pytest.approx(want)
    # a wave of 96 and one of 32 rows average to the same 64
    assert READ(_run(_cfg("zamba2-hybrid-dit"), k, (96, 32))) == \
        pytest.approx(want)


@pytest.mark.parametrize("case", ["no mixer launch", "no traced call",
                                  "unet", "not serving", "no trace"])
def test_silent_where_nothing_is_traced(case):
    cfg = _cfg("zamba2-hybrid-dit")
    k = [(CONV, 0, 30_000), ("ssd_wgmma_kernel", 30_000, 40_000)]
    run = _run(cfg, k)
    if case == "no mixer launch":
        run = _run(cfg, [("ssd_wgmma_kernel", 0, 10_000),
                         ("elementwise_kernel", 10_000, 20_000)])
    elif case == "no traced call":
        run.slice_rows = []
    elif case == "unet":
        run = _run(_cfg("ddpm-unet"), [
            ("void_pointwise_mult_and_sum_complex", 0, 10_000)])
    elif case == "not serving":
        run.kind = "train"
    else:
        run.trace = None
    assert READ(run) is None
