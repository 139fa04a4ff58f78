"""The Mamba2 mixer's fused glue kernels (kernels/mamba_mixer,
csrc/mamba_mixer.cu) and the route that picks them in
``models/ssm.mamba_forward``.

On the CPU: the route (eager on the CPU, under ``DTensor``, with autograd
and at widths the kernels do not take; the kernels on plain CUDA and meta
tensors without a gradient),
the meta route's shapes, types and operation counts, ``mamba_forward``'s
CPU output bitwise the eager composition it always computed, the
launches' checks (run before the device check, so they run here) and the
cost at the DiT's shape.

On the card (``cuda`` marker; skips without a device; no JAX in this
file): each kernel bitwise the eager route over a sweep of types, steps,
channels and batch (the norms add up their row sums in the order of
aten's reduction, whose team of threads a row changes with the row count,
so the steps and batch cover each team), and at the widest row the norms
take; planted faults, in bf16 and in float32, that must break that
equality; and a reduced hybrid DiT's forward, fused bitwise eager.
"""
import dataclasses
from types import SimpleNamespace

import pytest
import torch
import torch.nn.functional as F

from repro_torch import kernels
from repro_torch.configs.base import get_arch, reduced
from repro_torch.kernels.mamba_mixer import cost, kernel, ops
from repro_torch.models import ssm
from repro_torch.models.layers import rmsnorm

torch.set_num_threads(1)

BF16, F32 = torch.bfloat16, torch.float32
# the CUDA sweep: steps (1 and 3 below the conv width; at batch 1, 1, 3, 7
# and 13 rows give aten's reduction teams of 512, 256, 128 and 64 threads a
# row, 64 rows and more its warp a row), channels of x (128, 2,048, 4,096
# and one not a multiple of 8), with B/C's 2n beside them, batch
SWEEP_S = [1, 3, 7, 13, 64, 257]
SWEEP_C = [(128, 64, 64), (2048, 64, 64), (4096, 64, 64),
           (132, 5, 33)]                                  # Cx, n, head dim
SWEEP_B = [1, 64]


def _arch(dtype="float32", **kw):
    return reduced(get_arch("zamba2-1.2b"), dtype=dtype, **kw)


def _mixer(arch, device="cpu", seed=0):
    """A mixer with every parameter drawn (conv biases, norm scales and D
    away from their init's zeros and ones, so each shows)."""
    gen = torch.Generator().manual_seed(seed)
    m = ssm.Mamba(arch, arch.torch_dtype, "cpu")
    with torch.no_grad():
        for name, p in m.named_parameters():
            v = torch.randn(p.shape, generator=gen)
            if name.endswith(".weight"):
                v = v / p.shape[-1] ** 0.5
            elif name.startswith("conv_"):
                v = v * 0.5
            elif name.endswith("scale"):
                v = 1 + v * 0.1
            elif name == "A_log":
                v = torch.log(torch.linspace(1.0, 16.0, p.shape[0]))
            elif name == "dt_bias":
                v = torch.full(p.shape, -4.6)
            p.copy_(v.to(p.dtype))
    return m.to(device)


def _eager_mamba_forward(params, x, cfg, return_state=False):
    """``mamba_forward`` as it was before the fused route, verbatim."""
    B_, S, _ = x.shape
    di, n, h, p = (cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_n_heads,
                   cfg.ssm_head_dim)
    xn = rmsnorm(params.norm, x, cfg.norm_eps)
    z = params.z_proj(xn)
    x_raw = params.x_proj(xn)
    bc_raw = params.bc_proj(xn)
    xc = ssm._causal_conv(x_raw, params.conv_x_w, params.conv_x_b)
    bc = ssm._causal_conv(bc_raw, params.conv_bc_w, params.conv_bc_b)
    xs = xc.reshape(B_, S, h, p)
    Bm, Cm = bc[..., :n], bc[..., n:]
    dt = F.softplus(params.dt_proj(xn).float() + params.dt_bias)
    A = -torch.exp(params.A_log)
    y, final_state = ssm.ssd_ops.ssd_scan(xs, dt, A, Bm, Cm,
                                          min(cfg.ssm_chunk, S))
    y = y + xs * params.D[None, None, :, None].to(y.dtype)
    y = y.reshape(B_, S, di)
    y = rmsnorm(params.out_norm, y * F.silu(z), cfg.norm_eps)
    out = x + params.out_proj(y)
    if return_state:
        K = cfg.ssm_conv_kernel
        conv = torch.cat([t[:, -(K - 1):] for t in (x_raw, bc_raw)], dim=-1)
        return out, {"ssm": final_state, "conv": conv}
    return out


@pytest.fixture
def clean():
    kernel.reset_counts()
    kernels.reset_flops()
    yield
    kernel.reset_counts()
    kernels.reset_flops()


# ---- the route ---------------------------------------------------------

def test_route_eager_on_cpu_and_with_autograd_kernels_on_meta():
    arch = _arch("bfloat16")
    m = ssm.Mamba(arch, BF16, "meta")
    meta = torch.empty(2, 8, arch.d_model, dtype=BF16, device="meta")
    cpu = torch.zeros(2, 8, arch.d_model, dtype=BF16)
    with torch.no_grad():
        assert ops.takes_kernels(meta, m)
        assert not ops.takes_kernels(cpu, m)
        assert not ops.takes_kernels(meta.to(torch.float16), m)
    # grad enabled: the parameters need a gradient (training), or the input
    assert not ops.takes_kernels(meta, m)
    m.requires_grad_(False)
    assert ops.takes_kernels(meta, m)
    assert not ops.takes_kernels(meta.clone().requires_grad_(), m)


@pytest.mark.parametrize("widths", [dict(d_model=120), dict(ssm_conv_kernel=5)],
                         ids=["norm row under 128", "conv width 5"])
def test_route_eager_at_widths_the_kernels_do_not_take(widths):
    arch = _arch("bfloat16", **widths)
    m = ssm.Mamba(arch, BF16, "meta")
    x = torch.empty(2, 8, arch.d_model, dtype=BF16, device="meta")
    sound = _arch("bfloat16")
    with torch.no_grad():
        assert not ops.takes_kernels(x, m)
        assert ops.takes_kernels(                # the control
            torch.empty(2, 8, sound.d_model, dtype=BF16, device="meta"),
            ssm.Mamba(sound, BF16, "meta"))


def test_route_eager_under_dtensor():
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate
    from torch.testing._internal.distributed.fake_pg import FakeStore
    arch = _arch("bfloat16")
    m = ssm.Mamba(arch, BF16, "meta")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
    try:
        mesh = DeviceMesh("cpu", torch.arange(1))
        x = DTensor.from_local(
            torch.empty(2, 8, arch.d_model, dtype=BF16, device="meta"), mesh,
            [Replicate()])
        assert x.device.type == "meta"
        with torch.no_grad():
            assert not ops.takes_kernels(x, m)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("dtype", [BF16, F32])
def test_meta_route_shapes_and_counts(clean, dtype):
    """A mixer on meta without a gradient: the card's shapes and types,
    three launches' operations in ``kernels.FLOPS`` beside the scan's,
    and no launch counted (nothing ran); with autograd the eager route,
    so none of the three."""
    name = {BF16: "bfloat16", F32: "float32"}[dtype]
    arch = _arch(name)
    b, s, d, di, n = 2, 40, arch.d_model, arch.ssm_d_inner, arch.ssm_state
    m = ssm.Mamba(arch, dtype, "meta")
    x = torch.empty(b, s, d, dtype=dtype, device="meta")
    with torch.no_grad():
        out, state = ssm.mamba_forward(m, x, arch, return_state=True)
        xc, Bm, Cm = kernel.launch_conv_silu(
            torch.empty(b, s, di, dtype=dtype, device="meta"),
            torch.empty(b, s, 2 * n, dtype=dtype, device="meta"),
            m.conv_x_w, m.conv_x_b, m.conv_bc_w, m.conv_bc_b)
    assert out.shape == x.shape and out.dtype == dtype and out.is_meta
    assert state["conv"].shape == (b, arch.ssm_conv_kernel - 1, di + 2 * n)
    assert (xc.shape, Bm.shape, Cm.shape) == ((b, s, di), (b, s, n),
                                              (b, s, n))
    assert all(t.dtype == dtype and t.is_contiguous() for t in (xc, Bm, Cm))
    item, rows = x.element_size(), b * s
    conv = cost.conv_silu_cost(rows, di + 2 * n, arch.ssm_conv_kernel,
                               item)[1]
    assert {k: v for k, v in kernels.FLOPS.items() if k != "ssd_scan"} == {
        "mamba_rmsnorm": cost.rmsnorm_cost(rows, d, item)[1],
        "mamba_conv_silu": 2 * conv,
        "mamba_rmsnorm_gated": cost.rmsnorm_cost(
            rows, di, item, arch.ssm_n_heads)[1]}
    assert not any(kernel.COUNTS.values())
    kernels.reset_flops()
    ssm.mamba_forward(m, x, arch)
    assert set(kernels.FLOPS) == {"ssd_scan"}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_forward_on_cpu_is_the_eager_composition(clean, dtype):
    """The CPU route is the eager code as it stood: bitwise, output and
    decode state, with and without a gradient."""
    arch = _arch(dtype)
    m = _mixer(arch)
    x = torch.randn(2, 37, arch.d_model,
                    generator=torch.Generator().manual_seed(1)
                    ).to(arch.torch_dtype)
    with torch.no_grad():
        out, st = ssm.mamba_forward(m, x, arch, return_state=True)
        ref, ref_st = _eager_mamba_forward(m, x, arch, return_state=True)
    assert torch.equal(out, ref)
    assert torch.equal(st["ssm"], ref_st["ssm"])
    assert torch.equal(st["conv"], ref_st["conv"])
    assert torch.equal(ssm.mamba_forward(m, x, arch), ref)
    assert not kernels.FLOPS and not any(kernel.COUNTS.values())


# ---- the launches' checks (device last) --------------------------------

def _conv_args(dtype=BF16, b=2, s=5, cx=16, n=4, k=4, device="cpu"):
    t = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    return [t(b, s, cx), t(b, s, 2 * n), t(k, cx), t(cx), t(k, 2 * n),
            t(2 * n)]


@pytest.mark.parametrize("fault,error,match", [
    ("width 5", ValueError, "conv width 5"),
    ("float16", TypeError, "float32 or bfloat16"),
    ("mixed types", TypeError, "b_bc is torch.float32"),
    ("strided x", ValueError, "x is not contiguous"),
    ("odd B/C", ValueError, "bc"),
    ("bias shape", ValueError, "b_x"),
    ("cpu tensors", ValueError, "expected one CUDA device"),
])
def test_conv_launch_refuses(fault, error, match):
    args = _conv_args(k=5) if fault == "width 5" else _conv_args()
    if fault == "float16":
        args = _conv_args(torch.float16)
    elif fault == "mixed types":
        args[5] = args[5].float()
    elif fault == "strided x":
        args[0] = torch.zeros(2, 16, 5, dtype=BF16).transpose(1, 2)
    elif fault == "odd B/C":
        args[1] = torch.zeros(2, 5, 7, dtype=BF16)
    elif fault == "bias shape":
        args[3] = torch.zeros(15, dtype=BF16)
    with pytest.raises(error, match=match):
        kernel.launch_conv_silu(*args)


@pytest.mark.parametrize("fault,error,match", [
    ("scale shape", ValueError, "scale"),
    ("D float16", ValueError, "D"),
    ("D not dividing d", ValueError, "D"),
    ("z shape", ValueError, "z"),
    ("row too long", ValueError, "a row of 7940 values"),
    ("row not a multiple of 4", ValueError, "a row of 130 values"),
    ("cpu tensors", ValueError, "expected one CUDA device"),
])
def test_rmsnorm_launch_refuses(fault, error, match):
    d = 128
    x, xs, z = (torch.zeros(3, d, dtype=BF16) for _ in range(3))
    scale, D = torch.ones(d, dtype=BF16), torch.ones(4)
    if fault == "scale shape":
        scale = torch.ones(d + 1, dtype=BF16)
    elif fault == "D float16":
        D = D.half()
    elif fault == "D not dividing d":
        D = torch.ones(5)
    elif fault == "z shape":
        z = torch.zeros(3, d + 8, dtype=BF16)
    elif fault in ("row too long", "row not a multiple of 4"):
        x = xs = z = torch.zeros(1, 7940 if fault == "row too long" else 130,
                                 dtype=BF16)
        scale = torch.ones(x.shape[-1], dtype=BF16)
        D = torch.ones(1)
    with pytest.raises(error, match=match):
        kernel.launch_rmsnorm(x, scale, 1e-5, xs, D, z)


def test_cost_at_the_dit_shape():
    """A mixer of the benchmark's DiT at 64 images × 64 tokens: 69 MB
    through the conv, 34 MB through the input norm, 134 MB through the
    output norm, each input read once and each output written once."""
    rows = 64 * 64
    assert cost.conv_silu_cost(rows, 4096 + 128, 4, 2)[0] == \
        2 * (2 * rows * 4224 + 5 * 4224)
    assert cost.rmsnorm_cost(rows, 2048, 2)[0] == 2 * (2 * rows * 2048 + 2048)
    assert cost.rmsnorm_cost(rows, 4096, 2, 64)[0] == \
        2 * (4 * rows * 4096 + 4096) + 4 * 64
    mb = [cost.conv_silu_cost(rows, 4224, 4, 2)[0] / 1e6,
          cost.rmsnorm_cost(rows, 2048, 2)[0] / 1e6,
          cost.rmsnorm_cost(rows, 4096, 2, 64)[0] / 1e6]
    assert [round(v) for v in mb] == [69, 34, 134]


# ---- on the card -------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with -m cuda)")
    return torch.device("cuda", 0)


def ulps(a, ref):
    """|a - ref| in units in the last place of their type, elementwise
    (the distance between the two values' ordered bit patterns)."""
    bits, mag = {BF16: (torch.int16, 0x7FFF),
                 F32: (torch.int32, 0x7FFFFFFF)}[ref.dtype]

    def ordered(t):
        v = t.contiguous().view(bits).long()
        return torch.where(v < 0, -(v & mag), v)
    return (ordered(a) - ordered(ref)).abs()


def _differ(a, ref):
    """(values that differ, largest gap in ulps)."""
    return int((a != ref).sum()), int(ulps(a, ref).max())


def _norm(x, scale, eps):
    return rmsnorm(SimpleNamespace(scale=scale), x, eps)


def _gated_eager(y, scale, eps, xs, D, z, p):
    """The mixer's eager D skip, gate and output norm on (b, s, d)."""
    b, s, d = y.shape
    y4 = y.reshape(b, s, d // p, p) + xs.reshape(b, s, d // p, p) * \
        D[None, None, :, None].to(y.dtype)
    return _norm(y4.reshape(b, s, d) * F.silu(z), scale, eps)


def _case(dtype, b, s, cx, n, p, dev, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *shape, scale=1.0: (torch.randn(
        shape, generator=gen, device=dev) * scale).to(dtype)
    k = 4
    return dict(x=r(b, s, cx), bc=r(b, s, 2 * n), w_x=r(k, cx, scale=0.5),
                b_x=r(cx, scale=0.5), w_bc=r(k, 2 * n, scale=0.5),
                b_bc=r(2 * n, scale=0.5), scale=1 + r(cx, scale=0.1),
                y=r(b, s, cx), z=r(b, s, cx),
                D=torch.randn(cx // p, generator=gen, device=dev), p=p, n=n)


@pytest.mark.cuda
@pytest.mark.parametrize("b", SWEEP_B)
@pytest.mark.parametrize("cx,n,p", SWEEP_C)
@pytest.mark.parametrize("s", SWEEP_S)
@pytest.mark.parametrize("dtype", [BF16, F32])
def test_cuda_kernels_match_the_eager_route(clean, dtype, s, cx, n, p, b):
    dev = _cuda()
    c = _case(dtype, b, s, cx, n, p, dev)
    eps = 1e-5
    with torch.no_grad():
        xc, Bm, Cm = kernel.launch_conv_silu(c["x"], c["bc"], c["w_x"],
                                             c["b_x"], c["w_bc"], c["b_bc"])
        ref_x = ssm._causal_conv(c["x"], c["w_x"], c["b_x"])
        ref_bc = ssm._causal_conv(c["bc"], c["w_bc"], c["b_bc"])
        xn = kernel.launch_rmsnorm(c["x"], c["scale"], eps)
        out = kernel.launch_rmsnorm(c["y"], c["scale"], eps, xc, c["D"],
                                    c["z"])
        ref_out = _gated_eager(c["y"], c["scale"], eps, ref_x, c["D"],
                               c["z"], p)
    torch.cuda.synchronize()
    assert kernel.COUNTS == {"mamba_conv_silu": 1, "mamba_rmsnorm": 1,
                             "mamba_rmsnorm_gated": 1}
    assert Bm.is_contiguous() and Cm.is_contiguous()
    gaps = {"x conv": _differ(xc, ref_x),
            "B conv": _differ(Bm, ref_bc[..., :n]),
            "C conv": _differ(Cm, ref_bc[..., n:]),
            "input norm": _differ(xn, _norm(c["x"], c["scale"], eps)),
            "output norm": _differ(out, ref_out)}
    assert all(g == (0, 0) for g in gaps.values()), gaps


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 3, 7, 13, 64])
@pytest.mark.parametrize("dtype", [BF16, F32])
def test_cuda_norms_at_the_widest_row(clean, dtype, s):
    """Rows of 7,936 values, the widest aten still sums without splitting a
    row across warps, at each team width: both norms bitwise eager."""
    dev = _cuda()
    c = _case(dtype, 1, s, kernel.NORM_WIDTHS[1], 2, 62, dev, seed=2)
    xc = ssm._causal_conv(c["x"], c["w_x"], c["b_x"]).contiguous()
    with torch.no_grad():
        xn = kernel.launch_rmsnorm(c["x"], c["scale"], 1e-5)
        out = kernel.launch_rmsnorm(c["y"], c["scale"], 1e-5, xc, c["D"],
                                    c["z"])
    gaps = {"input norm": _differ(xn, _norm(c["x"], c["scale"], 1e-5)),
            "output norm": _differ(out, _gated_eager(
                c["y"], c["scale"], 1e-5, xc, c["D"], c["z"], 62))}
    assert all(g == (0, 0) for g in gaps.values()), gaps


@pytest.mark.cuda
def test_cuda_norm_refuses_a_view_off_the_4_value_alignment(clean):
    dev = _cuda()
    x = torch.zeros(3 * 128 + 1, dtype=BF16, device=dev)[1:].view(3, 128)
    with torch.no_grad(), pytest.raises(ValueError, match="not aligned"):
        kernel.launch_rmsnorm(x, torch.ones(128, dtype=BF16, device=dev),
                              1e-5)
    assert not any(kernel.COUNTS.values())


def _faults():
    """Each planted fault: (the kernel output it is held against, the
    faulted eager version of it)."""
    def shifted(c):
        x = c["x"]
        late = torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)
        return "xc", ssm._causal_conv(late, c["w_x"], c["b_x"])

    def no_bias(c):
        return "xc", ssm._causal_conv(c["x"], c["w_x"],
                                      torch.zeros_like(c["b_x"]))

    def no_gate(c):
        xc = ssm._causal_conv(c["x"], c["w_x"], c["b_x"])
        b, s, d = c["y"].shape
        p = c["p"]
        y = c["y"].reshape(b, s, d // p, p) + xc.reshape(b, s, d // p, p) * \
            c["D"][None, None, :, None].to(c["y"].dtype)
        return "out", _norm(y.reshape(b, s, d), c["scale"], 1e-5)

    def inv_float32(c):
        x32 = c["x"].float()
        inv = torch.rsqrt((x32 * x32).sum(-1, keepdim=True) /
                          x32.shape[-1] + 1e-5)
        return "xn", (c["x"] * inv * c["scale"]).to(c["x"].dtype)

    def sum_reversed(c):
        x = c["x"]
        var = torch.square(x).flip(-1).sum(-1, keepdim=True) / x.shape[-1]
        return "xn", x * torch.rsqrt(var + 1e-5) * c["scale"]

    return {"causal window shifted by one": shifted,
            "bias dropped": no_bias, "gate skipped": no_gate,
            "inv left in float32": inv_float32,
            "row sum in another order": sum_reversed}


# "inv left in float32" is the sound float32 route; "row sum in another
# order" moves a bf16 norm only where a sum lies at a rounding edge of inv
FAULTS = [(BF16, f) for f in sorted(_faults())
          if f != "row sum in another order"] + \
    [(F32, f) for f in sorted(_faults()) if f != "inv left in float32"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,fault", FAULTS,
                         ids=[f"{str(d)[6:]}-{f}" for d, f in FAULTS])
def test_cuda_planted_faults_fail_the_comparison(clean, dtype, fault):
    """At the DiT's widths (4 images × 64 tokens, d_inner 4,096), each
    fault of the eager version differs from what the kernels give, where
    the sound version equals it (the sweep above)."""
    dev = _cuda()
    c = _case(dtype, 4, 64, 4096, 64, 64, dev, seed=3)
    with torch.no_grad():
        got = {"xc": kernel.launch_conv_silu(c["x"], c["bc"], c["w_x"],
                                             c["b_x"], c["w_bc"],
                                             c["b_bc"])[0],
               "xn": kernel.launch_rmsnorm(c["x"], c["scale"], 1e-5)}
        got["out"] = kernel.launch_rmsnorm(c["y"], c["scale"], 1e-5,
                                           got["xc"], c["D"], c["z"])
        which, faulted = _faults()[fault](c)
    assert _differ(got[which], faulted)[0] > 0, fault


@pytest.mark.cuda
def test_cuda_dit_forward_fused_against_eager(clean):
    """A reduced hybrid DiT (3 Mamba2 layers and the shared block at the
    DiT's head dims, bf16) on the card: under ``no_grad`` every mixer runs
    the three kernels; with autograd (its parameters need a gradient) the
    eager route; the two outputs bitwise equal."""
    from repro_torch.core import prng
    from repro_torch.core.dit import DiTConfig, dit_apply, init_dit
    dev = _cuda()
    arch = dataclasses.replace(
        _arch("bfloat16"), d_model=256, n_heads=4, n_kv_heads=4,
        head_dim=64, ssm_state=64, ssm_head_dim=64, ssm_chunk=64)
    cfg = DiTConfig(image_size=16, channels=3, patch_size=2, n_classes=8)
    model = init_dit(prng.PRNGKey(0, device=dev), arch, cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(8, 16, 16, 3, generator=gen, device=dev)
    t = torch.linspace(1.0, 200.0, 8, device=dev)
    y = torch.zeros(8, 8, device=dev)
    y[torch.arange(8), torch.arange(8)] = 1.0
    with torch.no_grad():
        fused = dit_apply(model, x, t, y, arch, cfg)
    assert kernel.COUNTS == {"mamba_conv_silu": 3, "mamba_rmsnorm": 3,
                             "mamba_rmsnorm_gated": 3}
    eager = dit_apply(model, x, t, y, arch, cfg).detach()
    torch.cuda.synchronize()
    assert kernel.COUNTS["mamba_conv_silu"] == 3
    assert torch.equal(fused, eager), _differ(fused, eager)
