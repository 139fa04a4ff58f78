"""The grouped matmul's backward: its plain version, its wrapper's checks,
its autograd route, and on the card its kernel.

* ``grouped_matmul_bwd_ref`` (dX = dY·Wᵀ per expert and dW = Xᵀ·dY, in
  float32, each cast once) against ``torch.autograd`` of
  ``grouped_matmul_ref`` and against ``jax.vjp`` of the JAX package's
  reference einsum (``kernels/grouped_matmul/ref.grouped_matmul_ref``),
  with tokens broadcast to every expert (the dense MoE's ``expand``,
  expert stride 0; dX per expert, and summed over the experts against
  the vjp of the broadcast) and capacity-packed (the expert-parallel
  path's); float32 within TOL, bfloat16 within TOL_BF16.  The whole
  expert FFN's gradients (``_expert_ffn``) against ``jax.vjp`` of JAX's.
* ``kernel.launch_backward``'s checks of shape, type, strides and the
  ``variant=`` rule, each reachable on the CPU because the device is
  checked last; ``choose_variant_backward`` over dtype, D and F off a
  multiple of 8, misaligned and overlapping operands; ``bwd_tma_maps``
  against geometry worked out by hand; the counters.
* ``ops.GroupedMatmulFn`` with its two launches swapped for the plain
  versions (a CPU stand-in for the kernels): the gradients of packed and
  broadcast tokens and of the weights equal autograd's of the plain
  version, so the Function's wiring (saved tensors, the broadcast's sum,
  ``needs_input_grad``) holds.
* On the card (``cuda`` marker; skips without a device): the kernel in
  every variant against ``grouped_matmul_bwd_ref`` on the same inputs,
  with broadcast, packed and misaligned tokens, ragged shapes (C 1, 80
  and 257, D and F off the wgmma tile), each case naming the variant it
  must launch, rows of dX bitwise across C and two launches bitwise;
  ``variant="wmma"`` beside the chosen ``wgmma``; the op under grad
  against the CPU's autograd.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.grouped_matmul.ref import grouped_matmul_ref as jgmm_ref
from repro.models import moe as jmoe
from repro_torch.kernels.grouped_matmul import kernel, ops
from repro_torch.kernels.grouped_matmul.ref import (grouped_matmul_bwd_ref,
                                                    grouped_matmul_ref)
from repro_torch.models import moe as tmoe

torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=2e-3)
TOL_BF16 = dict(atol=5e-2, rtol=5e-2)
SHAPES = [(4, 24, 16, 40), (3, 7, 9, 11), (2, 80, 32, 24)]


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _inputs(E, C, D, F, broadcast, dtype=torch.float32, seed=0):
    x = _rand((C, D) if broadcast else (E, C, D), seed)
    w = _rand((E, D, F), seed + 1)
    g = _rand((E, C, F), seed + 2)
    xt = torch.from_numpy(x).to(dtype)
    tok = xt.unsqueeze(0).expand(E, -1, -1) if broadcast else xt
    return x, w, g, xt, tok, torch.from_numpy(w).to(dtype), \
        torch.from_numpy(g).to(dtype)


@pytest.mark.parametrize("broadcast", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_bwd_ref_matches_autograd_and_jax_vjp(shape, broadcast):
    E, C, D, F = shape
    x, w, g, xt, tok, wt, gt = _inputs(E, C, D, F, broadcast)
    dtok, dw = grouped_matmul_bwd_ref(tok, wt, gt)
    assert dtok.shape == (E, C, D) and dw.shape == (E, D, F)
    assert dtok.dtype == dw.dtype == torch.float32
    # torch.autograd of the plain forward, at the tokens as given
    tg = tok.detach().clone().requires_grad_()
    wg = wt.clone().requires_grad_()
    a_tok, a_w = torch.autograd.grad(grouped_matmul_ref(tg, wg), (tg, wg),
                                     gt)
    np.testing.assert_allclose(dtok.numpy(), a_tok.numpy(), **TOL)
    np.testing.assert_allclose(dw.numpy(), a_w.numpy(), **TOL)
    # jax.vjp of the reference einsum; broadcast tokens are one (C, D)
    # set, whose gradient is the sum over the experts
    if broadcast:
        f = lambda xx, ww: jgmm_ref(jnp.broadcast_to(xx, (E, C, D)), ww)
    else:
        f = jgmm_ref
    _, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w))
    j_tok, j_w = vjp(jnp.asarray(g))
    got_tok = dtok.sum(0) if broadcast else dtok
    np.testing.assert_allclose(got_tok.numpy(), np.asarray(j_tok), **TOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(j_w), **TOL)


@pytest.mark.parametrize("broadcast", [True, False])
def test_bwd_ref_bf16_matches_float32(broadcast):
    E, C, D, F = SHAPES[0]
    x, w, g, _, tok, wt, gt = _inputs(E, C, D, F, broadcast,
                                      torch.bfloat16, seed=3)
    dtok, dw = grouped_matmul_bwd_ref(tok, wt, gt)
    assert dtok.dtype == dw.dtype == torch.bfloat16
    f32 = grouped_matmul_bwd_ref(tok.float(), wt.float(), gt.float())
    for got, ref in zip((dtok, dw), f32):
        np.testing.assert_allclose(got.float().numpy(), ref.numpy(),
                                   **TOL_BF16)
    # one rounding of the float32 sum
    assert torch.equal(dtok, f32[0].bfloat16()) and \
        torch.equal(dw, f32[1].bfloat16())


def test_expert_ffn_gradients_match_jax():
    """The FFN's three products (gate and up on broadcast tokens, down on
    the packed (E, C, F) product) under autograd against jax.vjp of JAX's
    ``_expert_ffn``."""
    E, C, D, F = 4, 12, 16, 24
    x, wg_, wu_, wd_ = (_rand(s, i) for i, s in enumerate(
        [(C, D), (E, D, F), (E, D, F), (E, F, D)]))
    dy = _rand((E, C, D), 9)
    _, vjp = jax.vjp(
        lambda xx, a, b, c: jmoe._expert_ffn(
            a, b, c, jnp.broadcast_to(xx, (E, C, D))),
        *(jnp.asarray(a) for a in (x, wg_, wu_, wd_)))
    jg = vjp(jnp.asarray(dy))
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, wg_, wu_, wd_)]
    y = tmoe._expert_ffn(ts[1], ts[2], ts[3],
                         ts[0].unsqueeze(0).expand(E, -1, -1))
    tg = torch.autograd.grad(y, ts, torch.from_numpy(dy))
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def _bad(**kw):
    args = dict(tokens=torch.zeros(2, 5, 8), weights=torch.zeros(2, 8, 6),
                dout=torch.zeros(2, 5, 6))
    args.update(kw)
    return args


@pytest.mark.parametrize("args,err,match", [
    (_bad(tokens=torch.zeros(5, 8)), ValueError, "3 dimensions"),
    (_bad(weights=torch.zeros(2, 8, 6, dtype=torch.bfloat16)), TypeError,
     "one dtype"),
    (_bad(tokens=torch.zeros(2, 5, 8, dtype=torch.float16),
          weights=torch.zeros(2, 8, 6, dtype=torch.float16),
          dout=torch.zeros(2, 5, 6, dtype=torch.float16)), TypeError,
     "float32 or bfloat16"),
    (_bad(weights=torch.zeros(2, 7, 6)), ValueError, "do not fit"),
    (_bad(weights=torch.zeros(2, 6, 8).transpose(1, 2)), ValueError,
     "weights are not contiguous"),
    (_bad(tokens=torch.zeros(2, 8, 5).transpose(1, 2)), ValueError,
     "unit inner stride"),
    (_bad(dout=torch.zeros(2, 5, 7)), ValueError, "dout"),
    (_bad(dout=torch.zeros(2, 6, 5).transpose(1, 2)), ValueError, "dout"),
    (_bad(dout=torch.zeros(2, 5, 6, dtype=torch.bfloat16)), ValueError,
     "dout"),
    (_bad(), ValueError, "expected one CUDA device"),
    (_bad(tokens=torch.zeros(1, 5, 8).expand(2, -1, -1)), ValueError,
     "expected one CUDA device"),
])
def test_launch_backward_checks_with_the_device_last(args, err, match):
    before = dict(kernel.COUNTS)
    with pytest.raises(err, match=match):
        kernel.launch_backward(**args)
    assert kernel.COUNTS == before


def test_variants_and_counters():
    t32, t16 = torch.zeros(2, 3, 4), torch.zeros(2, 3, 4,
                                                 dtype=torch.bfloat16)
    w32, w16 = torch.zeros(2, 4, 5), torch.zeros(2, 4, 5,
                                                 dtype=torch.bfloat16)
    assert kernel.choose_variant_backward(t32, w32, None) == "simt"
    assert kernel.choose_variant_backward(t16, w16, None) == "wmma"
    assert kernel.BWD_VARIANTS == ("wgmma", "wmma", "simt")
    assert {k for k in kernel.COUNTS if k.startswith("grouped_matmul_bwd")} \
        == {"grouped_matmul_bwd", "grouped_matmul_bwd/wgmma",
            "grouped_matmul_bwd/wmma", "grouped_matmul_bwd/simt"}
    kernel.COUNTS["grouped_matmul_bwd/simt"] = 3
    kernel.reset_counts()
    assert not any(kernel.COUNTS.values())


BF16 = torch.bfloat16


def _bf16_operands(E=2, C=40, D=64, F=48, broadcast=False):
    tok = torch.zeros(C, D, dtype=BF16).unsqueeze(0).expand(E, -1, -1) \
        if broadcast else torch.zeros(E, C, D, dtype=BF16)
    return tok, torch.zeros(E, D, F, dtype=BF16), \
        torch.zeros(E, C, F, dtype=BF16)


def _misaligned(*shape, dtype=BF16):
    n = int(np.prod(shape))
    return torch.zeros(n + 8, dtype=dtype).narrow(0, 1, n).view(*shape)


@pytest.mark.parametrize("case,want", [
    ("float32", "simt"), ("broadcast", "wgmma"), ("packed", "wgmma"),
    ("C 1", "wgmma"), ("C 257, D and F off the tile", "wgmma"),
    ("D off a multiple of 8", "wmma"), ("F off a multiple of 8", "wmma"),
    ("misaligned tokens", "wmma"), ("misaligned weights", "wmma"),
    ("misaligned dout", "wmma"), ("misaligned dtokens", "wmma"),
    ("misaligned dweights", "wmma"), ("overlapping rows", "wmma"),
    ("overlapping experts", "wmma"), ("row stride off 8", "wmma"),
    ("padded rows", "wgmma")])
def test_choose_variant_backward(case, want):
    """wgmma wherever tensor maps describe every load and store of the
    bf16 backward; wmma for other bf16 operands; simt for float32."""
    E, C, D, F = 2, 40, 64, 48
    tok, w, dy = _bf16_operands(E, C, D, F, broadcast=case == "broadcast")
    outs = [torch.zeros(E, C, D, dtype=BF16), torch.zeros(E, D, F,
                                                           dtype=BF16)]
    if case == "float32":
        tok, w, dy = tok.float(), w.float(), dy.float()
    elif case == "C 1":
        tok, dy = torch.zeros(E, 1, D, dtype=BF16), torch.zeros(E, 1, F,
                                                                dtype=BF16)
    elif case.startswith("C 257"):
        tok, w, dy = _bf16_operands(E, 257, 264, 200)
    elif case.startswith("D off"):
        tok, w, dy = _bf16_operands(E, C, 60, F)
    elif case.startswith("F off"):
        tok, w, dy = _bf16_operands(E, C, D, 44)
    elif case == "misaligned tokens":
        tok = _misaligned(E, C, D)
    elif case == "misaligned weights":
        w = _misaligned(E, D, F)
    elif case == "misaligned dout":
        dy = _misaligned(E, C, F)
    elif case == "misaligned dtokens":
        outs[0] = _misaligned(E, C, D)
    elif case == "misaligned dweights":
        outs[1] = _misaligned(E, D, F)
    elif case == "overlapping rows":       # row stride under D
        tok = torch.zeros(E * C * D, dtype=BF16).as_strided(
            (E, C, D), (C * D, D // 2, 1))
    elif case == "overlapping experts":    # expert stride under C rows
        tok = torch.zeros(E * C * D, dtype=BF16).as_strided(
            (E, C, D), (8 * D, D, 1))
    elif case == "row stride off 8":
        tok = torch.zeros(E, C, D + 4, dtype=BF16)[..., :D]
    elif case == "padded rows":            # row stride D + 8: TMA takes it
        tok = torch.zeros(E, C, D + 8, dtype=BF16)[..., :D]
    assert kernel.choose_variant_backward(tok, w, dy, *outs) == want


def test_bwd_tma_maps_by_hand():
    """Broadcast tokens: a 2-D (D, C) map at the row stride; packed: 3-D
    over (D, C, E) at both strides; weights (F, D, E) and dout (F, C, E),
    contiguous; every box 64 x 64 (x 1) of bf16 with the 128-byte
    swizzle; the packed words as the C side reads them."""
    E, C, D, F = 16, 80, 6144, 10752
    tok, w, dy = kernel.bwd_tma_maps(E, C, D, F, 0, D)
    assert tok == kernel.TmaMap((6144, 80), (12288,), (64, 64), 128)
    assert w == kernel.TmaMap((10752, 6144, 16), (21504, 132120576),
                              (64, 64, 1), 128)
    assert dy == kernel.TmaMap((10752, 80, 16), (21504, 1720320),
                               (64, 64, 1), 128)
    packed = kernel.bwd_tma_maps(E, C, D, F, 80 * 6144 + 64, 6144 + 8)
    assert packed[0] == kernel.TmaMap((6144, 80, 16), (12304, 983168),
                                      (64, 64, 1), 128)
    assert packed[1:] == (w, dy)
    assert tok.packed() == (2, 6144, 80, 1, 12288, 0, 64, 64, 1, 128)
    assert w.packed() == (3, 10752, 6144, 16, 21504, 132120576, 64, 64, 1,
                          128)
    for m in packed:                       # TMA's limits
        assert all(s % 16 == 0 for s in m.strides)
        assert m.box[0] * 2 <= m.swizzle and max(m.box) <= 256


@pytest.mark.parametrize("variant,dtype,match", [
    ("wmma", BF16, "expected one CUDA device"),
    ("simt", torch.float32, "expected one CUDA device"),
    (None, BF16, "expected one CUDA device"),
    ("wgmma", BF16, "variant 'wgmma'"), ("simt", BF16, "variant 'simt'"),
    ("wmma", torch.float32, "variant 'wmma'"),
    ("tf32", torch.float32, "variant 'tf32'"), ("", BF16, "variant ''")],
    ids=["wmma-bf16", "simt-f32", "chosen", "wgmma-named", "simt-bf16",
         "wmma-f32", "unknown", "empty"])
def test_variant_rule_of_launch_backward(variant, dtype, match):
    """wmma (bf16) and simt (float32) may be asked for and reach the
    device check (CPU tensors: refused there); any other value is refused
    before it; no counter moves."""
    args = [a.to(dtype) for a in _bf16_operands()]
    before = dict(kernel.COUNTS)
    with pytest.raises(ValueError, match=match):
        kernel.launch_backward(*args, variant=variant)
    assert kernel.COUNTS == before


@pytest.mark.parametrize("broadcast", [True, False])
def test_autograd_function_wiring(monkeypatch, broadcast):
    """GroupedMatmulFn with the kernels swapped for the plain versions:
    the gradients of autograd through the plain forward, the forward
    called with grad off and the backward once per backward pass."""
    E, C, D, F = 3, 10, 8, 12
    calls = {"fwd": 0, "bwd": 0}

    def fwd(t, w):
        assert not torch.is_grad_enabled()
        calls["fwd"] += 1
        return grouped_matmul_ref(t, w)

    def bwd(t, w, g):
        calls["bwd"] += 1
        assert g.is_contiguous() and t.shape == (E, C, D)
        return grouped_matmul_bwd_ref(t, w, g)

    monkeypatch.setattr(kernel, "launch", fwd)
    monkeypatch.setattr(kernel, "launch_backward", bwd)
    x, w, g, *_ = _inputs(E, C, D, F, broadcast, seed=5)
    for train_tokens in (True, False):
        xs = [torch.from_numpy(x).requires_grad_(train_tokens)
              for _ in range(2)]
        ws = [torch.from_numpy(w).requires_grad_() for _ in range(2)]
        toks = [a.unsqueeze(0).expand(E, -1, -1) if broadcast else a
                for a in xs]
        out = ops.GroupedMatmulFn.apply(toks[0], ws[0])
        ref = grouped_matmul_ref(toks[1], ws[1])
        assert torch.equal(out, ref)
        gt = torch.from_numpy(g)
        want = [xs[1], ws[1]] if train_tokens else [ws[1]]
        got = [xs[0], ws[0]] if train_tokens else [ws[0]]
        for a, b in zip(torch.autograd.grad(out, got, gt),
                        torch.autograd.grad(ref, want, gt)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)
    assert calls == {"fwd": 2, "bwd": 2}


def test_op_on_the_cpu_stays_plain_autograd():
    x = torch.randn(2, 5, 4, requires_grad=True)
    w = torch.randn(2, 4, 3, requires_grad=True)
    before = dict(kernel.COUNTS)
    out = ops.grouped_matmul(x, w)
    assert out.grad_fn is not None and "Function" not in \
        type(out.grad_fn).__name__
    out.sum().backward()
    assert x.grad is not None and w.grad is not None
    assert kernel.COUNTS == before


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with -m cuda)")


# the card's cases: SHAPES, then the wgmma variant at C 1, 80 and 257 with
# D and F off its 256 x 192 tile (and D past one 256-row M-tile of dW)
CARD_SHAPES = SHAPES + [(2, 300, 136, 200), (3, 1, 72, 40),
                        (2, 80, 200, 392), (2, 257, 264, 200)]


def _card_variant(shape, how, dtype):
    """The variant a case must launch, by the rule worked out by hand."""
    if dtype == torch.float32:
        return "simt"
    _, _, D, F = shape
    return "wgmma" if how != "misaligned" and D % 8 == 0 and F % 8 == 0 \
        else "wmma"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("how", ["broadcast", "packed", "misaligned"])
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_kernel_matches_ref_on_the_card(shape, how, dtype):
    _card()
    E, C, D, F = shape
    g = torch.Generator(device="cuda").manual_seed(1)
    rn = lambda *s: torch.randn(s, generator=g, device="cuda").to(dtype)
    if how == "broadcast":
        tok = rn(C, D).unsqueeze(0).expand(E, -1, -1)
    elif how == "packed":
        tok = rn(E, C, D)
    else:
        tok = rn(E * C * D + 8).narrow(0, 1, E * C * D).view(E, C, D)
    w, dy = rn(E, D, F), rn(E, C, F)
    before = dict(kernel.COUNTS)
    dtok, dw = kernel.launch_backward(tok, w, dy)
    torch.cuda.synchronize()
    variant = _card_variant(shape, how, dtype)
    assert kernel.choose_variant_backward(tok, w, dy) == variant
    assert kernel.COUNTS["grouped_matmul_bwd"] == \
        before["grouped_matmul_bwd"] + 1
    assert kernel.COUNTS[f"grouped_matmul_bwd/{variant}"] == \
        before[f"grouped_matmul_bwd/{variant}"] + 1
    r_tok, r_w = grouped_matmul_bwd_ref(tok, w, dy)
    tol = TOL if dtype == torch.float32 else TOL_BF16
    for a, b in ((dtok, r_tok), (dw, r_w)):
        assert a.shape == b.shape and a.dtype == dtype
        torch.testing.assert_close(a.float(), b.float(), **tol)
    again = kernel.launch_backward(tok, w, dy)
    assert torch.equal(again[0], dtok) and torch.equal(again[1], dw)
    if C > 5:
        part, _ = kernel.launch_backward(tok[:, :5], w,
                                         dy[:, :5].contiguous())
        assert torch.equal(part, dtok[:, :5])
    if variant == "wgmma":                 # the older design, asked for
        old = kernel.launch_backward(tok, w, dy, variant="wmma")
        for a, b in zip(old, (r_tok, r_w)):
            torch.testing.assert_close(a.float(), b.float(), **tol)
        assert kernel.COUNTS["grouped_matmul_bwd/wmma"] == \
            before["grouped_matmul_bwd/wmma"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("broadcast", [True, False])
def test_op_under_grad_matches_cpu_on_the_card(broadcast):
    _card()
    E, C, D, F = 4, 40, 64, 48
    x, w, g, *_ = _inputs(E, C, D, F, broadcast, seed=11)
    res = {}
    for dev in ("cpu", "cuda"):
        xs = torch.from_numpy(x).to(dev).requires_grad_()
        ws = torch.from_numpy(w).to(dev).requires_grad_()
        tok = xs.unsqueeze(0).expand(E, -1, -1) if broadcast else xs
        out = ops.grouped_matmul(tok, ws)
        res[dev] = torch.autograd.grad(out, (xs, ws),
                                       torch.from_numpy(g).to(dev))
    for a, b in zip(res["cuda"], res["cpu"]):
        torch.testing.assert_close(a.cpu(), b, **TOL)
