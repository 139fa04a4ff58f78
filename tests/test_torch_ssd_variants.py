"""The SSD scan's wgmma variant: where it rounds, against JAX.

(Its ``choose_variant``, TMA maps and shared memory are pinned in
tests/test_torch_kernel_variants.py.)

* ``wgmma_rounding_model``, a plain-torch model of where the wgmma
  variant rounds (bf16 operands, float32 accumulators, 64-step tiles, the
  carried state rounded to bf16 for the inter-tile term), against JAX's
  ``models/ssm.ssd_chunked`` in bf16.  At p = 64 and n >= 64 the outputs
  reach |y| ~ 100 and JAX's own float32 and bf16 results differ by more
  than ``TOL_BF16`` elementwise (pinned below), so the model is held to
  ``SSD_BF16_RANGE · max(1, max |y|)``, the criterion ``chip_smoke.py``
  applies at the DiT's shape, and shown to be no farther than JAX's bf16
  from a float64 computation.
* The wgmma kernel against the model on the card (``cuda`` marker; skips
  without a device), five times tighter than that range.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.models import ssm as jssm
from repro_torch.kernels.ssd_scan import kernel, ops
from repro_torch.kernels.ssd_scan.ref import ssd_chunked

torch.set_num_threads(1)

BF16 = torch.bfloat16
TOL_BF16 = dict(atol=5e-2, rtol=5e-2)
SSD_BF16_RANGE = 5e-2
# (b, s, h, p, n, chunk): several tiles with a tail; chunk 256 at n 128;
# a chunk below the tile; head counts that two-head blocks do not divide
SSD_WGMMA = [(2, 200, 4, 64, 64, 64), (1, 256, 3, 64, 128, 256),
             (2, 64, 5, 64, 64, 16), (1, 130, 3, 64, 128, 32)]
DIT = (4, 64, 64, 64, 64)           # Zamba2-1.2B's scan: b, s, h, p, n


def _inputs(b, s, h, p, n, seed=0):
    """The JAX sweep's distributions: softplus(N - 1) steps, -exp(N)
    rates, unit-normal x, B and C."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    x = f(b, s, h, p)
    dt = np.logaddexp(f(b, s, h) - 1, 0).astype(np.float32)
    A = -np.exp(f(h))
    return x, dt, A, f(b, s, n), f(b, s, n)


def wgmma_rounding_model(x, dt, A, B, C):
    """Where csrc/ssd_scan.cu's wgmma variant rounds, in plain torch: per
    64-step tile, S = C Bᵀ in float32; the weights S e^{L_t - L_s} dt_s
    (s <= t) rounded to bf16; y = weights @ x plus, after the first tile,
    e^{L_t} (C @ bf16(state)ᵀ); the state scaled by e^{L_last} plus
    bf16(dt e^{L_last - L} x)ᵀ B, in float32.  Returns (y in x's dtype,
    final state float32)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    T = kernel.TILE
    pad = (-s) % T
    zpad = lambda t: F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))
    x, dt, B, C = (zpad(t).float() for t in (x, dt, B, C))
    A = A.float()
    causal = torch.tril(torch.ones(T, T, dtype=torch.bool,
                                   device=x.device))[None, :, :, None]
    state = torch.zeros(b, h, p, n, device=x.device)
    ys = []
    for t0 in range(0, s + pad, T):
        xt, dtt = x[:, t0:t0 + T], dt[:, t0:t0 + T]
        Bt, Ct = B[:, t0:t0 + T], C[:, t0:t0 + T]
        L = torch.cumsum(dtt * A, dim=1)                     # (b, T, h)
        S = Ct @ Bt.transpose(1, 2)                          # (b, t, s)
        diff = L[:, :, None, :] - L[:, None, :, :]           # (b, t, s, h)
        decay = torch.where(causal, torch.exp(torch.where(causal, diff, 0.)),
                            0.)
        P = (S[..., None] * decay * dtt[:, None]).to(BF16).float()
        y = torch.einsum("btsh,bshp->bthp", P, xt)
        if t0:
            y = y + torch.exp(L)[..., None] * torch.einsum(
                "btn,bhpn->bthp", Ct, state.to(BF16).float())
        wx = (dtt * torch.exp(L[:, -1:] - L))[..., None] * xt
        state = torch.exp(L[:, -1])[..., None, None] * state + torch.einsum(
            "bshp,bsn->bhpn", wx.to(BF16).float(), Bt)
        ys.append(y)
    return torch.cat(ys, 1)[:, :s].to(BF16), state


def _jax_bf16(arrs, chunk):
    x, dt, A, B, C = arrs
    jb = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    y, fs = jssm.ssd_chunked(jb(x), dt, A, jb(B), jb(C), chunk)
    return np.asarray(y, np.float32), np.asarray(fs)


def _model(arrs):
    x, dt, A, B, C = (torch.from_numpy(a) for a in arrs)
    y, fs = wgmma_rounding_model(x.to(BF16), dt, A, B.to(BF16), C.to(BF16))
    return y.float().numpy(), fs.numpy()


def _range_err(a, ref):
    """max |a - ref| over max(1, max |ref|)."""
    return np.abs(a - ref).max() / max(1.0, np.abs(ref).max())


# ---- the rounding design against JAX ----------------------------------------

@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_WGMMA)
def test_rounding_model_matches_jax_bf16(b, s, h, p, n, chunk):
    arrs = _inputs(b, s, h, p, n)
    y_ref, fs_ref = _jax_bf16(arrs, chunk)
    y, fs = _model(arrs)
    assert y.shape == y_ref.shape and fs.shape == (b, h, p, n)
    assert _range_err(y, y_ref) <= SSD_BF16_RANGE
    assert _range_err(fs, fs_ref) <= SSD_BF16_RANGE


def test_rounding_model_matches_jax_bf16_at_a_dit_shaped_input():
    b, s, h, p, n = DIT
    arrs = _inputs(1, s, h, p, n, seed=5)
    y_ref, fs_ref = _jax_bf16(arrs, min(256, s))
    y, fs = _model(arrs)
    assert _range_err(y, y_ref) <= SSD_BF16_RANGE
    assert _range_err(fs, fs_ref) <= SSD_BF16_RANGE


@pytest.mark.parametrize("shape", [SSD_WGMMA[0], SSD_WGMMA[1],
                                   (1, 64, 64, 64, 64, 64)],
                         ids=["tiles", "chunk256_n128", "dit"])
def test_rounding_model_is_no_farther_from_float64_than_jax_bf16(shape):
    """y against the float64 plain version on the bf16-rounded inputs."""
    b, s, h, p, n, chunk = shape
    arrs = _inputs(b, s, h, p, n, seed=1)
    y_ref, _ = _jax_bf16(arrs, chunk)
    y, _ = _model(arrs)
    x, dt, A, B, C = (torch.from_numpy(a) for a in arrs)
    r64 = lambda t: t.to(BF16).double()
    y64, _ = ssd_chunked(r64(x), dt.double(), A.double(), r64(B), r64(C),
                         chunk)
    y64 = y64.numpy()
    assert np.abs(y - y64).max() <= np.abs(y_ref - y64).max()


def test_tol_bf16_cannot_hold_at_these_widths():
    """JAX's ssd_chunked in float32 and in bf16, on the same bf16-rounded
    inputs, differ by more than TOL_BF16 elementwise at a DiT-shaped
    input: no kernel can be held to it there, hence the range."""
    arrs = _inputs(1, 64, 64, 64, 64, seed=1)
    y16, _ = _jax_bf16(arrs, 64)
    x, dt, A, B, C = arrs
    q = lambda a: np.asarray(jnp.asarray(a).astype(jnp.bfloat16), np.float32)
    y32, _ = jssm.ssd_chunked(q(x), dt, A, q(B), q(C), 64)
    assert not np.allclose(np.asarray(y32), y16, **TOL_BF16)
    assert _range_err(np.asarray(y32), y16) <= SSD_BF16_RANGE


# ---- on the card ------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_wgmma_matches_the_rounding_model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with -m cuda)")
    for b, s, h, p, n, chunk in SSD_WGMMA + [(4, 64, 64, 64, 64, 64)]:
        x, dt, A, B, C = (torch.from_numpy(a).cuda()
                          for a in _inputs(b, s, h, p, n))
        x, B, C = x.to(BF16), B.to(BF16), C.to(BF16)
        before = kernel.COUNTS["ssd_scan/wgmma"]
        y, fs = ops.ssd_scan(x, dt, A, B, C, chunk)
        assert kernel.COUNTS["ssd_scan/wgmma"] == before + 1
        y_m, fs_m = wgmma_rounding_model(x, dt, A, B, C)
        torch.cuda.synchronize()
        for a, m in ((y.float(), y_m.float()), (fs, fs_m)):
            err = (a - m).abs().max().item()
            lim = SSD_BF16_RANGE / 5 * max(1.0, m.abs().max().item())
            assert err <= lim, (b, s, h, p, n, chunk, err)
