"""The backward of the flash-attention kernel, checked on the CPU through
its plain version.

* ``flash_attention_bwd_ref`` (the CUDA backward's three passes written
  out in float32: D = rowsum(dO∘O), P from the log-sum-exp, dS = P∘(dP −
  D)) against ``torch.autograd`` of ``attention_ref`` and against
  ``jax.vjp`` of the JAX package's ``models/attention.attend`` under the
  same mask, with ``attention_lse`` against JAX's log-sum-exp: causal and
  not, a window below S (causal and not), GQA, and S not a multiple of
  the kernel's 64-row tiles.  Float32 within TOL (both sides compute in
  float32 and sum in other orders); bfloat16 inputs within BF16_RANGE of
  each gradient's range (max |a − b| / max(1, max |b|)): JAX runs on the
  same bf16 values in float32, the port rounds each gradient to bf16 once.
* ``ops.flash_attention`` on CPU tensors stays plain autograd of
  ``attention_ref`` (the kernels' autograd route is for CUDA tensors).
* ``kernel.launch_backward``'s and ``launch(..., lse=)``'s checks of
  shape, type and contiguity are reachable here: the device is checked
  last, so valid CPU tensors reach the device check and launch nothing.
* On the card (``cuda`` marker; skips without a device): the op under
  grad launches the forward with its lse and the backward kernel, within
  BF16_RANGE of the plain backward.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch.kernels.flash_attention import kernel, ops
from repro_torch.kernels.flash_attention.ref import (attention_lse,
                                                     attention_ref,
                                                     flash_attention_bwd_ref,
                                                     keep_mask)

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-4)
BF16_RANGE = 1e-2
CASES = [(2, 4, 2, 64, 32, True, 0), (1, 4, 4, 100, 16, False, 0),
         (2, 8, 2, 70, 64, True, 0), (1, 4, 1, 96, 32, True, 24),
         (1, 4, 1, 96, 32, False, 24), (1, 2, 1, 48, 8, True, 0),
         (2, 6, 2, 130, 64, False, 0)]


def _inputs(B, H, Hkv, S, dh, seed=0):
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)
    return n(B, H, S, dh), n(B, Hkv, S, dh), n(B, Hkv, S, dh), \
        n(B, H, S, dh)


def _jax_grads(q, k, v, do, causal, window):
    """jax.vjp of ``attend`` (float32) under the kernel's mask."""
    S = q.shape[2]
    mask = jnp.asarray(keep_mask(S, causal, window).numpy())

    def f(q, k, v):
        return jattn.attend(q, k, v, mask=mask)

    out, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))], np.asarray(out)


def _jax_lse(q, k, causal, window):
    B, H, S, dh = q.shape
    Hkv = k.shape[1]
    qg = jnp.asarray(q).reshape(B, Hkv, H // Hkv, S, dh)
    logits = jnp.einsum("bhgqd,bhkd->bhgqk", qg, jnp.asarray(k)) / \
        np.sqrt(dh)
    mask = jnp.asarray(keep_mask(S, causal, window).numpy())
    logits = jnp.where(mask, logits, -1e30)
    return np.asarray(jax.nn.logsumexp(logits, axis=-1)).reshape(B, H, S)


def _range_err(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))


@pytest.mark.parametrize("B,H,Hkv,S,dh,causal,window", CASES)
def test_bwd_ref_matches_autograd_and_jax_vjp(B, H, Hkv, S, dh, causal,
                                              window):
    q, k, v, do = _inputs(B, H, Hkv, S, dh)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = attention_ref(tq, tk, tv, causal, window)
    auto = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    lse = attention_lse(tq.detach(), tk.detach(), causal, window)
    np.testing.assert_allclose(lse.numpy(), _jax_lse(q, k, causal, window),
                               **TOL)
    got = flash_attention_bwd_ref(tq.detach(), tk.detach(), tv.detach(),
                                  out.detach(), torch.from_numpy(do), lse,
                                  causal, window)
    jgrads, jout = _jax_grads(q, k, v, do, causal, window)
    np.testing.assert_allclose(out.detach().numpy(), jout, **TOL)
    for name, g, a, j in zip("qkv", got, auto, jgrads):
        assert g.dtype == torch.float32 and g.shape == a.shape
        np.testing.assert_allclose(g.numpy(), a.numpy(), **TOL,
                                   err_msg=f"d{name} vs autograd")
        np.testing.assert_allclose(g.numpy(), j, **TOL,
                                   err_msg=f"d{name} vs jax.vjp")


@pytest.mark.parametrize("B,H,Hkv,S,dh,causal,window", CASES[::2])
def test_bwd_ref_in_bf16_within_its_range(B, H, Hkv, S, dh, causal, window):
    q, k, v, do = _inputs(B, H, Hkv, S, dh, seed=1)
    bf = lambda a: torch.from_numpy(a).bfloat16()
    tq, tk, tv, tdo = (bf(a) for a in (q, k, v, do))
    out = attention_ref(tq, tk, tv, causal, window)
    lse = attention_lse(tq, tk, causal, window)
    got = flash_attention_bwd_ref(tq, tk, tv, out, tdo, lse, causal, window)
    assert all(g.dtype == torch.bfloat16 for g in got)
    f32 = lambda t: t.float().numpy()
    # JAX in float32 on the same bf16 values, the port's bf16 output
    jgrads, _ = _jax_grads(f32(tq), f32(tk), f32(tv), f32(tdo), causal,
                           window)
    for name, g, j in zip("qkv", got, jgrads):
        assert _range_err(g.float().numpy(), j) <= BF16_RANGE, name


def test_cpu_op_stays_plain_autograd():
    q, k, v, do = _inputs(1, 4, 2, 40, 16, seed=2)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    before = dict(kernel.COUNTS)
    out = ops.flash_attention(tq, tk, tv, causal=True, window=8)
    assert out.grad_fn is not None and kernel.COUNTS == before
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    ref = flash_attention_bwd_ref(
        tq.detach(), tk.detach(), tv.detach(), out.detach(),
        torch.from_numpy(do), attention_lse(tq.detach(), tk.detach(), True,
                                            8), True, 8)
    for g, r in zip(grads, ref):
        torch.testing.assert_close(g, r, **TOL)
    assert kernel.COUNTS == before


def _valid(B=1, H=2, Hkv=1, S=8, dh=16, dtype=torch.float32):
    q = torch.randn(B, H, S, dh, dtype=dtype)
    k = torch.randn(B, Hkv, S, dh, dtype=dtype)
    v = torch.randn(B, Hkv, S, dh, dtype=dtype)
    return [q, k, v, torch.randn_like(q), torch.randn_like(q),
            torch.zeros(B, H, S)]


@pytest.mark.parametrize("mutate,error,match", [
    (lambda a: a.__setitem__(1, a[1][:, :, :4]), ValueError, "does not fit"),
    (lambda a: a.__setitem__(0, a[0].half()), ValueError, "k is"),
    (lambda a: [a.__setitem__(i, a[i].half()) for i in range(5)], TypeError,
     "float32 or bfloat16"),
    (lambda a: a.__setitem__(3, a[3][:, :, :4]), ValueError, "out is"),
    (lambda a: a.__setitem__(4, a[4].transpose(2, 3)), ValueError,
     "dout is"),
    (lambda a: a.__setitem__(5, a[5].double()), ValueError, "lse"),
    (lambda a: a.__setitem__(5, a[5][:, :1]), ValueError, "lse"),
    (lambda a: a.__setitem__(2, a[2].transpose(2, 3)), ValueError,
     "not contiguous"),
    (lambda a: None, ValueError, "CUDA"),
], ids=["gqa-shape", "mixed-dtype", "dtype", "out-shape", "dout-layout",
        "lse-dtype", "lse-shape", "v-layout", "device-last"])
def test_launch_backward_checks_before_the_device(mutate, error, match):
    args = _valid()
    mutate(args)
    before = dict(kernel.COUNTS)
    with pytest.raises(error, match=match):
        kernel.launch_backward(*args, causal=True, window=0)
    assert kernel.COUNTS == before


def test_launch_checks_its_lse_buffer_before_the_device():
    q, k, v = _valid()[:3]
    with pytest.raises(ValueError, match="lse"):
        kernel.launch(q, k, v, True, 0, lse=torch.zeros(1, 2, 7))
    with pytest.raises(ValueError, match="CUDA"):
        kernel.launch(q, k, v, True, 0, lse=torch.zeros(1, 2, 8))


@pytest.mark.cuda
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 40)])
def test_cuda_op_trains_through_the_backward_kernel(causal, window):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with -m cuda)")
    q, k, v, do = (torch.from_numpy(a).bfloat16().cuda()
                   for a in _inputs(2, 8, 2, 130, 64, seed=3))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    before = dict(kernel.COUNTS)
    with torch.enable_grad():
        out = ops.flash_attention(q, k, v, causal=causal, window=window)
        grads = torch.autograd.grad(out, (q, k, v), do)
    assert kernel.COUNTS["flash_attention"] == before["flash_attention"] + 1
    assert kernel.COUNTS["flash_attention_bwd"] == \
        before["flash_attention_bwd"] + 1
    qd, kd, vd = (t.detach() for t in (q, k, v))
    ref = flash_attention_bwd_ref(qd, kd, vd, out.detach(), do,
                                  attention_lse(qd, kd, causal, window),
                                  causal, window)
    torch.cuda.synchronize()
    for g, r in zip(grads, ref):
        assert _range_err(g.float().cpu().numpy(),
                          r.float().cpu().numpy()) <= BF16_RANGE
