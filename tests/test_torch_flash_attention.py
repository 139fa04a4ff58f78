"""The port's flash-attention op and attention layer against the JAX
package's.

* ``ops.flash_attention`` on CPU tensors (the plain version) against JAX's
  ``attention_ref`` at the shapes of ``test_flash_attention_sweep`` and
  ``test_flash_attention_window`` (tests/test_kernels.py), and at one shape
  against the Pallas kernel in interpret mode.  Tolerances are those
  tests': TOL in float32, TOL_BF16 in bfloat16 (both sides round the same
  numpy inputs to bf16; the sums run in other orders).
* ``self_attention``, ``attend`` and ``apply_rope`` against JAX with the
  same weights, in float32 (TOL).  A bidirectional ``self_attention``
  drops the window, as JAX's does; the kernel and its plain version would
  apply it.
* The CUDA kernels against the plain version on the card, and the wgmma variant at head dim 128 keeps a batch row's bits at any batch
  (``cuda`` marker; skips without a device).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.kernels.flash_attention.ref import attention_ref as jax_ref
from repro.models import attention as jattn
from repro_torch import bridge
from repro_torch.kernels.flash_attention import kernel, ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models import attention as tattn

torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=2e-3)
TOL_BF16 = dict(atol=5e-2, rtol=5e-2)
DTYPES = {"float32": (jnp.float32, torch.float32, TOL),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, TOL_BF16)}
SWEEP = [(2, 4, 2, 64, 32), (1, 4, 4, 100, 16), (2, 8, 2, 128, 64),
         (1, 2, 1, 48, 8)]


def _qkv(B, H, Hkv, S, dh, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, S, dh)).astype(np.float32),
            rng.standard_normal((B, Hkv, S, dh)).astype(np.float32),
            rng.standard_normal((B, Hkv, S, dh)).astype(np.float32))


def _both(arrays, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("B,H,Hkv,S,dh", SWEEP)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_jax_ref(B, H, Hkv, S, dh, causal, dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(B, H, Hkv, S, dh), dtype)
    ref = jax_ref(jq, jk, jv, causal=causal)
    out = ops.flash_attention(tq, tk, tv, causal=causal)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    np.testing.assert_allclose(_f32(out), _f32(ref), **DTYPES[dtype][2])


@pytest.mark.parametrize("window", [8, 24, 64])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_window_matches_jax_ref(window, causal):
    """The op applies ``window`` whether or not ``causal`` is set."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(1, 4, 1, 96, 32, seed=1),
                                       "float32")
    ref = jax_ref(jq, jk, jv, causal=causal, window=window)
    out = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_flash_attention_matches_pallas_interpret():
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(1, 4, 2, 48, 16, seed=2),
                                       "float32")
    pal = flash_attention_pallas(jq, jk, jv, causal=True, window=20,
                                 bq=16, bk=16, interpret=True)
    out = ops.flash_attention(tq, tk, tv, causal=True, window=20)
    np.testing.assert_allclose(out.numpy(), np.asarray(pal), **TOL)


def test_attend_matches_jax():
    q, k, v = _qkv(2, 4, 2, 32, 16, seed=3)
    ref = jattn.attend(q, k, v, jattn.causal_mask(32, 8)[None, None])
    t = [torch.from_numpy(a) for a in (q, k, v)]
    out = tattn.attend(*t, tattn.causal_mask(32, 8)[None, None])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(
        ops.flash_attention(*t, causal=True, window=8).numpy(),
        out.numpy(), **TOL)


@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_apply_rope_rotates_interleaved_pairs_as_jax(fraction):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 3, 10, 16)).astype(np.float32)
    pos = np.arange(10, dtype=np.int32)[None]
    ref = jattn.apply_rope(x, pos, 10_000.0, fraction)
    out = tattn.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                           10_000.0, fraction)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("causal,window", [(False, 16), (True, 16),
                                           (False, 0)])
def test_self_attention_matches_jax(causal, window):
    d, H, Hkv, dh, S = 64, 4, 2, 16, 40
    jp = jattn.attn_init(jax.random.PRNGKey(5), d, H, Hkv, dh, jnp.float32)
    mod = tattn.Attention(d, H, Hkv, dh, torch.float32)
    bridge.load_params(mod, jax.tree.map(np.asarray, jp))
    x = np.random.default_rng(6).standard_normal((2, S, d)).astype(
        np.float32)
    pos = np.arange(S, dtype=np.int32)[None]
    kw = dict(n_heads=H, n_kv_heads=Hkv, head_dim=dh, causal=causal,
              window=window)
    ref = jattn.self_attention(jp, x, positions=pos, **kw)
    out = tattn.self_attention(mod, torch.from_numpy(x),
                               positions=torch.from_numpy(pos), **kw)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    if not causal and window:
        # the window really is dropped: a windowed product differs
        q, k, v = tattn.qkv(mod, torch.from_numpy(x), H, Hkv, dh,
                            torch.from_numpy(pos), 10_000.0, 1.0)
        windowed = mod.wo(tattn._merge_heads(attention_ref(
            q, k, v, causal=False, window=window)))
        assert not np.allclose(windowed.detach().numpy(), np.asarray(ref),
                               **TOL)


def test_cpu_tensors_take_the_plain_version_and_kernel_refuses_them():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 1, 16, 8))
    before = kernel.COUNTS["flash_attention"]
    assert torch.equal(ops.flash_attention(q, k, v),
                       attention_ref(q, k, v))
    assert kernel.COUNTS["flash_attention"] == before
    with pytest.raises(ValueError, match="CUDA"):
        kernel.launch(q, k, v, True, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain_version(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with -m cuda)")
    tdt, tol = DTYPES[dtype][1], DTYPES[dtype][2]
    cases = [(s, c, 0) for s in SWEEP for c in (True, False)] + \
        [((1, 4, 1, 96, 32), c, w) for w in (8, 24, 64) for c in (True, False)]
    for (B, H, Hkv, S, dh), causal, window in cases:
        q, k, v = (torch.from_numpy(a).to(tdt).cuda()
                   for a in _qkv(B, H, Hkv, S, dh))
        before = kernel.COUNTS["flash_attention"]
        out = ops.flash_attention(q, k, v, causal=causal, window=window)
        assert kernel.COUNTS["flash_attention"] == before + 1
        ref = attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), ref.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_wgmma_variant_matches_plain_and_keeps_row_bits(causal):
    """Head dim 128 over two K/V tiles (the wgmma variant): within
    TOL_BF16 of the plain version, and the rows of batch 1 equal those of
    batch 2 bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with -m cuda)")
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16).cuda()
               for a in _qkv(2, 6, 2, 100, 128, seed=5))
    assert kernel.choose_variant(q, k, v) == "wgmma"
    before = kernel.COUNTS["flash_attention/wgmma"]
    out = ops.flash_attention(q, k, v, causal=causal)
    one = ops.flash_attention(q[:1], k[:1], v[:1], causal=causal)
    assert kernel.COUNTS["flash_attention/wgmma"] == before + 2
    ref = attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), **TOL_BF16)
    assert torch.equal(one, out[:1])
