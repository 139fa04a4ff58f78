"""The port's SSD scan and Mamba2 mixer against the JAX package's.

* ``ops.ssd_scan`` on CPU tensors (the plain version, the port of
  ``ssd_chunked``) against JAX's ``ssd_chunked`` at the shapes of
  ``test_ssd_scan_sweep`` (tests/test_kernels.py) plus a sequence that no
  chunk divides and one longer than the kernel's 64-step tile, and at one
  shape against the Pallas kernel in interpret mode: atol 1e-4 / rtol 1e-3
  in float32, as there.  In bfloat16 both sides keep the heavy tensors in
  bf16 (TOL_BF16).
* ``mamba_forward`` and ``_causal_conv`` against JAX with the same
  weights, in float32 (atol 1e-4 / rtol 1e-3).
* The CUDA kernels (both variants) against the plain version on the card
  (``cuda`` marker; skips without a device).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.configs.base import reduced as jax_reduced
from repro.kernels.ssd_scan.kernel import ssd_scan_pallas
from repro.models import ssm as jssm
from repro_torch import bridge
from repro_torch.configs.base import get_arch, reduced
from repro_torch.kernels.ssd_scan import kernel, ops
from repro_torch.kernels.ssd_scan.ref import ssd_chunked
from repro_torch.models import ssm as tssm

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-3)
TOL_BF16 = dict(atol=5e-2, rtol=5e-2)
SWEEP = [(2, 64, 4, 16, 8, 16), (1, 48, 2, 8, 4, 16), (2, 100, 3, 16, 8, 32),
         (1, 32, 1, 4, 4, 8), (1, 70, 2, 8, 4, 16), (1, 150, 2, 8, 4, 128)]
# bf16 shapes of the wgmma kernel (p 64, n 64 or 128): tiles with a tail,
# chunk 256 at n 128, a chunk below the tile, odd head counts
SSD_WGMMA = [(2, 200, 4, 64, 64, 64), (1, 256, 3, 64, 128, 256),
             (2, 64, 5, 64, 64, 16), (1, 130, 3, 64, 128, 32)]
SSD_BF16_RANGE = 5e-2


def _inputs(b, s, h, p, n, seed=0):
    """The sweep's distributions: softplus(N - 1) steps, -exp(N) rates."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    x = f(b, s, h, p)
    dt = np.logaddexp(f(b, s, h) - 1, 0).astype(np.float32)
    A = -np.exp(f(h))
    return x, dt, A, f(b, s, n), f(b, s, n)


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("b,s,h,p,n,chunk", SWEEP)
def test_ssd_scan_matches_jax_ssd_chunked(b, s, h, p, n, chunk):
    arrs = _inputs(b, s, h, p, n)
    y_ref, fs_ref = jssm.ssd_chunked(*arrs, chunk)
    y, fs = ops.ssd_scan(*_torch(arrs), chunk)
    assert y.dtype == torch.float32 and fs.shape == (b, h, p, n)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **TOL)
    np.testing.assert_allclose(fs.numpy(), np.asarray(fs_ref), **TOL)


def test_ssd_chunked_initial_state_matches_jax():
    arrs = _inputs(2, 40, 3, 8, 4, seed=1)
    h0 = np.random.default_rng(2).standard_normal((2, 3, 8, 4)).astype(
        np.float32)
    y_ref, fs_ref = jssm.ssd_chunked(*arrs, 16, initial_state=h0)
    y, fs = ssd_chunked(*_torch(arrs), 16,
                        initial_state=torch.from_numpy(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **TOL)
    np.testing.assert_allclose(fs.numpy(), np.asarray(fs_ref), **TOL)


def test_ssd_scan_bf16_matches_jax_ssd_chunked():
    x, dt, A, B, C = _inputs(2, 64, 4, 16, 8, seed=3)
    jb = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    tb = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    y_ref, fs_ref = jssm.ssd_chunked(jb(x), dt, A, jb(B), jb(C), 16)
    y, fs = ops.ssd_scan(tb(x), torch.from_numpy(dt), torch.from_numpy(A),
                         tb(B), tb(C), 16)
    assert y.dtype == torch.bfloat16 and fs.dtype == torch.float32
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(y_ref, np.float32), **TOL_BF16)
    np.testing.assert_allclose(fs.numpy(), np.asarray(fs_ref), **TOL_BF16)


def test_ssd_scan_matches_pallas_interpret():
    arrs = _inputs(1, 40, 2, 8, 4, seed=4)
    y_pal, fs_pal = ssd_scan_pallas(*arrs, chunk=16, interpret=True)
    y, fs = ops.ssd_scan(*_torch(arrs), 16)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_pal), **TOL)
    np.testing.assert_allclose(fs.numpy(), np.asarray(fs_pal), **TOL)


def _mixer(name):
    arch, jarch = reduced(get_arch(name)), jax_reduced(jax_get_arch(name))
    jp = jssm.mamba_init(jax.random.PRNGKey(7), jarch, jnp.float32)
    mod = tssm.Mamba(arch, torch.float32)
    bridge.load_params(mod, jax.tree.map(np.asarray, jp))
    return arch, jarch, jp, mod


@pytest.mark.parametrize("name", ["mamba2-2.7b", "zamba2-1.2b"])
def test_mamba_forward_matches_jax(name):
    arch, jarch, jp, mod = _mixer(name)
    x = np.random.default_rng(8).standard_normal(
        (2, 40, arch.d_model)).astype(np.float32)
    ref = jssm.mamba_forward(jp, x, jarch)
    with torch.no_grad():
        out = tssm.mamba_forward(mod, torch.from_numpy(x), arch)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_mamba_init_matches_jax():
    arch, jarch, _, bridged = _mixer("zamba2-1.2b")
    from repro_torch.core import prng
    drawn = tssm.mamba_init(prng.PRNGKey(7), arch, torch.float32)
    for (name, a), (_, b) in zip(drawn.state_dict().items(),
                                 bridged.state_dict().items()):
        torch.testing.assert_close(a, b, rtol=0, atol=5e-5, msg=name)


def test_causal_conv_matches_jax():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 12, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    ref = jssm._causal_conv(x, w, b)
    out = tssm._causal_conv(*_torch((x, w, b)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_cpu_tensors_take_the_plain_version_and_kernel_refuses_them():
    arrs = _torch(_inputs(1, 20, 2, 4, 4))
    before = kernel.COUNTS["ssd_scan"]
    y, fs = ops.ssd_scan(*arrs, 8)
    y_ref, fs_ref = ssd_chunked(*arrs, 8)
    assert torch.equal(y, y_ref) and torch.equal(fs, fs_ref)
    assert kernel.COUNTS["ssd_scan"] == before
    with pytest.raises(ValueError, match="CUDA"):
        kernel.launch(*arrs, 8)


def test_kernel_shared_memory_fits_the_models():
    """Mamba2-2.7B (p 64, n 128) at its default chunk fits one block."""
    cfg = get_arch("mamba2-2.7b")
    tq = min(cfg.ssm_chunk, kernel.MAX_TILE)
    assert kernel.smem_bytes(tq, cfg.ssm_head_dim, cfg.ssm_state) <= \
        kernel.SMEM_BYTES
    assert kernel.smem_bytes(64, 256, 256) > kernel.SMEM_BYTES


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_plain_version(dtype):
    """The JAX sweep takes the simt kernel at TOL / TOL_BF16; in bf16 the
    SSD_WGMMA shapes take the wgmma kernel, held (like the DiT's shape in
    chip_smoke.py) to SSD_BF16_RANGE · max(1, max |plain|): at p = 64 the
    plain version's own bf16 roundings exceed TOL_BF16 elementwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with -m cuda)")
    tol = TOL if dtype == torch.float32 else TOL_BF16
    cases = [(shape, "simt") for shape in SWEEP]
    if dtype == torch.bfloat16:
        cases += [(shape, "wgmma") for shape in SSD_WGMMA]
    for (b, s, h, p, n, chunk), variant in cases:
        x, dt, A, B, C = (t.cuda() for t in _torch(_inputs(b, s, h, p, n)))
        x, B, C = x.to(dtype), B.to(dtype), C.to(dtype)
        before = kernel.COUNTS["ssd_scan"]
        chosen = kernel.COUNTS[f"ssd_scan/{variant}"]
        y, fs = ops.ssd_scan(x, dt, A, B, C, chunk)
        assert kernel.COUNTS["ssd_scan"] == before + 1
        assert kernel.COUNTS[f"ssd_scan/{variant}"] == chosen + 1
        y_ref, fs_ref = ssd_chunked(x, dt, A, B, C, chunk)
        torch.cuda.synchronize()
        if variant == "simt":
            torch.testing.assert_close(y.float(), y_ref.float(), **tol)
            torch.testing.assert_close(fs, fs_ref, **tol)
            continue
        for a, r in ((y.float(), y_ref.float()), (fs, fs_ref)):
            lim = SSD_BF16_RANGE * max(1.0, r.abs().max().item())
            assert (a - r).abs().max().item() <= lim, (b, s, h, p, n, chunk)
