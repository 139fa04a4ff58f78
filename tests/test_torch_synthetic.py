"""The port's synthetic datasets (repro_torch.data.synthetic) against the
JAX package's (repro.data.synthetic).

Labels, priors and batch orders (permutations) must equal JAX's BITWISE.
Images within IMG_ATOL: the background's normals differ by erfinv ulps
(≤ 5e-5, scaled by 0.25) and the 4× linear upsampling by rounding.  The
upsampling alone (``jax.image.resize(..., "linear")`` against
``F.interpolate(bilinear, align_corners=False)``) is held on the same
input within RESIZE_ATOL, edges included.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.data import synthetic as jsyn
from repro_torch.core import prng
from repro_torch.data import synthetic as tsyn

torch.set_num_threads(1)

IMG_ATOL = 1e-4
RESIZE_ATOL = 1e-6


def _cfgs(**kw):
    return jsyn.SyntheticConfig(**kw), tsyn.SyntheticConfig(**kw)


@pytest.mark.parametrize("size", [8, 16, 32])
def test_linear_upsampling_matches_jax_resize_at_the_edges(size):
    rng = np.random.default_rng(size)
    z = rng.standard_normal((2, size // 4, size // 4, 3)).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(z), (2, size, size, 3), "linear")
    out = F.interpolate(torch.from_numpy(z).permute(0, 3, 1, 2),
                        size=(size, size), mode="bilinear",
                        align_corners=False).permute(0, 2, 3, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=RESIZE_ATOL)
    # the border rows and columns copy the edge samples' interpolation
    np.testing.assert_allclose(out[:, 0].numpy(), np.asarray(ref)[:, 0],
                               rtol=0, atol=RESIZE_ATOL)


@pytest.mark.parametrize("kw", [dict(), dict(image_size=32, n_attrs=5),
                                dict(channels=1, image_size=8)])
def test_attribute_patterns_match_jax(kw):
    jcfg, tcfg = _cfgs(**kw)
    ref = np.asarray(jsyn.attribute_patterns(jcfg))
    out = tsyn.attribute_patterns(tcfg, device="cpu")
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=IMG_ATOL)


def test_labels_bitwise_and_images_match_jax():
    jcfg, tcfg = _cfgs(image_size=16)
    jx, jy = jsyn.make_dataset(jax.random.PRNGKey(3), 20, jcfg)
    tx, ty = tsyn.make_dataset(prng.PRNGKey(3), 20, tcfg)
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    assert tx.dtype == torch.float32 and tx.shape == (20, 16, 16, 3)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0,
                               atol=IMG_ATOL)
    assert tx.abs().max() <= 1.0


@pytest.mark.parametrize("non_iid", [True, False])
def test_client_priors_match_jax(non_iid):
    jcfg, tcfg = _cfgs()
    for k in (1, 3, 5, 8, 10):
        ref = np.asarray(jsyn.client_attr_priors(jcfg, k, non_iid))
        out = tsyn.client_attr_priors(tcfg, k, non_iid, device="cpu")
        np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("sizes", [None, [3, 9, 1]])
def test_client_datasets_match_jax(sizes):
    jcfg, tcfg = _cfgs(image_size=8)
    ref = jsyn.make_client_datasets(jax.random.PRNGKey(4), jcfg, 3, 6,
                                    sizes=sizes)
    out = tsyn.make_client_datasets(prng.PRNGKey(4), tcfg, 3, 6, sizes=sizes,
                                    device="cpu")
    assert len(out) == 3
    for (tx, ty), (jx, jy) in zip(out, ref):
        np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0,
                                   atol=IMG_ATOL)


def test_client_datasets_refuse_mismatched_sizes():
    with pytest.raises(ValueError, match="one entry per client"):
        tsyn.make_client_datasets(prng.PRNGKey(0), tsyn.SyntheticConfig(), 3,
                                  4, sizes=[1, 2], device="cpu")


@pytest.mark.parametrize("drop_last", [True, False])
def test_batches_order_matches_jax(drop_last):
    x = np.arange(11 * 2, dtype=np.float32).reshape(11, 2)
    y = np.arange(11, dtype=np.float32)[:, None]
    ref = list(jsyn.batches(jnp.asarray(x), jnp.asarray(y), 4,
                            jax.random.PRNGKey(8), drop_last=drop_last))
    out = list(tsyn.batches(torch.from_numpy(x), torch.from_numpy(y), 4,
                            prng.PRNGKey(8), drop_last=drop_last))
    assert len(out) == len(ref) == (2 if drop_last else 3)
    for (tx, ty), (jx, jy) in zip(out, ref):
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    # without a key the order is the data's
    plain = list(tsyn.batches(torch.from_numpy(x), torch.from_numpy(y), 4))
    np.testing.assert_array_equal(plain[0][0].numpy(), x[:4])


def test_datasets_without_device_raise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsyn.make_client_datasets(prng.PRNGKey(0), tsyn.SyntheticConfig(),
                                  2, 4)
