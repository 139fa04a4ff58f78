"""The port's threefry (repro_torch.core.prng) against ``jax.random``.

Keys, splits, fold-ins, raw bits and uniforms must equal JAX's BITWISE.
``normal`` goes through ``torch.erfinv`` where XLA uses its own erfinv
polynomial, so it is held to NORMAL_ATOL (absolute, for standard normals
out to the ~5-sigma tails of these draws) and to a median of at most
NORMAL_MEDIAN_ULPS ulps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.protocol import rowwise_normal as jax_rowwise_normal
from repro_torch.core import prng
from repro_torch.core.protocol import rowwise_normal

torch.set_num_threads(1)

NORMAL_ATOL = 5e-5
NORMAL_MEDIAN_ULPS = 1


def _bits(key_t) -> np.ndarray:
    return prng.key_data(key_t)


def test_jax_uses_partitionable_threefry():
    # the port reproduces the partitionable counter layout; a jax upgrade
    # that changes the default must fail here, loudly
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", [0, 1, 42, 2 ** 31 - 1, -1, -12345])
def test_prngkey_bitwise(seed):
    np.testing.assert_array_equal(np.asarray(jax.random.PRNGKey(seed)),
                                  _bits(prng.PRNGKey(seed)))


@pytest.mark.parametrize("num", [1, 2, 3, 5, 1024])
def test_split_bitwise(num):
    for seed in (0, 7):
        np.testing.assert_array_equal(
            np.asarray(jax.random.split(jax.random.PRNGKey(seed), num)),
            _bits(prng.split(prng.PRNGKey(seed), num)))


def test_chained_split_bitwise():
    kj, kt = jax.random.PRNGKey(3), prng.PRNGKey(3)
    for _ in range(20):
        kj, _ = jax.random.split(kj)
        kt, _ = prng.split(kt)
    np.testing.assert_array_equal(np.asarray(kj), _bits(kt))


@pytest.mark.parametrize("data", [0, 1, 7, 2 ** 31 - 1, 123456789])
def test_fold_in_bitwise(data):
    np.testing.assert_array_equal(
        np.asarray(jax.random.fold_in(jax.random.PRNGKey(5), data)),
        _bits(prng.fold_in(prng.PRNGKey(5), data)))


def test_fold_in_batched_matches_vmap():
    seeds = jnp.asarray([0, 3, 9, 2 ** 30], jnp.int32)
    kj = jax.vmap(lambda s: jax.random.fold_in(jax.random.PRNGKey(1), s))(
        seeds)
    kt = prng.fold_in(prng.PRNGKey(1), torch.from_numpy(np.array(seeds)))
    np.testing.assert_array_equal(np.asarray(kj), _bits(kt))
    # batched keys x scalar data, and keys x per-key data
    kj2 = jax.vmap(lambda k: jax.random.fold_in(k, 11))(kj)
    np.testing.assert_array_equal(np.asarray(kj2),
                                  _bits(prng.fold_in(kt, 11)))


@pytest.mark.parametrize("shape", [(), (1,), (7,), (3, 5), (2, 3, 4)])
def test_random_bits_bitwise(shape):
    k = 17
    np.testing.assert_array_equal(
        np.asarray(jax.random.bits(jax.random.PRNGKey(k), shape)),
        prng.random_bits(prng.PRNGKey(k), shape).numpy().astype(np.uint32))


@pytest.mark.parametrize("shape", [(1000,), (4, 4, 4, 3)])
def test_uniform_bitwise(shape):
    uj = np.asarray(jax.random.uniform(jax.random.PRNGKey(2), shape))
    ut = prng.uniform(prng.PRNGKey(2), shape).numpy()
    np.testing.assert_array_equal(uj.view(np.uint32), ut.view(np.uint32))


def test_uniform_normal_range_bitwise():
    # the symmetric range normal() draws its uniforms from
    lo = float(np.nextafter(np.float32(-1), np.float32(0)))
    uj = np.asarray(jax.random.uniform(jax.random.PRNGKey(4), (4096,),
                                       minval=lo, maxval=1.0))
    ut = prng.uniform(prng.PRNGKey(4), (4096,), lo, 1.0).numpy()
    np.testing.assert_array_equal(uj.view(np.uint32), ut.view(np.uint32))


@pytest.mark.parametrize("seed", [0, 9])
def test_normal_within_tolerance(seed):
    nj = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (20000,)))
    nt = prng.normal(prng.PRNGKey(seed), (20000,)).numpy()
    np.testing.assert_allclose(nt, nj, rtol=0, atol=NORMAL_ATOL)
    ulps = np.abs(nj.view(np.int32).astype(np.int64) -
                  nt.view(np.int32).astype(np.int64))
    assert np.median(ulps) <= NORMAL_MEDIAN_ULPS


def test_normal_batched_keys_match_vmap():
    kj = jax.random.split(jax.random.PRNGKey(8), 3)
    nj = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (2, 5)))(kj))
    nt = prng.normal(prng.split(prng.PRNGKey(8), 3), (2, 5)).numpy()
    np.testing.assert_allclose(nt, nj, rtol=0, atol=NORMAL_ATOL)


@pytest.mark.parametrize("shape", [(1, 3), (4, 2, 2, 3)])
def test_rowwise_normal(shape):
    nj = np.asarray(jax_rowwise_normal(jax.random.PRNGKey(6), shape))
    nt = rowwise_normal(prng.PRNGKey(6), shape).numpy()
    np.testing.assert_allclose(nt, nj, rtol=0, atol=NORMAL_ATOL)


def test_rowwise_normal_rows_independent_of_batch():
    big = rowwise_normal(prng.PRNGKey(6), (5, 3))
    small = rowwise_normal(prng.PRNGKey(6), (2, 3))
    assert torch.equal(big[:2], small)
