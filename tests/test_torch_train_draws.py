"""The draws of the port's training step (Alg. 1) against ``jax.random``
and the JAX package's protocol.

Integers, booleans, permutations and keys must equal JAX's BITWISE:
``prng.randint`` (jax 0.9.0's ``_randint``: two 32-bit words a value,
(hi % span · mult + lo % span) % span in wrapping uint32 arithmetic, the
out-of-range branch, spans of 1 and spans that are not powers of two),
``prng.bernoulli``, ``prng.permutation`` (``_shuffle``'s sort rounds),
``CutPoint.sample_client_t`` / ``sample_server_t`` (row-keyed scalar
randint, cuts 0 … T), ``client_keys`` (position and identity keying) and
the server timesteps of ``make_payload``.  Float results (``renoise``,
the payload's x_{t_s} and ε_s) within NORMAL_ATOL: ``prng.normal``'s
erfinv differs from XLA's by a few ulps (≤ 5e-5 on standard normals).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import protocol as jprotocol
from repro.core.schedules import DiffusionSchedule as JSched
from repro.core.splitting import CutPoint as JCut
from repro.core.splitting import row_keys as jrow_keys
from repro_torch.core import prng, protocol
from repro_torch.core.schedules import DiffusionSchedule
from repro_torch.core.splitting import CutPoint, row_keys

torch.set_num_threads(1)

NORMAL_ATOL = 5e-5
TOL = dict(atol=2e-5, rtol=2e-3)
SPANS = [(0, 10), (1, 251), (3, 3), (5, 2), (0, 1), (-7, 1000), (1, 1001),
         (0, 2 ** 16), (7, 2 ** 31 - 1), (-2 ** 31, 2 ** 31 - 1),
         (-100, -3)]


def _k(seed):
    return jax.random.PRNGKey(seed), prng.PRNGKey(seed)


@pytest.mark.parametrize("lo,hi", SPANS)
@pytest.mark.parametrize("shape", [(7,), (2, 3), ()])
def test_randint_bitwise(lo, hi, shape):
    for seed in (0, 11):
        kj, kt = _k(seed)
        ref = np.asarray(jax.random.randint(kj, shape, lo, hi))
        out = prng.randint(kt, shape, lo, hi)
        assert out.dtype == torch.int32 and tuple(out.shape) == shape
        np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("lo,hi", [(-3, 4_000_000_000), (0, 2 ** 32 - 1),
                                   (2 ** 31 - 1, 2 ** 31 + 5)])
def test_randint_maxval_above_int32_bitwise(lo, hi):
    """A maxval above the int32 range is clipped and widens the span by
    one (jax's ``maxval_out_of_range`` branch, reached here with a uint32
    maxval)."""
    kj, kt = _k(5)
    ref = np.asarray(jax.random.randint(kj, (9,), lo, jnp.uint32(hi)))
    np.testing.assert_array_equal(prng.randint(kt, (9,), lo, hi).numpy(),
                                  ref)


@pytest.mark.parametrize("lo,hi", [(1, 251), (0, 1), (250, 1001), (9, 9)])
def test_randint_row_keyed_scalar_bitwise(lo, hi):
    """The vmap-over-row-keys scalar form the protocol draws t with."""
    kj, kt = _k(2)
    ref = jax.vmap(lambda k: jax.random.randint(k, (), lo, hi))(
        jrow_keys(kj, 13))
    out = prng.randint(row_keys(kt, 13), (), lo, hi)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("p", [0.35, 0.0, 1.0])
def test_bernoulli_scalar_p_bitwise(p):
    kj, kt = _k(4)
    ref = jax.random.bernoulli(kj, jnp.full((8,), p), (6, 8))
    out = prng.bernoulli(kt, torch.full((8,), p), (6, 8))
    assert out.dtype == torch.bool
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_bernoulli_vector_p_bitwise():
    p = np.linspace(0.05, 0.8, 8, dtype=np.float32)
    kj, kt = _k(9)
    ref = jax.random.bernoulli(kj, jnp.asarray(p), (40, 8))
    out = prng.bernoulli(kt, torch.from_numpy(p), (40, 8))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("n", [0, 1, 2, 10, 1000, 2000])
def test_permutation_of_range_bitwise(n):
    """n ≤ 1625 sorts once, n = 2000 twice (jax's round count)."""
    for seed in (0, 3):
        kj, kt = _k(seed)
        ref = np.asarray(jax.random.permutation(kj, n))
        out = prng.permutation(kt, n)
        assert out.dtype == torch.int32
        np.testing.assert_array_equal(out.numpy(), ref)


def test_permutation_of_a_tensor_along_its_first_axis_bitwise():
    x = np.arange(30, dtype=np.float32).reshape(10, 3)
    kj, kt = _k(6)
    ref = np.asarray(jax.random.permutation(kj, jnp.asarray(x)))
    np.testing.assert_array_equal(
        prng.permutation(kt, torch.from_numpy(x)).numpy(), ref)


@pytest.mark.parametrize("t_cut", [0, 1, 37, 99, 100])
def test_sample_client_and_server_t_bitwise(t_cut):
    jc, tc = JCut(100, t_cut), CutPoint(100, t_cut)
    kj, kt = _k(8)
    for batch in (1, 7):
        np.testing.assert_array_equal(
            tc.sample_client_t(kt, batch).numpy(),
            np.asarray(jc.sample_client_t(kj, batch)))
        np.testing.assert_array_equal(
            tc.sample_server_t(kt, batch).numpy(),
            np.asarray(jc.sample_server_t(kj, batch)))
    # row i's draw does not depend on the batch size
    assert torch.equal(tc.sample_server_t(kt, 7)[:3],
                       tc.sample_server_t(kt, 3))


@pytest.mark.parametrize("ids", [[0, 1, 2, 3], [5, 17, 2 ** 31 - 1]])
def test_client_keys_bitwise(ids):
    """Position keying (arange(k)) and identity keying (registry uids)."""
    kj, kt = _k(1)
    ref = jprotocol.client_keys(kj, jnp.asarray(ids, jnp.int32))
    out = protocol.client_keys(kt, torch.tensor(ids))
    np.testing.assert_array_equal(prng.key_data(out), np.asarray(ref))


def test_renoise_matches_jax():
    """α(t_s), σ(t_s) applied to the already-noised x_{t_ζ}."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 4, 4, 3)).astype(np.float32)
    e = rng.standard_normal((5, 4, 4, 3)).astype(np.float32)
    ts = np.array([10, 11, 50, 99, 100], np.int32)
    ref = JSched.linear(100).renoise(jnp.asarray(x), 10, jnp.asarray(ts),
                                     jnp.asarray(e))
    out = DiffusionSchedule.linear(100).renoise(
        torch.from_numpy(x), 10, torch.from_numpy(ts), torch.from_numpy(e))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("t_cut", [0, 10, 40])
def test_make_payload_matches_jax(t_cut):
    """t_s bitwise; x_{t_s} and ε_s within the normal draw's ulps."""
    rng = np.random.default_rng(1)
    x0 = rng.uniform(-1, 1, (6, 4, 4, 3)).astype(np.float32)
    y = np.eye(8, dtype=np.float32)[rng.integers(0, 8, 6)]
    kj, kt = _k(12)
    ref = jprotocol.make_payload(jnp.asarray(x0), jnp.asarray(y), kj,
                                 JSched.linear(40), JCut(40, t_cut))
    out = protocol.make_payload(torch.from_numpy(x0), torch.from_numpy(y),
                                kt, DiffusionSchedule.linear(40),
                                CutPoint(40, t_cut))
    np.testing.assert_array_equal(out.t_s.numpy(), np.asarray(ref.t_s))
    for a, b in ((out.x_ts, ref.x_ts), (out.eps_s, ref.eps_s)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=NORMAL_ATOL)
    assert out.nbytes() == ref.nbytes()


def test_make_payload_refuses_dp_until_the_privacy_slice():
    """The privacy slice has landed: payload DP (dp_sigma > 0) no longer
    raises; it clips and noises x_{t_s} as the reference does, from the
    split's fourth key (x_{t_s} within NORMAL_ATOL·(1 + σ·C), t_s
    bitwise, ε_s untouched)."""
    rng = np.random.default_rng(2)
    x0 = rng.uniform(-1, 1, (4, 4, 4, 3)).astype(np.float32)
    y = np.eye(8, dtype=np.float32)[rng.integers(0, 8, 4)]
    kj, kt = _k(13)
    ref = jprotocol.make_payload(jnp.asarray(x0), jnp.asarray(y), kj,
                                 JSched.linear(10), JCut(10, 5),
                                 dp_sigma=1.0, dp_clip=1.0)
    out = protocol.make_payload(torch.from_numpy(x0), torch.from_numpy(y),
                                kt, DiffusionSchedule.linear(10),
                                CutPoint(10, 5), dp_sigma=1.0, dp_clip=1.0)
    plain = protocol.make_payload(torch.from_numpy(x0), torch.from_numpy(y),
                                  kt, DiffusionSchedule.linear(10),
                                  CutPoint(10, 5))
    np.testing.assert_array_equal(out.t_s.numpy(), np.asarray(ref.t_s))
    np.testing.assert_allclose(out.x_ts.numpy(), np.asarray(ref.x_ts),
                               rtol=1e-5, atol=2 * NORMAL_ATOL)
    assert torch.equal(out.eps_s, plain.eps_s)
    assert not torch.equal(out.x_ts, plain.x_ts)
