"""Schedules, cut-point tables and DDPM-step coefficients of the port
against the JAX package.

Tolerances:
* integer tables (server sweeps, M) and row keys: bitwise;
* linspace-built tables (betas, client sweeps): within LINSPACE_ULPS ulps
  of the sweep's larger endpoint.  XLA's CPU code contracts some lanes of
  ``jnp.linspace`` into FMAs (which lanes depends on the vector width), so
  no portable formula matches it bitwise; the port keeps jnp.linspace's
  own formula;
* everything derived in float32 (ᾱ, α, σ, coefficients, steps): FP32 —
  cumprod and interpolation may round in another order;
* the cosine betas: COSINE — XLA's and torch's float32 cos differ by an
  ulp, which the 1 − ᾱ_t/ᾱ_{t−1} cancellation amplifies.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.schedules import DiffusionSchedule as JaxSchedule
from repro.core.splitting import CutPoint as JaxCut
from repro.core.splitting import row_keys as jax_row_keys
from repro.kernels.ddpm_step.ops import \
    step_coefficients as jax_step_coefficients
from repro_torch.core import prng
from repro_torch.core.schedules import DiffusionSchedule, linspace_f32
from repro_torch.core.splitting import CutPoint, row_keys
from repro_torch.kernels.ddpm_step.ops import step_coefficients

torch.set_num_threads(1)

LINSPACE_ULPS = 2
FP32 = dict(rtol=2e-6, atol=1e-7)
COSINE = dict(rtol=1e-4, atol=1e-7)


def _assert_linspace_close(port, ref, start, stop):
    ulp = np.spacing(np.float32(max(abs(start), abs(stop))))
    np.testing.assert_allclose(port, np.asarray(ref), rtol=0,
                               atol=LINSPACE_ULPS * ulp)
    assert port[0] == np.float32(start)
    if len(port) > 1:
        assert port[-1] == np.float32(stop)


@pytest.mark.parametrize("num", [1, 2, 5, 40, 250, 1000])
def test_linspace_f32(num):
    for start, stop in ((1e-4, 0.02), (400.0, 1.0), (7.0, 1.0)):
        _assert_linspace_close(
            linspace_f32(start, stop, num),
            jnp.linspace(start, stop, num, dtype=jnp.float32), start, stop)


@pytest.mark.parametrize("T", [10, 100, 1000])
def test_linear_schedule(T):
    j, t = JaxSchedule.linear(T), DiffusionSchedule.linear(T, device="cpu")
    _assert_linspace_close(t.betas.numpy(), j.betas, 1e-4, 0.02)
    np.testing.assert_allclose(t.alphas.numpy(), np.asarray(j.alphas), **FP32)
    np.testing.assert_allclose(t.alpha_bar.numpy(), np.asarray(j.alpha_bar),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("T", [10, 200])
def test_cosine_schedule(T):
    j, t = JaxSchedule.cosine(T), DiffusionSchedule.cosine(T, device="cpu")
    np.testing.assert_allclose(t.betas.numpy(), np.asarray(j.betas),
                               **COSINE)
    np.testing.assert_allclose(t.alpha_bar.numpy(), np.asarray(j.alpha_bar),
                               **COSINE)


@pytest.mark.parametrize("fn", ["alpha", "sigma", "_interp_alpha_bar"])
def test_interpolated_lookups(fn):
    T = 100
    j, t = JaxSchedule.linear(T), DiffusionSchedule.linear(T, device="cpu")
    ts = np.asarray([-3.0, 0.0, 0.25, 1.0, 1.5, 37.3, 99.99, 100.0, 140.0],
                    np.float32)
    np.testing.assert_allclose(getattr(t, fn)(torch.from_numpy(ts)).numpy(),
                               np.asarray(getattr(j, fn)(ts)), **FP32)


@pytest.mark.parametrize("T,t_cut", [(20, 0), (20, 1), (20, 7), (20, 20),
                                     (1000, 125), (1000, 250), (1000, 500),
                                     (1000, 999), (40, 13)])
@pytest.mark.parametrize("adjusted", [True, False])
def test_cut_point_tables(T, t_cut, adjusted):
    j, t = JaxCut(T, t_cut), CutPoint(T, t_cut)
    assert t.M == j.M
    assert (t.n_client_steps, t.n_server_steps) == \
        (j.n_client_steps, j.n_server_steps)
    np.testing.assert_array_equal(t.server_t_list(),
                                  np.asarray(j.server_t_list()))
    tl, tp = t.client_step_table(adjusted)
    jl, jp = j.client_step_table(adjusted)
    assert tl.dtype == np.float32 and tl.shape == jl.shape
    if t_cut:
        hi = float(j.M) if adjusted else float(t_cut)
        _assert_linspace_close(tl, jl, hi, 1.0)
        np.testing.assert_allclose(tp, np.asarray(jp), rtol=0,
                                   atol=LINSPACE_ULPS * np.spacing(
                                       np.float32(hi)))


def test_cut_point_rejects_out_of_range():
    with pytest.raises(ValueError):
        CutPoint(10, 11)


@pytest.mark.parametrize("batch", [1, 4, 9])
def test_row_keys_bitwise(batch):
    np.testing.assert_array_equal(
        np.asarray(jax_row_keys(jax.random.PRNGKey(3), batch)),
        prng.key_data(row_keys(prng.PRNGKey(3), batch)))


@pytest.mark.parametrize("with_prev", [False, True])
def test_step_coefficients(with_prev):
    T = 100
    j, t = JaxSchedule.linear(T), DiffusionSchedule.linear(T, device="cpu")
    ts = np.asarray([1.0, 1.5, 2.0, 50.5, 99.0, 100.0], np.float32)
    tps = np.maximum(ts - 1.5, 0.0).astype(np.float32) if with_prev else None
    jc = jax_step_coefficients(j, ts, tps)
    tc = step_coefficients(t, torch.from_numpy(ts),
                           None if tps is None else torch.from_numpy(tps))
    for a, b in zip(tc, jc):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **FP32)


def test_schedule_steps_match():
    T = 50
    j, t = JaxSchedule.linear(T), DiffusionSchedule.linear(T, device="cpu")
    rng = np.random.default_rng(0)
    x, e, n = (rng.standard_normal((2, 4, 4, 3)).astype(np.float32)
               for _ in range(3))
    tx, te, tn = (torch.from_numpy(a) for a in (x, e, n))
    for tt, tp in ((1.0, None), (7.0, None), (31.5, 20.25)):
        np.testing.assert_allclose(
            t.ddpm_step(tx, te, tt, tn, t_prev=tp).numpy(),
            np.asarray(j.ddpm_step(x, e, tt, n, t_prev=tp)), rtol=1e-5,
            atol=1e-6)
        np.testing.assert_allclose(
            t.ddim_step(tx, te, tt, 3.0).numpy(),
            np.asarray(j.ddim_step(x, e, tt, 3.0)), rtol=1e-5, atol=1e-6)
    tq = np.asarray([3, 40], np.int32)
    np.testing.assert_allclose(
        t.q_sample(tx, torch.from_numpy(tq), te).numpy(),
        np.asarray(j.q_sample(x, tq, e)), rtol=1e-5, atol=1e-6)
