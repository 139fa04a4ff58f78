"""The port's fused DDPM step (repro_torch.kernels.ddpm_step) against the
JAX package's Pallas kernel run in interpret mode, at the shapes, dtypes
and tolerances of tests/test_kernels.py (TOL fp32, TOL_BF16 bf16).

On the CPU the wrapper takes the plain version; the CUDA kernel itself is
held against the plain version on the card (the ``cuda``-marked test here
and chip_smoke.py), where it skips without a device.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.schedules import DiffusionSchedule as JaxSchedule
from repro.kernels.ddpm_step import ops as jax_ops
from repro_torch.core.schedules import DiffusionSchedule
from repro_torch.kernels.ddpm_step import kernel, ops
from repro_torch.kernels.ddpm_step.ref import ddpm_step_ref

torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=2e-3)
TOL_BF16 = dict(atol=5e-2, rtol=5e-2)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(shape, jdtype, seed=0):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]
    jx = [jnp.asarray(a).astype(jdtype) for a in arrs]
    # the port gets JAX's rounded values, so bf16 inputs agree exactly
    tx = [torch.from_numpy(np.array(a.astype(jnp.float32))) for a in jx]
    return jx, tx


@pytest.mark.parametrize("shape", [(4, 16, 16, 3), (2, 8, 8, 1), (1, 37)])
@pytest.mark.parametrize("t", [1.0, 50.5, 99.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ddpm_step_matches_pallas(shape, t, dtype):
    jdt, tdt = DTYPES[dtype]
    jsched, tsched = JaxSchedule.linear(100), DiffusionSchedule.linear(
        100, device="cpu")
    (jx, je, jn), (tx, te, tn) = _inputs(shape, jdt)
    pal = jax_ops.ddpm_step(jx, je, jn, jsched, t, use_pallas=True,
                            interpret=True)
    out = ops.ddpm_step(tx.to(tdt), te.to(tdt), tn.to(tdt), tsched, t)
    assert out.dtype == tdt and out.shape == shape
    tol = TOL if dtype == "float32" else TOL_BF16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(pal, np.float32), **tol)


@pytest.mark.parametrize("shape", [(5, 4, 8, 8, 3), (3, 2, 37), (1, 129)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ddpm_step_batched_matches_pallas(shape, dtype):
    jdt, tdt = DTYPES[dtype]
    K = shape[0]
    jsched, tsched = JaxSchedule.linear(100), DiffusionSchedule.linear(
        100, device="cpu")
    (jx, je, jn), (tx, te, tn) = _inputs(shape, jdt, seed=1)
    t = np.linspace(1.0, 99.0, K).astype(np.float32)
    tp = np.maximum(t - 1.5, 0.0).astype(np.float32)
    pal = jax_ops.ddpm_step_batched(jx, je, jn, jsched, jnp.asarray(t),
                                    t_prev=jnp.asarray(tp), use_pallas=True,
                                    interpret=True)
    tx, te, tn = tx.to(tdt), te.to(tdt), tn.to(tdt)
    tt, ttp = torch.from_numpy(t), torch.from_numpy(tp)
    out = ops.ddpm_step_batched(tx, te, tn, tsched, tt, tt_prev := ttp)
    tol = TOL if dtype == "float32" else TOL_BF16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(pal, np.float32), **tol)
    for k in range(K):      # each slab equals the scalar entry, bitwise
        row = ops.ddpm_step(tx[k], te[k], tn[k], tsched, tt[k], tt_prev[k])
        assert torch.equal(row, out[k])


def test_cpu_tensors_take_the_plain_version():
    kernel.reset_counts()
    sched = DiffusionSchedule.linear(10, device="cpu")
    x = torch.randn(2, 4, 4, 3)
    a, c, s = ops.step_coefficients(sched, 5.0)
    assert torch.equal(ops.ddpm_step(x, x, x, sched, 5.0),
                       ddpm_step_ref(x, x, x, a, c, s))
    ops.ddpm_step_batched(x, x, x, sched, torch.tensor([3.0, 9.0]))
    assert kernel.COUNTS == {"ddpm_step": 0, "ddpm_step_batched": 0}


def test_kernel_refuses_cpu_tensors():
    x = torch.zeros(1, 8)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.launch(x, x, x, torch.zeros(1, 3), "ddpm_step_batched")
    assert kernel.COUNTS["ddpm_step_batched"] == 0


def test_plain_version_matches_schedule_step():
    sched = DiffusionSchedule.linear(100, device="cpu")
    g = torch.Generator().manual_seed(0)
    x, e, n = (torch.randn(4, 8, 8, 3, generator=g) for _ in range(3))
    for t in (1.0, 50.0, 99.0):
        torch.testing.assert_close(ops.ddpm_step(x, e, n, sched, t),
                                   sched.ddpm_step(x, e, t, n), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_plain_version(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with -m cuda)")
    sched = DiffusionSchedule.linear(100, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    for shape in [(5, 4, 8, 8, 3), (3, 2, 37), (4, 12288)]:
        x, e, n = (torch.randn(shape, generator=g, device="cuda").to(dtype)
                   for _ in range(3))
        t = torch.linspace(1.0, 99.0, shape[0], device="cuda")
        before = kernel.COUNTS["ddpm_step_batched"]
        out = ops.ddpm_step_batched(x, e, n, sched, t)
        assert kernel.COUNTS["ddpm_step_batched"] == before + 1
        a, c, s = ops.step_coefficients(sched, t)
        bs = (shape[0],) + (1,) * (len(shape) - 1)
        ref = ddpm_step_ref(x, e, n, a.reshape(bs), c.reshape(bs),
                            s.reshape(bs))
        torch.cuda.synchronize()
        # no FMA contraction in the kernel: the plain version's roundings
        assert torch.equal(out, ref)
