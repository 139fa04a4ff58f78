"""The port's grouped-matmul op against the JAX package's.

* ``ops.grouped_matmul`` on CPU tensors (the plain version) against JAX's
  ``grouped_matmul_ref`` and against the Pallas kernel in interpret mode
  (``bc=16, bf=32, bd=16``, as tests/test_kernels.py runs it), at that
  test's sweep shapes.  Tolerances are that test's: TOL (atol 1e-4, rtol
  1e-3) in float32, TOL_BF16 in bfloat16 (both sides round the same numpy
  inputs to bf16; the sums run in other orders).
* Tokens broadcast to every expert (``expand``, expert stride 0, as
  ``moe_dense`` passes them) give exactly what a contiguous copy gives.
* CPU tensors take the plain version without a launch; the kernel's
  wrapper refuses CPU tensors, other dtypes and shapes that do not fit.
* The CUDA kernels against the plain version on the card, and the wgmma variant keeps a row's bits at any C
  (``cuda`` marker; skips without a device).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.grouped_matmul.kernel import grouped_matmul_pallas
from repro.kernels.grouped_matmul.ref import grouped_matmul_ref as jax_ref
from repro_torch.kernels.grouped_matmul import kernel, ops
from repro_torch.kernels.grouped_matmul.ref import grouped_matmul_ref

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-3)
TOL_BF16 = dict(atol=5e-2, rtol=5e-2)
DTYPES = {"float32": (jnp.float32, torch.float32, TOL),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, TOL_BF16)}
SWEEP = [(4, 32, 64, 48), (2, 100, 50, 70), (8, 16, 16, 16), (1, 7, 9, 11)]


def _tw(E, C, D, F, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((E, C, D)).astype(np.float32),
            rng.standard_normal((E, D, F)).astype(np.float32))


def _both(arrays, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("E,C,D,F", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_jax_ref(E, C, D, F, dtype):
    (jt, jw), (tt, tw) = _both(_tw(E, C, D, F), dtype)
    out = ops.grouped_matmul(tt, tw)
    assert out.dtype == tt.dtype and out.shape == (E, C, F)
    np.testing.assert_allclose(_f32(out), _f32(jax_ref(jt, jw)),
                               **DTYPES[dtype][2])


@pytest.mark.parametrize("E,C,D,F", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_pallas_interpret(E, C, D, F, dtype):
    (jt, jw), (tt, tw) = _both(_tw(E, C, D, F, seed=1), dtype)
    pal = grouped_matmul_pallas(jt, jw, bc=16, bf=32, bd=16, interpret=True)
    np.testing.assert_allclose(_f32(ops.grouped_matmul(tt, tw)), _f32(pal),
                               **DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_broadcast_tokens_equal_a_contiguous_copy(dtype):
    tdt = DTYPES[dtype][1]
    t, w = (torch.from_numpy(a).to(tdt) for a in _tw(4, 12, 24, 20, seed=2))
    shared = t[0].unsqueeze(0).expand(4, -1, -1)
    assert shared.stride(0) == 0
    assert torch.equal(ops.grouped_matmul(shared, w),
                       ops.grouped_matmul(shared.contiguous(), w))


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    t, w = (torch.from_numpy(a) for a in _tw(2, 5, 8, 6, seed=3))
    before = kernel.COUNTS["grouped_matmul"]
    assert torch.equal(ops.grouped_matmul(t, w), grouped_matmul_ref(t, w))
    assert kernel.COUNTS["grouped_matmul"] == before


def test_kernel_wrapper_refuses_what_it_cannot_run():
    t, w = (torch.from_numpy(a) for a in _tw(2, 5, 8, 6, seed=4))
    before = kernel.COUNTS["grouped_matmul"]
    with pytest.raises(ValueError, match="CUDA"):
        kernel.launch(t, w)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kernel.launch(t.half(), w.half())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kernel.launch(t, w.to(torch.bfloat16))
    with pytest.raises(ValueError, match="do not fit"):
        kernel.launch(t, w[:, :7])
    with pytest.raises(ValueError, match="do not fit"):
        kernel.launch(t, torch.cat([w, w[:1]]))
    with pytest.raises(ValueError, match="3 dimensions"):
        kernel.launch(t[0], w)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.launch(t, w.transpose(1, 2).contiguous().transpose(1, 2))
    assert kernel.COUNTS["grouped_matmul"] == before
    # a meta tensor takes the dry run's route: the card's output shape,
    # nothing computed and no launch counted
    meta = dict(device="meta")
    out = ops.grouped_matmul(torch.empty(2, 5, 8, **meta),
                             torch.empty(2, 8, 6, **meta))
    assert out.is_meta and out.shape == (2, 5, 6)
    assert kernel.COUNTS["grouped_matmul"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain_version(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with -m cuda)")
    tdt, tol = DTYPES[dtype][1], DTYPES[dtype][2]
    for E, C, D, F in SWEEP:
        t, w = (torch.from_numpy(a).to(tdt).cuda()
                for a in _tw(E, C, D, F))
        for tokens in (t, t[0].unsqueeze(0).expand(E, -1, -1)):
            before = kernel.COUNTS["grouped_matmul"]
            out = ops.grouped_matmul(tokens, w)
            assert kernel.COUNTS["grouped_matmul"] == before + 1
            ref = grouped_matmul_ref(tokens, w)
            torch.cuda.synchronize()
            torch.testing.assert_close(out.float(), ref.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("broadcast", [True, False])
def test_cuda_wgmma_variant_matches_plain_and_keeps_row_bits(broadcast):
    """A shape the wgmma variant takes (C over 200 of a 256-row tile, tokens
    broadcast as moe_dense passes them, or contiguous): within TOL_BF16 of
    the plain version, and the rows at C = 64 equal the first 64 rows at
    C = 200 bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with -m cuda)")
    E, C, D, F = 2, 200, 512, 384
    t, w = (torch.from_numpy(a).to(torch.bfloat16).cuda()
            for a in _tw(E, C, D, F, seed=5))
    tokens = t[0].unsqueeze(0).expand(E, -1, -1) if broadcast else t
    assert kernel.choose_variant(tokens, w) == "wgmma"
    before = kernel.COUNTS["grouped_matmul/wgmma"]
    out = ops.grouped_matmul(tokens, w)
    rows = ops.grouped_matmul(tokens[:, :64], w)
    assert kernel.COUNTS["grouped_matmul/wgmma"] == before + 2
    ref = grouped_matmul_ref(tokens, w)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), **TOL_BF16)
    assert torch.equal(rows, out[:, :64])
