"""The backward of the SSD-scan kernel, checked on the CPU through its
plain version.

* ``ssd_chunked_bwd_ref`` (the CUDA backward's algorithm in float32: the
  chunk states recomputed, the state gradient carried back over the
  chunks, then each chunk's gradients from its own inputs) against
  ``torch.autograd`` of ``ssd_chunked`` and ``jax.vjp`` of the JAX
  package's ``models/ssm.ssd_chunked``: S not a multiple of the chunk
  (the padded tail), chunks 16 and 64, one chunk and several, a zero and
  a random gradient of the final state.  Float32 within TOL of each
  gradient's range (max |a − b| / max(1, max |b|)): measured at most
  7.3e-6, in dA, whose terms cancel (autograd against JAX differs by
  6e-6 there); bfloat16 inputs within BF16_RANGE:
  JAX runs on the same bf16 values in float32, the port rounds dx, dB
  and dC to bf16 once.
* ``ops.ssd_scan`` on CPU tensors stays plain autograd of ``ssd_chunked``.
* ``kernel.launch_backward``'s checks of shape, type and contiguity are
  reachable here, the device checked last.
* On the card (``cuda`` marker; skips without a device): the op under
  grad launches the forward and the backward kernel, within BF16_RANGE
  of the plain backward; the CUDA side's tile (``bwd_tile``) is the
  largest that fits a block.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch.kernels.ssd_scan import kernel, ops
from repro_torch.kernels.ssd_scan.ref import ssd_chunked, ssd_chunked_bwd_ref

torch.set_num_threads(1)

TOL = 5e-5
BF16_RANGE = 1e-2
# (b, s, h, p, n, chunk, random d(final state))
CASES = [(2, 37, 3, 4, 5, 16, False), (1, 64, 2, 8, 4, 64, True),
         (2, 100, 2, 4, 3, 16, True), (1, 150, 2, 8, 8, 64, False),
         (2, 16, 1, 4, 4, 16, True), (1, 20, 2, 4, 4, 64, True)]


def _inputs(b, s, h, p, n, seed=0):
    rng = np.random.default_rng(seed)
    r = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    dt = np.log1p(np.exp(r(b, s, h) - 1)).astype(np.float32)   # softplus
    A = -np.exp(r(h)).astype(np.float32)
    return (r(b, s, h, p), dt, A, r(b, s, n), r(b, s, n), r(b, s, h, p),
            r(b, h, p, n))


def _range_err(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))


def _jax_grads(x, dt, A, B, C, chunk, dy, dfs):
    f = lambda *a: jssm.ssd_chunked(*a, chunk)
    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (x, dt, A, B, C)))
    return [np.asarray(g) for g in vjp((jnp.asarray(dy), jnp.asarray(dfs)))]


@pytest.mark.parametrize("b,s,h,p,n,chunk,final", CASES)
def test_bwd_ref_matches_autograd_and_jax_vjp(b, s, h, p, n, chunk, final):
    x, dt, A, B, C, dy, dfs = _inputs(b, s, h, p, n)
    dfs = dfs if final else np.zeros_like(dfs)
    t = [torch.from_numpy(a).requires_grad_() for a in (x, dt, A, B, C)]
    y, fs = ssd_chunked(*t, chunk)
    auto = torch.autograd.grad((y, fs), t, (torch.from_numpy(dy),
                                             torch.from_numpy(dfs)))
    got = ssd_chunked_bwd_ref(*(a.detach() for a in t), chunk,
                              torch.from_numpy(dy),
                              torch.from_numpy(dfs) if final else None)
    jgrads = _jax_grads(x, dt, A, B, C, chunk, dy, dfs)
    for name, g, a, j in zip(("x", "dt", "A", "B", "C"), got, auto, jgrads):
        assert g.dtype == torch.float32 and g.shape == a.shape, name
        assert _range_err(g.numpy(), a.numpy()) <= TOL, f"d{name} autograd"
        assert _range_err(g.numpy(), j) <= TOL, f"d{name} jax.vjp"


@pytest.mark.parametrize("b,s,h,p,n,chunk,final", CASES[::2])
def test_bwd_ref_in_bf16_within_its_range(b, s, h, p, n, chunk, final):
    x, dt, A, B, C, dy, dfs = _inputs(b, s, h, p, n, seed=1)
    bf = lambda a: torch.from_numpy(a).bfloat16()
    tx, tB, tC, tdy = bf(x), bf(B), bf(C), bf(dy)
    got = ssd_chunked_bwd_ref(tx, torch.from_numpy(dt), torch.from_numpy(A),
                              tB, tC, chunk, tdy,
                              torch.from_numpy(dfs) if final else None)
    assert [g.dtype for g in got] == [torch.bfloat16, torch.float32,
                                      torch.float32, torch.bfloat16,
                                      torch.bfloat16]
    f32 = lambda t: t.float().numpy()
    jgrads = _jax_grads(f32(tx), dt, A, f32(tB), f32(tC), chunk, f32(tdy),
                        dfs if final else np.zeros_like(dfs))
    for name, g, j in zip(("x", "dt", "A", "B", "C"), got, jgrads):
        assert _range_err(g.float().numpy(), j) <= BF16_RANGE, name


def test_padded_tail_gets_no_gradient_and_stays_out_of_dA():
    """The tail past S is dt = 0 padding: the gradients of the first S
    steps equal those of the same steps with the padding made explicit
    (zero inputs that the forward could have been given)."""
    x, dt, A, B, C, dy, _ = _inputs(1, 20, 2, 4, 4, seed=4)
    pad = lambda a: np.concatenate(
        [a, np.zeros((1, 12) + a.shape[2:], np.float32)], axis=1)
    t = lambda a: torch.from_numpy(a)
    short = ssd_chunked_bwd_ref(t(x), t(dt), t(A), t(B), t(C), 16, t(dy))
    full = ssd_chunked_bwd_ref(t(pad(x)), t(pad(dt)), t(A), t(pad(B)),
                               t(pad(C)), 16, t(pad(dy)))
    for i, (a, b) in enumerate(zip(short, full)):
        b = b if i == 2 else b[:, :20]
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def test_cpu_op_stays_plain_autograd():
    x, dt, A, B, C, dy, _ = _inputs(1, 24, 2, 4, 4, seed=2)
    t = [torch.from_numpy(a).requires_grad_() for a in (x, dt, A, B, C)]
    before = dict(kernel.COUNTS)
    y, fs = ops.ssd_scan(*t, 16)
    assert y.grad_fn is not None
    grads = torch.autograd.grad(y, t, torch.from_numpy(dy))
    ref = ssd_chunked_bwd_ref(*(a.detach() for a in t), 16,
                              torch.from_numpy(dy))
    for g, r in zip(grads, ref):
        assert _range_err(g.numpy(), r.numpy()) <= TOL
    assert kernel.COUNTS == before


def _valid(b=1, s=12, h=2, p=4, n=3, dtype=torch.float32):
    return [torch.randn(b, s, h, p, dtype=dtype), torch.rand(b, s, h),
            -torch.rand(h), torch.randn(b, s, n, dtype=dtype),
            torch.randn(b, s, n, dtype=dtype), 4,
            torch.randn(b, s, h, p, dtype=dtype),
            torch.randn(b, h, p, n)]


@pytest.mark.parametrize("mutate,error,match", [
    (lambda a: a.__setitem__(1, a[1][:, :, :1]), ValueError, "dt"),
    (lambda a: a.__setitem__(3, a[3].double()), ValueError, "B"),
    (lambda a: [a.__setitem__(i, a[i].half()) for i in (0, 3, 4, 6)],
     TypeError, "float32 or bfloat16"),
    (lambda a: a.__setitem__(6, a[6][:, :6]), ValueError, "dy"),
    (lambda a: a.__setitem__(7, a[7][..., :2]), ValueError, "dfinal"),
    (lambda a: a.__setitem__(5, 0), ValueError, "chunk"),
    (lambda a: a.__setitem__(0, a[0].transpose(2, 3)), ValueError,
     "not contiguous"),
    (lambda a: None, ValueError, "CUDA"),
    (lambda a: a.__setitem__(7, None), ValueError, "CUDA"),
], ids=["dt-shape", "B-dtype", "dtype", "dy-shape", "dfinal-shape",
        "chunk", "x-layout", "device-last", "no-dfinal"])
def test_launch_backward_checks_before_the_device(mutate, error, match):
    args = _valid()
    mutate(args)
    before = dict(kernel.COUNTS)
    with pytest.raises(error, match=match):
        kernel.launch_backward(*args)
    assert kernel.COUNTS == before


def test_launch_backward_refuses_dims_over_its_limit():
    x, dt, A, B, C, chunk, dy, dfs = _valid(p=kernel.BWD_MAX_DIM + 1)
    with pytest.raises(ValueError, match="head dim"):
        kernel.launch_backward(x, dt, A, B, C, chunk, dy, None)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_op_trains_through_the_backward_kernel(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with -m cuda)")
    tdt = getattr(torch, dtype)
    x, dt, A, B, C, dy, _ = (torch.from_numpy(a).cuda()
                             for a in _inputs(2, 150, 4, 64, 64, seed=3))
    x, B, C, dy = x.to(tdt), B.to(tdt), C.to(tdt), dy.to(tdt)
    leaves = [t.requires_grad_() for t in (x, dt, A, B, C)]
    before = dict(kernel.COUNTS)
    with torch.enable_grad():
        y, _ = ops.ssd_scan(*leaves, 64)
        grads = torch.autograd.grad(y, leaves, dy)
    assert kernel.COUNTS["ssd_scan"] == before["ssd_scan"] + 1
    assert kernel.COUNTS["ssd_scan_bwd"] == before["ssd_scan_bwd"] + 1
    ref = ssd_chunked_bwd_ref(*(t.detach() for t in leaves), 64, dy)
    torch.cuda.synchronize()
    for g, r in zip(grads, ref):
        assert _range_err(g.float().cpu().numpy(),
                          r.float().cpu().numpy()) <= BF16_RANGE


@pytest.mark.cuda
@pytest.mark.parametrize("q,p,n,tile", [(256, 64, 64, 64), (256, 64, 128, 64),
                                        (32, 64, 128, 32), (4, 16, 16, 8),
                                        (256, 128, 128, 32), (16, 8, 4, 16),
                                        (100, 64, 64, 64), (20000, 128, 128, 0)])
def test_cuda_bwd_tile_is_the_largest_that_fits(q, p, n, tile):
    """The tiles of an H100's 227 KB a block: 64 steps at the model's
    chunk 256 with head dim 64, fewer as the state grows or the chunk
    shrinks, none for a chunk whose L rows alone overflow."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with -m cuda)")
    assert kernel.bwd_tile(q, p, n) == tile
