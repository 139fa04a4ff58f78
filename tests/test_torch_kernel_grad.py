"""The CUDA kernels' raw launches have no backward, and say so.

Each ``kernels/*/kernel.py::launch`` fills a fresh output through ctypes,
so that output carries no ``grad_fn``: a loss on the card would train
nothing upstream of the kernel, silently.  Each launch therefore refuses,
as its first statement, an input (weights included) that requires grad
while grad is enabled — no fallback, no flag.  Flash attention, the SSD
scan and the grouped matmul train on the card through their ops'
autograd route instead (a ``torch.autograd.Function`` whose forward
calls ``launch`` with grad off and whose backward is a backward kernel);
the DDPM step has no backward, nor have the Mamba2 mixer's glue kernels
(a mixer that needs a gradient keeps its eager route).  Under
``no_grad`` (the samplers) or without such an input the refusal is
silent, and the launch goes on to its own checks (here, on the CPU, the
one that wants a CUDA device).
The public ops on CPU tensors take the plain versions, which stay
differentiable.
"""
import pytest
import torch

from repro_torch.kernels import refuse_grad
from repro_torch.kernels.ddpm_step import kernel as dkernel
from repro_torch.kernels.flash_attention import kernel as fkernel
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.grouped_matmul import kernel as gkernel
from repro_torch.kernels.grouped_matmul import ops as gops
from repro_torch.kernels.mamba_mixer import kernel as mkernel
from repro_torch.kernels.ssd_scan import kernel as skernel
from repro_torch.kernels.ssd_scan import ops as sops

torch.set_num_threads(1)


def _ddpm(grad):
    x = torch.randn(2, 4, 4, 3, requires_grad=grad)
    return dkernel.launch, (x, torch.randn(2, 4, 4, 3),
                            torch.randn(2, 4, 4, 3), torch.ones(1, 3),
                            "ddpm_step")


def _flash(grad):
    q = torch.randn(1, 2, 8, 16)
    k = torch.randn(1, 2, 8, 16, requires_grad=grad)
    return fkernel.launch, (q, k, torch.randn(1, 2, 8, 16), False, 0)


def _ssd(grad):
    A = -torch.ones(2, requires_grad=grad)    # a weight (A = −exp(A_log))
    return skernel.launch, (torch.randn(1, 8, 2, 4), torch.rand(1, 8, 2), A,
                            torch.randn(1, 8, 4), torch.randn(1, 8, 4), 4)


def _gmm(grad):
    w = torch.randn(2, 8, 6, requires_grad=grad)   # the expert weights
    return gkernel.launch, (torch.randn(2, 5, 8), w)


def _conv(grad):
    w = torch.randn(4, 8, requires_grad=grad)     # the conv weights
    return mkernel.launch_conv_silu, (torch.randn(1, 5, 8),
                                      torch.randn(1, 5, 4), w,
                                      torch.randn(8), torch.randn(4, 4),
                                      torch.randn(4))


def _norm(grad):
    scale = torch.ones(128, requires_grad=grad)   # the norm's weight
    return mkernel.launch_rmsnorm, (torch.randn(3, 128), scale, 1e-5)


KERNELS = {"ddpm_step": _ddpm, "flash_attention": _flash, "ssd_scan": _ssd,
           "grouped_matmul": _gmm, "mamba_conv_silu": _conv,
           "mamba_rmsnorm": _norm}


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_launch_refuses_an_input_that_requires_grad(name):
    launch, args = KERNELS[name](True)
    counts = dict(launch.__globals__["COUNTS"])
    with pytest.raises(RuntimeError, match=f"{name}: .*no backward"):
        launch(*args)
    assert launch.__globals__["COUNTS"] == counts     # nothing launched


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_launch_does_not_refuse_under_no_grad(name):
    """Serving runs under no_grad: the refusal stays silent, and on the
    CPU the launch's device check is what raises."""
    launch, args = KERNELS[name](True)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA|cuda"):
        launch(*args)
    launch, args = KERNELS[name](False)
    with pytest.raises(ValueError, match="CUDA|cuda"):
        launch(*args)


def test_refuse_grad_ignores_non_tensors_and_frozen_inputs():
    refuse_grad("k", torch.ones(2), None, 3, "entry")
    with torch.no_grad():
        refuse_grad("k", torch.ones(2, requires_grad=True))
    with pytest.raises(RuntimeError, match="^k: the CUDA kernel"):
        refuse_grad("k", torch.ones(2), torch.ones(1, requires_grad=True))


def test_plain_versions_stay_differentiable_on_the_cpu():
    q = torch.randn(1, 2, 8, 16, requires_grad=True)
    k, v = torch.randn(1, 1, 8, 16), torch.randn(1, 1, 8, 16)
    fops.flash_attention(q, k, v, causal=False).sum().backward()
    assert q.grad is not None and q.grad.abs().sum() > 0
    x = torch.randn(1, 8, 2, 4, requires_grad=True)
    A = torch.tensor([-0.5, -1.0], requires_grad=True)
    y, state = sops.ssd_scan(x, torch.rand(1, 8, 2), A, torch.randn(1, 8, 4),
                             torch.randn(1, 8, 4), 4)
    (y.sum() + state.sum()).backward()
    assert x.grad is not None and A.grad is not None
    w = torch.randn(2, 8, 6, requires_grad=True)
    gops.grouped_matmul(torch.randn(2, 5, 8), w).sum().backward()
    assert w.grad is not None and w.grad.abs().sum() > 0
