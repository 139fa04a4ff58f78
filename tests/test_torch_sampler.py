"""The port's per-request Alg.-2 samplers against the JAX package's, under
the same key: GM (t_ζ=0), ICM (t_ζ=T) and mid cuts with the M-remap on
and off, the shared-handoff fast path and the strided DDIM server phase,
with a toy linear denoiser and a tiny U-Net.

Tolerance SAMPLE: the draws agree bitwise except where ``normal``'s erfinv
differs by a few ulps (see test_torch_prng.py); those differences ride
along the sweep, scaled by σ_t ≤ 1 per step.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.ddpm_unet import SMALL as JAX_SMALL
from repro.core import sampler as js
from repro.core import unet as jax_unet
from repro.core.schedules import DiffusionSchedule as JaxSchedule
from repro.core.splitting import CutPoint as JaxCut
from repro_torch import bridge
from repro_torch.configs.ddpm_unet import SMALL
from repro_torch.core import prng
from repro_torch.core import sampler as ts
from repro_torch.core.schedules import DiffusionSchedule
from repro_torch.core.splitting import CutPoint
from repro_torch.core.unet import UNet, unet_apply

torch.set_num_threads(1)

SAMPLE = dict(rtol=1e-4, atol=1e-4)
T = 12
SHAPE = (2, 4, 4, 3)
JSCHED = JaxSchedule.linear(T)
TSCHED = DiffusionSchedule.linear(T, device="cpu")
Y = np.eye(3, dtype=np.float32)[[0, 2]]

TINY = dataclasses.replace(
    SMALL, name="tiny", image_size=8, base_width=8, width_mults=(1, 2),
    n_res_blocks=1, attn_resolutions=(4,), n_heads=2, time_dim=16,
    groupnorm_groups=4, n_classes=3)


def toy(p, x, t, y):
    """Param-, time- and label-dependent linear denoiser."""
    lead = (-1,) + (1,) * (x.ndim - 1)
    return x * p["a"] + 0.001 * t.reshape(lead) + \
        0.01 * y.sum(-1).reshape(lead)


def _jp(a):
    return {"a": jnp.float32(a)}


def _tp(a):
    return {"a": torch.tensor(a, dtype=torch.float32)}


def _close(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **SAMPLE)


@pytest.mark.parametrize("t_cut", [0, 5, T])
@pytest.mark.parametrize("adjusted", [True, False])
def test_collaborative_sample_toy(t_cut, adjusted):
    jo, jh = js.collaborative_sample(
        _jp(0.2), _jp(0.1), jax.random.PRNGKey(1), jnp.asarray(Y), SHAPE,
        JSCHED, JaxCut(T, t_cut), toy, adjusted=adjusted,
        return_handoff=True)
    to, th = ts.collaborative_sample(
        _tp(0.2), _tp(0.1), prng.PRNGKey(1), torch.from_numpy(Y), SHAPE,
        TSCHED, CutPoint(T, t_cut), toy, adjusted=adjusted,
        return_handoff=True)
    _close(to, jo)
    _close(th, jh)


@functools.lru_cache(maxsize=None)
def _tiny_models():
    jcfg = dataclasses.replace(JAX_SMALL, **dataclasses.asdict(TINY))
    jp = jax.jit(jax_unet.init_unet, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)
    # the client is the server net scaled: two distinct models, one init
    jps = [jp, jax.tree.map(lambda a: a * 0.5, jp)]
    tms = [bridge.load_unet(UNet(TINY), jax.tree.map(np.asarray, p))
           for p in jps]
    japply = lambda p, x, t, y: jax_unet.unet_apply(p, x, t, y, jcfg)
    return jps, tms, japply


@pytest.mark.parametrize("t_cut", [0, 4])
def test_collaborative_sample_tiny_unet(t_cut):
    Tu = 6
    (jsp, jcp), (tsp, tcp), japply = _tiny_models()
    shape = (2, 8, 8, 3)
    jo = js.collaborative_sample(
        jsp, jcp, jax.random.PRNGKey(3), jnp.asarray(Y), shape,
        JaxSchedule.linear(Tu), JaxCut(Tu, t_cut), japply)
    to = ts.collaborative_sample(
        tsp, tcp, prng.PRNGKey(3), torch.from_numpy(Y), shape,
        DiffusionSchedule.linear(Tu, device="cpu"), CutPoint(Tu, t_cut),
        unet_apply)
    _close(to, jo)


@pytest.mark.parametrize("n_clients", [1, 3])
def test_shared_handoff_sample(n_clients):
    cut = 5
    jcp = [_jp(0.1 * (i + 1)) for i in range(n_clients)]
    tcp = [_tp(0.1 * (i + 1)) for i in range(n_clients)]
    jo, jh = js.shared_handoff_sample(
        _jp(0.2), jcp, jax.random.PRNGKey(2), jnp.asarray(Y), SHAPE, JSCHED,
        JaxCut(T, cut), toy)
    to, th = ts.shared_handoff_sample(
        _tp(0.2), tcp, prng.PRNGKey(2), torch.from_numpy(Y), SHAPE, TSCHED,
        CutPoint(T, cut), toy)
    assert to.shape == (n_clients,) + SHAPE
    _close(to, jo)
    _close(th, jh)
    # a stacked client tree takes the same path as the list
    stacked = {"a": torch.stack([p["a"] for p in tcp])}
    so, _ = ts.shared_handoff_sample(
        _tp(0.2), stacked, prng.PRNGKey(2), torch.from_numpy(Y), SHAPE,
        TSCHED, CutPoint(T, cut), toy)
    assert torch.equal(so, to)


@pytest.mark.parametrize("stride", [2, 3, 5])
def test_server_denoise_ddim(stride):
    cut = 2
    jo = js.server_denoise_ddim(_jp(0.2), jax.random.PRNGKey(4),
                                jnp.asarray(Y), SHAPE, JSCHED,
                                JaxCut(T, cut), toy, stride=stride)
    to = ts.server_denoise_ddim(_tp(0.2), prng.PRNGKey(4),
                                torch.from_numpy(Y), SHAPE, TSCHED,
                                CutPoint(T, cut), toy, stride=stride)
    _close(to, jo)
    sho, _ = ts.shared_handoff_sample(
        _tp(0.2), [_tp(0.1)], prng.PRNGKey(5), torch.from_numpy(Y), SHAPE,
        TSCHED, CutPoint(T, cut), toy, server_stride=stride)
    jso, _ = js.shared_handoff_sample(
        _jp(0.2), [_jp(0.1)], jax.random.PRNGKey(5), jnp.asarray(Y), SHAPE,
        JSCHED, JaxCut(T, cut), toy, server_stride=stride)
    _close(sho, jso)


def test_server_handoff_for_eval_is_the_handoff():
    key = prng.PRNGKey(6)
    _, handoff = ts.collaborative_sample(
        _tp(0.2), _tp(0.1), key, torch.from_numpy(Y), SHAPE, TSCHED,
        CutPoint(T, 5), toy, return_handoff=True)
    ks, _ = prng.split(key)
    h = ts.server_handoff_for_eval(_tp(0.2), ks, torch.from_numpy(Y), SHAPE,
                                   TSCHED, CutPoint(T, 5), toy)
    assert torch.equal(h, handoff)


def test_per_request_sampler_is_collaborative_sample():
    fn_for = ts.make_per_request_sampler(TSCHED, toy, SHAPE)
    assert fn_for(5) is fn_for(5)
    a = fn_for(5)(_tp(0.2), _tp(0.1), prng.PRNGKey(7), torch.from_numpy(Y))
    b = ts.collaborative_sample(_tp(0.2), _tp(0.1), prng.PRNGKey(7),
                                torch.from_numpy(Y), SHAPE, TSCHED,
                                CutPoint(T, 5), toy)
    assert torch.equal(a, b)
