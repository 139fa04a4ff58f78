"""The U-Net in a dtype other than float32 (core/unet.py with
``UNetConfig(dtype="bfloat16")``) against the JAX package's
``init_unet`` / ``unet_apply`` at the same dtype, on the CPU.

* The init: every leaf drawn in float32, scaled, then cast, as JAX's;
  after the bridge each leaf within TOL_BF16 of JAX's (a normal that
  lies within its few ulps of a bf16 rounding boundary rounds the other
  way: one bf16 ulp).
* The forward on the same bf16 weights (numpy normals, std 0.05, and the
  init's): bf16 x, and float32 x (cast to the weights' dtype on entry,
  as JAX's convolution wants) against JAX's at bf16 x, within TOL_BF16;
  ε̂ comes out in bf16, as JAX's.
* The per-request sampler (Alg. 2) on the CPU with a bf16 server and
  client: ε̂ is cast to float32 for the DDPM step, the sample is float32,
  finite and bitwise across two runs.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.ddpm_unet import SMALL as JSMALL
from repro.core import unet as junet
from repro_torch import bridge
from repro_torch.configs.ddpm_unet import SMALL
from repro_torch.core import prng
from repro_torch.core import unet as tunet
from repro_torch.core.sampler import collaborative_sample
from repro_torch.core.schedules import DiffusionSchedule
from repro_torch.core.splitting import CutPoint

torch.set_num_threads(1)

TOL_BF16 = dict(atol=5e-2, rtol=5e-2)   # the JAX package's bf16 tolerance
CFG = dataclasses.replace(SMALL, image_size=8, dtype="bfloat16")
JCFG = dataclasses.replace(JSMALL, image_size=8, dtype="bfloat16")


@functools.lru_cache(maxsize=None)
def _jax_init():
    init = jax.jit(functools.partial(junet.init_unet, cfg=JCFG))
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _jax_apply():
    return jax.jit(functools.partial(junet.unet_apply, cfg=JCFG))


def _random_weights():
    """bf16 normals (std 0.05) in JAX's layout."""
    rng = np.random.default_rng(3)
    return jax.tree.map(
        lambda a: np.asarray(jnp.asarray(0.05 * rng.standard_normal(
            a.shape), jnp.float32).astype(jnp.bfloat16)), _jax_init())


def _inputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    t = np.array([3.0, 17.0], np.float32)
    y = np.eye(CFG.n_classes, dtype=np.float32)[[1, 2]]
    return x, t, y


def test_init_matches_jax_after_the_bridge():
    model = tunet.init_unet(prng.PRNGKey(0), CFG, "cpu")
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    want = _jax_init()
    got = bridge.dump_params(model, want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want),
                    strict=True):
        assert b.dtype == jnp.bfloat16
        np.testing.assert_allclose(a, np.asarray(b, np.float32), **TOL_BF16)
    # the round trip through the bridge is exact in bf16
    back = bridge.load_unet(tunet.UNet(CFG), want)
    again = bridge.dump_params(back, want)
    for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(want)):
        assert np.array_equal(a, np.asarray(b, np.float32))


@pytest.mark.parametrize("weights", ["init", "random"])
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_forward_matches_jax(weights, x_dtype):
    tree = _jax_init() if weights == "init" else _random_weights()
    x, t, y = _inputs()
    want = np.asarray(_jax_apply()(
        tree, jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(t),
        jnp.asarray(y)))
    assert want.dtype == jnp.bfloat16
    model = bridge.load_unet(tunet.UNet(CFG), tree)
    with torch.no_grad():
        got = model(torch.from_numpy(x).to(getattr(torch, x_dtype)),
                    torch.from_numpy(t), torch.from_numpy(y))
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32),
                               **TOL_BF16)


def test_per_request_sampler_runs_with_a_bf16_model():
    server = tunet.init_unet(prng.PRNGKey(1), CFG, "cpu")
    client = tunet.init_unet(prng.PRNGKey(2), CFG, "cpu")
    sched, cut = DiffusionSchedule.linear(10, device="cpu"), CutPoint(10, 4)
    y = torch.from_numpy(np.eye(CFG.n_classes, dtype=np.float32)[[0, 3]])
    run = lambda: collaborative_sample(
        server, client, prng.PRNGKey(5), y, (2, 8, 8, 3), sched, cut,
        tunet.unet_apply)
    a, b = run(), run()
    assert a.dtype == torch.float32 and a.shape == (2, 8, 8, 3)
    assert torch.isfinite(a).all() and torch.equal(a, b)
