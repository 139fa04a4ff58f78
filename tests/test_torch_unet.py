"""The port's DDPM U-Net against the JAX package's.

* ``init_unet``: the same key gives the same weights; they differ only
  through ``normal``'s erfinv (INIT_ATOL, weights scaled ≤ 1).
* forward: JAX parameters bridged into the port's module give the same ε̂
  on the same numpy inputs within FWD (fp32, different summation orders).
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs.ddpm_unet import SMALL as JAX_SMALL
from repro.core import unet as jax_unet
from repro_torch import bridge
from repro_torch.configs.ddpm_unet import SMALL, UNetConfig
from repro_torch.core import prng
from repro_torch.core.unet import (UNet, init_params, init_unet,
                                   norm_groups, unet_param_count)

torch.set_num_threads(1)

INIT_ATOL = 5e-5
FWD = dict(rtol=1e-4, atol=1e-6)

# channels 12 and 36 with 8 groups: GroupNorm falls back to 6 groups
NARROW = dataclasses.replace(
    SMALL, name="narrow", image_size=8, base_width=12, width_mults=(1, 3),
    n_res_blocks=1, attn_resolutions=(4,), n_heads=2, time_dim=16,
    groupnorm_groups=8, n_classes=3)


def _jax_cfg(cfg: UNetConfig):
    return dataclasses.replace(JAX_SMALL, **dataclasses.asdict(cfg))


@functools.lru_cache(maxsize=None)
def _jax_params(cfg: UNetConfig, seed: int):
    """The JAX package's init_unet, jitted once per config (eager init
    dispatches one compile per draw)."""
    jcfg = _jax_cfg(cfg)
    return jax.jit(jax_unet.init_unet, static_argnums=1)(
        jax.random.PRNGKey(seed), jcfg)


def _inputs(cfg, batch=2, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, cfg.image_size, cfg.image_size,
                             cfg.channels)).astype(np.float32)
    t = rng.uniform(1.0, 100.0, batch).astype(np.float32)
    y = np.eye(cfg.n_classes, dtype=np.float32)[
        rng.integers(0, cfg.n_classes, batch)]
    return x, t, y


def test_norm_groups_fallback():
    assert norm_groups(12, 8) == 6 and norm_groups(36, 8) == 6
    assert norm_groups(64, 8) == 8 and norm_groups(3, 8) == 3


@pytest.mark.parametrize("cfg", [SMALL, NARROW], ids=["small", "narrow"])
def test_init_matches_jax(cfg):
    jp = _jax_params(cfg, 4)
    tp = init_params(prng.PRNGKey(4), cfg)
    jl = [np.asarray(a) for a in jax.tree.leaves(jp)]
    tl = jax.tree.leaves(tp)         # same (sorted-key) leaf order
    assert [a.shape for a in jl] == [a.shape for a in tl]
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(b, a, rtol=0, atol=INIT_ATOL)
    model = init_unet(prng.PRNGKey(4), cfg, device="cpu")
    assert unet_param_count(model) == jax_unet.unet_param_count(jp)


@pytest.mark.parametrize("cfg", [SMALL, NARROW], ids=["small", "narrow"])
def test_forward_matches_jax(cfg):
    jcfg = _jax_cfg(cfg)
    jp = _jax_params(cfg, 4)
    model = bridge.load_unet(UNet(cfg), jax.tree.map(np.asarray, jp))
    x, t, y = _inputs(cfg)
    ref = np.asarray(jax.jit(jax_unet.unet_apply, static_argnums=4)(
        jp, x, t, y, jcfg))
    with torch.no_grad():
        out = model(*(torch.from_numpy(a) for a in (x, t, y)))
    assert out.shape == x.shape and out.is_contiguous()
    np.testing.assert_allclose(out.numpy(), ref, **FWD)


def test_forward_rows_are_batch_independent():
    model = init_unet(prng.PRNGKey(2), NARROW, device="cpu")
    x, t, y = (torch.from_numpy(a) for a in _inputs(NARROW, batch=3))
    with torch.no_grad():
        full = model(x, t, y)
        one = model(x[:1], t[:1], y[:1])
    torch.testing.assert_close(full[:1], one, rtol=1e-5, atol=1e-6)


def test_bridge_keeps_none_attention_slots():
    model = UNet(NARROW)
    assert model.down[0].attn[0] is None and model.down[1].attn[0] is not None
    params = init_params(prng.PRNGKey(0), NARROW)
    assert params["down"][0]["attn"][0] is None
    bridge.load_unet(model, params)
    np.testing.assert_array_equal(
        model.stem.weight.detach().numpy(),
        params["stem"]["w"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        model.time_mlp["w1"].weight.detach().numpy(),
        params["time_mlp"]["w1"].T)


def test_bridge_rejects_mismatches():
    params = init_params(prng.PRNGKey(0), NARROW)
    with pytest.raises(ValueError):
        bridge.load_unet(UNet(SMALL), params)
    with pytest.raises(TypeError):
        bridge.load_unet(UNet(NARROW),
                         bridge.tree_map(torch.from_numpy, params))


def test_bridge_unstacks_client_axis():
    stacked = {"a": np.arange(3, dtype=np.float32),
               "w": np.ones((3, 2, 2), np.float32), "none": None}
    per = bridge.unstack(stacked)
    assert len(per) == 3 and per[1]["a"] == 1.0 and per[2]["none"] is None
    t = bridge.to_torch(per[2])
    assert isinstance(t["w"], torch.Tensor) and t["w"].shape == (2, 2)
