"""The port's MoE layer, MoE blocks and MoE DiT against the JAX package's.

At ``reduced(dbrx-132b)`` and ``reduced(kimi-k2-1t-a32b)`` (float32, 4
experts, top-2), with inputs from numpy and parameters bridged from JAX:

* ``_router``: top-k indices bitwise, weights and probabilities within
  ROUTER_ATOL (1e-6; other summation orders in the logits).  The inputs
  are random, so exact ties between probabilities, where ``lax.top_k``
  takes the lower index first and ``torch.topk`` promises no order, do
  not occur;
* ``_aux_loss`` within ROUTER_ATOL;
* ``moe_dense`` and ``block_apply`` within FWD (atol 1e-4, rtol 1e-3);
* ``fill_moe`` against ``moe_init`` from the same key within INIT_ATOL
  (5e-5: ``normal``'s erfinv ulps, weights <= 1);
* ``prng.fill_normal_``: the chunked draw equals the one-shot draw
  bitwise at several chunk sizes, one of which does not divide the size,
  and ``jax.random.normal`` within NORMAL_ATOL;
* the reduced MoE DiT forward against ``dit_apply`` within FWD, and
  ``build_denoiser`` + ``sample_for_client`` for ``dbrx-132b`` against
  JAX at T = 20, cut 5 within SAMPLE.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.configs.base import reduced as jax_reduced
from repro.core import collab as jcollab
from repro.core import dit as jdit
from repro.models import moe as jmoe
from repro.models import transformer as jtransformer
from repro_torch import bridge
from repro_torch.configs.base import get_arch, reduced
from repro_torch.core import collab as tcollab
from repro_torch.core import dit as tdit
from repro_torch.core import prng
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttransformer

torch.set_num_threads(1)

ROUTER_ATOL = 1e-6
INIT_ATOL = 5e-5
NORMAL_ATOL = 5e-5
FWD = dict(atol=1e-4, rtol=1e-3)
SAMPLE = dict(atol=1e-4, rtol=1e-4)
ARCHS = ["dbrx-132b", "kimi-k2-1t-a32b"]
DIT = dict(image_size=16, channels=3, patch_size=2, n_classes=8)


def _cfgs(name):
    return jax_reduced(jax_get_arch(name)), reduced(get_arch(name))


@functools.lru_cache(maxsize=None)
def _jax_moe(name, seed):
    jcfg, _ = _cfgs(name)
    return jmoe.moe_init(jax.random.PRNGKey(seed), jcfg, jnp.float32)


def _port_moe(name, seed):
    _, cfg = _cfgs(name)
    m = tmoe.MoE(cfg, torch.float32)
    return bridge.load_params(m, jax.tree.map(np.asarray, _jax_moe(name,
                                                                   seed)))


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("name", ARCHS)
def test_router_matches_jax(name):
    jcfg, cfg = _cfgs(name)
    x = _x((64, cfg.d_model))
    probs, w, idx = jmoe._router(_jax_moe(name, 0), x, jcfg.top_k)
    with torch.no_grad():
        tprobs, tw, tidx = tmoe._router(_port_moe(name, 0),
                                        torch.from_numpy(x), cfg.top_k)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(idx))
    np.testing.assert_allclose(tw.numpy(), np.asarray(w), rtol=0,
                               atol=ROUTER_ATOL)
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(probs), rtol=0,
                               atol=ROUTER_ATOL)
    # descending, renormalised
    assert (tw[:, :-1] >= tw[:, 1:]).all()
    np.testing.assert_allclose(tw.sum(-1).numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("name", ARCHS)
def test_aux_loss_matches_jax(name):
    jcfg, cfg = _cfgs(name)
    x = _x((64, cfg.d_model), seed=1)
    probs, _, idx = jmoe._router(_jax_moe(name, 1), x, jcfg.top_k)
    ref = jmoe._aux_loss(probs, idx, jcfg.n_experts)
    out = tmoe._aux_loss(torch.from_numpy(np.array(probs)),
                         torch.from_numpy(np.array(idx)).long(),
                         cfg.n_experts)
    np.testing.assert_allclose(float(out), float(ref), rtol=0,
                               atol=ROUTER_ATOL)


@pytest.mark.parametrize("name", ARCHS)
def test_moe_dense_matches_jax(name):
    jcfg, cfg = _cfgs(name)
    x = _x((2, 16, cfg.d_model), seed=2)
    ref, ref_aux = jmoe.moe_dense(_jax_moe(name, 2), x, jcfg)
    with torch.no_grad():
        out, aux = tmoe.moe_apply(_port_moe(name, 2), torch.from_numpy(x),
                                  cfg)
    assert out.shape == x.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FWD)
    np.testing.assert_allclose(float(aux), float(ref_aux), rtol=0,
                               atol=ROUTER_ATOL)


@pytest.mark.parametrize("name", ARCHS)
def test_block_apply_matches_jax(name):
    jcfg, cfg = _cfgs(name)
    jp = jtransformer.block_init(jax.random.PRNGKey(3), jcfg, jnp.float32)
    block = ttransformer.Block(cfg, torch.float32)
    bridge.load_params(block, jax.tree.map(np.asarray, jp))
    assert hasattr(block, "moe") and not hasattr(block, "mlp")
    x = _x((2, 24, cfg.d_model), seed=3)
    pos = np.arange(24, dtype=np.int32)[None]
    ref, ref_aux, _ = jtransformer.block_apply(jp, x, jcfg, jdit.CPU, pos,
                                               causal=False)
    with torch.no_grad():
        out, aux, _ = ttransformer.block_apply(block, torch.from_numpy(x),
                                               cfg, torch.from_numpy(pos),
                                               causal=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FWD)
    np.testing.assert_allclose(float(aux), float(ref_aux), **FWD)


@pytest.mark.parametrize("name", ARCHS)
def test_fill_moe_matches_moe_init(name):
    _, cfg = _cfgs(name)
    ref = jax.tree.map(np.asarray, _jax_moe(name, 4))
    drawn = tmoe.moe_init(prng.PRNGKey(4), cfg, torch.float32)
    assert drawn.router.dtype == torch.float32
    for k, v in drawn.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref[k], rtol=0,
                                   atol=INIT_ATOL, err_msg=k)


def test_router_stays_float32_in_a_bf16_model():
    _, cfg = _cfgs("dbrx-132b")
    m = tmoe.moe_init(prng.PRNGKey(5), cfg, torch.bfloat16)
    assert m.router.dtype == torch.float32
    assert {p.dtype for n, p in m.named_parameters() if n != "router"} == \
        {torch.bfloat16}


SHAPE = (3, 17, 11)      # 561 elements


@pytest.mark.parametrize("chunk", [1, 7, 64, 561, 4096])
def test_chunked_normal_equals_the_one_shot_draw(chunk):
    key = prng.PRNGKey(6)
    one_shot = prng.normal(key, SHAPE)
    p = torch.empty(SHAPE)
    prng.fill_normal_(p, key, chunk=chunk)
    assert torch.equal(p, one_shot)
    scale = np.float32(1.0 / np.sqrt(11.0))
    q = torch.empty(SHAPE, dtype=torch.bfloat16)
    prng.fill_normal_(q, key, scale=float(1.0 / np.sqrt(11.0)), chunk=chunk)
    assert torch.equal(q, (one_shot * torch.tensor(scale)).to(torch.bfloat16))
    r = torch.empty(SHAPE)
    prng.fill_normal_(r, key, divisor=float(np.sqrt(11.0)), chunk=chunk)
    assert torch.equal(r, one_shot / torch.tensor(np.float32(np.sqrt(11.0))))


def test_chunked_normal_matches_jax_normal():
    ref = np.asarray(jax.random.normal(jax.random.PRNGKey(7), SHAPE) /
                     np.sqrt(11.0))
    p = torch.empty(SHAPE)
    prng.fill_normal_(p, prng.PRNGKey(7), divisor=float(np.sqrt(11.0)),
                      chunk=50)
    np.testing.assert_allclose(p.numpy(), ref, rtol=0, atol=NORMAL_ATOL)


def test_fill_normal_refuses_a_strided_parameter():
    p = torch.empty(4, 6).t()
    with pytest.raises(ValueError, match="contiguous"):
        prng.fill_normal_(p, prng.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _jax_dit(name, seed):
    jarch = jax_reduced(jax_get_arch(name))
    jcfg = jdit.DiTConfig(**DIT)
    params = jax.jit(jdit.init_dit, static_argnums=(1, 2))(
        jax.random.PRNGKey(seed), jarch, jcfg)
    return jarch, jcfg, params


def _port_dit(name, seed):
    _, _, jp = _jax_dit(name, seed)
    arch, cfg = reduced(get_arch(name)), tdit.DiTConfig(**DIT)
    return arch, cfg, bridge.load_dit(tdit.DiT(arch, cfg),
                                      jax.tree.map(np.asarray, jp))


def _dit_inputs(batch=2, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, 16, 16, 3)).astype(np.float32)
    t = rng.uniform(1.0, 100.0, batch).astype(np.float32)
    y = np.eye(8, dtype=np.float32)[rng.integers(0, 8, batch)]
    return x, t, y


@pytest.mark.parametrize("name", ARCHS)
def test_moe_dit_forward_matches_jax(name):
    jarch, jcfg, jp = _jax_dit(name, 1)
    arch, cfg, model = _port_dit(name, 1)
    x, t, y = _dit_inputs()
    h = _x((2, cfg.n_patches, arch.d_model), seed=8)
    ref_h, _ = jdit._backbone(jp, h, jarch, jdit.CPU)
    ref = jax.jit(jdit.dit_apply, static_argnums=(4, 5))(jp, x, t, y, jarch,
                                                         jcfg)
    with torch.no_grad():
        out_h = tdit._backbone(model, torch.from_numpy(h), arch)
        out = model(*(torch.from_numpy(a) for a in (x, t, y)))
    np.testing.assert_allclose(out_h.numpy(), np.asarray(ref_h), **FWD)
    assert out.shape == x.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FWD)


def test_moe_dit_init_matches_jax():
    name = "dbrx-132b"
    arch, cfg, bridged = _port_dit(name, 4)
    drawn = tdit.init_dit(prng.PRNGKey(4), arch, cfg, device="cpu")
    sd_b, sd_d = bridged.state_dict(), drawn.state_dict()
    assert list(sd_b) == list(sd_d)
    assert any(".moe.w_down" in k for k in sd_d)
    for k in sd_b:
        torch.testing.assert_close(sd_d[k], sd_b[k], rtol=0,
                                   atol=INIT_ATOL, msg=k)


def test_sample_for_client_matches_jax():
    """Alg. 2 end to end with the reduced DBRX DiT (the grouped matmul's
    and flash attention's plain versions on the CPU), T = 20, cut 5."""
    name, T, t_cut = "dbrx-132b", 20, 5
    kw = dict(n_clients=2, T=T, t_cut=t_cut, denoiser=name, image_size=16,
              channels=3, n_classes=8, batch_size=2, dit_patch=2)
    jcfg, tcfg = jcollab.CollabConfig(**kw), tcollab.CollabConfig(**kw)
    _, japply = jcollab.build_denoiser(jax.random.PRNGKey(0), jcfg)
    init_one, tapply = tcollab.build_denoiser(prng.PRNGKey(0), tcfg,
                                              device="cpu")
    model = init_one(prng.PRNGKey(9))
    assert isinstance(model, tdit.DiT) and hasattr(model.layers[0], "moe")
    ps = [_jax_dit(name, s)[2] for s in (5, 6, 7)]
    jstate = jcollab.CollabState(ps[0], None, ps[1:], None)
    tstate = tcollab.CollabState(
        _port_dit(name, 5)[2], None, [_port_dit(name, s)[2] for s in (6, 7)],
        None)
    y = np.eye(8, dtype=np.float32)[[3, 6]]
    ref = jcollab.sample_for_client(jstate, 1, jax.random.PRNGKey(2),
                                    jnp.asarray(y), jcfg, jax.jit(japply))
    with torch.no_grad():
        out = tcollab.sample_for_client(tstate, 1, prng.PRNGKey(2),
                                        torch.from_numpy(y), tcfg, tapply)
    assert out.shape == (2, 16, 16, 3) and torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **SAMPLE)
