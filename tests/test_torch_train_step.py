"""One Alg.-1 step of the port (core/protocol.py, optim/adamw.py) with
the SMALL U-Net against the JAX package's.

Parameters come from the JAX package's ``init_unet`` through the bridge;
inputs from a numpy seed.  Compared in JAX's layout (``bridge.dump_params``):

* the loss and the gradients of ``mse_eps_loss`` against
  ``jax.value_and_grad`` on the same (x_t, t, y, ε), within TOL (atol 2e-5,
  rtol 2e-3, the reference's fp32 tolerance);
* the masked weighted mean: rows of weight 0 get zero gradient, and the
  weighted loss equals the loss of the kept rows; all-ones weights equal
  the unweighted loss (within 1e-6 relative: a sum over B rows and a mean);
* params, both AdamW moments and the step counter after one
  ``make_collab_step`` at cuts 0 (GM: the client is not updated), mid
  and T (ICM: the server is not updated), within TOL, and the step's
  metrics; each moment leaf also within MOMENT_RTOL (TOL's rtol) of its
  own largest value, since TOL's atol exceeds every moment.  The step draws its own noise: ``prng.normal`` differs from
  ``jax.random.normal`` by ≤ 5e-5 (erfinv ulps) and that difference
  carries into x_t; after one AdamW step the params still agree within
  TOL;
* the server's backward leaves every client parameter's ``.grad``
  untouched (the payload is detached);
* the optimizer-state bridge: a JAX AdamW state → the port's → JAX's
  again, bitwise.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.ddpm_unet import SMALL as JSMALL
from repro.core import protocol as jprotocol
from repro.core import unet as junet
from repro.core.schedules import DiffusionSchedule as JSched
from repro.core.splitting import CutPoint as JCut
from repro.optim import adamw as jadamw
from repro_torch import bridge
from repro_torch.configs.ddpm_unet import SMALL
from repro_torch.core import prng, protocol
from repro_torch.core.schedules import DiffusionSchedule
from repro_torch.core.splitting import CutPoint
from repro_torch.core.unet import UNet, unet_apply
from repro_torch.optim import adamw

torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=2e-3)
# the moments are far below TOL's atol (m ~ 1e-2 … 1e-8, v ~ 1e-5 … 1e-16
# after a clipped step), so each leaf is also held to TOL's rtol of its
# own largest value (JAX vs the port: ≤ 5e-6 of it after one step)
MOMENT_RTOL = TOL["rtol"]
T = 100
B = 4


@functools.lru_cache(maxsize=None)
def _jax_params(seed: int):
    return jax.tree.map(np.asarray, jax.jit(junet.init_unet, static_argnums=1)(
        jax.random.PRNGKey(seed), JSMALL))


def _model(seed: int) -> UNet:
    return bridge.load_unet(UNet(SMALL), _jax_params(seed))


def _japply(p, x, t, y):
    return junet.unet_apply(p, x, t, y, JSMALL)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-1, 1, (B, 16, 16, 3)).astype(np.float32)
    y = np.eye(8, dtype=np.float32)[rng.integers(0, 8, B)]
    return x0, y


def _assert_tree_close(out, ref, **tol):
    lo, lr = jax.tree.leaves(out), jax.tree.leaves(ref)
    assert len(lo) == len(lr)
    for a, b in zip(lo, lr):
        np.testing.assert_allclose(a, np.asarray(b, np.float32), **tol)


def _assert_scaled_close(out, ref, rtol):
    """Each leaf within ``rtol`` of its own scale: max |a − b| ≤ rtol ·
    max |b| (a leaf that is zero in ``ref`` must be zero)."""
    for a, b in zip(jax.tree.leaves(out), jax.tree.leaves(ref), strict=True):
        b = np.asarray(b, np.float64)
        assert np.abs(np.asarray(a, np.float64) - b).max() <= \
            rtol * np.abs(b).max()


def _loss_inputs(seed=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, 16, 16, 3)).astype(np.float32)
    t = np.array([1, 17, 60, 100], np.int32)
    y = np.eye(8, dtype=np.float32)[rng.integers(0, 8, B)]
    eps = rng.standard_normal((B, 16, 16, 3)).astype(np.float32)
    return x, t, y, eps


@pytest.mark.parametrize("weights", [None, [1.0, 1.0, 0.0, 1.0]])
def test_loss_and_grads_match_jax_value_and_grad(weights):
    x, t, y, eps = _loss_inputs()
    w = None if weights is None else np.asarray(weights, np.float32)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jprotocol.mse_eps_loss(
            _japply, p, *map(jnp.asarray, (x, t, y, eps)),
            weights=None if w is None else jnp.asarray(w))))(_jax_params(0))
    model = _model(0)
    loss = protocol.mse_eps_loss(
        unet_apply, model, *map(torch.from_numpy, (x, t, y, eps)),
        weights=None if w is None else torch.from_numpy(w))
    grads = protocol._grads(loss, model)
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    _assert_tree_close(bridge.dump_params(model, _jax_params(0), grads),
                       jgrads, **TOL)


def test_masked_loss_zero_weight_rows_get_no_gradient():
    x, t, y, eps = map(torch.from_numpy, _loss_inputs())
    model = _model(0)
    ones = protocol.mse_eps_loss(unet_apply, model, x, t, y, eps,
                                 weights=torch.ones(B))
    plain = protocol.mse_eps_loss(unet_apply, model, x, t, y, eps)
    torch.testing.assert_close(ones, plain, rtol=1e-6, atol=0)
    w = torch.tensor([1.0, 0.0, 1.0, 0.0])
    masked = protocol.mse_eps_loss(unet_apply, model, x, t, y, eps,
                                   weights=w)
    kept = protocol.mse_eps_loss(unet_apply, model, x[::2], t[::2], y[::2],
                                 eps[::2])
    torch.testing.assert_close(masked, kept, rtol=1e-6, atol=0)
    # the padded rows' inputs do not reach the gradient
    x2 = x.clone()
    x2[1::2] = 100.0
    g1 = protocol._grads(masked, model)
    g2 = protocol._grads(protocol.mse_eps_loss(
        unet_apply, model, x2, t, y, eps, weights=w), model)
    for n in g1:
        torch.testing.assert_close(g1[n], g2[n], rtol=1e-5, atol=1e-7)
    # all-zero weights: a zero loss and zero gradients
    zero = protocol.mse_eps_loss(unet_apply, model, x, t, y, eps,
                                 weights=torch.zeros(B))
    assert zero.item() == 0.0
    assert all(not g.any() for g in protocol._grads(zero, model).values())


@pytest.mark.parametrize("t_cut", [0, 30, T])
def test_collab_step_matches_jax(t_cut):
    """One Alg.-1 step: client and server updates from JAX-initialised
    models and fresh AdamW states, the same key and batch."""
    x0, y = _batch()
    opt = dict(lr=1e-3)
    jstep = jax.jit(jprotocol.make_collab_step(
        JSched.linear(T), JCut(T, t_cut), _japply, jadamw.AdamWConfig(**opt)))
    jc, js = _jax_params(1), _jax_params(2)
    jout = jstep(jc, jadamw.init_opt_state(jc), js,
                 jadamw.init_opt_state(js), jnp.asarray(x0), jnp.asarray(y),
                 jax.random.PRNGKey(7))
    cm, sm = _model(1), _model(2)
    copt, sopt = adamw.init_opt_state(cm), adamw.init_opt_state(sm)
    step = protocol.make_collab_step(DiffusionSchedule.linear(T),
                                     CutPoint(T, t_cut), unet_apply,
                                     adamw.AdamWConfig(**opt))
    out = step(cm, copt, sm, sopt, torch.from_numpy(x0), torch.from_numpy(y),
               prng.PRNGKey(7))
    assert out[0] is cm and out[2] is sm          # updated in place
    for model, port_opt, jp, jopt, seed in ((cm, copt, jout[0], jout[1], 1),
                                            (sm, sopt, jout[2], jout[3], 2)):
        like = _jax_params(seed)
        _assert_tree_close(bridge.dump_params(model, like), jp, **TOL)
        for k in ("m", "v"):
            moment = bridge.dump_params(model, like, port_opt[k])
            _assert_tree_close(moment, jopt[k], **TOL)
            _assert_scaled_close(moment, jopt[k], MOMENT_RTOL)
        assert int(port_opt["step"]) == int(jopt["step"])
    # GM: the client is not updated; ICM: the server is not
    assert int(copt["step"]) == (0 if t_cut == 0 else 1)
    assert int(sopt["step"]) == (0 if t_cut == T else 1)
    jm, m = jout[4], out[4]
    assert set(m) == set(jm)
    for k in m:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), **TOL)


def test_server_backward_leaves_client_grads_untouched():
    x0, y = map(torch.from_numpy, _batch(1))
    cm, sm = _model(1), _model(2)
    sched, cut = DiffusionSchedule.linear(T), CutPoint(T, 30)
    loss_c, payload = protocol.client_losses(cm, x0, y, prng.PRNGKey(4),
                                             sched, cut, unet_apply)
    assert loss_c.requires_grad
    assert not any(t.requires_grad for t in payload)
    protocol.server_loss(sm, payload, sched, unet_apply).backward()
    assert all(p.grad is None for p in cm.parameters())
    assert all(p.grad is not None for p in sm.parameters())


def test_opt_state_bridge_round_trip_is_bitwise():
    """A JAX AdamW state after one update → the port's → JAX's layout."""
    jp = _jax_params(0)
    grads = jax.tree.map(lambda a: np.asarray(a) * 0.5 + 0.01, jp)
    update = jax.jit(functools.partial(jadamw.adamw_update,
                                       cfg=jadamw.AdamWConfig()))
    _, jstate, _ = update(jp, grads, jadamw.init_opt_state(jp))
    jstate = jax.tree.map(np.asarray, jstate)
    model = _model(0)
    state = bridge.load_opt_state(model, jstate)
    assert list(state["m"]) == [n for n, _ in model.named_parameters()]
    for n, p in model.named_parameters():
        assert state["m"][n].shape == p.shape
        assert state["v"][n].dtype == torch.float32
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 1
    back = bridge.dump_opt_state(model, state, jp)
    for k in ("m", "v"):
        for a, b in zip(jax.tree.leaves(back[k]), jax.tree.leaves(jstate[k])):
            np.testing.assert_array_equal(a, b)
    assert int(back["step"]) == int(jstate["step"])
    # and the port's own update continues from the bridged state as JAX's
    jp2, jstate2, _ = update(jp, grads, jstate)
    # the gradients in the port's layout, through the same transforms
    port_grads = bridge.load_opt_state(
        model, {"m": grads, "v": grads, "step": np.int32(0)})["m"]
    adamw.adamw_update(model, port_grads, state, adamw.AdamWConfig())
    _assert_tree_close(bridge.dump_params(model, jp), jp2, **TOL)
    _assert_tree_close(bridge.dump_params(model, jp, state["v"]),
                       jstate2["v"], **TOL)
