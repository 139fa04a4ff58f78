"""The port's training round (core/collab.py ``setup`` + ``train_round``,
paper Alg. 1's outer loops) against the JAX package's.

Three clients (the third with no batches this round) and the SMALL U-Net
resized to 8×8 images; the other two clients take 2 batches of 4 from
the JAX package's non-IID synthetic data.  ``setup`` draws the same
weights as JAX's key order gives (within INIT_ATOL: ``normal``'s erfinv);
both rounds then start from JAX's weights (bridged) with fresh AdamW
states and the same key, at cuts 0 (GM), mid and T (ICM):

* params, both AdamW moments and every step counter within TOL (atol
  2e-5, rtol 2e-3, the reference's fp32 tolerance; the step's noise
  differs from JAX's by ≤ 5e-5, erfinv ulps); each moment leaf also
  within MOMENT_RTOL (TOL's rtol) of its own largest value, since TOL's
  atol exceeds every moment;
* the returned metrics within TOL, ``{}`` for the client without batches,
  whose model and state stay untouched, and ``state.step`` counts steps;
* ``sample_for_client`` on the trained state equals the sample from the
  same models in a state without optimizers, bitwise.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import collab as jcollab
from repro.core import protocol as jprotocol
from repro.data import synthetic as jsyn
from repro.optim import adamw as jadamw
from repro_torch import bridge
from repro_torch.core import collab as tcollab
from repro_torch.core import prng

torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=2e-3)
# each moment leaf against its own largest value (JAX vs the port after
# the round: ≤ 2.2e-4 of it)
MOMENT_RTOL = TOL["rtol"]
INIT_ATOL = 5e-5
KW = dict(n_clients=3, T=40, image_size=8, channels=3, n_classes=8,
          batch_size=4)


@functools.lru_cache(maxsize=None)
def _jax_models():
    """The JAX package's ``setup`` weights (server, then clients) for
    PRNGKey(0), its key order, each model drawn by a jitted init."""
    init_one, _ = jcollab.build_denoiser(None, jcollab.CollabConfig(**KW))
    keys = jax.random.split(jax.random.PRNGKey(0), KW["n_clients"] + 1)
    init = jax.jit(init_one)
    return [jax.tree.map(np.asarray, init(k)) for k in keys]


@functools.lru_cache(maxsize=None)
def _jax_batches():
    data = jsyn.make_client_datasets(jax.random.PRNGKey(1),
                                     jsyn.SyntheticConfig(image_size=8), 2, 8)
    out = [[(np.array(x), np.array(y)) for x, y in
            jsyn.batches(x, y, 4, jax.random.fold_in(jax.random.PRNGKey(2),
                                                     c))]
           for c, (x, y) in enumerate(data)]
    return out + [[]]                   # the third client: no batches


def _jax_round(t_cut: int):
    jcfg = jcollab.CollabConfig(t_cut=t_cut, **KW)
    _, japply = jcollab.build_denoiser(None, jcfg)
    sp, *cps = _jax_models()
    state = jcollab.CollabState(
        server_params=sp, server_opt=jadamw.init_opt_state(sp),
        client_params=list(cps),
        client_opt=[jadamw.init_opt_state(p) for p in cps])
    step = jax.jit(jprotocol.make_collab_step(
        jcfg.sched(), jcfg.cut(), japply, jadamw.AdamWConfig(lr=jcfg.lr)))
    batches = [[(jnp.asarray(x), jnp.asarray(y)) for x, y in b]
               for b in _jax_batches()]
    last = jcollab.train_round(state, step, batches, jax.random.PRNGKey(5))
    return state, last


def _close(model, values, like, ref, scaled=False):
    """Within TOL elementwise; with ``scaled`` (the moments, far below
    TOL's atol) each leaf also within MOMENT_RTOL of its largest value."""
    out = bridge.dump_params(model, like, values)
    for a, b in zip(jax.tree.leaves(out), jax.tree.leaves(ref), strict=True):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)
        if scaled:
            b = np.asarray(b, np.float64)
            assert np.abs(np.asarray(a, np.float64) - b).max() <= \
                MOMENT_RTOL * np.abs(b).max()


def test_setup_draws_the_jax_weights_in_its_key_order():
    state, _, _ = tcollab.setup(prng.PRNGKey(0),
                                tcollab.CollabConfig(t_cut=10, **KW),
                                device="cpu")
    models = [state.server_params] + state.client_params
    for model, ref in zip(models, _jax_models(), strict=True):
        out = bridge.dump_params(model, ref)
        for a, b in zip(jax.tree.leaves(out), jax.tree.leaves(ref)):
            np.testing.assert_allclose(a, b, rtol=0, atol=INIT_ATOL)
    for model, opt in zip(models, [state.server_opt] + state.client_opt):
        assert list(opt["m"]) == [n for n, _ in model.named_parameters()]
        assert int(opt["step"]) == 0
    assert state.step == 0


@pytest.mark.parametrize("t_cut", [0, 10, 40])
def test_train_round_matches_jax(t_cut):
    jstate, jlast = _jax_round(t_cut)
    cfg = tcollab.CollabConfig(t_cut=t_cut, **KW)
    state, step, apply_fn = tcollab.setup(prng.PRNGKey(0), cfg, device="cpu")
    models = [state.server_params] + state.client_params
    for model, params in zip(models, _jax_models()):
        bridge.load_unet(model, params)
    untouched = {n: p.detach().clone()
                 for n, p in state.client_params[2].named_parameters()}
    batches = [[(torch.from_numpy(x), torch.from_numpy(y)) for x, y in b]
               for b in _jax_batches()]
    last = tcollab.train_round(state, step, batches, prng.PRNGKey(5))

    assert state.step == jstate.step == 4
    pairs = [(state.server_params, state.server_opt, jstate.server_params,
              jstate.server_opt, _jax_models()[0])] + [
        (state.client_params[c], state.client_opt[c],
         jstate.client_params[c], jstate.client_opt[c], _jax_models()[c + 1])
        for c in range(3)]
    for model, opt, jp, jopt, like in pairs:
        _close(model, None, like, jp)
        _close(model, opt["m"], like, jopt["m"], scaled=True)
        _close(model, opt["v"], like, jopt["v"], scaled=True)
        assert int(opt["step"]) == int(jopt["step"])
    assert int(state.server_opt["step"]) == (0 if t_cut == 40 else 4)
    assert int(state.client_opt[0]["step"]) == (0 if t_cut == 0 else 2)
    assert last[2] == jlast[2] == {}
    assert int(state.client_opt[2]["step"]) == 0
    for n, p in state.client_params[2].named_parameters():
        assert torch.equal(p, untouched[n])
    for c in (0, 1):
        assert set(last[c]) == set(jlast[c])
        for k, v in last[c].items():
            assert isinstance(v, float)
            np.testing.assert_allclose(v, jlast[c][k], **TOL)

    # Alg. 2 on the trained state: the optimizers play no part
    y = torch.from_numpy(np.eye(8, dtype=np.float32)[[1, 4]])
    with torch.no_grad():
        out = tcollab.sample_for_client(state, 1, prng.PRNGKey(9), y, cfg,
                                        apply_fn)
        ref = tcollab.sample_for_client(
            tcollab.CollabState(state.server_params, None,
                                state.client_params, None),
            1, prng.PRNGKey(9), y, cfg, apply_fn)
    assert out.shape == (2, 8, 8, 3) and torch.isfinite(out).all()
    assert torch.equal(out, ref)


def test_setup_without_device_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcollab.setup(prng.PRNGKey(0), tcollab.CollabConfig(**KW))


def test_collab_state_keeps_its_sampling_form():
    """The reference's fields in its order; a state of models alone (the
    serving slice's form) builds with ``None`` optimizer states, and
    ``train_round`` refuses it."""
    st = tcollab.CollabState("server", None, ["c0", "c1"], None)
    assert st.step == 0
    assert [f.name for f in dataclasses.fields(st)] == [
        f.name for f in dataclasses.fields(jcollab.CollabState)]
    with pytest.raises(ValueError, match="no optimizer states"):
        tcollab.train_round(st, None, [[], []], prng.PRNGKey(0))
