"""One Alg.-1 step with a DiT denoiser on the CPU: the reduced Zamba2
hybrid (Mamba2 layers through the SSD scan's plain version, the shared
attention block through flash attention's) against the JAX package's.

This shows that the plain versions are differentiable end to end (on the
card the same step runs through the kernels' autograd routes, flash
attention's and the SSD scan's backward kernels).
Parameters come from JAX's ``init_dit`` through ``bridge.load_dit``;
compared in JAX's layout (layer stacks restacked by ``bridge.dump_params``)
at the tolerance ``tests/test_torch_dit.py`` holds the forward to (FWD:
atol 1e-4 / rtol 1e-3, float32, other summation orders):

* the loss and its gradients against ``jax.value_and_grad`` on the same
  (x_t, t, y, ε);
* params, both moments and the metrics after one ``make_collab_step``
  (cut 10 of T = 40: both models trained), whose noise differs from
  JAX's by erfinv ulps (≤ 5e-5); each moment leaf also within FWD's
  rtol of its own largest value (measured ≤ 5e-6 of it), since FWD's
  atol exceeds every moment;
* the optimizer-state bridge unstacks the DiT's layer axis and back,
  bitwise.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import collab as jcollab
from repro.core import protocol as jprotocol
from repro.optim import adamw as jadamw
from repro_torch import bridge
from repro_torch.configs.base import get_arch, reduced
from repro_torch.core import collab as tcollab
from repro_torch.core import dit as tdit
from repro_torch.core import prng, protocol
from repro_torch.optim import adamw

torch.set_num_threads(1)

FWD = dict(atol=1e-4, rtol=1e-3)
NAME = "zamba2-1.2b"
KW = dict(n_clients=1, T=40, t_cut=10, denoiser=NAME, image_size=16,
          channels=3, n_classes=8, batch_size=2, dit_patch=2)


@functools.lru_cache(maxsize=None)
def _jax(seed: int):
    init_one, apply_fn = jcollab.build_denoiser(None,
                                                jcollab.CollabConfig(**KW))
    return jax.tree.map(np.asarray, jax.jit(init_one)(
        jax.random.PRNGKey(seed))), apply_fn


def _port(seed: int) -> tdit.DiT:
    model = tdit.DiT(reduced(get_arch(NAME)), tdit.DiTConfig(
        image_size=16, channels=3, patch_size=2, n_classes=8))
    return bridge.load_dit(model, _jax(seed)[0])


def _apply():
    return tcollab.build_denoiser(None, tcollab.CollabConfig(**KW),
                                  device="cpu")[1]


def _close(out, ref, scaled=False, **tol):
    """Within ``tol`` elementwise; with ``scaled`` (the moments, far below
    FWD's atol) each leaf also within FWD's rtol of its largest value."""
    lo, lr = jax.tree.leaves(out), jax.tree.leaves(ref)
    assert len(lo) == len(lr)
    for a, b in zip(lo, lr):
        np.testing.assert_allclose(a, np.asarray(b, np.float32), **tol)
        if scaled:
            b = np.asarray(b, np.float64)
            assert np.abs(np.asarray(a, np.float64) - b).max() <= \
                FWD["rtol"] * np.abs(b).max()


def test_dit_loss_and_grads_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    t = np.array([3, 31], np.int32)
    y = np.eye(8, dtype=np.float32)[[2, 5]]
    eps = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    jp, japply = _jax(0)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jprotocol.mse_eps_loss(japply, p, *map(
            jnp.asarray, (x, t, y, eps)))))(jp)
    model = _port(0)
    loss = protocol.mse_eps_loss(_apply(), model,
                                 *map(torch.from_numpy, (x, t, y, eps)))
    np.testing.assert_allclose(loss.item(), float(jloss), **FWD)
    grads = protocol._grads(loss, model)
    assert all(g.abs().sum() > 0 for g in grads.values())
    _close(bridge.dump_params(model, jp, grads), jgrads, **FWD)


def test_dit_collab_step_matches_jax():
    rng = np.random.default_rng(1)
    x0 = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    y = np.eye(8, dtype=np.float32)[[0, 7]]
    jcfg = jcollab.CollabConfig(**KW)
    (jc, japply), (js, _) = _jax(1), _jax(2)
    jstep = jax.jit(jprotocol.make_collab_step(
        jcfg.sched(), jcfg.cut(), japply, jadamw.AdamWConfig(lr=1e-3)))
    jout = jstep(jc, jadamw.init_opt_state(jc), js, jadamw.init_opt_state(js),
                 jnp.asarray(x0), jnp.asarray(y), jax.random.PRNGKey(3))
    cfg = tcollab.CollabConfig(**KW)
    cm, sm = _port(1), _port(2)
    copt, sopt = adamw.init_opt_state(cm), adamw.init_opt_state(sm)
    step = protocol.make_collab_step(cfg.sched("cpu"), cfg.cut(), _apply(),
                                     adamw.AdamWConfig(lr=1e-3))
    _, _, _, _, m = step(cm, copt, sm, sopt, torch.from_numpy(x0),
                         torch.from_numpy(y), prng.PRNGKey(3))
    for model, opt, jp, jopt, seed in ((cm, copt, jout[0], jout[1], 1),
                                       (sm, sopt, jout[2], jout[3], 2)):
        like = _jax(seed)[0]
        _close(bridge.dump_params(model, like), jp, **FWD)
        for k in ("m", "v"):
            _close(bridge.dump_params(model, like, opt[k]), jopt[k],
                   scaled=True, **FWD)
        assert int(opt["step"]) == int(jopt["step"]) == 1
    for k, v in jout[4].items():
        np.testing.assert_allclose(float(m[k]), float(v), **FWD)


def test_dit_opt_state_bridge_round_trip_is_bitwise():
    jp = _jax(0)[0]
    rng = np.random.default_rng(2)
    state = {"m": jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32), jp), "v": jax.tree.map(
        lambda a: rng.uniform(0, 1, a.shape).astype(np.float32), jp),
        "step": np.int32(7)}
    model = _port(0)
    port = bridge.load_opt_state(model, state)
    names = [n for n, _ in model.named_parameters()]
    assert list(port["m"]) == names and int(port["step"]) == 7
    assert any(n.startswith("mamba.1.") for n in names)   # unstacked
    back = bridge.dump_opt_state(model, port, jp)
    for k in ("m", "v"):
        for a, b in zip(jax.tree.leaves(back[k]), jax.tree.leaves(state[k])):
            np.testing.assert_array_equal(a, b)
