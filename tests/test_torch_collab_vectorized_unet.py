"""The port's vectorized round with the SMALL U-Net at 8×8 against the
JAX package's ``make_vectorized_round``.

Three clients, 2 batches of 4, one mode at each cut: masked at cut 0
(GM), identity-keyed at the mid cut (uids 4, 0, 9, as the training
runtime drives it) and dense at cut T (ICM); the masked rounds ragged
(one client with a short last batch, one without a second batch).  The weights are numpy
normals (std 0.05) in JAX's layout (``jax.eval_shape`` gives the tree),
bridged into the port's modules.  Params, both moments and the step
counters within TOL (atol 2e-5, rtol 2e-3, the reference's fp32
tolerance), each moment leaf also within MOMENT_RTOL (TOL's rtol) of its
own largest value, the metrics within TOL.  One JAX compile a cut (the
cut is static): ~12–22 s each on one CPU.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import collab as jcollab
from repro.optim import adamw as jadamw
from repro_torch import bridge
from repro_torch.core import collab as tcollab
from repro_torch.core import prng
from repro_torch.optim import adamw

torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=2e-3)
MOMENT_RTOL = TOL["rtol"]
OPT = dict(lr=1e-3)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close_metrics(port, ref):
    assert set(port) == set(ref)
    for n in ref:
        np.testing.assert_allclose(port[n].numpy(), np.asarray(ref[n]),
                                   err_msg=n, **TOL)


KW = dict(n_clients=3, T=40, image_size=8, channels=3, n_classes=8,
          batch_size=4)


@functools.lru_cache(maxsize=None)
def _unet_weights():
    """Four SMALL U-Nets (server, three clients) in JAX's layout: numpy
    normals of the init's scale-free shape, std 0.05."""
    init_one, _ = jcollab.build_denoiser(None, jcollab.CollabConfig(**KW))
    like = jax.eval_shape(init_one, jax.random.PRNGKey(0))
    rng = np.random.default_rng(11)
    return [jax.tree.map(lambda s: (0.05 * rng.standard_normal(s.shape))
                         .astype(np.float32), like) for _ in range(4)]


def _port_model(params):
    cfg = tcollab.CollabConfig(**KW)
    init_one, _ = tcollab.build_denoiser(None, cfg, "cpu")
    model = init_one(prng.PRNGKey(0))
    return bridge.load_unet(model, params)


def _close_unet(model, values, like, ref, scaled=False):
    out = bridge.dump_params(model, like, values)
    for a, b in zip(jax.tree.leaves(out), jax.tree.leaves(ref), strict=True):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)
        if scaled:
            b = np.asarray(b, np.float64)
            assert np.abs(np.asarray(a, np.float64) - b).max() <= \
                MOMENT_RTOL * np.abs(b).max()


@pytest.mark.parametrize("t_cut,mode", [(0, "masked"), (20, "identity"),
                                         (40, "dense")])
def test_unet_round_matches_jax(t_cut, mode):
    rng = np.random.default_rng(3)
    xs = rng.uniform(-1, 1, (2, 3, 4, 8, 8, 3)).astype(np.float32)
    ys = np.eye(8, dtype=np.float32)[rng.integers(0, 8, (2, 3, 4))]
    mask = np.ones((2, 3, 4), np.float32)
    mask[1, 2] = 0.0
    mask[1, 1, 2:] = 0.0
    uids = np.array([4, 0, 9], np.int32)
    kw = dict(masked=mode != "dense", identity_keyed=mode == "identity")
    jargs, targs = [jnp.asarray(xs), jnp.asarray(ys)], \
        [torch.from_numpy(xs), torch.from_numpy(ys)]
    if mode != "dense":
        jargs.append(jnp.asarray(mask))
        targs.append(mask)
    if mode == "identity":
        jargs.append(jnp.asarray(uids))
        targs.append(uids)
    sp, *cps = _unet_weights()
    jcfg = jcollab.CollabConfig(t_cut=t_cut, **KW)
    _, japply = jcollab.build_denoiser(None, jcfg)
    jround = jcollab.make_vectorized_round(
        jcfg.sched(), jcfg.cut(), japply, jadamw.AdamWConfig(**OPT), **kw)
    jout = jround(jcollab.stack_clients(cps),
                  jcollab.stack_clients([jadamw.init_opt_state(p)
                                         for p in cps]),
                  sp, jadamw.init_opt_state(sp), *jargs,
                  jax.random.PRNGKey(5))
    jcp = bridge.unstack(_np(jout[0]))
    jco = [bridge.unstack(_np(jout[1][k])) for k in ("m", "v")]

    cfg = tcollab.CollabConfig(t_cut=t_cut, **KW)
    _, apply_fn = tcollab.build_denoiser(None, cfg, "cpu")
    models = [_port_model(p) for p in cps]
    opts = [adamw.init_opt_state(m) for m in models]
    server = _port_model(sp)
    sopt = adamw.init_opt_state(server)
    tround = tcollab.make_vectorized_round(
        cfg.sched("cpu"), cfg.cut(), apply_fn, adamw.AdamWConfig(**OPT),
        **kw)
    metrics = tround(models, opts, server, sopt, *targs,
                     prng.PRNGKey(5))[4]

    for c in range(3):
        _close_unet(models[c], None, cps[c], jcp[c])
        _close_unet(models[c], opts[c]["m"], cps[c], jco[0][c], True)
        _close_unet(models[c], opts[c]["v"], cps[c], jco[1][c], True)
        assert int(opts[c]["step"]) == int(jout[1]["step"][c])
    _close_unet(server, None, sp, _np(jout[2]))
    _close_unet(server, sopt["m"], sp, _np(jout[3]["m"]), True)
    _close_unet(server, sopt["v"], sp, _np(jout[3]["v"]), True)
    assert int(sopt["step"]) == int(jout[3]["step"])
    want_steps = [0, 0, 0] if t_cut == 0 else \
        [2, 2, 2] if mode == "dense" else [2, 2, 1]
    assert [int(o["step"]) for o in opts] == want_steps
    _close_metrics(metrics, jout[4])
