"""The port's vectorized round (core/collab.py ``make_vectorized_round``
and its helpers) against the JAX package's.

Inputs come from numpy seeds and go through both packages:

* the toy denoiser of the reference's runtime tests (ε̂ = a·x + b) in
  every mode — masked, dense, identity-keyed — at cuts 0 / mid / T
  (3 ragged clients: one with a short last batch, one without a second
  batch), within the reference's own oracle tolerance (atol 1e-7, rtol
  1e-6): params, both moments, step counters, losses; the grad norms
  within GRAD_NORM_ATOL (a toy's gradient is a sum of order-1 terms
  that cancels to ~0.1, so the few-ulp differences of the normal draw
  (erfinv) and of the summation order show there: 2.3e-7 seen at a norm
  of 0.082, dense round at the mid cut);
  (the SMALL U-Net's round is in test_torch_collab_vectorized_unet.py);
* ``stack_round_batches`` (mask bitwise, truncation warning),
  ``bucket_round_batches`` / ``padded_row_waste``,
  ``train_round_vectorized``'s metrics, the stacked view and its inverse;
* within the port: the engine against its plain oracle
  ``train_round_reference``; a cohort padded along the client axis to a
  tier bitwise equal to the unpadded one (the pad slots untouched).
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import collab as jcollab
from repro.core.schedules import DiffusionSchedule as JSched
from repro.core.splitting import CutPoint as JCut
from repro.optim import adamw as jadamw
from repro_torch.configs.ddpm_unet import SMALL
from repro_torch.core import collab as tcollab
from repro_torch.core import prng, trees
from repro_torch.core.schedules import DiffusionSchedule
from repro_torch.core.splitting import CutPoint
from repro_torch.core.unet import UNet
from repro_torch.optim import adamw

torch.set_num_threads(1)

ORACLE = dict(atol=1e-7, rtol=1e-6)
GRAD_NORM_ATOL = 1e-6
T = 60
OPT = dict(lr=1e-3)
KW = dict(n_clients=3, T=40, image_size=8, channels=3, n_classes=8,
          batch_size=4)


def tiny_apply(p, x, t, y):
    return x * p["a"] + p["b"]


def _toy_port(a, b):
    return {"a": torch.tensor(np.float32(a), requires_grad=True),
            "b": torch.tensor(np.float32(b), requires_grad=True)}


def _toy_jax(a, b):
    return {"a": jnp.float32(a), "b": jnp.float32(b)}


def _inputs(seed, nb=2, k=3, B=4, img=6, nc=4):
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(nb, k, B, img, img, 3)).astype(np.float32)
    ys = np.eye(nc, dtype=np.float32)[rng.integers(0, nc, (nb, k, B))]
    mask = np.ones((nb, k, B), np.float32)
    mask[1, k - 1] = 0.0                     # no second batch
    mask[1, 1, B // 2:] = 0.0                # a short last batch
    return xs, ys, mask


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close_tree(port, ref, **tol):
    for a, b in zip(trees.leaves(port), jax.tree.leaves(ref), strict=True):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **tol)


def _close_metrics(port, ref, **tol):
    """Every metric within ``tol``; the grad norms within GRAD_NORM_ATOL
    (rtol as ``tol``'s)."""
    assert set(port) == set(ref)
    for n in ref:
        t = dict(tol, atol=GRAD_NORM_ATOL) if n.endswith("grad_norm") \
            else tol
        np.testing.assert_allclose(port[n].numpy(), np.asarray(ref[n]),
                                   err_msg=n, **t)


@pytest.mark.parametrize("mode", ["masked", "dense", "identity"])
@pytest.mark.parametrize("t_cut", [0, 20, T])
def test_toy_round_matches_jax(mode, t_cut):
    xs, ys, mask = _inputs(0)
    if mode == "dense":
        mask = np.ones_like(mask)
    a0 = [0.4, 0.25, 0.55]
    uids = np.array([3, 0, 7], np.int32)
    kw = dict(masked=mode != "dense", identity_keyed=mode == "identity")
    jround = jcollab.make_vectorized_round(
        JSched.linear(T), JCut(T, t_cut), tiny_apply,
        jadamw.AdamWConfig(**OPT), **kw)
    jcp = jcollab.stack_clients([_toy_jax(a, 0.01 * i)
                                 for i, a in enumerate(a0)])
    jco = jcollab.stack_clients([jadamw.init_opt_state(_toy_jax(a, 0.0))
                                 for a in a0])
    jsp = _toy_jax(0.5, 0.0)
    jargs = [jnp.asarray(xs), jnp.asarray(ys)]
    targs = [torch.from_numpy(xs), torch.from_numpy(ys)]
    if mode != "dense":
        jargs.append(jnp.asarray(mask))
        targs.append(mask)
    if mode == "identity":
        jargs.append(jnp.asarray(uids))
        targs.append(uids)
    jout = jround(jcp, jco, jsp, jadamw.init_opt_state(jsp), *jargs,
                  jax.random.PRNGKey(5))

    tround = tcollab.make_vectorized_round(
        DiffusionSchedule.linear(T), CutPoint(T, t_cut), tiny_apply,
        adamw.AdamWConfig(**OPT), **kw)
    cp = [_toy_port(a, 0.01 * i) for i, a in enumerate(a0)]
    co = [adamw.init_opt_state(p) for p in cp]
    sp = _toy_port(0.5, 0.0)
    so = adamw.init_opt_state(sp)
    tout = tround(cp, co, sp, so, *targs, prng.PRNGKey(5))
    assert tout[0] is cp and tout[2] is sp       # updated in place
    jcp, jco = _np(jout[0]), _np(jout[1])
    for c in range(3):
        _close_tree(cp[c], {n: jcp[n][c] for n in ("a", "b")}, **ORACLE)
        for kind in ("m", "v"):
            _close_tree(co[c][kind], {n: jco[kind][n][c]
                                      for n in ("a", "b")}, **ORACLE)
        assert int(co[c]["step"]) == int(jout[1]["step"][c])
    _close_tree(sp, jout[2], **ORACLE)
    for kind in ("m", "v"):
        _close_tree(so[kind], jout[3][kind], **ORACLE)
    assert int(so["step"]) == int(jout[3]["step"])
    _close_metrics(tout[4], jout[4], **ORACLE)


# ---------------------------------------------------------------------------
# stacking helpers
# ---------------------------------------------------------------------------


def _ragged_batches(seed):
    rng = np.random.default_rng(seed)
    sizes = [[4, 4, 3], [4], [2, 4]]
    out = []
    for c, bs in enumerate(sizes):
        out.append([(rng.normal(size=(n, 6, 6, 3)).astype(np.float32),
                     np.eye(4, dtype=np.float32)[rng.integers(0, 4, n)])
                    for n in bs])
    return out


def test_stack_round_batches_matches_jax():
    raw = _ragged_batches(1)
    jx, jy, jm = jcollab.stack_round_batches(
        [[(jnp.asarray(x), jnp.asarray(y)) for x, y in bs] for bs in raw])
    tx, ty, tm = tcollab.stack_round_batches(
        [[(torch.from_numpy(x), torch.from_numpy(y)) for x, y in bs]
         for bs in raw])
    assert isinstance(tm, np.ndarray)
    np.testing.assert_array_equal(tm, np.asarray(jm))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    assert tcollab.stack_round_batches([[], []]) == (None, None, None)
    # the dense layout truncates to the shortest client, and says so
    dense = [[(torch.zeros(4, 2, 2, 3), torch.zeros(4, 4))] * n
             for n in (3, 1)]
    with pytest.warns(UserWarning, match="dropping 2 batch"):
        x, y = tcollab.stack_round_batches(dense, pad=False)
    assert tuple(x.shape) == (1, 2, 4, 2, 2, 3)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert tcollab.stack_round_batches([[], dense[0]],
                                           pad=False) == (None, None)


def test_bucket_round_batches_and_waste_match_jax():
    raw = _ragged_batches(2)
    jst = jcollab.bucket_round_batches(
        [[(jnp.asarray(x), jnp.asarray(y)) for x, y in bs] for bs in raw])
    tst = tcollab.bucket_round_batches(
        [[(torch.from_numpy(x), torch.from_numpy(y)) for x, y in bs]
         for bs in raw])
    assert len(tst) == len(jst)
    for (tx, ty, tm), (jx, jy, jm) in zip(tst, jst):
        np.testing.assert_array_equal(tm, np.asarray(jm))
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    assert tcollab.padded_row_waste(tst) == jcollab.padded_row_waste(jst)
    assert tcollab.padded_row_waste(tst[0]) == \
        jcollab.padded_row_waste(jst[0])
    assert tcollab.bucket_round_batches([[], []]) == []


def test_stacked_view_round_trips():
    models = [_toy_port(0.1 * i, 0.2) for i in range(3)]
    opts = [adamw.init_opt_state(m) for m in models]
    st = tcollab.stack_clients(models)
    assert st["a"].shape == (3,) and not st["a"].requires_grad
    back = tcollab.unstack_clients(st, 3)
    assert all(trees.equal(b, m) for b, m in zip(back, models))
    so = tcollab.stack_clients(opts)
    assert so["step"].shape == (3,) and so["m"]["a"].shape == (3,)
    unet = UNet(dataclasses.replace(SMALL, image_size=8, channels=3,
                                    n_classes=8))
    su = tcollab.stack_clients([unet, unet])
    name, p = next(iter(unet.named_parameters()))
    assert su[name].shape == (2,) + tuple(p.shape)
    state = tcollab.CollabState("s", {}, models, opts, step=3)
    v = tcollab.to_vectorized(state)
    assert v.n_clients == 3 and v.client_params[0] is models[0]
    s2 = tcollab.to_sequential(v)
    assert s2.client_opt[2] is opts[2] and s2.step == 3


def test_train_round_vectorized_matches_jax():
    xs, ys, mask = _inputs(4)
    a0 = [0.3, 0.45, 0.2]
    jst = jcollab.VectorizedCollabState(
        server_params=_toy_jax(0.5, 0.0),
        server_opt=jadamw.init_opt_state(_toy_jax(0.5, 0.0)),
        client_params=jcollab.stack_clients([_toy_jax(a, 0) for a in a0]),
        client_opt=jcollab.stack_clients(
            [jadamw.init_opt_state(_toy_jax(a, 0)) for a in a0]))
    jround = jcollab.make_vectorized_round(
        JSched.linear(T), JCut(T, 20), tiny_apply, jadamw.AdamWConfig(**OPT))
    jlast = jcollab.train_round_vectorized(
        jst, jround, jnp.asarray(xs), jnp.asarray(ys), jax.random.PRNGKey(8),
        mask=jnp.asarray(mask))
    models = [_toy_port(a, 0) for a in a0]
    tst = tcollab.VectorizedCollabState(
        server_params=_toy_port(0.5, 0.0),
        server_opt=adamw.init_opt_state(_toy_port(0.5, 0.0)),
        client_params=models,
        client_opt=[adamw.init_opt_state(m) for m in models])
    tround = tcollab.make_vectorized_round(
        DiffusionSchedule.linear(T), CutPoint(T, 20), tiny_apply,
        adamw.AdamWConfig(**OPT))
    tlast = tcollab.train_round_vectorized(
        tst, tround, torch.from_numpy(xs), torch.from_numpy(ys),
        prng.PRNGKey(8), mask=mask)
    assert tst.step == jst.step == 5
    assert set(tlast) == set(jlast)
    for c in tlast:
        assert set(tlast[c]) == set(jlast[c])
        for k, v in tlast[c].items():
            assert isinstance(v, float)
            np.testing.assert_allclose(v, jlast[c][k], **ORACLE)
    assert tcollab.train_round_vectorized(tst, tround, None, None,
                                          prng.PRNGKey(0)) == {}


# ---------------------------------------------------------------------------
# within the port
# ---------------------------------------------------------------------------


def _toy_state(a0):
    models = [_toy_port(a, 0.01) for a in a0]
    return tcollab.CollabState(
        server_params=_toy_port(0.5, 0.0),
        server_opt=adamw.init_opt_state(_toy_port(0.5, 0.0)),
        client_params=models,
        client_opt=[adamw.init_opt_state(m) for m in models])


def test_engine_matches_its_plain_oracle():
    """The engine (inactive cells skipped, only rows of weight > 0 in the
    server batch) against ``train_round_reference`` (every slot computed,
    every row in the server batch at its weight), identity-keyed."""
    xs, ys, mask = _inputs(6)
    uids = np.array([2, 0, 5], np.int32)
    sched, cut = DiffusionSchedule.linear(T), CutPoint(T, 20)
    cfg = adamw.AdamWConfig(**OPT)
    eng = _toy_state([0.4, 0.3, 0.2])
    ref = _toy_state([0.4, 0.3, 0.2])
    tcollab.make_vectorized_round(sched, cut, tiny_apply, cfg,
                                  identity_keyed=True)(
        eng.client_params, eng.client_opt, eng.server_params,
        eng.server_opt, torch.from_numpy(xs), torch.from_numpy(ys), mask,
        uids, prng.PRNGKey(1))
    tcollab.train_round_reference(ref, torch.from_numpy(xs),
                                  torch.from_numpy(ys), prng.PRNGKey(1),
                                  sched, cut, tiny_apply, cfg, mask=mask,
                                  uids=uids)
    assert ref.step == 5
    for a, b in ((eng.client_params, ref.client_params),
                 (eng.client_opt, ref.client_opt),
                 (eng.server_params, ref.server_params),
                 (eng.server_opt, ref.server_opt)):
        for x, y in zip(trees.leaves(a), trees.leaves(b), strict=True):
            np.testing.assert_allclose(x.detach().numpy(),
                                       y.detach().numpy(), **ORACLE)


def test_identity_keyed_requires_mask():
    with pytest.raises(ValueError, match="identity_keyed"):
        tcollab.make_vectorized_round(DiffusionSchedule.linear(T),
                                      CutPoint(T, 20), tiny_apply,
                                      adamw.AdamWConfig(), masked=False,
                                      identity_keyed=True)


@pytest.mark.parametrize("tier", [4, 8])
def test_tier_padding_is_bitwise(tier):
    """A cohort of 3 seated in a tier-4 (tier-8) stack with all-masked pad
    slots: params, moments, step counters and metrics of the real slots
    and the server bitwise equal to the unpadded round; the pad slots'
    model and state (member 0's objects, as the runtime seats them) are
    untouched."""
    xs, ys, mask = _inputs(9)
    uids = np.array([3, 1, 6], np.int32)
    sched, cut = DiffusionSchedule.linear(T), CutPoint(T, 20)
    rnd = tcollab.make_vectorized_round(sched, cut, tiny_apply,
                                        adamw.AdamWConfig(**OPT),
                                        identity_keyed=True)
    base = _toy_state([0.4, 0.3, 0.2])
    mb = rnd(base.client_params, base.client_opt, base.server_params,
             base.server_opt, torch.from_numpy(xs), torch.from_numpy(ys),
             mask, uids, prng.PRNGKey(4))[4]
    padded = _toy_state([0.4, 0.3, 0.2])
    pad = tier - 3
    nb, _, B = mask.shape
    xsP = np.concatenate([xs, np.zeros((nb, pad) + xs.shape[2:],
                                       np.float32)], 1)
    ysP = np.concatenate([ys, np.zeros((nb, pad) + ys.shape[2:],
                                       np.float32)], 1)
    maskP = np.concatenate([mask, np.zeros((nb, pad, B), np.float32)], 1)
    uidsP = np.array(list(uids) + [uids[0]] * pad, np.int32)
    spare = _toy_port(0.4, 0.01)
    spare_opt = adamw.init_opt_state(spare)
    frozen = trees.copy(spare), trees.copy(spare_opt)
    mp = rnd(padded.client_params + [spare] * pad,
             padded.client_opt + [spare_opt] * pad, padded.server_params,
             padded.server_opt, torch.from_numpy(xsP),
             torch.from_numpy(ysP), maskP, uidsP, prng.PRNGKey(4))[4]
    for a, b in ((padded.client_params, base.client_params),
                 (padded.client_opt, base.client_opt),
                 (padded.server_params, base.server_params),
                 (padded.server_opt, base.server_opt)):
        assert trees.equal(a, b)
    assert torch.equal(mp["client_loss"][:, :3], mb["client_loss"])
    assert not mp["client_loss"][:, 3:].any()
    for n in ("server_loss", "server_grad_norm"):
        assert torch.equal(mp[n], mb[n])
    assert trees.equal(spare, frozen[0]) and \
        trees.equal(spare_opt, frozen[1])


def test_setup_vectorized_draws_the_sequential_weights():
    cfg = tcollab.CollabConfig(t_cut=20, **KW)
    seq, _, _ = tcollab.setup(prng.PRNGKey(0), cfg, device="cpu")
    vec, round_fn, _ = tcollab.setup_vectorized(prng.PRNGKey(0), cfg,
                                                device="cpu")
    assert vec.n_clients == 3 and callable(round_fn)
    assert trees.equal(vec.server_params, seq.server_params)
    for a, b in zip(vec.client_params, seq.client_params):
        assert trees.equal(a, b)
