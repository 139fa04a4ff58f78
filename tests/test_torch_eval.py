"""The port's evaluation (``repro_torch.eval``) against the JAX package's
``repro.eval`` on the CPU, both sides given the same numpy inputs (made
from a seed) and, where a net is trained or applied, the same weights
(``bridge.load_params`` of the JAX draw).

Tolerances:
* INIT_ATOL: the port's own draw of a net against JAX's (``normal``'s
  erfinv ulps; weights are below 1).
* TOL (atol 2e-5 / rtol 2e-3, tests/test_kernels.py): features, the
  classifier after 20 steps, the reconstructor's step 1 wherever JAX's
  gradient is not at Adam's eps scale.
* FD_TOL (atol 1e-4 / rtol 1e-4): ``frechet_distance`` on the same
  features.  Full-rank covariances (N > D) give ~1e-6 relative; with
  N < D the product C1·C2 is singular and the clipped near-zero
  eigenvalues enter through their square roots (sqrt(1e-9) = 3e-5), so
  the port's own net and those sets are held to FD_RANK_TOL (atol 1e-3).
* The inverter: an element of the reconstructor's gradient near Adam's
  eps (1e-8; c3 has two at 5e-9 at the first step) takes an update of
  lr·g/(|g| + eps), which float32 summation order moves by a fraction of
  lr = 3e-3, and the next steps carry it on.  After 20 steps the weights
  are held to INV_ATOL (1.2e-3 measured) and the reconstructions to
  INV_OUT_ATOL (0.012 measured on outputs of 0.68); the full 400-step
  attack's metrics to ATTACK (rtol 5%, atol 2e-3; measured ≤ 2% on the
  MSEs, 4e-4 on the FDs).
* Attribute inference in full: F1 equal (no held-out prediction flips),
  the held-out logits within LOGIT_ATOL.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sampler as jsampler
from repro.data.synthetic import SyntheticConfig as JaxSynth
from repro.data.synthetic import make_dataset as jax_make_dataset
from repro.eval import attr_inference as jai
from repro.eval import fd_proxy as jfd
from repro.eval import inversion as jinv
from repro_torch import bridge
from repro_torch.core import prng
from repro_torch.core import sampler as tsampler
from repro_torch.core.schedules import DiffusionSchedule
from repro_torch.core.splitting import CutPoint
from repro_torch.data.synthetic import SyntheticConfig, make_dataset
from repro_torch.eval import attr_inference as tai
from repro_torch.eval import convnet as tconv
from repro_torch.eval import fd_proxy as tfd
from repro_torch.eval import inversion as tinv

torch.set_num_threads(1)

INIT_ATOL = 5e-5
TOL = dict(atol=2e-5, rtol=2e-3)
FD_TOL = dict(atol=1e-4, rtol=1e-4)
FD_RANK_TOL = dict(atol=1e-3, rtol=1e-4)
INV_ATOL = 3e-3
INV_OUT_ATOL = 0.03
ATTACK = dict(rtol=0.05, atol=2e-3)
LOGIT_ATOL = 1e-3
ADAM_EPS_SCALE = 1e-6
LR = 3e-3


def _np(a):
    return np.asarray(a)


def _images(seed, n, hw=8, c=3, normal=False):
    rng = np.random.default_rng(seed)
    if normal:
        return rng.normal(size=(n, hw, hw, c)).astype(np.float32)
    return rng.uniform(-1, 1, (n, hw, hw, c)).astype(np.float32)


def _labels(seed, n, a=4):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(n, a)) < 0.5).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _oihw(a):
    a = np.asarray(a)
    return a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T


def _feature_net():
    net = tfd.FeatureNet(3)
    return bridge.load_params(net, tuple(_np(w) for w in
                                         jfd._feature_params(3)))


# ---------------------------------------------------------------------------
# FD proxy
# ---------------------------------------------------------------------------


def test_feature_params_match_jax_draw():
    own = tfd.init_feature_net(3)
    for w, c in zip(jfd._feature_params(3), own):
        np.testing.assert_allclose(c.weight.numpy(), _oihw(w),
                                   atol=INIT_ATOL, rtol=0)
    assert [c.stride[0] for c in own] == [2, 2, 1]
    assert not any(p.requires_grad for p in own.parameters())


def test_feature_net_is_cached_per_channels_and_device():
    a = tfd._feature_params(3, "cpu")
    assert tfd._feature_params(3, torch.device("cpu")) is a
    assert tfd._feature_params(1, "cpu") is not a
    assert tfd._feature_params(1, "cpu")[0].in_channels == 1


@pytest.mark.parametrize("hw", [8, 16, 9])
def test_features_match_jax(hw):
    """Bridged weights, the same images: the stride-2 SAME convs pad the
    odd row/column at the end as XLA does (hw 9: an odd size)."""
    x = _images(hw, 6, hw)
    ref = jfd.features(jnp.asarray(x))
    with torch.no_grad():
        out = tfd.apply_features(_feature_net(), _t(x))
    assert out.shape == (6, tfd.FEATURE_DIM)
    np.testing.assert_allclose(out.numpy(), _np(ref), **TOL)


@pytest.mark.parametrize("n_a,n_b", [(96, 80), (40, 24)])
def test_frechet_distance_matches_jax(n_a, n_b):
    rng = np.random.default_rng(n_a)
    fa = rng.normal(size=(n_a, 64)).astype(np.float32)
    fb = (rng.normal(size=(n_b, 64)) * 1.3 + 0.2).astype(np.float32)
    ref = jfd.frechet_distance(jnp.asarray(fa), jnp.asarray(fb))
    out = tfd.frechet_distance(_t(fa), _t(fb))
    tol = FD_TOL if n_a > 64 and n_b > 64 else FD_RANK_TOL
    assert out == pytest.approx(ref, abs=tol["atol"], rel=tol["rtol"])


def test_fd_proxy_matches_jax_with_its_own_net():
    x, z = _images(0, 40), _images(1, 40, normal=True)
    for a, b in ((x, z), (x[:20], x[20:])):
        ref = jfd.fd_proxy(jnp.asarray(a), jnp.asarray(b))
        out = tfd.fd_proxy(_t(a), _t(b))
        assert out == pytest.approx(ref, abs=FD_RANK_TOL["atol"],
                                    rel=FD_RANK_TOL["rtol"])


# the reference's properties (tests/test_eval.py), on the port's data


def _port_data(seed, n, **kw):
    cfg = SyntheticConfig(image_size=16, **kw)
    return make_dataset(prng.PRNGKey(seed), n, cfg)


def test_fd_identity_near_zero():
    x, _ = _port_data(0, 256)
    assert tfd.fd_proxy(x[:128], x[128:]) < 0.1


def test_fd_separates_distributions():
    x, _ = _port_data(0, 128)
    noise = prng.normal(prng.PRNGKey(0), tuple(x.shape))
    assert tfd.fd_proxy(x, noise) > 10 * tfd.fd_proxy(x[:64], x[64:])


def test_fd_symmetricish():
    x, _ = _port_data(0, 96)
    z, _ = make_dataset(prng.fold_in(prng.PRNGKey(0), 7), 96,
                        SyntheticConfig(image_size=16, attr_prob=0.9))
    assert tfd.fd_proxy(x, z) == pytest.approx(tfd.fd_proxy(z, x),
                                               rel=1e-2, abs=1e-4)


def test_features_deterministic():
    x = prng.normal(prng.PRNGKey(0), (4, 16, 16, 3))
    assert torch.equal(tfd.features(x), tfd.features(x))


def test_port_data_scores_as_jax_data():
    """The same synthetic set (port vs JAX draw, within the erfinv ulps)
    scores the same FD proxy."""
    xj, _ = jax_make_dataset(jax.random.PRNGKey(0), 96,
                             JaxSynth(image_size=16))
    xt, _ = _port_data(0, 96)
    np.testing.assert_allclose(xt.numpy(), _np(xj), atol=1e-4)
    ref = jfd.fd_proxy(xj[:48], xj[48:])
    assert tfd.fd_proxy(xt[:48], xt[48:]) == pytest.approx(
        ref, abs=FD_RANK_TOL["atol"], rel=1e-3)


# ---------------------------------------------------------------------------
# Trainers
# ---------------------------------------------------------------------------


def test_batch_indices_are_jax_draws():
    key = jax.random.PRNGKey(5)
    idx = tconv.batch_indices(prng.PRNGKey(5), 7, 64, 40)
    assert idx.shape == (7, 40)
    for i in range(7):
        ref = jax.random.randint(jax.random.fold_in(key, i), (40,), 0, 40)
        np.testing.assert_array_equal(idx[i].numpy(), _np(ref))


def test_init_nets_match_jax_draws():
    k = jax.random.PRNGKey(3)
    rec = tinv._init_reconstructor(prng.PRNGKey(3), 3)
    for name, w in jinv._init_reconstructor(k, 3).items():
        np.testing.assert_allclose(getattr(rec, name).weight.detach().numpy(),
                                   _oihw(w), atol=INIT_ATOL, rtol=0)
    clf = tai._init_clf(prng.PRNGKey(3), 3, 4)
    for name, w in jai._init_clf(k, 3, 4).items():
        np.testing.assert_allclose(getattr(clf, name).weight.detach().numpy(),
                                   _oihw(w), atol=INIT_ATOL, rtol=0)


def _bridged_reconstructor(seed):
    m = tinv.Reconstructor(3)
    init = jinv._init_reconstructor(jax.random.PRNGKey(seed), 3)
    return bridge.load_params(m, jax.tree.map(np.asarray, init)), init


def _bridged_classifier(seed, a=4):
    m = tai.Classifier(3, a)
    init = jai._init_clf(jax.random.PRNGKey(seed), 3, a)
    return bridge.load_params(m, jax.tree.map(np.asarray, init)), init


def test_apply_functions_match_jax():
    x = _images(2, 5)
    rec, jrec = _bridged_reconstructor(1)
    clf, jclf = _bridged_classifier(1)
    with torch.no_grad():
        np.testing.assert_allclose(tinv._recon_apply(rec, _t(x)).numpy(),
                                   _np(jinv._recon_apply(jrec, x)), **TOL)
        np.testing.assert_allclose(tai._clf_logits(clf, _t(x)).numpy(),
                                   _np(jai._clf_logits(jclf, x)), **TOL)


def test_inverter_first_step_matches_jax():
    """One step from the same weights: within TOL wherever JAX's gradient
    is above Adam's eps scale; where it is not, the update is still one
    of at most lr."""
    z, x = _images(0, 40, normal=True), _images(1, 40)
    ref = jinv.train_inverter(jax.random.PRNGKey(5), jnp.asarray(z),
                              jnp.asarray(x), steps=1, batch=16)
    init_m, init = _bridged_reconstructor(5)
    before = {n: p.clone() for n, p in init_m.named_parameters()}
    out = tconv.fit(init_m, tinv._mse, _t(z), _t(x), prng.PRNGKey(5), 1, 16,
                   LR)
    idx = _np(jax.random.randint(jax.random.fold_in(jax.random.PRNGKey(5),
                                                    0), (16,), 0, 40))
    g = jax.grad(lambda p: jnp.mean(jnp.square(
        jinv._recon_apply(p, z[idx]) - x[idx])))(init)
    for name in ("c1", "c2", "c3", "out"):
        a, b = getattr(out, name).weight.detach().numpy(), _oihw(ref[name])
        big = np.abs(_oihw(g[name])) > ADAM_EPS_SCALE
        np.testing.assert_allclose(a[big], b[big], **TOL)
        moved = np.abs(a - before[name + ".weight"].detach().numpy())
        assert moved.max() <= LR * (1 + 1e-5)


def test_train_inverter_20_steps():
    z, x = _images(0, 40, normal=True), _images(1, 40)
    ref = jinv.train_inverter(jax.random.PRNGKey(5), jnp.asarray(z),
                              jnp.asarray(x), steps=20, batch=16)
    m, _ = _bridged_reconstructor(5)
    out = tconv.fit(m, tinv._mse, _t(z), _t(x), prng.PRNGKey(5), 20, 16, LR)
    for name in ("c1", "c2", "c3", "out"):
        np.testing.assert_allclose(getattr(out, name).weight.detach().numpy(),
                                   _oihw(ref[name]), atol=INV_ATOL, rtol=0)
    with torch.no_grad():
        np.testing.assert_allclose(
            tinv._recon_apply(out, _t(z)).numpy(),
            _np(jinv._recon_apply(ref, z)), atol=INV_OUT_ATOL, rtol=0)
    # the entry point itself is the port's own draw, then the same steps
    own = tinv.train_inverter(prng.PRNGKey(5), _t(z), _t(x), steps=20,
                              batch=16)
    again = tconv.fit(tinv._init_reconstructor(prng.PRNGKey(5), 3),
                     tinv._mse, _t(z), _t(x), prng.PRNGKey(5), 20, 16, LR)
    for a, b in zip(own.parameters(), again.parameters()):
        assert torch.equal(a, b)


def test_train_attr_classifier_20_steps():
    x, y = _images(1, 40), _labels(2, 40)
    ref = jai.train_attr_classifier(jax.random.PRNGKey(5), jnp.asarray(x),
                                    jnp.asarray(y), steps=20, batch=16)
    m, _ = _bridged_classifier(5)
    out = tconv.fit(m, tai._bce, _t(x), _t(y), prng.PRNGKey(5), 20, 16, LR)
    own = tai.train_attr_classifier(prng.PRNGKey(5), _t(x), _t(y), steps=20,
                                    batch=16)
    for name in ("c1", "c2", "head"):
        for mod in (out, own):
            np.testing.assert_allclose(getattr(mod, name).weight.detach()
                                       .numpy(), _oihw(ref[name]), **TOL)


def test_trainers_run_under_no_grad():
    """The trainers enable grad themselves (callers such as the samplers
    run with grad disabled)."""
    x, y = _images(1, 8), _labels(2, 8)
    with torch.no_grad():
        clf = tai.train_attr_classifier(prng.PRNGKey(1), _t(x), _t(y),
                                        steps=2, batch=4)
    m, _ = _bridged_classifier(1)
    assert not torch.equal(clf.c1.weight, m.c1.weight)


# ---------------------------------------------------------------------------
# The attacks in full (8×8, N = 32)
# ---------------------------------------------------------------------------


def test_inversion_attack_matches_jax():
    z, x = _images(0, 40, normal=True), _images(1, 40)
    args = (z[:32], x[:32], z[8:], x[8:])
    ref = jinv.inversion_attack(jax.random.PRNGKey(5),
                                *map(jnp.asarray, args))
    out = tinv.inversion_attack(prng.PRNGKey(5), *map(_t, args))
    assert set(out) == set(ref) == {"mse_own", "mse_cross", "fd_own",
                                    "fd_cross"}
    for k in ref:
        assert out[k] == pytest.approx(ref[k], rel=ATTACK["rtol"],
                                       abs=ATTACK["atol"]), k
    assert out["mse_own"] < out["mse_cross"]


def test_attribute_inference_matches_jax():
    x, y = _images(1, 32), _labels(2, 32)
    ref = jai.attribute_inference_f1(jax.random.PRNGKey(5), jnp.asarray(x),
                                     jnp.asarray(y))
    out = tai.attribute_inference_f1(prng.PRNGKey(5), _t(x), _t(y))
    assert out.shape == (4,)
    np.testing.assert_array_equal(out.numpy(), _np(ref))
    # no held-out prediction sits within the logits' gap of a flip
    perm = _np(jax.random.permutation(jax.random.PRNGKey(5), 32))
    np.testing.assert_array_equal(
        prng.permutation(prng.PRNGKey(5), 32).numpy(), perm)
    jclf = jai.train_attr_classifier(jax.random.PRNGKey(5), x[perm[:25]],
                                     y[perm[:25]])
    tclf = tai.train_attr_classifier(prng.PRNGKey(5), _t(x[perm[:25]]),
                                     _t(y[perm[:25]]))
    with torch.no_grad():
        lt = tai._clf_logits(tclf, _t(x[perm[25:]])).numpy()
    lj = _np(jai._clf_logits(jclf, x[perm[25:]]))
    np.testing.assert_allclose(lt, lj, atol=LOGIT_ATOL, rtol=0)
    assert np.abs(lj).min() > LOGIT_ATOL


def test_f1_per_attribute_is_exact():
    x, y = _images(3, 12), _labels(4, 12)
    clf, jclf = _bridged_classifier(2)
    out = tai.f1_per_attribute(clf, _t(x), _t(y))
    np.testing.assert_array_equal(out.numpy(),
                                  _np(jai.f1_per_attribute(jclf, x, y)))


def test_f1_perfect_and_inverted(monkeypatch):
    y = torch.tensor([[1., 0.], [0., 1.], [1., 1.], [0., 0.]])
    for sign, want in ((1.0, np.ones(2)), (-1.0, np.zeros(2))):
        monkeypatch.setattr(tai, "_clf_logits",
                            lambda p, x, s=sign: s * (y * 2 - 1) * 10.0)
        f1 = tai.f1_per_attribute(None, torch.zeros((4, 8, 8, 3)), y)
        np.testing.assert_allclose(f1.numpy(), want, atol=1e-6)


# ---------------------------------------------------------------------------
# The deprecated shim
# ---------------------------------------------------------------------------


def toy(p, x, t, y):
    lead = (-1,) + (1,) * (x.ndim - 1)
    return x * p["a"] + 0.001 * t.reshape(lead) + \
        0.01 * y.sum(-1).reshape(lead)


def test_shared_handoff_sample_list_warns_and_returns_rows():
    T, shape = 10, (2, 4, 4, 3)
    sched = DiffusionSchedule.linear(T, device="cpu")
    cut = CutPoint(T, 4)
    y = torch.eye(3)[[0, 2]]
    sp = {"a": torch.tensor(0.2)}
    cps = [{"a": torch.tensor(0.1)}, {"a": torch.tensor(0.3)}]
    args = (sp, cps, prng.PRNGKey(1), y, shape, sched, cut, toy)
    with pytest.warns(DeprecationWarning, match="shared_handoff_sample"):
        rows, handoff = tsampler.shared_handoff_sample_list(*args)
    outs, x_cut = tsampler.shared_handoff_sample(*args)
    assert isinstance(rows, list) and len(rows) == 2
    for i, r in enumerate(rows):
        assert torch.equal(r, outs[i])
    assert torch.equal(handoff, x_cut)
    # the reference's shim warns with the same category and text
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        try:
            jsampler.shared_handoff_sample_list()
        except TypeError:
            pass
    assert w and w[0].category is DeprecationWarning
    with pytest.warns(DeprecationWarning) as port:
        try:
            tsampler.shared_handoff_sample_list()
        except TypeError:
            pass
    assert str(port[0].message) == str(w[0].message)
