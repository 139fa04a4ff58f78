"""The port's privacy subsystem (privacy/accountant.py, secagg.py, dp.py,
payload DP in core/protocol.make_payload) against the JAX package's, and
its runtime contracts within the port.

* the accountant: RDP vectors and ε over sampling rates, noise
  multipliers and release counts within 1e-12 relative of the
  reference's; the σ-from-ε bisection; the state round trip bitwise;
* secagg: ``quantize``, pair masks, ``mask_for``, ``masked_upload`` and
  ``secagg_sum`` (masked, unmasked, with a dropped party) BITWISE equal
  to the reference's (the masks are ``random_bits``, JAX's bits);
* DP: ``global_l2_norm`` / ``clip_by_global_norm`` /
  ``dp_average_cohort`` (with noise, secagg on and off) within TOL (atol
  2e-5, rtol 2e-3; the noise is ``prng.normal``, within the erfinv ulps
  of JAX's), its guards; ``privatize_payload`` and ``make_payload``'s DP
  path against the reference's (the split's fourth key) within
  NORMAL_ATOL · (1 + σ·C);
* the runtime (toy denoiser, CPU): the identity ladder (clip=inf, σ=0,
  secagg off) bitwise equal to no privacy config, secagg on == off
  bitwise, ε monotone and equal to the reference accountant's for the
  releases charged, a DP checkpoint resumed bitwise, the DP epoch
  callback, a departed member recovered as a SecAgg dropout.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import protocol as jprotocol
from repro.core.schedules import DiffusionSchedule as JSched
from repro.core.splitting import CutPoint as JCut
from repro.privacy import accountant as jacct
from repro.privacy import dp as jdp
from repro.privacy import secagg as jsecagg
from repro_torch.core import prng, protocol, trees
from repro_torch.core.schedules import DiffusionSchedule
from repro_torch.core.splitting import CutPoint
from repro_torch.privacy import accountant as acct
from repro_torch.privacy import dp, secagg
from repro_torch.privacy.dp import PrivacyConfig
from repro_torch.train import ParticipationConfig, TrainRuntime
from repro_torch.train.participation import (TAG_DATA, TAG_DROP, TAG_INIT,
                                             TAG_LAG, TAG_PART, TAG_ROUND)

from tests.test_torch_train_runtime import (make_runtime, tiny_apply,
                                            tiny_config, tiny_data,
                                            tiny_init, trees_equal)

torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=2e-3)
NORMAL_ATOL = 5e-5
JKEY, TKEY = jax.random.PRNGKey(0), prng.PRNGKey(0)


def tree_of(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": (scale * rng.normal(size=(3, 4))).astype(np.float32),
            "b": np.float32(scale * rng.normal())}


def _j(t):
    return {k: jnp.asarray(v) for k, v in t.items()}


def _t(t):
    return {k: torch.from_numpy(np.array(v)) for k, v in t.items()}


def _close(port, ref, **tol):
    for a, b in zip(trees.leaves(port), jax.tree.leaves(ref), strict=True):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   **(tol or TOL))


# ---------------------------------------------------------------------------
# accountant
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("q", [0.0, 0.01, 0.3, 0.999, 1.0])
@pytest.mark.parametrize("sigma", [0.0, 0.6, 1.1, 4.0])
def test_accountant_matches_reference(q, sigma):
    a = acct.rdp_subsampled_gaussian(q, sigma)
    b = jacct.rdp_subsampled_gaussian(q, sigma)
    np.testing.assert_array_equal(np.isinf(a), np.isinf(b))
    fin = np.isfinite(b)
    np.testing.assert_allclose(a[fin], b[fin], rtol=1e-12, atol=0)
    for releases in (1, 7, 200):
        e1 = acct.epsilon_for(sigma, 1e-5, releases, q)
        e2 = jacct.epsilon_for(sigma, 1e-5, releases, q)
        if math.isinf(e2):
            assert math.isinf(e1)
        else:
            assert abs(e1 - e2) <= 1e-12 * max(abs(e2), 1e-300)


def test_accountant_bisection_and_state():
    s1 = acct.noise_multiplier_for_epsilon(8.0, 1e-5, 50, 0.2)
    s2 = jacct.noise_multiplier_for_epsilon(8.0, 1e-5, 50, 0.2)
    assert abs(s1 - s2) <= 1e-12 * s2
    assert acct.noise_multiplier_for_epsilon(math.inf, 1e-5, 5, 0.3) == 0.0
    a = acct.RdpAccountant(0.9, 1e-5)
    for q in (0.3, 0.3, 1.0):
        a.charge(q)
    b = acct.RdpAccountant.from_state(a.state_dict())
    assert np.array_equal(a._rdp, b._rdp) and a.steps == b.steps == 3
    assert a.epsilon() == b.epsilon() > 0.0
    with pytest.raises(ValueError):
        acct.rdp_to_epsilon(a._rdp, a.orders, 1.5)


# ---------------------------------------------------------------------------
# secagg: bitwise with the reference
# ---------------------------------------------------------------------------


def test_quantize_and_masks_bitwise():
    t = tree_of(0, scale=3.0)
    for a, b in zip(secagg.quantize(_t(t)), jsecagg.quantize(_j(t))):
        assert a.dtype == np.uint64 and np.array_equal(a, b)
    for uid, cohort in ((2, [2, 5, 9]), (9, [2, 5, 9]), (5, [1, 5])):
        a = secagg.mask_for(TKEY, 7, uid, cohort, _t(t))
        b = jsecagg.mask_for(JKEY, 7, uid, cohort, _j(t))
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
        a = secagg.masked_upload(_t(t), TKEY, 7, uid, cohort)
        b = jsecagg.masked_upload(_j(t), JKEY, 7, uid, cohort)
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    back = secagg.dequantize(secagg.quantize(_t(t)), _t(t))
    _close(back, t, atol=2.0 ** -(secagg.SCALE_BITS + 1) + 1e-9, rtol=0)


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("cohort", [[2, 5, 9], [2, 5, 9, 11]])
def test_secagg_sum_bitwise(masked, cohort):
    ups = {2: tree_of(1), 5: tree_of(2), 9: tree_of(3)}
    a = secagg.secagg_sum({u: _t(t) for u, t in ups.items()}, cohort, TKEY,
                          4, masked=masked)
    b = jsecagg.secagg_sum({u: _j(t) for u, t in ups.items()}, cohort, JKEY,
                           4, masked=masked)
    for x, y in zip(trees.leaves(a), jax.tree.leaves(b)):
        assert np.array_equal(x.numpy(), np.asarray(y))
    plain = secagg.secagg_sum({u: _t(t) for u, t in ups.items()},
                              [2, 5, 9], TKEY, 4, masked=False)
    assert trees_equal(a, plain)          # masks cancel, dropouts recovered
    with pytest.raises(ValueError, match="not in the mask-agreement"):
        secagg.secagg_sum({3: _t(tree_of(0))}, [1, 2], TKEY, 0)
    with pytest.raises(ValueError, match="at least one"):
        secagg.secagg_sum({}, [1, 2], TKEY, 0)


def test_leafwise_bits_is_the_per_leaf_draw():
    shapes = [(3, 4), (), (2, 1, 5), (0,)]
    got = prng.leafwise_bits(TKEY, shapes)
    for i, (g, s) in enumerate(zip(got, shapes)):
        assert torch.equal(g, prng.random_bits(prng.fold_in(TKEY, i), s))


# ---------------------------------------------------------------------------
# DP primitives against the reference
# ---------------------------------------------------------------------------


def test_norm_and_clip_match_reference():
    t = tree_of(4, scale=10.0)
    np.testing.assert_allclose(float(dp.global_l2_norm(_t(t))),
                               float(jdp.global_l2_norm(_j(t))), **TOL)
    got, n1 = dp.clip_by_global_norm(_t(t), 1.0)
    want, n2 = jdp.clip_by_global_norm(_j(t), 1.0)
    _close(got, want)
    assert float(dp.global_l2_norm(got)) <= 1.0 + 1e-5
    same, _ = dp.clip_by_global_norm(_t(t), math.inf)
    assert trees_equal(same, _t(t))
    src = _t(t)
    assert dp.clip_by_global_norm(src, math.inf)[0] is src


def test_noise_is_addressed_and_matches_reference():
    t = tree_of(5)
    n5 = dp.gaussian_noise_like(dp.dp_noise_key(TKEY, 5), _t(t), 0.7)
    ref = jdp.gaussian_noise_like(jdp.dp_noise_key(JKEY, 5), _j(t), 0.7)
    _close(n5, ref, atol=NORMAL_ATOL, rtol=0)
    assert trees_equal(n5, dp.gaussian_noise_like(
        dp.dp_noise_key(TKEY, 5), _t(t), 0.7))
    assert not trees_equal(n5, dp.gaussian_noise_like(
        dp.dp_noise_key(TKEY, 6), _t(t), 0.7))
    zero = dp.gaussian_noise_like(TKEY, _t(t), 0.0)
    assert all(not l.any() for l in trees.leaves(zero))
    tags = [TAG_INIT, TAG_ROUND, TAG_PART, TAG_DROP, TAG_DATA, TAG_LAG,
            dp.TAG_DP, secagg.TAG_SECAGG]
    assert len(set(tags)) == len(tags)


@pytest.mark.parametrize("secagg_on", [False, True])
def test_dp_average_cohort_matches_reference(secagg_on):
    params = [tree_of(i) for i in range(4)]
    ref = tree_of(9)
    kw = dict(clip=0.5, noise_multiplier=0.7, round_idx=3,
              secagg=secagg_on, dropped_uids=[6])
    seen, members, uids = [4, 0, 5, 3], [True, True, True, False], \
        [0, 1, 4, 7]
    jo, jr, js = jdp.dp_average_cohort([_j(p) for p in params], seen,
                                       members, _j(ref), uids,
                                       base_key=JKEY, **kw)
    tin = [_t(p) for p in params]
    to, tr, ts = dp.dp_average_cohort(tin, seen, members, _t(ref), uids,
                                      base_key=TKEY, **kw)
    assert ts == js and ts["applied"] == 1.0 and ts["clip_frac"] > 0.0
    _close(tr, jr)
    for a, b in zip(to, jo):
        _close(a, b)
    assert to[3] is tin[3]                       # absent: identity
    assert to[1] is not to[0] and trees_equal(to[0], to[1])
    assert trees_equal(to[0], tr)


def test_dp_average_cohort_guards():
    params = [_t(tree_of(i)) for i in range(3)]
    ref = _t(tree_of(9))
    out, new_ref, stats = dp.dp_average_cohort(
        params, [0, 0, 0], [True] * 3, ref, [0, 1, 2], clip=1.0,
        noise_multiplier=0.0, base_key=TKEY, round_idx=0)
    assert stats["applied"] == 0.0 and new_ref is ref
    assert all(o is p for o, p in zip(out, params))
    with pytest.raises(ValueError, match="one seen-count"):
        dp.dp_average_cohort(params, [1], [True], ref, [0], clip=1.0,
                             noise_multiplier=0.0, base_key=TKEY,
                             round_idx=0)
    with pytest.raises(ValueError):
        PrivacyConfig(clip=0.0)
    with pytest.raises(ValueError):
        PrivacyConfig(noise_multiplier=-1.0)
    with pytest.raises(ValueError):
        PrivacyConfig(delta=1.0)
    with pytest.raises(ValueError, match="finite clip"):
        PrivacyConfig(noise_multiplier=1.0)
    assert not PrivacyConfig().enabled and PrivacyConfig(secagg=True).enabled


# ---------------------------------------------------------------------------
# payload DP (the lifted refusal in make_payload)
# ---------------------------------------------------------------------------


def test_privatize_payload_matches_reference():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(6, 4, 4, 3)).astype(np.float32) * 5.0
    sigma, clip = 0.06, dp.DP_CLIP / 4
    got = dp.privatize_payload(torch.from_numpy(x), prng.fold_in(TKEY, 11),
                               sigma, clip)
    want = jdp.privatize_payload(jnp.asarray(x),
                                 jax.random.fold_in(JKEY, 11), sigma, clip)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=NORMAL_ATOL * (1 + sigma * clip))
    clipped = dp.clip_rows(torch.from_numpy(x), clip)
    assert (torch.linalg.vector_norm(clipped.reshape(6, -1), dim=1)
            <= clip * (1 + 1e-6)).all()


@pytest.mark.parametrize("t_cut", [0, 20, 60])
def test_make_payload_dp_matches_reference(t_cut):
    rng = np.random.default_rng(7)
    x0 = rng.uniform(-1, 1, (5, 4, 4, 3)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 5)]
    kj, kt = jax.random.fold_in(JKEY, 3), prng.fold_in(TKEY, 3)
    sigma, clip = 0.5, 2.0
    want = jprotocol.make_payload(jnp.asarray(x0), jnp.asarray(y), kj,
                                  JSched.linear(60), JCut(60, t_cut),
                                  dp_sigma=sigma, dp_clip=clip)
    got = protocol.make_payload(torch.from_numpy(x0), torch.from_numpy(y),
                                kt, DiffusionSchedule.linear(60),
                                CutPoint(60, t_cut), dp_sigma=sigma,
                                dp_clip=clip)
    base = protocol.make_payload(torch.from_numpy(x0), torch.from_numpy(y),
                                 kt, DiffusionSchedule.linear(60),
                                 CutPoint(60, t_cut))
    np.testing.assert_array_equal(got.t_s.numpy(), np.asarray(want.t_s))
    np.testing.assert_allclose(got.x_ts.numpy(), np.asarray(want.x_ts),
                               rtol=1e-5,
                               atol=NORMAL_ATOL * (1 + sigma * clip))
    np.testing.assert_allclose(got.eps_s.numpy(), np.asarray(want.eps_s),
                               rtol=0, atol=NORMAL_ATOL)
    assert torch.equal(got.eps_s, base.eps_s)
    assert not torch.equal(got.x_ts, base.x_ts)


# ---------------------------------------------------------------------------
# the runtime
# ---------------------------------------------------------------------------

LADDER = dict(policy="bernoulli", p=0.7, drop_p=0.2)
SIZES = (10, 7, 9)


def _run(rounds=4, **cfg_kw):
    cfg_kw.setdefault("participation", ParticipationConfig(**LADDER))
    cfg_kw.setdefault("fedavg_every", 2)
    rt = make_runtime(SIZES, **cfg_kw)
    return rt, rt.run(rounds)


def _assert_runtime_bitwise(a, b):
    assert trees_equal(a.server_params, b.server_params)
    assert trees_equal(a.server_opt, b.server_opt)
    assert a.round == b.round and a.dp_epoch == b.dp_epoch
    assert trees_equal(a._dp_ref, b._dp_ref)
    for u in a.registry.uids():
        ra, rb = a.registry.get(u), b.registry.get(u)
        assert trees_equal(ra.params, rb.params), f"client {u}"
        assert trees_equal(ra.opt, rb.opt), f"client {u}"
        assert (ra.seen, ra.window_seen) == (rb.seen, rb.window_seen)
    if a._accountant is not None:
        assert np.array_equal(a._accountant._rdp, b._accountant._rdp)
        assert a._accountant.steps == b._accountant.steps


def test_identity_ladder_bitwise():
    base, base_reps = _run()
    ident, id_reps = _run(privacy=PrivacyConfig(clip=math.inf,
                                                noise_multiplier=0.0,
                                                secagg=False))
    _assert_runtime_bitwise(base, ident)
    assert all(r["dp_epsilon"] == 0.0 and r["dp_epoch"] == 0
               for r in id_reps)


def test_secagg_on_off_bitwise_and_epsilon():
    dp_cfg = dict(clip=0.5, noise_multiplier=0.8, delta=1e-5)
    off, off_reps = _run(6, privacy=PrivacyConfig(secagg=False, **dp_cfg))
    on, _ = _run(6, privacy=PrivacyConfig(secagg=True, **dp_cfg))
    _assert_runtime_bitwise(off, on)
    eps = [r["dp_epsilon"] for r in off_reps]
    assert all(np.isfinite(e) for e in eps)
    assert all(b >= a for a, b in zip(eps, eps[1:]))
    assert off.dp_epoch > 0 and eps[-1] > 0.0
    ref = jacct.RdpAccountant(0.8, 1e-5)
    q = 1.0 - (1.0 - 0.7) ** 2
    ref.charge(q, off.dp_epoch)
    assert abs(eps[-1] - ref.epsilon()) <= 1e-12 * ref.epsilon()


def test_privacy_requires_fedavg_boundary_and_fires_epochs():
    with pytest.raises(ValueError, match="fedavg_every"):
        make_runtime(SIZES, privacy=PrivacyConfig(secagg=True))
    rt = make_runtime(SIZES, participation=ParticipationConfig(**LADDER),
                      fedavg_every=2,
                      privacy=PrivacyConfig(clip=1.0, noise_multiplier=0.5))
    seen = []
    rt.on_dp_epoch = seen.append
    rt.run(4)
    assert seen == list(range(1, rt.dp_epoch + 1)) and rt.dp_epoch > 0


def test_dp_checkpoint_resumes_bitwise(tmp_path):
    kw = dict(participation=ParticipationConfig(**LADDER), fedavg_every=2,
              privacy=PrivacyConfig(clip=0.5, noise_multiplier=0.8,
                                    secagg=True))
    full, _ = _run(6, **kw)
    half, _ = _run(3, **kw)
    path = str(tmp_path / "dp.msgpack")
    half.save(path)
    resumed = TrainRuntime.restore(tiny_config(**kw), tiny_init, tiny_apply,
                                   path, device="cpu")
    for i, n in enumerate(SIZES):
        resumed.attach_data(i, *tiny_data(i, n))
    resumed.run(3)
    _assert_runtime_bitwise(resumed, full)
    with pytest.raises(ValueError, match="PrivacyConfig is disabled"):
        TrainRuntime.restore(tiny_config(fedavg_every=2), tiny_init,
                             tiny_apply, path, device="cpu")


def test_departed_member_recovered_as_secagg_dropout():
    kw = dict(participation=ParticipationConfig(policy="full"),
              fedavg_every=2)
    on = make_runtime(SIZES, privacy=PrivacyConfig(
        clip=0.5, noise_multiplier=0.8, secagg=True), **kw)
    off = make_runtime(SIZES, privacy=PrivacyConfig(
        clip=0.5, noise_multiplier=0.8, secagg=False), **kw)
    for rt in (on, off):
        rt.run(1)
        rt.leave(1)
        rt.run(1)
    _assert_runtime_bitwise(on, off)
    assert on.dp_epoch == 1
