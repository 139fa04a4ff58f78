"""The port's participation sampler, round planner and client registry
(train/participation.py, rounds.py, registry.py) against the JAX
package's — BITWISE.

The draws are ``prng.uniform`` of ``fold_in`` keys, JAX's bits exactly,
so over many rounds and policies: every uid score, cohort, mid-round
drop slot and straggler lag equals the reference's; ``plan_round``'s
mask, uid vector, tier and signature equal the reference's, and its
stacks hold the same samples (the data shuffle is ``prng.permutation``).
Also the tier menu, the policy guards, identity keying (one client's
draw does not move when another joins) and the registry's permanent
uids.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import participation as jpart
from repro.train import rounds as jrounds
from repro.train.registry import ClientRegistry as JRegistry
from repro_torch.core import prng
from repro_torch.train import participation as tpart
from repro_torch.train import rounds as trounds
from repro_torch.train.registry import ClientRegistry

torch.set_num_threads(1)

UIDS = [0, 1, 2, 3, 4, 7, 11, 12]
POLICIES = [dict(policy="full"),
            dict(policy="bernoulli", p=0.6, drop_p=0.3, lag_p=0.5,
                 lag_max=3),
            dict(policy="fixed", cohort_k=3, drop_p=1.0, lag_p=1.0),
            dict(policy="bernoulli", p=0.05, min_cohort=2)]


def _keys(seed):
    return jax.random.PRNGKey(seed), prng.PRNGKey(seed)


@pytest.mark.parametrize("tag", [jpart.TAG_PART, jpart.TAG_DROP,
                                 jpart.TAG_LAG])
def test_uid_scores_bitwise(tag):
    jk, tk = _keys(3)
    for r in (0, 1, 17, 2 ** 20):
        a = jpart.uid_scores(jk, tag, r, UIDS)
        b = tpart.uid_scores(tk, tag, r, UIDS)
        assert b.dtype == np.float32
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("kw", POLICIES)
def test_cohorts_drops_lags_bitwise(kw):
    jcfg, tcfg = jpart.ParticipationConfig(**kw), \
        tpart.ParticipationConfig(**kw)
    jk, tk = _keys(0)
    for r in range(12):
        jc = jpart.sample_cohort(jcfg, jk, r, UIDS)
        tc = tpart.sample_cohort(tcfg, tk, r, UIDS)
        assert tc == jc
        assert tpart.sample_drops(tcfg, tk, r, tc, 3) == \
            jpart.sample_drops(jcfg, jk, r, jc, 3)
        assert tpart.sample_lags(tcfg, tk, r, tc) == \
            jpart.sample_lags(jcfg, jk, r, jc)
    assert tpart.sampling_rate(tcfg, 8) == jpart.sampling_rate(jcfg, 8)
    assert tpart.sampling_rate(tcfg, 0) == 0.0


def test_draws_are_identity_keyed_and_configs_guarded():
    cfg = tpart.ParticipationConfig(policy="bernoulli", p=0.5)
    _, tk = _keys(0)
    for r in range(6):
        small = tpart.sample_cohort(cfg, tk, r, [0, 1, 2, 3, 4])
        big = tpart.sample_cohort(cfg, tk, r, [0, 1, 2, 3, 4, 9])
        assert [u for u in big if u != 9] == small
    with pytest.raises(ValueError, match="cohort_k"):
        tpart.ParticipationConfig(policy="fixed")
    with pytest.raises(ValueError):
        tpart.ParticipationConfig(lag_p=1.5)
    with pytest.raises(ValueError):
        tpart.ParticipationConfig(lag_max=0)
    with pytest.raises(ValueError, match="unknown participation"):
        tpart.ParticipationConfig(policy="all")


def test_participation_tier_matches_jax():
    for n in range(0, 20):
        for cap in (None, 1, 3, 6, 8):
            assert trounds.participation_tier(n, cap) == \
                jrounds.participation_tier(n, cap)


def _data(seed, n, img=6, nc=4):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, img, img, 3)).astype(np.float32)
    y = np.eye(nc, dtype=np.float32)[rng.integers(0, nc, n)]
    return x, y


@pytest.mark.parametrize("cohort,drops,cap", [
    ([0, 2, 3], {}, None), ([1, 4], {4: 0}, None),
    ([0, 1, 2, 3, 4], {2: 1}, 8), ([3], {}, None), ([0, 1, 2], {}, 2)])
def test_plan_round_bitwise(cohort, drops, cap):
    sizes = [9, 4, 0, 12, 7]
    jreg, treg = JRegistry(), ClientRegistry()
    for i, n in enumerate(sizes):
        if n:
            x, y = _data(i, n)
            jreg.register(jnp.asarray(x), jnp.asarray(y))
            treg.register(torch.from_numpy(x), torch.from_numpy(y))
        else:
            jreg.register()
            treg.register()
    jk, tk = _keys(5)
    kw = dict(n_batches=3, batch_size=4, image_shape=(6, 6, 3),
              n_classes=4, tier_cap=cap, drops=drops)
    if cap is not None and len(cohort) > trounds.participation_tier(
            len(cohort), cap):
        with pytest.raises(ValueError, match="exceeds tier cap"):
            trounds.plan_round(treg, cohort, 2, tk, **kw)
        return
    jp = jrounds.plan_round(jreg, cohort, 2, jk, **kw)
    tp = trounds.plan_round(treg, cohort, 2, tk, device="cpu", **kw)
    assert tp.tier == jp.tier and tp.cohort == jp.cohort
    assert isinstance(tp.mask, np.ndarray)
    np.testing.assert_array_equal(tp.mask, np.asarray(jp.mask))
    np.testing.assert_array_equal(tp.uids, np.asarray(jp.uids))
    assert tp.uids.dtype == np.int32
    assert tp.signature() == tuple(tuple(s) for s in jp.signature())
    np.testing.assert_array_equal(tp.xs.numpy(), np.asarray(jp.xs))
    np.testing.assert_array_equal(tp.ys.numpy(), np.asarray(jp.ys))
    assert tp.real_samples == jp.real_samples
    assert tp.padded_cells == jp.padded_cells
    assert tp.drops == jp.drops


def test_plan_round_empty():
    reg = ClientRegistry()
    reg.register()
    _, tk = _keys(0)
    kw = dict(n_batches=2, batch_size=4, image_shape=(6, 6, 3),
              n_classes=4)
    assert trounds.plan_round(reg, [], 0, tk, **kw) is None
    assert trounds.plan_round(reg, [0], 0, tk, **kw) is None


def test_registry_uids_are_permanent():
    reg = ClientRegistry()
    a, b = reg.register(), reg.register()
    assert (a, b) == (0, 1)
    reg.leave(a)
    assert reg.active_uids() == [b] and reg.uids() == [a, b]
    assert reg.register() == 2
    with pytest.raises(ValueError, match="already registered"):
        reg.register(uid=1)
    with pytest.raises(KeyError):
        reg.get(9)
    reg.rejoin(a)
    assert reg.active_uids() == [0, 1, 2] and len(reg) == 3 and 2 in reg
    reg.attach_data(2, torch.zeros(5, 2, 2, 3), torch.zeros(5, 4))
    assert reg.get(2).n_samples == 5 and reg.get(0).n_samples == 0
