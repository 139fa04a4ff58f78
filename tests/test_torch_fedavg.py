"""The port's FedAvg (core/fedavg.py) against the JAX package's.

Trees come from a numpy seed and go through both packages:

* ``average_weights`` (uniform, size-weighted, bf16 leaves),
  ``average_cohort`` (members, zero-seen guard, absent identity, no-op)
  and ``average_stale`` (the staleness weight, the w ≥ 1 / w ≤ 0
  identities) within TOL (atol 2e-5, rtol 2e-3) — in fact the same
  float32 arithmetic in the same order, so within an ulp;
* on an ``nn.Module`` the aggregate is a new module of the same kind, each
  member holding its own copy;
* ``fedavg_round`` with the toy denoiser and ``make_local_step`` against
  JAX's round within TOL (the step's noise differs from JAX's by the
  erfinv ulps of ``prng.normal``), and the communication bytes exactly;
* ``fedavg_sample`` (the whole chain on the client, through the keyed
  DDPM step — its plain version on the CPU) against JAX's within TOL.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from repro.core import fedavg as jfedavg
from repro.core.schedules import DiffusionSchedule as JSched
from repro.optim.adamw import AdamWConfig as JAdamW
from repro_torch.core import fedavg, prng, trees
from repro_torch.core.schedules import DiffusionSchedule
from repro_torch.optim.adamw import AdamWConfig

torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=2e-3)


def tiny_apply(p, x, t, y):
    return x * p["a"] + p["b"]


def _trees(seed, n, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [{"w": rng.normal(size=(3, 4)).astype(dtype),
             "b": rng.normal(size=(4,)).astype(dtype)} for _ in range(n)]


def _port(tree, dtype=None):
    return {k: torch.from_numpy(np.array(v)).to(dtype or torch.float32)
            for k, v in tree.items()}


def _jax(tree, dtype=jnp.float32):
    return {k: jnp.asarray(v, dtype) for k, v in tree.items()}


def _close(port, ref, **tol):
    assert set(port) == set(ref)
    for k in ref:
        np.testing.assert_allclose(port[k].detach().float().numpy(),
                                   np.asarray(ref[k], np.float32),
                                   **(tol or TOL))


@pytest.mark.parametrize("weights", [None, [1, 3, 0], [0.2, 0.5, 0.3]])
def test_average_weights_matches_jax(weights):
    ts = _trees(0, 3)
    ref = jfedavg.average_weights([_jax(t) for t in ts], weights)
    out = fedavg.average_weights([_port(t) for t in ts], weights)
    _close(out, ref)


def test_average_weights_bf16_and_guards():
    ts = _trees(1, 2)
    ref = jfedavg.average_weights([_jax(t, jnp.bfloat16) for t in ts],
                                  [1, 2])
    out = fedavg.average_weights([_port(t, torch.bfloat16) for t in ts],
                                 [1, 2])
    assert out["w"].dtype == torch.bfloat16
    _close(out, ref)
    with pytest.raises(ValueError, match="dtype mismatch"):
        fedavg.average_weights([_port(ts[0]), _port(ts[1], torch.bfloat16)])
    with pytest.raises(ValueError, match="one weight per client"):
        fedavg.average_weights([_port(ts[0])] * 2, weights=[1.0])
    with pytest.raises(ValueError, match="non-negative"):
        fedavg.average_weights([_port(ts[0])] * 2, weights=[0.0, 0.0])
    with pytest.raises(ValueError, match="at least one"):
        fedavg.average_weights([])


def test_average_weights_of_modules():
    torch.manual_seed(0)
    mods = [nn.Linear(4, 3) for _ in range(2)]
    avg = fedavg.average_weights(mods, [1, 3])
    assert isinstance(avg, nn.Linear) and avg is not mods[0]
    want = 0.25 * mods[0].weight.detach() + 0.75 * mods[1].weight.detach()
    torch.testing.assert_close(avg.weight.detach(), want)
    out = fedavg.average_cohort(mods + [mods[0]], [1, 3, 5],
                                [True, True, False])
    assert out[2] is mods[0]
    assert out[0] is not out[1] and trees.equal(out[0], out[1])
    assert trees.equal(out[0], avg)


def test_average_cohort_matches_jax():
    ts = _trees(2, 4)
    seen, members = [4, 0, 6, 9], [True, True, True, False]
    ref = jfedavg.average_cohort([_jax(t) for t in ts], seen, members)
    port_in = [_port(t) for t in ts]
    out = fedavg.average_cohort(port_in, seen, members)
    for o, r in zip(out, ref):
        _close(o, r)
    assert out[3] is port_in[3]                     # absent: identity
    assert out[1] is not out[0] and trees.equal(out[0], out[1])
    # nobody trained / nobody a member: no-op, identities
    same = fedavg.average_cohort(port_in, [0, 0, 0, 0], [True] * 4)
    assert all(a is b for a, b in zip(same, port_in))
    none = fedavg.average_cohort(port_in, seen, [False] * 4)
    assert all(a is b for a, b in zip(none, port_in))
    with pytest.raises(ValueError, match="one seen-count"):
        fedavg.average_cohort(port_in, [1], [True])


@pytest.mark.parametrize("staleness,alpha,decay", [(0, 0.6, 0.5),
                                                   (3, 0.6, 0.5),
                                                   (1, 0.9, 2.0)])
def test_average_stale_matches_jax(staleness, alpha, decay):
    cur, pay = _trees(3, 2)
    ref = jfedavg.average_stale(_jax(cur), _jax(pay), staleness, alpha,
                                decay)
    out = fedavg.average_stale(_port(cur), _port(pay), staleness, alpha,
                               decay)
    _close(out, ref)


def test_average_stale_identities_and_guards():
    cur, pay = (_port(t) for t in _trees(4, 2))
    assert fedavg.average_stale(cur, pay, 0, alpha=1.0) is pay
    assert fedavg.average_stale(cur, pay, 0, alpha=0.0) is cur
    with pytest.raises(ValueError):
        fedavg.average_stale(cur, pay, -1)
    with pytest.raises(ValueError):
        fedavg.average_stale(cur, pay, 0, alpha=1.5)
    with pytest.raises(ValueError):
        fedavg.average_stale(cur, pay, 0, decay=-0.1)


def _toy_init(a):
    return lambda k: {"a": torch.tensor(np.float32(a), requires_grad=True),
                      "b": torch.tensor(np.float32(0.0), requires_grad=True)}


def test_fedavg_round_matches_jax():
    rng = np.random.default_rng(5)
    batches = [[(rng.normal(size=(n, 6, 6, 3)).astype(np.float32),
                 np.eye(4, dtype=np.float32)[rng.integers(0, 4, n)])
                for n in sizes] for sizes in ([4, 4], [2], [])]
    jst = jfedavg.fedavg_setup(jax.random.PRNGKey(0), lambda k: {
        "a": jnp.float32(0.5), "b": jnp.float32(0.0)}, 3)
    jstep = jax.jit(jfedavg.make_local_step(JSched.linear(50), 50,
                                            tiny_apply, JAdamW(lr=0.05)))
    tst = fedavg.fedavg_setup(prng.PRNGKey(0), _toy_init(0.5), 3)
    tstep = fedavg.make_local_step(DiffusionSchedule.linear(50), 50,
                                   tiny_apply, AdamWConfig(lr=0.05))
    for r in range(2):
        jm = jfedavg.fedavg_round(
            jst, jstep, [[(jnp.asarray(x), jnp.asarray(y)) for x, y in b]
                         for b in batches], jax.random.PRNGKey(10 + r))
        tm = fedavg.fedavg_round(
            tst, tstep, [[(torch.from_numpy(x), torch.from_numpy(y))
                          for x, y in b] for b in batches],
            prng.PRNGKey(10 + r))
        np.testing.assert_allclose(tm["mean_loss"], jm["mean_loss"], **TOL)
        assert tm["comm_bytes_total"] == jm["comm_bytes_total"]
    _close(tst.global_params, jst.global_params)
    for cp, jcp in zip(tst.client_params, jst.client_params):
        _close(cp, jcp)
        assert cp is not tst.global_params and cp["a"].requires_grad
    for o, jo in zip(tst.client_opt, jst.client_opt):
        _close(o["m"], jo["m"])
        assert int(o["step"]) == int(jo["step"])
    assert tst.round == jst.round == 2
    assert fedavg.params_nbytes(tst.global_params) == \
        jfedavg.params_nbytes(jst.global_params)
    with pytest.raises(ValueError, match="no client contributed"):
        fedavg.fedavg_round(tst, tstep, [[], []], prng.PRNGKey(0))


def test_fedavg_sample_matches_jax():
    y = np.eye(4, dtype=np.float32)[[0, 2]]
    jst = jfedavg.fedavg_setup(jax.random.PRNGKey(0), lambda k: {
        "a": jnp.float32(0.3), "b": jnp.float32(0.01)}, 1)
    ref = jfedavg.fedavg_sample(jst, 0, jax.random.PRNGKey(3),
                                jnp.asarray(y), (2, 6, 6, 3),
                                JSched.linear(12), 12, tiny_apply)
    tst = fedavg.fedavg_setup(prng.PRNGKey(0), lambda k: {
        "a": torch.tensor(np.float32(0.3)),
        "b": torch.tensor(np.float32(0.01))}, 1)
    out = fedavg.fedavg_sample(tst, 0, prng.PRNGKey(3), torch.from_numpy(y),
                               (2, 6, 6, 3), DiffusionSchedule.linear(12),
                               12, tiny_apply)
    assert tuple(out.shape) == (2, 6, 6, 3) and torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
