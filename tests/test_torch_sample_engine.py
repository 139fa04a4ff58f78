"""The port's batched sampling engine and planner against the JAX
package's.

* Plan tables: integers, masks, seeds and group keys BITWISE; the
  linspace-built client timesteps within LINSPACE_ULPS ulps of the sweep's
  start (see test_torch_schedules.py); call accounting equal.
* Engine vs JAX engine: SAMPLE (erfinv few-ulp noise differences ride the
  sweep, as in test_torch_sampler.py).
* Inside the port, bitwise: fused engine == split stages == the
  per-request reference (sample_plan_reference); masked steps pass x
  through; padding rows never perturb real rows.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sample_plan as jsp
from repro.core import sampler as js
from repro.core.schedules import DiffusionSchedule as JaxSchedule
from repro_torch.core import prng
from repro_torch.core import sample_plan as tsp
from repro_torch.core import sampler as ts
from repro_torch.core.schedules import DiffusionSchedule

torch.set_num_threads(1)

SAMPLE = dict(rtol=1e-4, atol=1e-4)
LINSPACE_ULPS = 2
T = 16
IMG = (4, 4, 3)
B, NC, K = 2, 3, 3
JSCHED = JaxSchedule.linear(T)
TSCHED = DiffusionSchedule.linear(T, device="cpu")
FLOAT_FIELDS = ("client_t", "client_t_prev")


def apply_fn(p, x, t, y):
    """Param-, time- and label-dependent toy denoiser, row-independent
    (works on jnp and torch alike)."""
    lead = (-1,) + (1,) * (x.ndim - 1)
    return x * p["a"] + 0.001 * t.reshape(lead) + \
        0.01 * y.sum(-1).reshape(lead)


JSP = {"a": jnp.float32(0.2)}
JCP = {"a": jnp.asarray([0.1, 0.3, 0.5], jnp.float32)}
TSP = {"a": torch.tensor(0.2)}
TCP = [{"a": torch.tensor(v)} for v in (0.1, 0.3, 0.5)]


def _y(label):
    return np.broadcast_to(np.eye(NC, dtype=np.float32)[label],
                           (B, NC)).copy()


def _requests(mod):
    """GM (0), ICM (T) and mid cuts, a duplicate (y, t_ζ) for the dedup."""
    return [mod.SampleRequest(0, 6, _y(0)), mod.SampleRequest(1, 0, _y(0)),
            mod.SampleRequest(2, T, _y(1)), mod.SampleRequest(1, 6, _y(0)),
            mod.SampleRequest(2, 11, _y(2))]


def _assert_tables_equal(port: tsp.PlanTables, ref):
    for name, a, b in zip(tsp.PlanTables._fields, port, ref):
        b = np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if name in FLOAT_FIELDS and a.size:
            np.testing.assert_allclose(a, b, rtol=0, atol=LINSPACE_ULPS *
                                       np.spacing(np.float32(T)))
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("adjusted", [True, False])
@pytest.mark.parametrize("stride", [1, 3])
def test_plan_tables_match_jax(adjusted, stride):
    kw = dict(adjusted=adjusted, n_clients=K, server_stride=stride,
              group_seed_fn=None, request_seeds=[5, 9, 11, 2, 7])
    pj = jsp.plan_requests(_requests(jsp), T, **kw)
    pt = tsp.plan_requests(_requests(tsp), T, **kw)
    _assert_tables_equal(pt.tables, pj.tables)
    assert pt.group_keys == pj.group_keys
    assert (pt.group_t_cut, pt.request_t_cut, pt.group_seed) == \
        (pj.group_t_cut, pj.request_t_cut, pj.group_seed)
    assert (pt.server_steps_run, pt.server_steps_saved) == \
        (pj.server_steps_run, pj.server_steps_saved)
    padded_j = jsp.pad_plan(pj, n_groups=4, n_requests=8)
    padded_t = tsp.pad_plan(pt, n_groups=4, n_requests=8)
    _assert_tables_equal(padded_t.tables, padded_j.tables)
    assert tsp.call_accounting(padded_t) == jsp.call_accounting(padded_j)


def test_stable_group_seed_and_keys_bitwise():
    for r in _requests(tsp):
        gk = tsp.group_key(r.t_cut, r.y, 2)
        assert gk == jsp.group_key(r.t_cut, r.y, 2)
        assert tsp.stable_group_seed(gk) == jsp.stable_group_seed(gk)
    for tc, stride in ((0, 1), (5, 1), (5, 4), (T, 3), (1, 7)):
        for a, b in zip(tsp.server_table_np(T, tc, stride),
                        jsp.server_table_np(T, tc, stride)):
            np.testing.assert_array_equal(a, b)


def _jax_engine(plan, **kw):
    eng = js.make_sample_engine(JSCHED, apply_fn, IMG, jit=False, **kw)
    return eng(JSP, JCP, jax.random.PRNGKey(2), plan.tables, plan.inject)


def _port_engine(plan, key=None, **kw):
    eng = ts.make_sample_engine(TSCHED, apply_fn, IMG, **kw)
    inject = tsp.inject_to_device(plan.inject, "cpu")
    return eng(TSP, TCP, key if key is not None else prng.PRNGKey(2),
               tsp.tables_to_device(plan.tables, "cpu"), inject)


def test_engine_matches_jax_and_reference():
    pj = jsp.plan_requests(_requests(jsp), T, n_clients=K)
    pt = tsp.plan_requests(_requests(tsp), T, n_clients=K)
    jo, jh = _jax_engine(pj)
    to, th = _port_engine(pt)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **SAMPLE)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **SAMPLE)
    ro, rh = ts.sample_plan_reference(TSP, TCP, prng.PRNGKey(2), pt, TSCHED,
                                      apply_fn, IMG)
    assert torch.equal(ro, to) and torch.equal(rh, th)


def test_split_stages_equal_fused_engine():
    pt = tsp.plan_requests(_requests(tsp), T, n_clients=K)
    tables = tsp.tables_to_device(pt.tables, "cpu")
    server, client = ts.make_sample_engine(TSCHED, apply_fn, IMG, split=True)
    key = prng.PRNGKey(4)
    out = client(TCP, key, tables, server(TSP, key, tables))
    fused, _ = _port_engine(pt, key)
    assert torch.equal(out, fused)


def test_engine_with_injected_handoffs():
    """A cache-hit group enters as an injected row: zero server steps and
    the same samples as recomputing its prefix."""
    seeds = tsp.stable_group_seed      # content-stable, as when serving
    cold = tsp.plan_requests(_requests(tsp), T, n_clients=K,
                             group_seed_fn=seeds)
    cold_out, cold_hand = _port_engine(cold)
    stored = {gk: cold_hand[g] for g, gk in enumerate(cold.group_keys)}
    warm = tsp.plan_requests(_requests(tsp), T, n_clients=K,
                             group_seed_fn=seeds, lookup_fn=stored.get,
                             image_shape=IMG)
    assert warm.n_hits >= 1 and warm.n_groups < cold.n_groups
    warm_out, _ = _port_engine(warm)
    assert torch.equal(warm_out, cold_out)
    # the same injected plan through JAX's engine
    jstored = {gk: jnp.asarray(v.numpy()) for gk, v in stored.items()}
    jwarm = jsp.plan_requests(_requests(jsp), T, n_clients=K,
                              group_seed_fn=jsp.stable_group_seed,
                              lookup_fn=jstored.get, image_shape=IMG)
    jo, _ = _jax_engine(jwarm)
    np.testing.assert_allclose(warm_out.numpy(), np.asarray(jo), **SAMPLE)


def test_ddim_engine_matches_jax_and_reference():
    pj = jsp.plan_requests(_requests(jsp), T, n_clients=K, server_stride=3)
    pt = tsp.plan_requests(_requests(tsp), T, n_clients=K, server_stride=3)
    jo, jh = _jax_engine(pj, server_ddim=True)
    to, th = _port_engine(pt, server_ddim=True)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **SAMPLE)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **SAMPLE)
    ro, rh = ts.sample_plan_reference(TSP, TCP, prng.PRNGKey(2), pt, TSCHED,
                                      apply_fn, IMG)
    torch.testing.assert_close(ro, to, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        ts.check_engine_plan(False, pt)


def test_masked_steps_pass_x_through_bitwise():
    pt = tsp.plan_requests([tsp.SampleRequest(0, 5, _y(0))], T, n_clients=K)
    tables = tsp.tables_to_device(pt.tables, "cpu")
    dead = tables._replace(group_active=torch.zeros_like(tables.group_active),
                           client_active=torch.zeros_like(
                               tables.client_active))
    server, client = ts.make_sample_engine(TSCHED, apply_fn, IMG, split=True)
    key = prng.PRNGKey(1)
    hand = server(TSP, key, dead)
    x0 = server(TSP, key, dead._replace(
        group_t=dead.group_t[:, :0], group_t_prev=dead.group_t_prev[:, :0],
        group_active=dead.group_active[:, :0]))
    assert torch.equal(hand, x0)           # no server step changed x
    out = client(TCP, key, dead, hand)
    assert torch.equal(out[0], hand[0])    # no client step changed x


@pytest.mark.ragged
@pytest.mark.parametrize("n_groups,n_requests", [(4, 5), (8, 8), (5, 12)])
def test_padding_invariance(n_groups, n_requests):
    pt = tsp.plan_requests(_requests(tsp), T, n_clients=K)
    base, base_h = _port_engine(pt)
    padded = tsp.pad_plan(pt, n_groups=n_groups, n_requests=n_requests)
    out, hand = _port_engine(padded)
    R, G = pt.n_requests, pt.n_groups
    assert out.shape[0] == n_requests and hand.shape[0] == n_groups
    assert torch.equal(out[:R], base) and torch.equal(hand[:G], base_h)
