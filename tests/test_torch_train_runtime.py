"""The port's federated training runtime (train/runtime.py) against the
JAX package's, and its bitwise contracts within the port.

Against JAX, with the toy denoiser of the reference's tests (ε̂ = a·x + b)
and the same base key and data (numpy seeds):

* a 3-round run (bernoulli p 0.6 with mid-round dropout, FedAvg every 2,
  EMA 0.9): every round's cohort, tier, drops, sample and padded-cell
  counts, signatures and FedAvg flag BITWISE; losses, params, EMA and
  both moments of every model within atol 1e-7 / rtol 1e-6 (the
  reference's oracle tolerance); step counters exact;
* the reference's version-3 checkpoint after round 2 restores into the
  port, which finishes round 3 within TOL (atol 2e-5, rtol 2e-3) of the
  reference's own; and the reference restores the port's round-2 file
  to the port's state bitwise.

Within the port, bitwise: resume at the midpoint (sync, and async with
uploads in flight), an absent client frozen, the sync straggler barrier
equal to the lag-free run, async without lag equal to sync, async at full
weight with lag 1 equal to sync after ``drain``; async within atol 5e-2 of
sync; one engine signature per tier; tier caps, joins, empty data, a
whole-cohort dropout round; a version-1 checkpoint; and without a card
the runtime raises unless asked for the CPU.
"""
import functools
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import ParticipationConfig as JPart
from repro.train import TrainConfig as JConfig
from repro.train import TrainRuntime as JRuntime
from repro_torch.checkpointing import checkpoint as ckpt
from repro_torch.core import prng, trees
from repro_torch.train import ParticipationConfig, TrainConfig, TrainRuntime

torch.set_num_threads(1)

ORACLE = dict(atol=1e-7, rtol=1e-6)
TOL = dict(atol=2e-5, rtol=2e-3)
KEY = prng.PRNGKey(0)


def tiny_apply(params, x, t, y):
    return x * params["a"] + params["b"]


def tiny_init(key):
    return {"a": prng.uniform(key, (), 0.1, 0.6).requires_grad_(),
            "b": torch.zeros((), device=key.device, requires_grad=True)}


def jtiny_init(key):
    return {"a": jax.random.uniform(key, (), minval=0.1, maxval=0.6),
            "b": jnp.float32(0.0)}


def tiny_data(seed, n, img=6, n_classes=4):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, img, img, 3)).astype(np.float32)
    y = np.zeros((n, n_classes), np.float32)
    y[:, seed % n_classes] = 1.0
    return torch.from_numpy(x), torch.from_numpy(y)


def tiny_config(**kw):
    base = dict(T=60, t_cut=20, image_shape=(6, 6, 3), n_classes=4,
                batch_size=4, batches_per_round=2, lr=1e-3)
    base.update(kw)
    return TrainConfig(**base)


def make_runtime(sizes, key=KEY, **cfg_kw):
    rt = TrainRuntime(tiny_config(**cfg_kw), tiny_init, tiny_apply, key,
                      device="cpu")
    for i, n in enumerate(sizes):
        rt.register_client(*tiny_data(i, n))
    return rt


trees_equal = trees.equal


def assert_runtimes_bitwise(a, b):
    assert a.round == b.round and a.total_steps == b.total_steps
    assert trees_equal(a.server_params, b.server_params)
    assert trees_equal(a.server_opt, b.server_opt)
    assert trees_equal(a.ema_server, b.ema_server)
    for u in a.registry.uids():
        ra, rb = a.registry.get(u), b.registry.get(u)
        assert trees_equal(ra.params, rb.params), u
        assert trees_equal(ra.opt, rb.opt), u
        assert (ra.seen, ra.window_seen, ra.active) == \
            (rb.seen, rb.window_seen, rb.active), u


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

SIZES = [12, 8, 6, 12, 10]
RUN = dict(participation=dict(policy="bernoulli", p=0.6, drop_p=0.25),
           fedavg_every=2, ema_decay=0.9)
EXACT = ("round", "n_registered", "n_active", "cohort", "cohort_size",
         "strict_subset", "tier", "padded_client_slots", "real_samples",
         "padded_cells", "mid_round_drops", "engine_traces",
         "signatures_per_tier", "max_signatures_per_tier",
         "fedavg_applied", "seen_total", "stragglers", "stale_merges",
         "pending_payloads")


def _jconfig():
    return JConfig(T=60, t_cut=20, image_shape=(6, 6, 3), n_classes=4,
                   batch_size=4, batches_per_round=2, lr=1e-3,
                   participation=JPart(**RUN["participation"]),
                   fedavg_every=RUN["fedavg_every"],
                   ema_decay=RUN["ema_decay"])


def _tconfig():
    return tiny_config(participation=ParticipationConfig(
        **RUN["participation"]), fedavg_every=RUN["fedavg_every"],
        ema_decay=RUN["ema_decay"])


@functools.lru_cache(maxsize=None)
def _jax_run():
    """The reference's 3-round run, with its version-3 checkpoint after
    round 2: (reports, final state as numpy, checkpoint path)."""
    rt = JRuntime(_jconfig(), jtiny_init, tiny_apply, jax.random.PRNGKey(0))
    for i, n in enumerate(SIZES):
        x, y = tiny_data(i, n)
        rt.register_client(jnp.asarray(x.numpy()), jnp.asarray(y.numpy()))
    reps = rt.run(2)
    path = tempfile.mkdtemp() + "/jax_round2.msgpack"
    rt.save(path)
    reps += rt.run(1)
    return reps, jax.tree.map(np.asarray, rt.state_dict()), path


def _state_close(port_rt, ref_state, **tol):
    """Port runtime vs a reference state dict: params, EMA, moments
    within ``tol``, step counters and registry counters exact."""
    def close(p, r):
        for a, b in zip(trees.leaves(trees.as_tree(p)), jax.tree.leaves(r),
                        strict=True):
            np.testing.assert_allclose(a.detach().float().numpy(),
                                       np.asarray(b, np.float32), **tol)

    def opt_close(o, r):
        close(o["m"], r["m"])
        close(o["v"], r["v"])
        assert int(o["step"]) == int(r["step"])

    assert port_rt.round == ref_state["round"]
    assert port_rt.total_steps == ref_state["total_steps"]
    close(port_rt.server_params, ref_state["server_params"])
    opt_close(port_rt.server_opt, ref_state["server_opt"])
    close(port_rt.ema_server, ref_state["ema_server"])
    for u in port_rt.registry.uids():
        rec, ref = port_rt.registry.get(u), ref_state["clients"][str(u)]
        close(rec.params, ref["params"])
        opt_close(rec.opt, ref["opt"])
        assert (rec.seen, rec.window_seen, rec.window_member) == \
            (ref["seen"], ref["window_seen"], ref["window_member"])


def test_three_round_run_matches_jax():
    jreps, jstate, _ = _jax_run()
    rt = TrainRuntime(_tconfig(), tiny_init, tiny_apply, KEY, device="cpu")
    for i, n in enumerate(SIZES):
        rt.register_client(*tiny_data(i, n))
    reps = rt.run(3)
    for r, j in zip(reps, jreps, strict=True):
        for k in EXACT:
            assert r[k] == j[k], (k, r[k], j[k])
        for k in ("client_loss", "server_loss"):
            np.testing.assert_allclose(r[k], j[k], **ORACLE)
    assert any(r["strict_subset"] for r in reps)
    _state_close(rt, jstate, **ORACLE)


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    _, jstate, path = _jax_run()
    rt = TrainRuntime.restore(_tconfig(), tiny_init, tiny_apply, path,
                              device="cpu")
    assert rt.round == 2 and rt.registry.uids() == list(range(5))
    assert torch.equal(rt._key, KEY)
    for i, n in enumerate(SIZES):
        rt.attach_data(i, *tiny_data(i, n))
    rt.run(1)
    _state_close(rt, jstate, **TOL)


def test_reference_reads_the_port_checkpoint(tmp_path):
    rt = make_runtime(SIZES, **{**RUN, "participation":
                                ParticipationConfig(**RUN["participation"])})
    rt.run(2)
    path = str(tmp_path / "port.msgpack")
    rt.save(path)
    back = JRuntime.restore(_jconfig(), jtiny_init, tiny_apply, path)
    state = jax.tree.map(np.asarray, back.state_dict())
    _state_close(rt, state, atol=0, rtol=0)
    assert np.array_equal(state["base_key"]["data"], prng.key_data(KEY))


# ---------------------------------------------------------------------------
# within the port
# ---------------------------------------------------------------------------


def test_one_signature_per_tier():
    rt = make_runtime([12, 8, 6, 12, 10], participation=ParticipationConfig(
        policy="bernoulli", p=0.6, drop_p=0.25))
    reps = rt.run(8)
    last = reps[-1]
    assert any(r["strict_subset"] and r["cohort_size"] for r in reps)
    assert last["max_signatures_per_tier"] == 1
    assert rt.traces == len(last["signatures_per_tier"]) > 1
    assert sum(r.seen for r in rt.registry.records()) == \
        sum(rep["real_samples"] for rep in reps)


def test_resume_bitwise(tmp_path):
    kw = dict(participation=ParticipationConfig(policy="bernoulli", p=0.7,
                                                drop_p=0.2),
              fedavg_every=2, ema_decay=0.9)
    sizes = [10, 6, 12]
    full = make_runtime(sizes, **kw)
    full.run(5)
    half = make_runtime(sizes, **kw)
    half.run(2)
    path = str(tmp_path / "rt.msgpack")
    half.save(path)
    resumed = TrainRuntime.restore(tiny_config(**kw), tiny_init, tiny_apply,
                                   path, device="cpu")
    for i, n in enumerate(sizes):
        resumed.attach_data(i, *tiny_data(i, n))
    resumed.run(3)
    assert_runtimes_bitwise(resumed, full)


def test_absent_client_is_frozen():
    rt = make_runtime([10, 10, 10],
                      participation=ParticipationConfig(policy="full"))
    rt.run(1)
    frozen_p = trees.copy(rt.registry.get(1).params)
    frozen_o = trees.copy(rt.registry.get(1).opt)
    rt.leave(1)
    rt.run(3)
    assert trees_equal(rt.registry.get(1).params, frozen_p)
    assert trees_equal(rt.registry.get(1).opt, frozen_o)
    rt.rejoin(1)
    rt.run(1)
    assert not trees_equal(rt.registry.get(1).params, frozen_p)


def test_fedavg_skips_departed_member():
    rt = make_runtime([10, 10, 10],
                      participation=ParticipationConfig(policy="full"),
                      fedavg_every=2)
    rt.run(1)
    frozen = trees.copy(rt.registry.get(1).params)
    rt.leave(1)
    rt.run(1)
    assert trees_equal(rt.registry.get(1).params, frozen)
    assert trees_equal(rt.registry.get(0).params, rt.registry.get(2).params)
    assert rt.registry.get(0).params is not rt.registry.get(2).params


def test_tier_cap_join_and_empty_data():
    rt = make_runtime([8] * 5,
                      participation=ParticipationConfig(policy="full"),
                      tier_cap=2)
    reps = rt.run(4)
    assert all(0 < r["cohort_size"] <= 2 and r["tier"] <= 2 for r in reps)
    assert len({tuple(r["cohort"]) for r in reps}) > 1
    uid = rt.register_client(*tiny_data(5, 9))
    empty = rt.register_client(None, None)
    rt.run(6)
    assert rt.registry.get(uid).seen > 0
    assert rt.registry.get(empty).seen == 0
    assert all(torch.isfinite(l).all() for r in rt.registry.records()
               for l in trees.leaves(r.params))


def test_ema_track():
    rt = make_runtime([8], participation=ParticipationConfig(policy="full"),
                      ema_decay=0.5)
    s0 = trees.copy(rt.server_params)
    rt.run(1)
    for e, a, b in zip(trees.leaves(rt.ema_server), trees.leaves(s0),
                       trees.leaves(rt.server_params)):
        assert torch.equal(e, 0.5 * a + 0.5 * b)
    assert rt.sampling_server_params() is rt.ema_server


def test_whole_cohort_dropout_round(monkeypatch):
    import repro_torch.train.runtime as rt_mod
    rt = make_runtime([10, 8, 12], participation=ParticipationConfig(
        policy="full", drop_p=1.0), fedavg_every=1)
    before = {u: (trees.copy(rt.registry.get(u).params),
                  trees.copy(rt.registry.get(u).opt))
              for u in rt.registry.uids()}
    monkeypatch.setattr(rt_mod, "sample_drops",
                        lambda cfg, k, r, cohort, nb: {int(u): 0
                                                       for u in cohort})
    rep = rt.run_round()
    assert rep["cohort_size"] == 3 and rep["real_samples"] == 0
    assert rep["tier"] == 0 and rep["client_loss"] == 0.0
    assert not rep["fedavg_applied"] and rt.round == 1
    for u, (p, o) in before.items():
        assert trees_equal(rt.registry.get(u).params, p)
        assert trees_equal(rt.registry.get(u).opt, o)


LAGGY = dict(policy="bernoulli", p=0.7, drop_p=0.2)


def test_sync_straggler_barrier_is_pure_wall_clock():
    kw = dict(fedavg_every=2)
    lagged = make_runtime([10, 6, 12], participation=ParticipationConfig(
        lag_p=0.8, lag_max=2, **LAGGY), lag_s=0.002, **kw)
    free = make_runtime([10, 6, 12],
                        participation=ParticipationConfig(**LAGGY), **kw)
    rl = lagged.run(4)
    free.run(4)
    assert_runtimes_bitwise(lagged, free)
    assert sum(r["stragglers"] for r in rl) > 0
    assert sum(r["barrier_stall_s"] for r in rl) > 0.0
    assert all(r["pending_payloads"] == 0 for r in rl)


def test_async_without_lag_is_bitwise_sync():
    common = dict(participation=ParticipationConfig(**LAGGY),
                  fedavg_every=2, ema_decay=0.9)
    a = make_runtime([10, 6, 12], async_mode=True, **common)
    s = make_runtime([10, 6, 12], **common)
    a.run(5)
    s.run(5)
    assert a._pending == []
    assert_runtimes_bitwise(a, s)


def test_async_full_weight_lag1_drain_is_bitwise_sync():
    part = ParticipationConfig(lag_p=0.6, lag_max=1, **LAGGY)
    a = make_runtime([10, 6, 12], participation=part, async_mode=True,
                     stale_alpha=1.0)
    s = make_runtime([10, 6, 12], participation=part)
    ra = a.run(6)
    s.run(6)
    assert sum(r["stragglers"] for r in ra) > 0
    assert sum(r["stale_merges"] for r in ra) > 0
    a.drain()
    assert_runtimes_bitwise(a, s)


def test_async_tolerance_vs_sync():
    part = ParticipationConfig(lag_p=0.5, lag_max=2, **LAGGY)
    a = make_runtime([10, 6, 12], participation=part, async_mode=True,
                     fedavg_every=2)
    s = make_runtime([10, 6, 12], participation=part, fedavg_every=2)
    ra = a.run(8)
    s.run(8)
    merged = a.drain()
    n_straggled = sum(r["stragglers"] for r in ra)
    assert 0 < sum(r["stale_merges"] for r in ra) + merged <= n_straggled
    assert a._pending == []
    pairs = [(a.server_params, s.server_params)] + [
        (a.registry.get(u).params, s.registry.get(u).params)
        for u in a.registry.uids()]
    for pa, pb in pairs:
        for x, y in zip(trees.leaves(pa), trees.leaves(pb)):
            assert torch.isfinite(x).all()
            np.testing.assert_allclose(x.detach().numpy(),
                                       y.detach().numpy(), atol=5e-2)


def test_async_busy_client_sits_out_and_leave_drops_its_upload():
    part = ParticipationConfig(policy="full", lag_p=1.0, lag_max=2)
    rt = make_runtime([8, 8], participation=part, async_mode=True)
    r0 = rt.run_round()
    assert r0["stragglers"] == 2 and r0["pending_payloads"] == 2
    busy = {p["uid"] for p in rt._pending}
    r1 = rt.run_round()
    assert not busy.intersection(r1["cohort"])
    rt2 = make_runtime([8, 8], participation=part, async_mode=True)
    rt2.run_round()
    frozen = trees.copy(rt2.registry.get(0).params)
    rt2.leave(0)
    assert {int(p["uid"]) for p in rt2._pending} == {1}
    rt2.rejoin(0)
    assert trees_equal(rt2.registry.get(0).params, frozen)


def test_async_resume_bitwise_with_pending(tmp_path):
    part = ParticipationConfig(lag_p=0.8, lag_max=3, **LAGGY)
    kw = dict(participation=part, async_mode=True, fedavg_every=2,
              ema_decay=0.9)
    full = make_runtime([10, 6, 12], **kw)
    full.run(6)
    half = make_runtime([10, 6, 12], **kw)
    half.run(3)
    assert half._pending
    path = str(tmp_path / "rt_async.msgpack")
    half.save(path)
    resumed = TrainRuntime.restore(tiny_config(**kw), tiny_init, tiny_apply,
                                   path, device="cpu")
    for i, n in enumerate([10, 6, 12]):
        resumed.attach_data(i, *tiny_data(i, n))
    assert len(resumed._pending) == len(half._pending)
    resumed.run(3)
    full.drain()
    resumed.drain()
    assert_runtimes_bitwise(resumed, full)


def test_v1_checkpoint_still_restores(tmp_path):
    rt = make_runtime([8], participation=ParticipationConfig(policy="full"))
    rt.run(1)
    state = rt.state_dict()
    state["version"] = 1
    del state["pending"]
    path = str(tmp_path / "v1.msgpack")
    ckpt.save(path, state)
    restored = TrainRuntime.restore(tiny_config(), tiny_init, tiny_apply,
                                    path, device="cpu")
    assert restored._pending == [] and restored.round == rt.round
    assert trees_equal(restored.server_params, rt.server_params)
    state["version"] = 99
    ckpt.save(path, state)
    with pytest.raises(ValueError, match="version"):
        TrainRuntime.restore(tiny_config(), tiny_init, tiny_apply, path,
                             device="cpu")


def test_runtime_without_device_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TrainRuntime(tiny_config(), tiny_init, tiny_apply, KEY)
