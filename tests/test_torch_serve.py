"""The port's serve runtime against the JAX package's, and its own bitwise
contracts.

* Same queue, same key, same toy denoiser: outputs within SAMPLE (the
  erfinv few-ulp noise differences of test_torch_prng.py, riding the
  sweep); every integer report counter, the signature counts and the
  report's key set BITWISE equal (the key set but for the port's
  starvation-probe counters).
* Inside the port, bitwise: warm == cold == fifo, pipelined ==
  sequential, continuous == depth, obs on == off; the CLI smoke passes
  in-process on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.schedules import DiffusionSchedule as JaxSchedule
from repro.serve import ServeConfig as JaxConfig
from repro.serve import ServeRuntime as JaxRuntime
from repro.serve import runtime as jax_runtime
from repro_torch.core import prng
from repro_torch.core.schedules import DiffusionSchedule
from repro_torch.launch import collab_serve
from repro_torch.obs import DELTA, ObsConfig
from repro_torch.serve import ServeConfig, ServeRuntime
from repro_torch.serve import runtime as torch_runtime

torch.set_num_threads(1)

SAMPLE = dict(rtol=1e-4, atol=1e-4)
T = 16
IMG = (4, 4, 3)
B, NC, K = 2, 3, 3
INT_KEYS = ("requests", "waves", "buckets", "server_calls_physical",
            "server_calls_logical", "client_calls_physical",
            "client_calls_logical", "padded_model_calls",
            "server_calls_saved_by_dedup", "server_calls_saved_by_cache",
            "requests_from_cache", "engine_traces", "signatures_per_bucket",
            "max_signatures_per_bucket", "slo_tracked", "slo_misses",
            "cache_hits", "cache_misses", "cache_insertions",
            "cache_evictions", "cache_rejected", "cache_entries",
            "cache_bytes")
# the port's starvation probe (CUDA events between engine steps) has no
# counterpart in the JAX package: its two report keys are the port's own
PROBE_KEYS = {"probed_steps": DELTA, "starved_steps": DELTA}


def apply_fn(p, x, t, y):
    return x * p["a"] + p["b"]


JSP = {"a": jnp.float32(0.2), "b": jnp.float32(0.0)}
JCP = {"a": jnp.asarray([0.1, 0.3, 0.5], jnp.float32),
       "b": jnp.zeros((K,), jnp.float32)}
TSP = {"a": torch.tensor(0.2), "b": torch.tensor(0.0)}
TCP = {"a": torch.tensor([0.1, 0.3, 0.5]), "b": torch.zeros(K)}


def _y(label):
    return np.broadcast_to(np.eye(NC, dtype=np.float32)[label],
                           (B, NC)).copy()


def _queue(mod):
    """Two cut-depth buckets x two labels with repeats inside and across
    waves, plus a GM request."""
    spec = [(0, 4, 0), (1, 8, 0), (2, 4, 0), (0, 4, 1), (1, 8, 0), (2, 8, 1),
            (0, 4, 0), (1, 4, 1), (2, 0, 1)]
    return [mod.SampleRequest(c, tc, _y(l)) for c, tc, l in spec]


def _port(seed=0, obs=None, **over):
    over.setdefault("max_wave", 4)
    return ServeRuntime(ServeConfig(T=T, image_shape=IMG, **over), TSP, TCP,
                        apply_fn, DiffusionSchedule.linear(T, device="cpu"),
                        prng.PRNGKey(seed), obs=obs, device="cpu")


def _jax(seed=0, **over):
    over.setdefault("max_wave", 4)
    return JaxRuntime(JaxConfig(T=T, image_shape=IMG, **over), JSP, JCP,
                      apply_fn, JaxSchedule.linear(T),
                      jax.random.PRNGKey(seed))


def _same(outs_a, outs_b):
    assert len(outs_a) == len(outs_b)
    for a, b in zip(outs_a, outs_b):
        assert torch.equal(a, b)


def assert_runtime_matches_jax(over, passes):
    """Serve the same queue through both packages; outputs within SAMPLE,
    integer counters and report keys equal (test_torch_serve_parity.py
    covers the other policies)."""
    jr, tr = _jax(**over), _port(**over)
    for _ in range(passes):                  # cold, then warm
        jo, jrep = jr.process(_queue(jax_runtime))
        to, trep = tr.process(_queue(torch_runtime))
        for a, b in zip(to, jo):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **SAMPLE)
        assert set(trep) == set(jrep) | set(PROBE_KEYS)
        for k in INT_KEYS:
            if k in jrep:
                assert trep[k] == jrep[k], k


@pytest.mark.parametrize("over,passes", [
    (dict(policy="depth"), 2), (dict(policy="fifo", cache=False), 1)],
    ids=["depth", "fifo"])
def test_runtime_matches_jax(over, passes):
    assert_runtime_matches_jax(over, passes)


def test_report_schema_matches_jax():
    assert torch_runtime._SERVE_REPORT_SCHEMA == \
        dict(jax_runtime._SERVE_REPORT_SCHEMA, **PROBE_KEYS)
    assert set(_port()._empty_report()) == \
        set(_jax()._empty_report()) | set(PROBE_KEYS)


def test_key_fingerprint_and_rotation_match_jax():
    assert torch_runtime._key_fingerprint(prng.PRNGKey(5)) == \
        jax_runtime._key_fingerprint(jax.random.PRNGKey(5))
    tr, jr = _port(), _jax()
    assert tr.rotate_for_epoch(3, prng.PRNGKey(9))
    assert jr.rotate_for_epoch(3, jax.random.PRNGKey(9))
    assert tr._key_fp == jr._key_fp
    assert not tr.rotate_for_epoch(3, prng.PRNGKey(9))     # idempotent


def test_warm_cold_fifo_bitwise():
    warm, cold = _port(cache=True), _port(cache=False)
    fifo = _port(policy="fifo", cache=False)
    q = _queue(torch_runtime)
    for p in range(3):
        wo, wrep = warm.process(q)
        _same(wo, cold.process(q)[0])
        _same(wo, fifo.process(q)[0])
        if p:
            assert wrep["cache_hits"] >= 1
            assert wrep["server_calls_physical"] == 0
        if p == 2:                  # steady: no new signature anywhere
            assert wrep["engine_traces"] == 0
            assert wrep["max_signatures_per_bucket"] == 1


def test_pipelined_equals_sequential_bitwise():
    pipe = _port(pipeline=True, straggle_s=0.001)
    seq = _port(pipeline=False, straggle_s=0.001)
    q = _queue(torch_runtime)
    for _ in range(2):
        po, prep = pipe.process(q)
        so, srep = seq.process(q)
        _same(po, so)
        assert prep["cache_hits"] == srep["cache_hits"]


def test_continuous_equals_depth_bitwise():
    cont, depth = _port(policy="continuous"), _port(policy="depth")
    q = _queue(torch_runtime)
    tickets = cont.submit(q, slo_s=60.0)
    while cont.busy:
        cont.poll(block=True)
    rep = cont.finish_report()
    _same([t.output for t in tickets], depth.process(q)[0])
    assert rep["slo_tracked"] == len(q) and rep["slo_misses"] == 0


def test_obs_on_equals_off_bitwise(tmp_path):
    off = _port()
    on = _port(obs=ObsConfig(jsonl_path=str(tmp_path / "s.jsonl"),
                             trace_path=str(tmp_path / "t.json")))
    q = _queue(torch_runtime)
    for _ in range(2):
        oo, orep = off.process(q)
        no, nrep = on.process(q)
        _same(oo, no)
        assert orep["engine_traces"] == nrep["engine_traces"]
    on.obs.close()
    names = {s.name for s in on.obs.spans()}
    assert {"wave", "plan", "server_scan", "client_scan"} <= names


def test_recompile_guard_counts_first_sightings():
    from repro_torch.obs.metrics import Counter, RecompileGuard
    guard = RecompileGuard(Counter("t"))
    f = guard.wrap(lambda x, n: x.sum() * n)
    f(torch.zeros(2, 3), 1)
    f(torch.ones(2, 3), 1)           # same signature
    assert guard.count == 1
    f(torch.zeros(4, 3), 1)          # new shape
    f(torch.zeros(2, 3), 2)          # new static argument
    f(torch.zeros(2, 3, dtype=torch.float64), 1)     # new dtype
    assert guard.count == 4


def test_collab_serve_smoke_cpu():
    steady = collab_serve.main(["--smoke", "--device", "cpu"])
    assert steady["engine_traces"] == 0 and steady["cache_hits"] >= 1
