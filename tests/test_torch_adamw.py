"""The port's AdamW and LR schedules (repro_torch.optim) against the JAX
package's (repro.optim).

Same numpy parameters and gradients on both sides; the port's state is
keyed by parameter name, JAX's is a tree of the same names.  One update
and several, with the clip active, inactive and off, weight decay on and
the cosine / WSD schedules, are held to TOL (atol 2e-5 / rtol 2e-3, the
reference's fp32 tolerance, ``tests/test_kernels.py``); ``global_norm``
and the clip scale too.  A bf16 parameter is held to TOL_BF16 (its
moments, float32 on both sides, to TOL).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro.optim import schedules as jsched
from repro_torch.optim import adamw, schedules

torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=2e-3)
TOL_BF16 = dict(atol=5e-2, rtol=5e-2)
SHAPES = {"w": (8, 5), "b": (5,), "conv": (3, 3, 2, 4), "s": ()}


def _params(seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return {n: (rng.standard_normal(s) * scale).astype(np.float32)
            for n, s in SHAPES.items()}


def _jax(tree):
    return {n: jnp.asarray(a) for n, a in tree.items()}


def _torch(tree):
    return {n: torch.from_numpy(np.array(a)) for n, a in tree.items()}


def _check(tp, tstate, jp, jstate, tol=TOL):
    for n in SHAPES:
        np.testing.assert_allclose(tp[n].float().numpy(),
                                   np.asarray(jp[n], np.float32), **tol)
        for k in ("m", "v"):
            assert tstate[k][n].dtype == torch.float32
            np.testing.assert_allclose(tstate[k][n].numpy(),
                                       np.asarray(jstate[k][n]), **TOL)
    assert int(tstate["step"]) == int(jstate["step"])
    assert tstate["step"].dtype == torch.int32


def test_init_opt_state_mirrors_params():
    p = _torch(_params())
    p["h"] = torch.zeros(3, dtype=torch.bfloat16)
    st = adamw.init_opt_state(p)
    assert list(st["m"]) == list(p) and list(st["v"]) == list(p)
    for n, x in p.items():
        assert st["m"][n].shape == x.shape and st["m"][n].dtype == torch.float32
        assert not st["v"][n].any()
    assert st["step"].dtype == torch.int32 and int(st["step"]) == 0


@pytest.mark.parametrize("scale", [0.01, 1.0, 30.0])
def test_global_norm_and_clip_match_jax(scale):
    g = _params(1, scale)
    ref = jadamw.global_norm(_jax(g))
    out = adamw.global_norm(_torch(g))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    for max_norm in (0.5, 1.0, 100.0):
        jc, jn = jadamw.clip_by_global_norm(_jax(g), max_norm)
        tc, tn = adamw.clip_by_global_norm(_torch(g), max_norm)
        np.testing.assert_allclose(tn.numpy(), np.asarray(jn), **TOL)
        for n in SHAPES:
            assert tc[n].dtype == torch.float32
            np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]),
                                       **TOL)


CASES = {
    "clip_active": dict(cfg=dict(clip_norm=0.5), gscale=3.0),
    "clip_inactive": dict(cfg=dict(clip_norm=100.0), gscale=0.1),
    "no_clip": dict(cfg=dict(clip_norm=0.0), gscale=1.0),
    "weight_decay": dict(cfg=dict(weight_decay=0.01, lr=3e-3), gscale=1.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("n_updates", [1, 5])
def test_adamw_updates_match_jax(case, n_updates):
    kw = CASES[case]
    jcfg = jadamw.AdamWConfig(**kw["cfg"])
    tcfg = adamw.AdamWConfig(**kw["cfg"])
    p0 = _params(0)
    jp, tp = _jax(p0), _torch(p0)
    jstate, tstate = jadamw.init_opt_state(jp), adamw.init_opt_state(tp)
    for i in range(n_updates):
        g = _params(10 + i, kw["gscale"])
        jp, jstate, jn = jadamw.adamw_update(jp, _jax(g), jstate, jcfg)
        same, tstate, tn = adamw.adamw_update(tp, _torch(g), tstate, tcfg)
        assert same is tp                      # updated in place
        np.testing.assert_allclose(tn.numpy(), np.asarray(jn), **TOL)
    _check(tp, tstate, jp, jstate)


@pytest.mark.parametrize("name", ["constant", "cosine", "wsd"])
def test_adamw_with_schedule_matches_jax(name):
    mk = {"constant": lambda m: m.constant(),
          "cosine": lambda m: m.cosine(20, warmup=3),
          "wsd": lambda m: m.wsd(10, warmup_frac=0.2, decay_frac=0.3)}[name]
    jcfg = jadamw.AdamWConfig(lr=1e-2, schedule=mk(jsched))
    tcfg = adamw.AdamWConfig(lr=1e-2, schedule=mk(schedules))
    p0 = _params(2)
    jp, tp = _jax(p0), _torch(p0)
    jstate, tstate = jadamw.init_opt_state(jp), adamw.init_opt_state(tp)
    for i in range(6):
        g = _params(20 + i)
        jp, jstate, _ = jadamw.adamw_update(jp, _jax(g), jstate, jcfg)
        adamw.adamw_update(tp, _torch(g), tstate, tcfg)
    _check(tp, tstate, jp, jstate)


@pytest.mark.parametrize("name", ["constant", "cosine", "wsd"])
def test_schedules_match_jax(name):
    mk = {"constant": lambda m: m.constant(),
          "cosine": lambda m: m.cosine(100, warmup=10, floor=0.2),
          "wsd": lambda m: m.wsd(100)}[name]
    jf, tf = mk(jsched), mk(schedules)
    for s in (0, 1, 5, 10, 11, 50, 89, 90, 95, 100, 120):
        out = tf(torch.tensor(s, dtype=torch.int32))
        assert out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(),
                                   np.asarray(jf(jnp.int32(s))), rtol=1e-6,
                                   atol=1e-7)


def test_bf16_parameter_matches_jax():
    """A bf16 parameter keeps its dtype; its moments are float32 and the
    update runs in float32 before the cast, on both sides."""
    p0 = _params(3)
    jp = {n: jnp.asarray(a, jnp.bfloat16) for n, a in p0.items()}
    tp = {n: torch.from_numpy(np.array(a)).to(torch.bfloat16)
          for n, a in p0.items()}
    cfg = dict(lr=1e-2, weight_decay=0.01)
    jstate, tstate = jadamw.init_opt_state(jp), adamw.init_opt_state(tp)
    for i in range(3):
        g = _params(30 + i)
        jp, jstate, _ = jadamw.adamw_update(
            jp, {n: jnp.asarray(a, jnp.bfloat16) for n, a in g.items()},
            jstate, jadamw.AdamWConfig(**cfg))
        adamw.adamw_update(tp, {n: torch.from_numpy(np.array(a)).to(
            torch.bfloat16) for n, a in g.items()},
                           tstate, adamw.AdamWConfig(**cfg))
    for n in SHAPES:
        assert tp[n].dtype == torch.bfloat16
    _check(tp, tstate, jp, jstate, tol=TOL_BF16)


def test_adamw_refuses_mismatched_names():
    tp = _torch(_params())
    st = adamw.init_opt_state(tp)
    g = _torch(_params(1))
    del g["b"]
    with pytest.raises(ValueError, match="names differ"):
        adamw.adamw_update(tp, g, st, adamw.AdamWConfig())
