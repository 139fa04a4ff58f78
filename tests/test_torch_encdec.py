"""The port's encoder-decoder (``models/encdec.py``: whisper-base,
reduced, float32) against the JAX package's on the CPU.

* ``layernorm`` with random scale and bias: float32 within TOL; bf16
  within one bf16 ulp of JAX's (both round the same float32 row once, so
  only a value that lands on a rounding boundary may differ), almost all
  bitwise.
* The port's threefry init within INIT_ATOL (erfinv ulps) of JAX's, and
  the bridge's round trip (``load_dit`` then ``dump_params``) bitwise.
* With JAX's weights bridged (``bridge.load_dit``) and numpy inputs:
  ``encode``, ``encoder_cross_kv`` and ``decode_train`` (with its K/V);
  ``encdec_loss`` and every gradient leaf, the leaves against their own
  scale as tests/test_torch_lm_train.py holds them; one
  ``make_train_step`` step (parameters and both AdamW moments);
  ``launch/shapes.py``'s prefill and decode steps are the API's;
  ``encdec_prefill`` at S_dec below, at and past the C = 16 slot cache
  (logits and the four cache tensors of every layer); a 12-step greedy
  decode from an 8-token prompt that wraps the cache (tokens equal,
  logits within TOL).  All within TOL.
* ``n_params`` / ``n_active_params`` / ``is_attention_free`` /
  ``has_decoder`` for every ``ARCH_IDS`` entry, full and reduced, equal
  to the reference's, and ``all_archs``.
* The card's tests are tests/test_torch_encdec_card.py (no JAX there).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ARCH_IDS as JAX_ARCH_IDS
from repro.configs.base import get_arch as jax_get_arch
from repro.configs.base import reduced as jax_reduced
from repro.launch import shapes as jshapes
from repro.models import api as japi
from repro.models import encdec as jencdec
from repro.models.layers import layernorm as jlayernorm
from repro.models.transformer import Runtime
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.optim.adamw import init_opt_state as jax_init_opt_state
from repro_torch import bridge
from repro_torch.configs.base import ARCH_IDS, all_archs, get_arch, reduced
from repro_torch.core import prng
from repro_torch.launch import shapes
from repro_torch.models import api, encdec
from repro_torch.models.layers import LayerNorm, layernorm
from repro_torch.optim.adamw import AdamWConfig, init_opt_state, named

torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=2e-3)
GRAD_ATOL = 2e-5             # times each leaf's largest |value|
INIT_ATOL = 5e-5
ARCH = "whisper-base"
B, S_ENC, S_DEC = 2, 24, 10


def _t(a):
    return torch.from_numpy(np.array(a))


def _setup(seed=0):
    jcfg, cfg = jax_reduced(jax_get_arch(ARCH)), reduced(get_arch(ARCH))
    jp = japi.init_params(jax.random.PRNGKey(seed), jcfg)
    tree = jax.tree.map(np.asarray, jp)
    model = bridge.load_dit(encdec.EncDec(cfg), tree)
    return jcfg, cfg, jp, tree, model


def _batch(cfg, seed, s_dec=S_DEC):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((B, S_ENC, cfg.d_model)).astype(np.float32)
    tok = rng.integers(0, cfg.vocab_size, (B, s_dec + 1)).astype(np.int32)
    labels = tok[:, 1:].copy()
    labels[0, :3] = -1                        # ignored positions
    batch = {"frames": frames, "tokens": tok[:, :s_dec], "labels": labels}
    tbatch = {k: _t(v) for k, v in batch.items()}
    tbatch["tokens"] = tbatch["tokens"].long()
    tbatch["labels"] = tbatch["labels"].long()
    return {k: jnp.asarray(v) for k, v in batch.items()}, tbatch


def _stacked(cache):
    """The port's per-layer cache as JAX's stacked dict."""
    return {k: torch.stack([c[k] for c in cache]).numpy() for k in cache[0]}


def _close_tree(port, ref, what, scaled=False):
    for path, a in jax.tree_util.tree_leaves_with_path(ref):
        b = port
        for p in path:
            b = b[p.key]
        a = np.asarray(a, np.float32)
        atol = GRAD_ATOL * float(np.abs(a).max()) if scaled else TOL["atol"]
        np.testing.assert_allclose(np.asarray(b), a, rtol=TOL["rtol"],
                                   atol=atol, err_msg=f"{what} {path}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_jax(dtype):
    rng = np.random.default_rng(4)
    d = 96
    x = (rng.standard_normal((3, 7, d)) * 3 + 1).astype(np.float32)
    scale = rng.standard_normal(d).astype(np.float32)
    bias = rng.standard_normal(d).astype(np.float32)
    jdt = getattr(jnp, dtype)
    want = np.asarray(jlayernorm(
        {"scale": jnp.asarray(scale, jdt), "bias": jnp.asarray(bias, jdt)},
        jnp.asarray(x, jdt), 1e-5).astype(jnp.float32))
    tdt = getattr(torch, dtype)
    ln = LayerNorm(d, tdt)
    with torch.no_grad():
        ln.scale.copy_(_t(scale))
        ln.bias.copy_(_t(bias))
    got = layernorm(ln, _t(x).to(tdt), 1e-5)
    assert got.dtype == tdt and tuple(got.shape) == x.shape
    got = got.detach().float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **TOL)
    else:
        # one rounding of the same float32 value: at most one bf16 ulp
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        assert np.all(np.abs(got - want) <= ulp)
        assert np.mean(got != want) < 0.01


def test_init_matches_jax_and_the_bridge_round_trips():
    jcfg, cfg, jp, tree, model = _setup()
    own = api.init_params(prng.PRNGKey(0), cfg, device="cpu")
    assert isinstance(own, encdec.EncDec)
    for a, b in zip(jax.tree.leaves(tree),
                    jax.tree.leaves(bridge.dump_params(own, tree))):
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, atol=INIT_ATOL, rtol=0)
    for a, b in zip(jax.tree.leaves(tree),
                    jax.tree.leaves(bridge.dump_params(model, tree))):
        np.testing.assert_array_equal(b, a)
    # the per-layer inits draw what the stacks hold: layer 0 from the
    # first of split(ke, L) (ke, kd = split(key, 4)[:2]); its attention
    # from the first of split(layer key)
    ke, kd = prng.split(prng.PRNGKey(0), 4)[:2]
    k0, kd0 = prng.split(ke, cfg.n_encoder_layers)[0], prng.split(
        kd, cfg.n_layers)[0]
    for built, layer in ((encdec.enc_layer_init(k0, cfg, torch.float32),
                          own.enc_layers[0]),
                         (encdec.dec_layer_init(kd0, cfg, torch.float32),
                          own.dec_layers[0]),
                         (encdec._attn_init(prng.split(k0)[0], cfg,
                                            torch.float32),
                          own.enc_layers[0].attn)):
        got, want = built.state_dict(), layer.state_dict()
        assert list(got) == list(want)
        assert all(torch.equal(got[n], want[n]) for n in want)
    # the LayerNorms keep JAX's keys, and every leaf is covered
    assert set(tree["enc_norm"]) == {"scale", "bias"}
    assert sum(p.numel() for p in model.parameters()) == sum(
        a.size for a in jax.tree.leaves(tree))


def test_encode_cross_kv_and_decode_train_match_jax():
    jcfg, cfg, jp, tree, model = _setup()
    jb, tb = _batch(cfg, 1)
    enc_j = jencdec.encode(jp, jb["frames"], jcfg)
    ks_j, vs_j = jencdec.encoder_cross_kv(jp, enc_j, jcfg)
    hid_j, (k_j, v_j) = jencdec.decode_train(jp, jb["tokens"], enc_j, jcfg,
                                             collect_kv=True)
    with torch.no_grad():
        enc = encdec.encode(model, tb["frames"], cfg)
        ks, vs = encdec.encoder_cross_kv(model, enc, cfg)
        hid, kvs = encdec.decode_train(model, tb["tokens"], enc, cfg,
                                       collect_kv=True)
        hid2, none = encdec.decode_train(model, tb["tokens"], enc, cfg,
                                         cross_kv=(ks, vs))
    np.testing.assert_allclose(enc.numpy(), np.asarray(enc_j), **TOL)
    np.testing.assert_allclose(torch.stack(ks).numpy(), np.asarray(ks_j),
                               **TOL)
    np.testing.assert_allclose(torch.stack(vs).numpy(), np.asarray(vs_j),
                               **TOL)
    np.testing.assert_allclose(hid.numpy(), np.asarray(hid_j), **TOL)
    np.testing.assert_allclose(torch.stack([k for k, _ in kvs]).numpy(),
                               np.asarray(k_j), **TOL)
    np.testing.assert_allclose(torch.stack([v for _, v in kvs]).numpy(),
                               np.asarray(v_j), **TOL)
    # the cross K/V passed in are the ones computed inside: same bits
    assert none is None and torch.equal(hid2, hid)


def test_loss_and_grads_match_jax():
    jcfg, cfg, jp, tree, model = _setup()
    jb, tb = _batch(cfg, 2)
    jloss, jgrads = jax.value_and_grad(japi.loss_fn)(jp, jb, jcfg)
    loss, grads = shapes.loss_and_grads(model, tb, cfg)
    assert loss.dtype == torch.float32 and loss.ndim == 0
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    assert set(grads) == set(named(model))
    _close_tree(bridge.dump_params(model, tree, grads), jgrads, "grad",
                scaled=True)


def test_train_step_matches_jax():
    jcfg, cfg, jp, tree, model = _setup(seed=1)
    jb, tb = _batch(cfg, 3)
    jstep = jshapes.make_train_step(jcfg, Runtime(), JAdamWConfig(lr=1e-3))
    jp2, jopt2, jm = jstep(jp, jax_init_opt_state(jp), jb)
    assert shapes.step_fn(cfg, "train_4k").__name__ == "train_step"
    step = shapes.make_train_step(cfg, AdamWConfig(lr=1e-3))
    model, opt, m = step(model, init_opt_state(model), tb)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), **TOL)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               **TOL)
    assert int(opt["step"]) == int(jopt2["step"]) == 1
    _close_tree(bridge.dump_params(model, tree), jp2, "params")
    state = bridge.dump_opt_state(model, opt, tree)
    _close_tree(state["m"], jopt2["m"], "m", scaled=True)
    _close_tree(state["v"], jopt2["v"], "v", scaled=True)


@pytest.mark.parametrize("s_dec", [10, 16, 21])
def test_prefill_matches_jax_below_at_and_past_the_cache(s_dec):
    """C = max_decoder_len = 16: zero-padded below it, the last 16
    positions at and past it."""
    jcfg, cfg, jp, tree, model = _setup()
    assert cfg.max_decoder_len == 16
    jb, tb = _batch(cfg, 5, s_dec)
    lg_j, cache_j = japi.prefill_fn(jp, jb, jcfg, cache_len=99)
    with torch.no_grad():
        lg, cache = api.prefill_fn(model, tb, cfg, cache_len=99)
        # launch/shapes.py's prefill step is api.prefill_fn
        assert torch.equal(shapes.step_fn(cfg, "prefill_32k")(model, tb)[0],
                           lg)
    assert tuple(lg.shape) == (B, 1, cfg.vocab_size)
    np.testing.assert_allclose(lg.numpy(), np.asarray(lg_j), **TOL)
    got = _stacked(cache)
    assert set(got) == set(cache_j) == {"k", "v", "cross_k", "cross_v"}
    for name, a in cache_j.items():
        assert got[name].shape == a.shape, name
        np.testing.assert_allclose(got[name], np.asarray(a), **TOL,
                                   err_msg=name)
    if s_dec < 16:
        assert not got["k"][:, :, :, s_dec:].any()
    # the zero state has the reference's shapes and types
    zero = _stacked(api.init_decode_state(cfg, B, S_ENC, device="cpu"))
    for name, a in japi.init_decode_state(jcfg, B, S_ENC).items():
        np.testing.assert_array_equal(zero[name], np.asarray(a))


def test_greedy_decode_wraps_the_cache_as_jax():
    """An 8-token prompt and 12 greedy steps at positions 8..19: the
    16-slot cache wraps at 16 (slot pos % 16)."""
    jcfg, cfg, jp, tree, model = _setup(seed=2)
    jb, tb = _batch(cfg, 6, 8)
    serve_step = shapes.step_fn(cfg, "decode_32k")   # api.decode_fn
    lg_j, st_j = japi.prefill_fn(jp, jb, jcfg)
    with torch.no_grad():
        lg, st = api.prefill_fn(model, tb, cfg)
    toks, toks_j = [], []
    for i in range(12):
        nxt_j = jnp.argmax(lg_j[:, -1], -1)[:, None].astype(jnp.int32)
        nxt = torch.argmax(lg[:, -1], dim=-1)[:, None]
        toks_j.append(np.asarray(nxt_j))
        toks.append(nxt.numpy())
        np.testing.assert_array_equal(toks[-1], toks_j[-1])
        lg_j, st_j = japi.decode_fn(jp, nxt_j, st_j, jnp.int32(8 + i), jcfg)
        with torch.no_grad():
            lg, st = serve_step(model, nxt, st, 8 + i)
        np.testing.assert_allclose(lg.numpy(), np.asarray(lg_j), **TOL,
                                   err_msg=f"step {i}")
    got = _stacked(st)
    for name, a in st_j.items():
        np.testing.assert_allclose(got[name], np.asarray(a), **TOL,
                                   err_msg=name)


@pytest.mark.parametrize("arch", JAX_ARCH_IDS)
@pytest.mark.parametrize("small", [False, True])
def test_param_counts_match_the_reference(arch, small):
    jcfg, cfg = jax_get_arch(arch), get_arch(arch)
    if small:
        jcfg, cfg = jax_reduced(jcfg), reduced(cfg)
    assert cfg.n_params() == jcfg.n_params()
    assert cfg.n_active_params() == jcfg.n_active_params()
    assert cfg.is_attention_free == jcfg.is_attention_free
    assert cfg.has_decoder == jcfg.has_decoder


def test_all_archs_and_whisper_base_count():
    assert tuple(ARCH_IDS) == tuple(JAX_ARCH_IDS)
    assert [c.name for c in all_archs()] == \
        [get_arch(a).name for a in ARCH_IDS]
    cfg = get_arch(ARCH)
    assert cfg.n_params() == 97_149_952
    # the model holds that plus its 32 LayerNorms (scale and bias, 512)
    m = encdec.EncDec(dataclasses.replace(cfg, dtype="bfloat16"),
                      device="meta")
    assert sum(p.numel() for p in m.parameters()) == \
        cfg.n_params() + 32 * 2 * cfg.d_model
