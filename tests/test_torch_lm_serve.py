"""The port's LM serving path (``models/api.py``: prefill, then cached
decode; ``launch/serve.py``) against the JAX package's on the CPU.

* Against JAX, for every decoder architecture of
  tests/test_decode_consistency.py (reduced, float32): the port's own
  threefry init within INIT_ATOL (erfinv ulps); with the JAX weights
  bridged (``bridge.load_dit``), the prefill's logits, its decode state,
  one decode step's logits and the state after it, as JAX's stacked tree
  (``_stacked``), within TOL (measured ≤ 5e-6).
* The reference's three decode contracts inside the port, at its
  tolerance (< 1e-3): prefill + one decode step equals the full forward
  at position S; a decode far past a reduced model's window (16) through
  the ring; a greedy multi-step decode equals repeated full forwards.
* ``_to_ring`` (pad, roll) and ``decode_attention``'s ring mask against
  JAX's, exactly and within TOL.
* ``prng.categorical`` against ``jax.random.categorical``: equal indices.
* ``launch/serve.py --reduced --device cpu`` decodes JAX's tokens (greedy
  and sampled), whisper-base's encoder-decoder included.  The
  encoder-decoder's own parity tests are tests/test_torch_encdec.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ARCH_IDS
from repro.configs.base import get_arch as jax_get_arch
from repro.configs.base import reduced as jax_reduced
from repro.launch import serve as jserve
from repro.models import api as japi
from repro.models import attention as jattn
from repro.models import transformer as jtransformer
from repro_torch import bridge
from repro_torch.configs.base import get_arch, reduced
from repro_torch.core import prng
from repro_torch.launch import serve as tserve
from repro_torch.models import api
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttransformer
from repro_torch.models.hybrid import HybridLM, hybrid_forward
from repro_torch.models.transformer import LM, lm_forward, logits_of

torch.set_num_threads(1)

DECODER_ARCHS = [a for a in ARCH_IDS if a != "whisper_base"]
INIT_ATOL = 5e-5
TOL = dict(atol=2e-5, rtol=2e-3)
CONSISTENCY = 1e-3               # tests/test_decode_consistency.py


def _t(a):
    return torch.from_numpy(np.array(a))


def _model(cfg):
    return (HybridLM if cfg.family in api.SSM_FAMILIES else LM)(cfg)


def _stack_items(items):
    if isinstance(items[0], dict):
        return {k: _stack_items([it[k] for it in items]) for k in items[0]}
    return torch.stack(items)


def _stacked(state):
    """The port's decode state (lists of per-layer dicts) as JAX's
    stacked tree: a list of L dicts becomes a dict of (L, ...) tensors,
    nested lists nest the leading axes (the hybrid's (G, g, ...)), and
    an empty list (no shared groups) becomes None."""
    if isinstance(state, dict):
        return {k: _stacked(v) for k, v in state.items()}
    if isinstance(state, list):
        return _stack_items([_stacked(s) for s in state]) if state else None
    return state


def _leaves_close(port_tree, ref_tree, **tol):
    """Every leaf of JAX's tree against the port's at the same path; an
    empty stack (0 layers) is None in the port."""
    for path, a in jax.tree_util.tree_leaves_with_path(ref_tree):
        b = port_tree
        for p in path:
            b = b[p.key] if b is not None else None
        if b is None:
            assert np.asarray(a).size == 0, path
            continue
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **tol,
                                   err_msg=str(path))


def _inputs(cfg, B, S, key):
    tok = jax.random.randint(key, (B, S + 1), 0, cfg.vocab_size)
    batch = {"tokens": tok[:, :S]}
    P = cfg.n_vision_tokens if cfg.family == "vlm" else 0
    if cfg.family == "vlm":
        batch["vision_embeds"] = jax.random.normal(key, (B, P, cfg.d_model))
    return tok, batch, P


@pytest.mark.parametrize("arch", DECODER_ARCHS)
def test_prefill_and_decode_match_jax(arch):
    jcfg, cfg = jax_reduced(jax_get_arch(arch)), reduced(get_arch(arch))
    key = jax.random.PRNGKey(0)
    B, S = 2, 24
    tok, batch, P = _inputs(jcfg, B, S, key)
    jp = japi.init_params(key, jcfg)
    own = api.init_params(prng.PRNGKey(0), cfg, device="cpu")
    ref_tree = jax.tree.map(np.asarray, jp)
    for a, b in zip(jax.tree.leaves(ref_tree),
                    jax.tree.leaves(bridge.dump_params(own, ref_tree))):
        np.testing.assert_allclose(b, a, atol=INIT_ATOL, rtol=0)
    model = bridge.load_dit(_model(cfg), ref_tree)
    C = S + P + 8
    lg_j, st_j = japi.prefill_fn(jp, batch, jcfg, cache_len=C)
    dec_j, st2_j = japi.decode_fn(jp, tok[:, S:S + 1], st_j,
                                  jnp.int32(S + P), jcfg)
    tbatch = {k: _t(v) for k, v in batch.items()}
    with torch.no_grad():
        lg, st = api.prefill_fn(model, tbatch, cfg, cache_len=C)
        dec, st2 = api.decode_fn(model, _t(tok[:, S:S + 1]), st, S + P, cfg)
    np.testing.assert_allclose(lg.numpy(), np.asarray(lg_j), **TOL)
    np.testing.assert_allclose(dec.numpy(), np.asarray(dec_j), **TOL)
    _leaves_close(_stacked(st), st_j, **TOL)
    _leaves_close(_stacked(st2), st2_j, **TOL)
    # the zero state has the reference's shapes and types
    zero_j = japi.init_decode_state(jcfg, B, C)
    zero = _stacked(api.init_decode_state(cfg, B, C, device="cpu"))
    _leaves_close(zero, zero_j, atol=0, rtol=0)


def _port_lm(arch, seed=0):
    cfg = reduced(get_arch(arch))
    return cfg, api.init_params(prng.PRNGKey(seed), cfg, device="cpu")


def _full_logits(model, cfg, tok, prefix=None):
    if cfg.family in api.SSM_FAMILIES:
        hid, _, _ = hybrid_forward(model, tok, cfg)
    else:
        hid, _, _ = lm_forward(model, tok, cfg, embeds_prefix=prefix)
    return logits_of(model, hid)


@pytest.mark.parametrize("arch", DECODER_ARCHS)
@torch.no_grad()
def test_prefill_decode_matches_full_forward(arch):
    cfg, model = _port_lm(arch)
    B, S = 2, 24
    tok = prng.randint(prng.PRNGKey(1), (B, S + 1), 0, cfg.vocab_size).long()
    batch = {"tokens": tok[:, :S]}
    P = cfg.n_vision_tokens if cfg.family == "vlm" else 0
    if P:
        batch["vision_embeds"] = prng.normal(prng.PRNGKey(2),
                                             (B, P, cfg.d_model))
    _, cache = api.prefill_fn(model, batch, cfg, cache_len=S + P + 8)
    lg_dec, _ = api.decode_fn(model, tok[:, S:S + 1], cache, S + P, cfg)
    full = _full_logits(model, cfg, tok, batch.get("vision_embeds"))
    assert (lg_dec - full[:, S + P:S + P + 1]).abs().max() < CONSISTENCY


@torch.no_grad()
def test_sliding_window_ring_long_decode():
    """Granite's windowed cache: a prompt of 40 > 2 × the window (16) in a
    ring of 16, then decode steps past it, each against a full forward."""
    cfg, model = _port_lm("granite-8b")
    assert cfg.sliding_window == 16
    B, S, N = 1, 40, 5
    tok = prng.randint(prng.PRNGKey(3), (B, S + N), 0, cfg.vocab_size).long()
    _, cache = api.prefill_fn(model, {"tokens": tok[:, :S]}, cfg,
                              cache_len=cfg.sliding_window)
    assert cache[0]["k"].shape[2] == cfg.sliding_window
    full = _full_logits(model, cfg, tok)
    for i in range(N):
        lg, cache = api.decode_fn(model, tok[:, S + i:S + i + 1], cache,
                                  S + i, cfg)
        assert (lg - full[:, S + i:S + i + 1]).abs().max() < CONSISTENCY


@pytest.mark.parametrize("arch", ["mamba2_2p7b", "zamba2_1p2b"])
@torch.no_grad()
def test_ssm_multi_step_decode(arch):
    """Greedy multi-token decode equals repeated full forwards (the SSM
    state carried across steps)."""
    cfg, model = _port_lm(arch)
    B, S, N = 1, 12, 4
    tok = prng.randint(prng.PRNGKey(4), (B, S), 0, cfg.vocab_size).long()
    lg, state = api.prefill_fn(model, {"tokens": tok}, cfg,
                               cache_len=S + N + 1)
    seq = tok
    for i in range(N):
        nxt = torch.argmax(lg[:, -1:, :], dim=-1)
        seq = torch.cat([seq, nxt], dim=1)
        lg, state = api.decode_fn(model, nxt, state, S + i, cfg)
        full = _full_logits(model, cfg, seq)[:, -1:]
        assert (lg - full).abs().max() < CONSISTENCY


@pytest.mark.parametrize("S,C", [(5, 8), (8, 8), (20, 8), (17, 16)])
def test_to_ring_matches_jax(S, C):
    k = np.random.default_rng(S).normal(size=(2, 3, S, 4)).astype(np.float32)
    ref = jtransformer._to_ring(jnp.asarray(k), C, S)
    out = ttransformer._to_ring(_t(k), C, S)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("pos", [3, 15, 16, 40])
def test_decode_attention_ring_mask_matches_jax(pos):
    """One step of ``decode_attention`` at a window of 6 in a ring of 8,
    before, at and far past the ring's wrap: the same cache, output and
    written slot as JAX's."""
    d, H, Hkv, dh, C, W = 32, 4, 2, 8, 8, 6
    jp = jattn.attn_init(jax.random.PRNGKey(7), d, H, Hkv, dh, jnp.float32)
    m = tattn.Attention(d, H, Hkv, dh, torch.float32)
    bridge.load_params(m, jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(pos)
    cache = {n: rng.normal(size=(2, Hkv, C, dh)).astype(np.float32)
             for n in ("k", "v")}
    x = rng.normal(size=(2, 1, d)).astype(np.float32)
    kw = dict(n_heads=H, n_kv_heads=Hkv, head_dim=dh, window=W)
    ref, rc = jattn.decode_attention(jp, x, cache, jnp.int32(pos), **kw)
    with torch.no_grad():
        out, oc = tattn.decode_attention(m, _t(x), {n: _t(v) for n, v in
                                                    cache.items()}, pos,
                                         **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(oc[n].numpy(), np.asarray(rc[n]), **TOL)
        untouched = np.arange(C) != pos % C
        np.testing.assert_array_equal(oc[n].numpy()[:, :, untouched],
                                      cache[n][:, :, untouched])


@pytest.mark.parametrize("shape", [(4, 32), (3, 5, 17), (1000,)])
def test_categorical_matches_jax(shape):
    logits = np.random.default_rng(len(shape)).normal(
        size=shape).astype(np.float32) * 3
    for seed in range(3):
        ref = jax.random.categorical(jax.random.PRNGKey(seed),
                                     jnp.asarray(logits))
        out = prng.categorical(prng.PRNGKey(seed), _t(logits))
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    # axis 0
    ref = jax.random.categorical(jax.random.PRNGKey(9),
                                 jnp.asarray(logits), axis=0)
    out = prng.categorical(prng.PRNGKey(9), _t(logits), axis=0)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("arch,extra", [
    ("zamba2-1.2b", []), ("granite-8b", []),
    ("mamba2-2.7b", ["--no-greedy", "--temperature", "0.7"])])
def test_serve_cli_decodes_jax_tokens(arch, extra, capsys):
    argv = ["--arch", arch, "--reduced", "--batch", "2", "--prompt-len",
            "12", "--new-tokens", "6"] + extra
    ref = np.asarray(jserve.main(argv))
    out = tserve.main(argv + ["--device", "cpu"])
    assert out.shape == (2, 6)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert "tok/s" in capsys.readouterr().out


@pytest.mark.parametrize("extra", [[], ["--no-greedy", "--temperature",
                                           "0.7"]])
def test_audio_serve_cli_decodes_jax_tokens(extra, capsys):
    """whisper-base (reduced): 24 stub frames, the prompt's first 8 tokens
    as the decoder's prompt, 12 new tokens from position 8 on, through
    the 16-slot cache's wrap."""
    argv = ["--arch", "whisper-base", "--reduced", "--batch", "2",
            "--prompt-len", "24", "--new-tokens", "12"] + extra
    ref = np.asarray(jserve.main(argv))
    out = tserve.main(argv + ["--device", "cpu"])
    assert out.shape == (2, 12)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert "prefill: (2, 1, 512)" in capsys.readouterr().out


def test_entry_points_want_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    cfg = reduced(get_arch("granite-8b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.init_params(prng.PRNGKey(0), cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.init_decode_state(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.main(["--arch", "granite-8b", "--reduced"])


def test_tma_encode_cache_keys_on_pointer_and_every_word():
    """The LM prefill's tensor maps go through the 16-entry encode cache
    of csrc/hopper.cuh beside the DiT's: an entry is reused only for the
    same base pointer and all MAP_WORDS words of geometry (dims, strides,
    box, swizzle), and the LM's and the DiT's maps over the sequence differ
    in them."""
    from pathlib import Path
    from repro_torch.kernels import tma
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.kernels.ssd_scan import kernel as skernel
    src = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" /
           "csrc" / "hopper.cuh").read_text()
    assert f"constexpr int kMapWords = {tma.MAP_WORDS};" in src
    assert "long long geometry[kMapWords];" in src
    assert ("cache[i].base == base &&\n        memcmp(cache[i].geometry, "
            "geometry, sizeof(cache[i].geometry)) == 0") in src
    lm = fkernel.tma_maps(4, 32, 32, 512, 64) + skernel.tma_maps(4, 512, 64,
                                                                  64)
    dit = fkernel.tma_maps(4, 32, 32, 64, 64) + skernel.tma_maps(4, 64, 64,
                                                                  64)
    for a, b in zip(lm, dit):
        assert len(a.packed()) == tma.MAP_WORDS
    # every map over the sequence differs (the SSD final state's does not
    # depend on S: one map serves both)
    for i in (0, 1, 2, 3):
        assert lm[i].packed() != dit[i].packed()
    assert lm[4] == dit[4]
