"""The port's DiT denoiser and collaboration entry points against the JAX
package's.

* ``init_dit``: the same threefry key gives the same weights as JAX's
  ``init_dit`` (within INIT_ATOL: ``normal``'s erfinv, weights <= 1).
* forward: JAX parameters bridged with ``bridge.load_dit`` give the same
  backbone states and ε̂ on the same numpy inputs, for reduced minitron-4b
  (dense), mamba2-2.7b (ssm) and zamba2-1.2b (hybrid) at image 16, patch
  2: S = 64 tokens, four SSD chunks of 16, longer than the reduced window
  of 16 that the bidirectional shared block must ignore.  FWD: atol 1e-4 /
  rtol 1e-3 in float32 (other summation orders).
* end to end: ``build_denoiser`` + ``sample_for_client`` against JAX at
  T = 20, cut 5 (SAMPLE: the draws differ only by erfinv ulps).
* the refusal of audio (the JAX message); without a card the entry
  points raise instead of falling back.  The MoE family is held against
  JAX in tests/test_torch_moe.py.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.configs.base import reduced as jax_reduced
from repro.core import collab as jcollab
from repro.core import dit as jdit
from repro.models import layers as jlayers
from repro_torch import bridge
from repro_torch.configs.base import get_arch, reduced
from repro_torch.core import collab as tcollab
from repro_torch.core import dit as tdit
from repro_torch.core import prng
from repro_torch.models import layers as tlayers

torch.set_num_threads(1)

INIT_ATOL = 5e-5
FWD = dict(atol=1e-4, rtol=1e-3)
SAMPLE = dict(atol=1e-4, rtol=1e-4)
ARCHS = ["minitron-4b", "mamba2-2.7b", "zamba2-1.2b"]
DIT = dict(image_size=16, channels=3, patch_size=2, n_classes=8)


@functools.lru_cache(maxsize=None)
def _jax_params(name: str, seed: int):
    jarch = jax_reduced(jax_get_arch(name))
    jcfg = jdit.DiTConfig(**DIT)
    params = jax.jit(jdit.init_dit, static_argnums=(1, 2))(
        jax.random.PRNGKey(seed), jarch, jcfg)
    return jarch, jcfg, params


def _port(name: str, seed: int):
    jarch, jcfg, jp = _jax_params(name, seed)
    arch, cfg = reduced(get_arch(name)), tdit.DiTConfig(**DIT)
    model = bridge.load_dit(tdit.DiT(arch, cfg), jax.tree.map(np.asarray, jp))
    return arch, cfg, model


def _inputs(batch=2, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, 16, 16, 3)).astype(np.float32)
    t = rng.uniform(1.0, 100.0, batch).astype(np.float32)
    y = np.eye(8, dtype=np.float32)[rng.integers(0, 8, batch)]
    return x, t, y


def test_configs_match_jax():
    for name in ARCHS + ["whisper-base", "dbrx-132b", "chatglm3-6b"]:
        port, ref = get_arch(name), jax_get_arch(name)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert dataclasses.asdict(reduced(port)) == \
            dataclasses.asdict(jax_reduced(ref))
    assert get_arch("zamba2-1.2b").torch_dtype == torch.bfloat16


@pytest.mark.parametrize("name", ARCHS)
def test_init_matches_jax(name):
    arch, cfg, bridged = _port(name, 4)
    drawn = tdit.init_dit(prng.PRNGKey(4), arch, cfg, device="cpu")
    sd_b, sd_d = bridged.state_dict(), drawn.state_dict()
    assert list(sd_b) == list(sd_d)
    for k in sd_b:
        torch.testing.assert_close(sd_d[k], sd_b[k], rtol=0,
                                   atol=INIT_ATOL, msg=k)


@pytest.mark.parametrize("name", ARCHS)
def test_forward_matches_jax(name):
    jarch, jcfg, jp = _jax_params(name, 1)
    arch, cfg, model = _port(name, 1)
    x, t, y = _inputs()
    # the backbone alone (the patch head scales ε̂ down by 1e-3)
    h = np.random.default_rng(1).standard_normal(
        (2, cfg.n_patches, arch.d_model)).astype(np.float32)
    ref_h, _ = jdit._backbone(jp, h, jarch, jdit.CPU)
    ref = jax.jit(jdit.dit_apply, static_argnums=(4, 5))(jp, x, t, y, jarch,
                                                         jcfg)
    with torch.no_grad():
        out_h = tdit._backbone(model, torch.from_numpy(h), arch)
        out = model(*(torch.from_numpy(a) for a in (x, t, y)))
    np.testing.assert_allclose(out_h.numpy(), np.asarray(ref_h), **FWD)
    assert out.shape == x.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FWD)


def test_patchify_round_trip_matches_jax():
    x = _inputs()[0]
    ref = jdit.patchify(x, 4)
    tok = tdit.patchify(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(
        tdit.unpatchify(tok, 4, 16, 16, 3).numpy(), x)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_both_forms_match_jax(dtype):
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    ref = jlayers.rmsnorm({"scale": jnp.asarray(scale).astype(jdt)},
                          jnp.asarray(x).astype(jdt))
    norm = tlayers.rmsnorm_init(64, tdt)
    tlayers.fill(norm.scale, torch.from_numpy(scale).to(tdt))
    with torch.no_grad():
        out = tlayers.rmsnorm(norm, torch.from_numpy(x).to(tdt))
    assert out.dtype == tdt
    # bf16: the same fp32 statistic and the same two bf16 roundings
    tol = FWD if dtype == "float32" else dict(atol=0, rtol=0)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), **tol)


def test_sample_for_client_matches_jax():
    """Alg. 2 end to end with the reduced Zamba2 DiT (both kernels' plain
    versions on the CPU), T = 20, cut 5."""
    name, T, t_cut = "zamba2-1.2b", 20, 5
    kw = dict(n_clients=2, T=T, t_cut=t_cut, denoiser=name, image_size=16,
              channels=3, n_classes=8, batch_size=2, dit_patch=2)
    jcfg, tcfg = jcollab.CollabConfig(**kw), tcollab.CollabConfig(**kw)
    _, japply = jcollab.build_denoiser(jax.random.PRNGKey(0), jcfg)
    init_one, tapply = tcollab.build_denoiser(prng.PRNGKey(0), tcfg,
                                              device="cpu")
    assert isinstance(init_one(prng.PRNGKey(9)), tdit.DiT)
    ps = [_jax_params(name, s)[2] for s in (5, 6, 7)]
    jstate = jcollab.CollabState(ps[0], None, ps[1:], None)
    tstate = tcollab.CollabState(
        _port(name, 5)[2], None, [_port(name, s)[2] for s in (6, 7)], None)
    y = np.eye(8, dtype=np.float32)[[3, 6]]
    ref = jcollab.sample_for_client(jstate, 1, jax.random.PRNGKey(2),
                                    jnp.asarray(y), jcfg, jax.jit(japply))
    out = tcollab.sample_for_client(tstate, 1, prng.PRNGKey(2),
                                    torch.from_numpy(y), tcfg, tapply)
    assert out.shape == (2, 16, 16, 3) and torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **SAMPLE)


def test_build_denoiser_refuses_audio_with_the_jax_message():
    kw = dict(denoiser="whisper-base")
    with pytest.raises(ValueError) as ref:
        jcollab.build_denoiser(jax.random.PRNGKey(0),
                               jcollab.CollabConfig(**kw))
    with pytest.raises(ValueError) as out:
        tcollab.build_denoiser(prng.PRNGKey(0), tcollab.CollabConfig(**kw),
                               device="cpu")
    assert str(out.value) == str(ref.value)


def test_init_dit_without_device_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    arch = reduced(get_arch("zamba2-1.2b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdit.init_dit(prng.PRNGKey(0), arch, tdit.DiTConfig(**DIT))
