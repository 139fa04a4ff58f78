"""The port's LM training path (``api.loss_fn``, ``launch/shapes.py``'s
``make_train_step``, ``launch/train.py``) against the JAX package's on the
CPU.

* For one reduced float32 architecture of each family — dense
  (granite-8b), moe (dbrx-132b: the grouped matmul's plain version on the
  CPU is differentiable), vlm (internvl2-76b), ssm (mamba2-2.7b) and
  hybrid (zamba2-1.2b: the reduced config applies the shared block after
  each of its 3 layers, so its gradients sum over 3 applications) — with
  JAX's weights bridged (``bridge.load_dit``) and numpy tokens and labels
  (some labels −1, ignored): the loss against ``repro.models.api.loss_fn``
  within TOL, and every gradient leaf, mapped back to JAX's layout
  (``bridge.dump_params``), against ``jax.value_and_grad`` within
  GRAD_TOL: elementwise TOL's rtol, and an atol of GRAD_ATOL times the
  leaf's largest value (gradients run from ~1e-1 down to ~1e-6, where a
  fixed atol would check nothing).  The moe case also through the
  expert-parallel modes (``moe_ep``, ``moe_ep2d``) on a one-rank mesh
  against JAX's on a (1, 1) mesh.
* One ``make_train_step`` step (AdamW, lr 1e-3, clip 1.0): the loss, the
  grad norm, and the parameters and both moments after it against JAX's
  ``make_train_step`` within TOL (the moments against their own scale, as
  the gradients).
* ``cross_entropy``'s mask and count against JAX's; the audio family's
  batch (stub frames, tokens cut to ``max_decoder_len``) and its loss
  against the reference's (tests/test_torch_encdec.py holds the
  encoder-decoder's gradients and AdamW step); the step builders,
  ``skip_reason`` and the input shapes against the reference's.
* The CLI (``launch/train.py``) is tests/test_torch_lm_train_cli.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs.base import get_arch as jax_get_arch
from repro.configs.base import get_shape as jax_get_shape
from repro.configs.base import reduced as jax_reduced
from repro.launch import shapes as jshapes
from repro.models import api as japi
from repro.models.transformer import Runtime
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.optim.adamw import init_opt_state as jax_init_opt_state
from repro_torch import bridge
from repro_torch.configs.base import get_arch, get_shape, reduced
from repro_torch.core import prng
from repro_torch.launch import shapes, train
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import api
from repro_torch.models.hybrid import HybridLM
from repro_torch.models.transformer import LM, cross_entropy
from repro_torch.optim.adamw import AdamWConfig, init_opt_state, named

torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=2e-3)
INIT_ATOL = 5e-5             # prng.normal against jax.random.normal
GRAD_ATOL = 2e-5             # times each leaf's largest |value|
ARCHS = ["granite-8b", "dbrx-132b", "internvl2-76b", "mamba2-2.7b",
         "zamba2-1.2b"]
B, S = 2, 24


def _model(cfg):
    return (HybridLM if cfg.family in api.SSM_FAMILIES else LM)(cfg)


def _setup(arch, seed=0):
    jcfg, cfg = jax_reduced(jax_get_arch(arch)), reduced(get_arch(arch))
    jp = japi.init_params(jax.random.PRNGKey(seed), jcfg)
    tree = jax.tree.map(np.asarray, jp)
    model = bridge.load_dit(_model(cfg), tree)
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    labels = tok[:, 1:].copy()
    labels[0, :3] = -1                        # ignored positions
    batch = {"tokens": tok[:, :S], "labels": labels}
    if cfg.family == "vlm":
        batch["vision_embeds"] = rng.standard_normal(
            (B, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tbatch["tokens"] = tbatch["tokens"].long()
    tbatch["labels"] = tbatch["labels"].long()
    return jcfg, cfg, jp, tree, model, jbatch, tbatch


def _close_tree(port, ref, what, scaled=False):
    """Every leaf of JAX's tree against the port's at the same path, at
    TOL's rtol and TOL's atol, or (``scaled``) GRAD_ATOL times the leaf's
    largest |value|."""
    for path, a in jax.tree_util.tree_leaves_with_path(ref):
        b = port
        for p in path:
            b = b[p.key]
        a = np.asarray(a, np.float32)
        atol = GRAD_ATOL * float(np.abs(a).max()) if scaled else TOL["atol"]
        np.testing.assert_allclose(np.asarray(b), a, rtol=TOL["rtol"],
                                   atol=atol, err_msg=f"{what} {path}")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    jcfg, cfg, jp, tree, model, jbatch, tbatch = _setup(arch)
    jloss, jgrads = jax.value_and_grad(japi.loss_fn)(jp, jbatch, jcfg)
    loss = api.loss_fn(model, tbatch, cfg)
    assert loss.dtype == torch.float32 and loss.ndim == 0
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    loss2, grads = shapes.loss_and_grads(model, tbatch, cfg)
    assert loss2.item() == loss.item()
    assert set(grads) == set(named(model))
    port = bridge.dump_params(model, tree, grads)
    _close_tree(port, jgrads, f"{arch} grad", scaled=True)


@pytest.mark.parametrize("mode", ["ep", "ep2d"])
def test_moe_expert_parallel_loss_and_grads_match_jax(mode):
    """The moe case through the expert-parallel modes: the port's
    ``make_runtime`` on a one-rank ``gloo`` mesh against JAX's on a (1, 1)
    mesh, the loss and every gradient leaf as the dense case holds them
    (capacity factor 1.25: the same drops on both sides).  JAX's mesh has
    Auto axes: its ``with_sharding_constraint`` refuses Explicit ones."""
    jcfg, cfg, jp, tree, model, jbatch, tbatch = _setup("dbrx-132b", seed=2)
    auto = (jax.sharding.AxisType.Auto,) * 2
    jrt = jshapes.make_runtime(
        jax.make_mesh((1, 1), ("data", "model"), axis_types=auto),
        moe_mode=mode)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: japi.loss_fn(p, b, jcfg, jrt)))(jp, jbatch)
    mesh = make_debug_mesh(device="cpu")
    try:
        rt = shapes.make_runtime(mesh, moe_mode=mode)
        loss, grads = shapes.loss_and_grads(model, tbatch, cfg, rt)
        dense, _ = shapes.loss_and_grads(model, tbatch, cfg)
    finally:
        dist.destroy_process_group()
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    assert loss.item() != dense.item()          # the modes differ
    port = bridge.dump_params(model, tree, grads)
    _close_tree(port, jgrads, f"moe {mode} grad", scaled=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch):
    jcfg, cfg, jp, tree, model, jbatch, tbatch = _setup(arch, seed=1)
    jstep = jshapes.make_train_step(jcfg, Runtime(), JAdamWConfig(lr=1e-3))
    jp2, jopt2, jm = jstep(jp, jax_init_opt_state(jp), jbatch)
    step = shapes.make_train_step(cfg, AdamWConfig(lr=1e-3))
    opt = init_opt_state(model)
    model, opt, m = step(model, opt, tbatch)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), **TOL)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               **TOL)
    assert int(opt["step"]) == int(jopt2["step"]) == 1
    _close_tree(bridge.dump_params(model, tree), jp2, f"{arch} params")
    state = bridge.dump_opt_state(model, opt, tree)
    _close_tree(state["m"], jopt2["m"], f"{arch} m", scaled=True)
    _close_tree(state["v"], jopt2["v"], f"{arch} v", scaled=True)


def test_cross_entropy_masks_and_clips_its_count():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 5, 7)).astype(np.float32)
    labels = rng.integers(0, 7, (2, 5)).astype(np.int32)
    labels[1, 2:] = -1
    from repro.models.transformer import cross_entropy as jce
    got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), float(jce(jnp.asarray(logits),
                                                     jnp.asarray(labels))),
                               **TOL)
    none = -np.ones_like(labels)
    assert float(cross_entropy(torch.from_numpy(logits),
                               torch.from_numpy(none))) == 0.0
    mask = np.zeros((2, 5), bool)
    mask[0, 1] = True
    np.testing.assert_allclose(
        float(cross_entropy(torch.from_numpy(logits),
                            torch.from_numpy(labels),
                            torch.from_numpy(mask))),
        float(jce(jnp.asarray(logits), jnp.asarray(labels),
                  jnp.asarray(mask))), **TOL)


@pytest.mark.parametrize("seq", [40, 12])
def test_audio_batch_and_loss_match_jax(seq):
    """The train CLI's audio batch (``build_batch``): frames (B, seq, D)
    from the step key, tokens and labels cut to min(max_decoder_len 16,
    seq), against the reference's; then ``api.loss_fn`` on it with JAX's
    weights bridged."""
    from repro.launch import train as jtrain
    jcfg = jax_reduced(jax_get_arch("whisper-base"))
    cfg = reduced(get_arch("whisper-base"))
    jb = jtrain.build_batch(jax.random.PRNGKey(4), jcfg, 2, seq)
    b = train.build_batch(prng.PRNGKey(4), cfg, 2, seq)
    assert set(b) == set(jb) == {"tokens", "labels", "frames"}
    dec = min(16, seq)
    assert tuple(b["tokens"].shape) == tuple(b["labels"].shape) == (2, dec)
    assert tuple(b["frames"].shape) == (2, seq, cfg.d_model)
    np.testing.assert_allclose(b["frames"].numpy(), np.asarray(jb["frames"]),
                               atol=INIT_ATOL, rtol=0)
    np.testing.assert_array_equal(b["tokens"].numpy(),
                                  np.asarray(jb["tokens"]))
    np.testing.assert_array_equal(b["labels"].numpy(),
                                  np.asarray(jb["labels"]))
    jp = japi.init_params(jax.random.PRNGKey(0), jcfg)
    from repro_torch.models.encdec import EncDec
    model = bridge.load_dit(EncDec(cfg), jax.tree.map(np.asarray, jp))
    with torch.no_grad():
        loss = api.loss_fn(model, b, cfg)
    np.testing.assert_allclose(loss.item(), float(japi.loss_fn(jp, jb, jcfg)),
                               **TOL)


def test_step_builders_and_skip_reasons():
    cfg = reduced(get_arch("granite-8b"))
    assert shapes.step_fn(cfg, "train_4k").__name__ == "train_step"
    assert shapes.step_fn(cfg, "prefill_32k").__name__ == "prefill_step"
    assert shapes.step_fn(cfg, "decode_32k").__name__ == "serve_step"
    for arch in ("granite-8b", "zamba2-1.2b", "mamba2-2.7b", "minicpm-2b",
                 "whisper-base", "chatglm3-6b"):
        for shape in ("train_4k", "long_500k"):
            want = jshapes.skip_reason(jax_get_arch(arch),
                                       jax_get_shape(shape))
            assert shapes.skip_reason(get_arch(arch),
                                      get_shape(shape)) == want
    for name in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        assert dataclasses.asdict(get_shape(name)) == \
            dataclasses.asdict(jax_get_shape(name))
    # the prefill step is api.prefill_fn
    model = api.init_params(prng.PRNGKey(0), cfg, "cpu")
    tok = torch.zeros(1, 8, dtype=torch.long)
    with torch.no_grad():
        lg, _ = shapes.make_prefill_step(cfg)(model, {"tokens": tok})
        ref, _ = api.prefill_fn(model, {"tokens": tok}, cfg)
    assert torch.equal(lg, ref)
