"""The non-MoE families partitioned over a ("data", "model") mesh with
``DTensor`` (sharding/specs.py ``shard_params`` / ``shard_batch``,
models/transformer.py ``constrain`` / ``batch_spec``) on the CPU, at the
reduced float32 configs of the five families: dense (granite-8b, and
chatglm3-6b with one K/V head, so the K/V projection is cut inside a head
at two ranks), vlm (internvl2-76b), ssm (mamba2-2.7b), hybrid
(zamba2-1.2b) and audio (whisper-base).

(a) On a fake 2 × 2 mesh in process: every parameter laid out by
    ``shard_params`` carries the placements of its sanitized
    ``param_specs`` entry and holds this rank's slice, AdamW moments
    follow it, and the local bytes sum to ``dryrun.device_bytes`` of the
    abstract parameters; the multi-pod batch ``("pod", "data")`` is cut
    on both mesh dims, major first.
(b) On one ``gloo`` rank: the partitioned loss, every gradient, the
    prefill logits and one AdamW step bitwise the unpartitioned ones.
(c) On 2 × 2 (4 spawned ``gloo`` ranks), 1 × 2 and 2 × 1 (2 each; a
    ``FileStore`` each, a join limit): the loss, every gradient and the
    prefill logits within TOL of the unpartitioned ones, and each
    gradient placed as its parameter.
(d) The port's partitioned loss on a (1, 1) mesh against JAX's jitted
    ``loss_fn`` on a (1, 1) mesh with Auto axes, so that ``constrain`` is
    active on both sides (the reference's Explicit-axis mesh tests fail
    for their own reasons); the loss and every gradient of reduced
    granite-8b on the spawned 2 × 2 ranks against JAX's jitted
    ``value_and_grad`` over four forced host devices on a (2, 2) Auto
    mesh, parameters and batch laid out by the reference's specs (in a
    process of its own: the device count is fixed when JAX starts);
    ``constrain`` is a no-op off-mesh.
"""
import os
import pickle
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch import bridge
from repro_torch.configs.base import get_arch, reduced
from repro_torch.core import prng
from repro_torch.launch import dryrun, shapes
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import api
from repro_torch.models.transformer import CPU, batch_spec, constrain
from repro_torch.optim.adamw import init_opt_state
from repro_torch.sharding import specs as S

torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=2e-3)
JOIN_S = 240
# the reduced configs' overrides
ARCHS = {"granite-8b": {}, "chatglm3-6b": {"n_kv_heads": 1},
         "internvl2-76b": {}, "mamba2-2.7b": {}, "zamba2-1.2b": {},
         "whisper-base": {}}
B, SEQ, FRAMES = 2, 16, 24


def _cfg(arch):
    return reduced(get_arch(arch), **ARCHS[arch])


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (B, SEQ + 1))
    batch = {"tokens": torch.from_numpy(tok[:, :SEQ]),
             "labels": torch.from_numpy(tok[:, 1:].copy())}
    batch["labels"][0, :3] = -1                  # ignored positions
    normal = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32))
    if cfg.family == "vlm":
        batch["vision_embeds"] = normal(B, cfg.n_vision_tokens, cfg.d_model)
    if cfg.family == "audio":
        batch["frames"] = normal(B, FRAMES, cfg.d_model)
    return batch


def _both(cfg, mesh, seed=0):
    """(whole model, its partitioned copy, batch, placed batch, runtime)
    from the same weights."""
    model = api.init_params(prng.PRNGKey(seed), cfg, "cpu")
    placed = api.init_params(prng.PRNGKey(seed), cfg, "cpu")
    batch = _batch(cfg, seed)
    return (model, S.shard_params(placed, mesh), batch,
            S.shard_batch(mesh, batch), shapes.make_runtime(mesh))


# ---- (a) the layout on a fake 2 x 2 mesh ---------------------------------

@pytest.fixture
def fake_mesh():
    def make(shape, axes=("data", "model")):
        from torch.testing._internal.distributed.fake_pg import FakeStore
        world = int(np.prod(shape))
        dist.init_process_group("fake", store=FakeStore(), rank=world - 1,
                                world_size=world)
        return init_device_mesh("cpu", shape, mesh_dim_names=axes)
    yield make
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", list(ARCHS))
def test_shard_params_lays_out_every_parameter(fake_mesh, arch):
    mesh = fake_mesh((2, 2))
    cfg = _cfg(arch)
    model = api.init_params(prng.PRNGKey(0), cfg, "cpu")
    whole = {n: p.detach().clone() for n, p in model.named_parameters()}
    specs = S.param_specs(model)
    S.shard_params(model, mesh)
    params = dict(model.named_parameters())
    assert set(params) == set(whole)
    cut = 0
    for n, p in params.items():
        want = S.placements(S.sanitize_spec(specs[n], whole[n].shape, mesh),
                            mesh)
        assert isinstance(p, torch.nn.Parameter) and isinstance(p, DTensor)
        assert tuple(p.placements) == tuple(want), n
        assert p.shape == whole[n].shape and p.requires_grad
        local = whole[n]
        for d, pl in enumerate(want):
            if pl.is_shard():
                local = local.chunk(2, pl.dim)[mesh.get_local_rank(d)]
        assert torch.equal(p.to_local(), local), n
        cut += p.to_local().numel() < whole[n].numel()
    assert cut > 0
    opt = init_opt_state(model)
    for w in ("m", "v"):
        for n, t in opt[w].items():
            assert t.placements == params[n].placements
            assert t.to_local().dtype == torch.float32
    abstract = shapes.abstract_params(cfg, mesh)
    assert dryrun.local_bytes(model) == dryrun.device_bytes(abstract, mesh)


def test_multi_pod_batch_is_cut_major_first(fake_mesh):
    mesh = fake_mesh((2, 2, 1), ("pod", "data", "model"))
    tok = torch.arange(8 * 3).reshape(8, 3)
    placed = S.shard_batch(mesh, {"tokens": tok})["tokens"]
    assert tuple(placed.placements) == (Shard(0), Shard(0), Replicate())
    # this process is rank 3: pod 1, data 1 -> the last quarter of rows
    assert torch.equal(placed.to_local(), tok[6:])
    names = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert S.placements((("pod", "data"), "model"), names) == \
        [Shard(0), Shard(0), Shard(1)]
    with pytest.raises(ValueError):
        S.placements((("data", "pod"),), names)


# ---- (b) one gloo rank, bitwise ------------------------------------------

@pytest.fixture
def mesh1():
    yield make_debug_mesh(device="cpu")
    dist.destroy_process_group()


def _whole(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


@pytest.mark.parametrize("arch", list(ARCHS))
def test_one_rank_bitwise(mesh1, arch):
    cfg = _cfg(arch)
    model, placed, batch, pbatch, rt = _both(cfg, mesh1)
    l0, g0 = shapes.loss_and_grads(model, batch, cfg)
    l1, g1 = shapes.loss_and_grads(placed, pbatch, cfg, rt)
    assert not isinstance(l1, DTensor) and torch.equal(l0, l1)
    params = dict(placed.named_parameters())
    for n, g in g1.items():
        assert g.placements == params[n].placements, n
        assert torch.equal(g.to_local(), g0[n]), n
    p0, _ = api.prefill_fn(model, batch, cfg)
    p1, _ = api.prefill_fn(placed, pbatch, cfg, rt)
    assert torch.equal(_whole(p1), p0)
    step = shapes.make_train_step(cfg)
    _, _, m0 = step(model, init_opt_state(model), batch)
    _, _, m1 = step(placed, init_opt_state(placed), pbatch)
    assert torch.equal(m0["loss"], m1["loss"])
    assert torch.equal(m0["grad_norm"], m1["grad_norm"])
    for n, p in model.named_parameters():
        assert torch.equal(params[n].to_local(), p), n


# ---- (c) 2 and 4 spawned gloo ranks, within TOL --------------------------

def _rank_main(rank, shape, store_path, jax_dir=None):
    """One rank of a ``shape`` mesh: every arch's partitioned loss,
    gradients and prefill logits against the unpartitioned ones; with
    ``jax_dir``, then the JAX-weighted case of ``_jax_case``."""
    torch.set_num_threads(1)
    world = int(np.prod(shape))
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, world), rank=rank,
        world_size=world)
    try:
        mesh = make_debug_mesh(*shape, device="cpu")
        for arch in ARCHS:
            cfg = _cfg(arch)
            model, placed, batch, pbatch, rt = _both(cfg, mesh)
            l0, g0 = shapes.loss_and_grads(model, batch, cfg)
            l1, g1 = shapes.loss_and_grads(placed, pbatch, cfg, rt)
            np.testing.assert_allclose(l1.item(), l0.item(), **TOL,
                                       err_msg=f"{arch} loss")
            params = dict(placed.named_parameters())
            for n, g in g1.items():
                assert g.placements == params[n].placements, (arch, n)
                np.testing.assert_allclose(
                    g.full_tensor().numpy(), g0[n].numpy(), **TOL,
                    err_msg=f"{arch} {n}")
            with torch.no_grad():
                p0, _ = api.prefill_fn(model, batch, cfg)
                p1, _ = api.prefill_fn(placed, pbatch, cfg, rt)
            np.testing.assert_allclose(_whole(p1).numpy(), p0.numpy(),
                                       **TOL, err_msg=f"{arch} prefill")
        if jax_dir is not None:
            _jax_case(mesh, rank, Path(jax_dir))
    finally:
        dist.destroy_process_group()


JAX_ARCH, JAX_SEED = "granite-8b", 3
# JAX's loss and gradients on a (2, 2) mesh of four host devices, the
# parameters laid out by param_specs and the batch by batch_spec_for, as
# launch/dryrun.py lays out the jitted step's inputs
JAX_2X2 = """
import os, pickle, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding
from repro.configs.base import get_arch, reduced
from repro.launch import shapes
from repro.models import api
from repro.sharding import specs as S
out = sys.argv[1]
try:
    cfg = reduced(get_arch(sys.argv[2]))
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    put = lambda t, spec: jax.device_put(t, NamedSharding(
        mesh, S.sanitize_spec(spec, t.shape, mesh)))
    params = api.init_params(jax.random.PRNGKey(int(sys.argv[3])), cfg)
    params = jax.tree.map(put, params, S.param_specs(params))
    b = np.load(os.path.join(out, "batch.npz"))
    batch = {k: put(jnp.asarray(b[k].astype(np.int32)),
                    S.batch_spec_for(mesh, b[k].shape[0], 1)) for k in b}
    rt = shapes.make_runtime(mesh)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: api.loss_fn(p, b, cfg, rt)))(params, batch)
    res = {"loss": float(loss), "params": jax.tree.map(np.asarray, params),
           "grads": jax.tree.map(np.asarray, grads)}
    with open(os.path.join(out, "jax.tmp"), "wb") as f:
        pickle.dump(res, f)
    os.replace(os.path.join(out, "jax.tmp"), os.path.join(out, "jax.pkl"))
except BaseException:
    open(os.path.join(out, "jax.failed"), "w").close()
    raise
"""


def _wait_for(path: Path, failed: Path, what: str):
    deadline = time.monotonic() + JOIN_S
    while not path.exists():
        assert not failed.exists(), f"{what} failed"
        assert time.monotonic() < deadline, f"{what} did not finish"
        time.sleep(0.5)


def _jax_case(mesh, rank, jax_dir: Path):
    """JAX's reduced granite-8b weights (``JAX_2X2``) laid out by
    ``shard_params``, JAX's batch by ``shard_batch``: the partitioned
    loss and gradients, gathered whole, written by rank 0."""
    _wait_for(jax_dir / "jax.pkl", jax_dir / "jax.failed", "JAX's (2, 2) run")
    with open(jax_dir / "jax.pkl", "rb") as f:
        ref = pickle.load(f)
    cfg = _cfg(JAX_ARCH)
    model = S.shard_params(
        bridge.load_dit(api.empty_params(cfg, "cpu"), ref["params"]), mesh)
    batch = {k: torch.from_numpy(v) for k, v in
             np.load(jax_dir / "batch.npz").items()}
    loss, grads = shapes.loss_and_grads(model, S.shard_batch(mesh, batch),
                                        cfg, shapes.make_runtime(mesh))
    params = dict(model.named_parameters())
    out = {"loss": loss.item(), "grads": {}, "placed": True}
    for n, g in grads.items():
        out["placed"] &= g.placements == params[n].placements
        out["grads"][n] = g.full_tensor().numpy()
    if rank == 0:
        torch.save(out, jax_dir / "port.tmp")
        os.replace(jax_dir / "port.tmp", jax_dir / "port.pt")


SHAPES = [(2, 2), (1, 2), (2, 1)]


@pytest.fixture(scope="module")
def rank_groups(tmp_path_factory):
    """The three meshes' ranks, spawned together (8 processes), each
    group under its own ``FileStore``, beside JAX's (2, 2) run (``JAX_2X2``,
    in a process of its own) whose weights the 2 × 2 ranks take last;
    all killed at the end."""
    jax_dir = tmp_path_factory.mktemp("jax2x2")
    np.savez(jax_dir / "batch.npz", **{
        k: v.numpy() for k, v in _batch(_cfg(JAX_ARCH), JAX_SEED).items()})
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(Path(__file__).resolve().parents[1] / "src"))
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", JAX_2X2, str(jax_dir), JAX_ARCH,
         str(JAX_SEED)], env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    groups = {}
    for shape in SHAPES:
        store = tmp_path_factory.mktemp("store") / "store"
        groups[shape] = mp.start_processes(
            _rank_main, args=(shape, str(store),
                              str(jax_dir) if shape == (2, 2) else None),
            nprocs=int(np.prod(shape)), join=False, start_method="spawn")
    yield groups, time.monotonic() + JOIN_S, jax_dir, jax_proc
    if jax_proc.poll() is None:
        jax_proc.kill()
    jax_proc.communicate()
    for ctx in groups.values():
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


@pytest.mark.parametrize("shape", SHAPES)
def test_spawned_ranks_match_unpartitioned(rank_groups, shape):
    groups, deadline, _, _ = rank_groups
    while not groups[shape].join(timeout=5):
        assert time.monotonic() < deadline, "ranks did not finish"


# ---- (d) against JAX's constrained loss; constrain off-mesh --------------

def test_partitioned_loss_matches_jax_on_a_mesh(mesh1):
    # JAX imported here: the spawned ranks import this module
    import jax
    import jax.numpy as jnp
    from repro.configs.base import get_arch as jax_get_arch
    from repro.configs.base import reduced as jax_reduced
    from repro.launch import shapes as jshapes
    from repro.models import api as japi
    arch = "granite-8b"
    jcfg, cfg = jax_reduced(jax_get_arch(arch)), _cfg(arch)
    jp = japi.init_params(jax.random.PRNGKey(3), jcfg)
    tree = jax.tree.map(np.asarray, jp)
    model = bridge.load_dit(api.empty_params(cfg, "cpu"), tree)
    batch = _batch(cfg, 3)
    auto = (jax.sharding.AxisType.Auto,) * 2
    jrt = jshapes.make_runtime(
        jax.make_mesh((1, 1), ("data", "model"), axis_types=auto))
    jbatch = {k: jnp.asarray(v.numpy().astype(np.int32))
              for k, v in batch.items()}
    jloss = jax.jit(lambda p, b: japi.loss_fn(p, b, jcfg, jrt))(jp, jbatch)
    S.shard_params(model, mesh1)
    loss, _ = shapes.loss_and_grads(model, S.shard_batch(mesh1, batch), cfg,
                                    shapes.make_runtime(mesh1))
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)


def test_partitioned_grads_match_jax_on_a_2x2_mesh(rank_groups):
    """The 2 × 2 ranks' loss and every gradient, from JAX's weights and
    batch, against JAX's partitioned ``value_and_grad`` on a (2, 2)
    mesh, each gradient placed as its parameter."""
    groups, deadline, jax_dir, jax_proc = rank_groups
    _wait_for(jax_dir / "jax.pkl", jax_dir / "jax.failed", "JAX's (2, 2) run")
    while not groups[(2, 2)].join(timeout=5):
        assert time.monotonic() < deadline, "ranks did not finish"
    with open(jax_dir / "jax.pkl", "rb") as f:
        ref = pickle.load(f)
    got = torch.load(jax_dir / "port.pt", weights_only=False)
    assert got["placed"]
    np.testing.assert_allclose(got["loss"], ref["loss"], **TOL)
    want = bridge.load_dit(api.empty_params(_cfg(JAX_ARCH), "cpu"),
                           ref["grads"])
    names = dict(want.named_parameters())
    assert set(got["grads"]) == set(names)
    for n, g in got["grads"].items():
        np.testing.assert_allclose(g, names[n].detach().numpy(), **TOL,
                                   err_msg=n)


def test_constrain_is_a_no_op_off_mesh(mesh1):
    x = torch.randn(2, 3, 4)
    rt = shapes.make_runtime(mesh1)
    assert constrain(x, rt, batch_spec(rt)) is x
    placed = S.place(mesh1, x, (None, None, "model"))
    assert constrain(placed, CPU, batch_spec(CPU)) is placed
    assert constrain(placed, None, batch_spec(CPU)) is placed
    pinned = constrain(placed, rt, batch_spec(rt))
    assert tuple(pinned.placements) == (Shard(0), Replicate())
    assert torch.equal(pinned.to_local(), x)
