"""The MoE architectures partitioned with ``DTensor``: the experts placed
by sharding/specs.py ``shard_params`` (the training layout
``("model", "data", None)``, ``w_down`` ``("model", None, "data")``; the
inference layout with "data" on the expert FFN width) and taken by
models/moe.py ``moe_ep`` / ``moe_ep2d`` / ``moe_dense`` as local parts,
the router, norms, attention and embedding by the dense rules, on the
CPU at reduced float32 dbrx-132b (4 experts, top-2).

(a) On a fake 2 × 2 mesh in process: ``_local_experts`` in the inference
    layout is this rank's ``[experts, :, F slice]`` with nothing moved;
    in the training layout it is gathered over "data" to this rank's
    experts whole; the placed tokens' local part, and a local output
    placed back as them.
(b) On one ``gloo`` rank: the placed EP train step (``make_train_step``:
    loss, every gradient, the AdamW step) bitwise today's EP path on
    whole parameters; prefill then 8 greedy ``moe_ep2d`` decode steps in
    the inference layout bitwise the unplaced ones; the placed
    ``moe_dense`` loss and gradients bitwise the plain ones.
(c) On spawned 1 × 2 and 2 × 2 ranks, at capacity factor 8 (no token is
    dropped): the placed EP loss and gradients within TOL of the same
    function without a mesh (the cross entropy over the whole batch plus
    the aux loss averaged over the batch shards, as ``moe_ep`` averages
    it); ``moe_dense`` placed against plain; prefill and 8 ``moe_ep2d``
    decode steps against the plain model's.
(d) The 2 × 2 ranks' placed ``moe_ep`` (training layout) value and
    gradients, and ``moe_ep2d`` (inference layout) output, from JAX's
    weights and inputs, against JAX's jitted functions on a (2, 2) Auto
    mesh of four forced host devices (a process of its own).
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import time
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
from repro_torch.launch import shapes
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import api
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import init_opt_state, named
from repro_torch.sharding import specs as S

torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=2e-3)
JOIN_S = 240
ARCH = "dbrx-132b"
B, SEQ, STEPS = 4, 12, 8


def _cfg(capacity_factor=None):
    cfg = reduced(get_arch(ARCH))
    return cfg if capacity_factor is None else \
        dataclasses.replace(cfg, capacity_factor=capacity_factor)


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (B, SEQ + 1))
    batch = {"tokens": torch.from_numpy(tok[:, :SEQ]),
             "labels": torch.from_numpy(tok[:, 1:].copy())}
    batch["labels"][0, :3] = -1
    return batch


def _model(cfg, mesh=None, inference=False):
    m = api.init_params(prng.PRNGKey(0), cfg, "cpu")
    return m if mesh is None else S.shard_params(m, mesh, inference)


def _whole(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def _decode_run(cfg, model, batch, prefill_rt, decode_rt, mesh=None):
    """Prefill (a cache of the prompt + STEPS slots) and STEPS greedy
    steps: (every step's logits, the final state)."""
    place = (lambda t: t) if mesh is None else \
        (lambda t: S.place(mesh, t, S.batch_spec_for(mesh, B, 1)))
    tokens = {"tokens": place(batch["tokens"])}
    logits = []
    with torch.no_grad():
        out, state = api.prefill_fn(model, tokens, cfg, prefill_rt,
                                    cache_len=SEQ + STEPS)
        logits.append(_whole(out))
        for i in range(STEPS):
            out, state = api.decode_fn(model, place(logits[-1].argmax(-1)),
                                       state, SEQ + i, cfg, decode_rt)
            logits.append(_whole(out))
    return logits, state


def _reference(model, batch, cfg, shards: int):
    """The loss the expert-parallel step computes over ``shards`` batch
    shards, without a mesh (no token dropped): the cross entropy over the
    whole batch plus the aux loss averaged over the shards; and its
    gradients."""
    with torch.enable_grad():
        hidden, _, _ = T.lm_forward(model, batch["tokens"], cfg)
        loss = T.cross_entropy(T.logits_of(model, hidden), batch["labels"])
        aux = sum(T.lm_forward(model, t, cfg)[1]
                  for t in batch["tokens"].chunk(shards)) / shards
        loss = loss + cfg.router_aux_coef * aux
        ps = named(model)
        grads = torch.autograd.grad(loss, list(ps.values()))
    return loss.detach(), dict(zip(ps, grads))


# ---- (a) the placed experts on a fake 2 x 2 mesh -------------------------

@pytest.fixture
def fake_mesh():
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=3, world_size=4)
    yield init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    dist.destroy_process_group()


@pytest.mark.parametrize("name,dim", [("w_gate", 2), ("w_up", 2),
                                      ("w_down", 1)])
def test_local_experts_in_both_layouts(fake_mesh, name, dim):
    mesh, cfg = fake_mesh, _cfg()
    whole = getattr(api.init_params(prng.PRNGKey(0), cfg, "cpu")
                    .layers[0].moe, name).detach()
    x = S.place(mesh, torch.randn(B, SEQ, cfg.d_model),
                S.batch_spec_for(mesh, B, 2))
    # this process is rank 3: data 1, model 1 -> experts 2, 3
    placed = S.place(mesh, whole, (("model", None, "data") if dim == 2 else
                                   ("model", "data", None)), copy=True)
    local = tmoe._local_experts(placed, x, "model", ("data", dim))
    assert torch.equal(local, whole[2:].chunk(2, dim)[1])
    train = S.place(mesh, whole, S.param_spec_for((name,), 3), copy=True)
    local = tmoe._local_experts(train, x, "model")
    assert local.shape == whole[2:].shape
    moe = S.shard_params(tmoe.MoE(cfg, torch.float32), mesh)
    x_loc, _, back, _ = tmoe._placed(moe, x)
    assert torch.equal(x_loc, x.to_local()) and x_loc.shape[0] == B // 2
    y = back(x_loc * 2)
    assert y.placements == x.placements and y.shape == x.shape
    assert tuple(x.placements) == (Shard(0), Replicate())


# ---- (b) one gloo rank, bitwise ------------------------------------------

@pytest.fixture
def mesh1():
    yield make_debug_mesh(device="cpu")
    dist.destroy_process_group()


def test_one_rank_ep_train_step_bitwise(mesh1):
    cfg = _cfg()
    batch = _batch(cfg)
    rt = shapes.make_runtime(mesh1)
    whole, placed = _model(cfg), _model(cfg, mesh1)
    pbatch = S.shard_batch(mesh1, batch)
    l0, g0 = shapes.loss_and_grads(whole, batch, cfg, rt)
    l1, g1 = shapes.loss_and_grads(placed, pbatch, cfg, rt)
    assert not isinstance(l1, DTensor) and torch.equal(l0, l1)
    params = dict(placed.named_parameters())
    for n, g in g1.items():
        assert g.placements == params[n].placements, n
        assert torch.equal(g.to_local(), g0[n]), n
    step = shapes.make_train_step(cfg, runtime=rt)
    _, _, m0 = step(whole, init_opt_state(whole), batch)
    _, _, m1 = step(placed, init_opt_state(placed), pbatch)
    assert torch.equal(m0["loss"], m1["loss"])
    assert torch.equal(m0["grad_norm"], m1["grad_norm"])
    for n, p in whole.named_parameters():
        assert torch.equal(params[n].to_local(), p), n


def test_one_rank_ep2d_decode_bitwise(mesh1):
    cfg = _cfg()
    batch = _batch(cfg)
    rt_p = shapes.runtime_for(cfg, "prefill_32k", mesh1)
    rt_d = shapes.runtime_for(cfg, "decode_32k", mesh1)
    assert (rt_p.moe_mode, rt_d.moe_mode) == ("ep", "ep2d")
    l0, s0 = _decode_run(cfg, _model(cfg), batch, rt_p, rt_d)
    l1, s1 = _decode_run(cfg, _model(cfg, mesh1, inference=True), batch,
                         rt_p, rt_d, mesh1)
    for i, (a, b) in enumerate(zip(l0, l1, strict=True)):
        assert torch.equal(a, b), i
    for x, y in zip(bridge.leaves(s0), bridge.leaves(s1), strict=True):
        assert isinstance(y, DTensor) and torch.equal(x, _whole(y))


def test_one_rank_placed_dense_moe_bitwise(mesh1):
    cfg = _cfg()
    batch = _batch(cfg)
    l0, g0 = shapes.loss_and_grads(_model(cfg), batch, cfg)
    l1, g1 = shapes.loss_and_grads(
        _model(cfg, mesh1), S.shard_batch(mesh1, batch), cfg,
        shapes.make_runtime(mesh1, moe_mode="dense"))
    assert torch.equal(l0, l1)
    for n, g in g1.items():
        assert torch.equal(g.to_local(), g0[n]), n


# ---- (c) spawned 1 x 2 and 2 x 2 ranks, within TOL -----------------------

def _close_grads(got, want, params, what):
    for n, g in got.items():
        assert g.placements == params[n].placements, (what, n)
        np.testing.assert_allclose(g.full_tensor().numpy(), want[n].numpy(),
                                   **TOL, err_msg=f"{what} {n}")


def _rank_main(rank, shape, store_path, jax_dir=None):
    torch.set_num_threads(1)
    world = int(np.prod(shape))
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, world), rank=rank,
        world_size=world)
    try:
        mesh = make_debug_mesh(*shape, device="cpu")
        cfg = _cfg(8.0)
        batch = _batch(cfg)
        pbatch = S.shard_batch(mesh, batch)
        whole = _model(cfg)
        for mode in ("ep", "dense"):
            placed = _model(cfg, mesh)
            l0, g0 = _reference(whole, batch, cfg,
                                shape[0] if mode == "ep" else 1)
            l1, g1 = shapes.loss_and_grads(placed, pbatch, cfg,
                                           shapes.make_runtime(mesh, mode))
            np.testing.assert_allclose(l1.item(), l0.item(), **TOL,
                                       err_msg=mode)
            _close_grads(g1, g0, dict(placed.named_parameters()), mode)
        l0, s0 = _decode_run(cfg, whole, batch, T.CPU, T.CPU)
        l1, s1 = _decode_run(cfg, _model(cfg, mesh, inference=True), batch,
                             shapes.runtime_for(cfg, "prefill_32k", mesh),
                             shapes.runtime_for(cfg, "decode_32k", mesh),
                             mesh)
        for i, (a, b) in enumerate(zip(l0, l1, strict=True)):
            np.testing.assert_allclose(b.numpy(), a.numpy(), **TOL,
                                       err_msg=f"decode step {i}")
        for x, y in zip(bridge.leaves(s0), bridge.leaves(s1), strict=True):
            np.testing.assert_allclose(_whole(y).numpy(), x.numpy(), **TOL)
        if jax_dir is not None:
            _jax_case(mesh, rank, Path(jax_dir))
    finally:
        dist.destroy_process_group()


JAX_SEED = 7
# JAX's moe_ep value and gradients (training layout) and moe_ep2d output
# (inference layout) on a (2, 2) mesh of four host devices, the
# parameters laid out by param_specs and x by batch_spec_for
JAX_2X2 = """
import os, pickle, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding
from repro.configs.base import get_arch, reduced
from repro.models import moe
from repro.sharding import specs as S
out = sys.argv[1]
try:
    cfg = reduced(get_arch("dbrx-132b"))
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    put = lambda t, spec: jax.device_put(t, NamedSharding(
        mesh, S.sanitize_spec(spec, t.shape, mesh)))
    p = moe.moe_init(jax.random.PRNGKey(int(sys.argv[2])), cfg, jnp.float32)
    io = np.load(os.path.join(out, "io.npz"))
    x = put(jnp.asarray(io["x"]), S.batch_spec_for(mesh, io["x"].shape[0], 2))
    g = jnp.asarray(io["g"])

    def loss(pp, xx):
        y, aux = moe.moe_ep(pp, xx, cfg, mesh, ("data",))
        return jnp.sum(y * g) + aux, (y, aux)

    pt = jax.tree.map(put, p, S.param_specs(p))
    (l, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(pt, x)
    pi = jax.tree.map(put, p, S.param_specs(p, inference=True))
    y2, aux2 = jax.jit(lambda pp, xx: moe.moe_ep2d(
        pp, xx, cfg, mesh, ("data",)))(pi, x)
    res = {"params": jax.tree.map(np.asarray, p), "loss": float(l),
           "y": np.asarray(y), "aux": float(aux),
           "grads": jax.tree.map(np.asarray, gp), "dx": np.asarray(gx),
           "y2d": np.asarray(y2), "aux2d": float(aux2)}
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
    """JAX's MoE weights placed on the 2 × 2 mesh in each layout, JAX's x
    placed by batch: ``moe_ep``'s value, aux, loss sum(y·g) + aux and its
    gradients, and ``moe_ep2d``'s value, gathered whole; rank 0 writes
    them."""
    _wait_for(jax_dir / "jax.pkl", jax_dir / "jax.failed", "JAX's (2, 2) run")
    with open(jax_dir / "jax.pkl", "rb") as f:
        ref = pickle.load(f)
    cfg = _cfg()
    io = np.load(jax_dir / "io.npz")
    x = S.place(mesh, torch.from_numpy(io["x"]),
                S.batch_spec_for(mesh, io["x"].shape[0], 2))
    x = x.detach().requires_grad_()
    g = S.place(mesh, torch.from_numpy(io["g"]),
                S.batch_spec_for(mesh, io["g"].shape[0], 2))
    out = {}
    m = S.shard_params(bridge.load_params(tmoe.MoE(cfg, torch.float32),
                                          ref["params"]), mesh)
    y, aux = tmoe.moe_ep(m, x, cfg, mesh, ("data",))
    loss = (y * g).sum() + aux
    params = dict(m.named_parameters())
    grads = torch.autograd.grad(loss, [x, *params.values()])
    out.update(y=_whole(y).detach().numpy(), aux=_whole(aux).item(),
               loss=_whole(loss).item(), dx=_whole(grads[0]).numpy(),
               grads={n: _whole(gr).numpy()
                      for n, gr in zip(params, grads[1:])})
    m = S.shard_params(bridge.load_params(tmoe.MoE(cfg, torch.float32),
                                          ref["params"]), mesh,
                       inference=True)
    with torch.no_grad():
        y, aux = tmoe.moe_ep2d(m, x.detach(), cfg, mesh, ("data",))
    out.update(y2d=_whole(y).numpy(), aux2d=_whole(aux).item())
    if rank == 0:
        torch.save(out, jax_dir / "port.tmp")
        os.replace(jax_dir / "port.tmp", jax_dir / "port.pt")


SHAPES = [(1, 2), (2, 2)]


@pytest.fixture(scope="module")
def rank_groups(tmp_path_factory):
    """Both meshes' ranks spawned together (6 processes), each group
    under its own ``FileStore``, beside JAX's (2, 2) run (``JAX_2X2``, a
    process of its own); all killed at the end."""
    jax_dir = tmp_path_factory.mktemp("jax2x2")
    rng = np.random.default_rng(JAX_SEED)
    d = _cfg().d_model
    np.savez(jax_dir / "io.npz",
             x=rng.standard_normal((B, SEQ, d)).astype(np.float32),
             g=rng.standard_normal((B, SEQ, d)).astype(np.float32))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(Path(__file__).resolve().parents[1] / "src"))
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", JAX_2X2, str(jax_dir), str(JAX_SEED)],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True)
    groups = {}
    for shape in SHAPES:
        store = tmp_path_factory.mktemp("store") / "store"
        groups[shape] = mp.start_processes(
            _rank_main, args=(shape, str(store),
                              str(jax_dir) if shape == (2, 2) else None),
            nprocs=int(np.prod(shape)), join=False, start_method="spawn")
    yield groups, time.monotonic() + JOIN_S, jax_dir
    if jax_proc.poll() is None:
        jax_proc.kill()
    jax_proc.communicate()
    for ctx in groups.values():
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


@pytest.mark.parametrize("shape", SHAPES)
def test_spawned_ranks_within_tol(rank_groups, shape):
    groups, deadline, _ = rank_groups
    while not groups[shape].join(timeout=5):
        assert time.monotonic() < deadline, "ranks did not finish"


# ---- (d) against JAX's moe_ep / moe_ep2d on a (2, 2) mesh ----------------

@pytest.fixture(scope="module")
def jax_and_port(rank_groups):
    groups, deadline, jax_dir = rank_groups
    _wait_for(jax_dir / "jax.pkl", jax_dir / "jax.failed", "JAX's (2, 2) run")
    while not groups[(2, 2)].join(timeout=5):
        assert time.monotonic() < deadline, "ranks did not finish"
    with open(jax_dir / "jax.pkl", "rb") as f:
        ref = pickle.load(f)
    return ref, torch.load(jax_dir / "port.pt", weights_only=False)


def test_placed_moe_ep_matches_jax_in_value_and_grad(jax_and_port):
    ref, got = jax_and_port
    np.testing.assert_allclose(got["y"], ref["y"], **TOL)
    np.testing.assert_allclose(got["aux"], ref["aux"], **TOL)
    np.testing.assert_allclose(got["loss"], ref["loss"], **TOL)
    np.testing.assert_allclose(got["dx"], ref["dx"], **TOL)
    assert set(got["grads"]) == set(ref["grads"])
    for n, g in got["grads"].items():
        want = ref["grads"][n]
        np.testing.assert_allclose(
            g, want, atol=TOL["atol"] * max(1.0, float(np.abs(want).max())),
            rtol=TOL["rtol"], err_msg=n)


def test_placed_moe_ep2d_matches_jax(jax_and_port):
    ref, got = jax_and_port
    np.testing.assert_allclose(got["y2d"], ref["y2d"], **TOL)
    np.testing.assert_allclose(got["aux2d"], ref["aux2d"], **TOL)
