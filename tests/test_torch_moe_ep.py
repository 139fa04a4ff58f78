"""The port's expert-parallel MoE (``models/moe.py``: ``_dispatch_local``,
``_combine_local``, ``moe_ep``, ``moe_ep2d``; ``launch/mesh.py``;
``sharding/specs.py``; ``Runtime``) against the JAX package's on the CPU.

At ``reduced(dbrx-132b)`` (float32, 4 experts, top-2, d_model 128, d_ff
256) with inputs from numpy and parameters bridged from JAX:

* ``_dispatch_local``: ``order``, ``keep``, ``slot`` and ``token_id``
  bitwise with JAX's (``argsort(stable=True)``, ``searchsorted(side=
  "left")``), the packed buffer and ``_combine_local``'s output within
  TOL, at capacity factors 8 (nothing dropped) and 0.1 (most dropped);
* ``moe_ep`` and ``moe_ep2d`` on a (1, 1) mesh (one rank, ``gloo`` over a
  ``HashStore``) against JAX's on ``jax.make_mesh((1, 1), ("data",
  "model"))``: the output and the aux loss, and under grad a loss
  sum(y·G) + aux against ``jax.value_and_grad``, every parameter's
  gradient and x's within TOL (a graph cut at a collective would leave
  the router's and the experts' gradients at zero);
* capacity drops (factor 0.1, as ``tests/test_moe.py``): against JAX's
  ``moe_ep``, and smaller than ``moe_dense`` on average;
* four ranks on a 2 × 2 mesh (``torch.multiprocessing``, ``gloo``, a
  ``FileStore`` under ``tmp_path``, each rank its batch shard) at
  capacity factor 8: every rank's ``moe_ep`` and ``moe_ep2d`` rows
  against ``moe_dense`` on the whole batch within TOL, as
  ``tests/test_moe.py`` does on 8 devices;
* ``Runtime(remat=True)``: an MoE LM's loss and every gradient bitwise
  equal to those without it;
* ``make_debug_mesh``, ``mesh_batch_axes``, ``batch_axis_size``,
  ``make_runtime`` and ``runtime_for`` against the reference's.

Each test that sets up a process group tears it down (``mesh`` fixture).
"""
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro.configs.base import get_arch as jax_get_arch
from repro.configs.base import reduced as jax_reduced
from repro.launch import shapes as jshapes
from repro.models import moe as jmoe
from repro.sharding import specs as jspecs
from repro_torch import bridge
from repro_torch.configs.base import get_arch, reduced
from repro_torch.core import prng
from repro_torch.launch import shapes
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import api
from repro_torch.models import moe as tmoe
from repro_torch.models.transformer import CPU, Runtime
from repro_torch.optim.adamw import named
from repro_torch.sharding import specs

torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=2e-3)
ARCH = "dbrx-132b"
RANKS, JOIN_S = 4, 240


def _cfgs(capacity_factor=1.25):
    jcfg = dataclasses.replace(jax_reduced(jax_get_arch(ARCH)),
                               capacity_factor=capacity_factor)
    cfg = dataclasses.replace(reduced(get_arch(ARCH)),
                              capacity_factor=capacity_factor)
    return jcfg, cfg


def _params(seed=0):
    jcfg, cfg = _cfgs()
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    tree = jax.tree.map(np.asarray, jp)
    return jp, tree, bridge.load_params(tmoe.MoE(cfg, torch.float32), tree)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.fixture
def mesh():
    m = make_debug_mesh(device="cpu")
    yield m
    dist.destroy_process_group()


def _jmesh():
    return jax.make_mesh((1, 1), ("data", "model"))


@pytest.mark.parametrize("capacity_factor", [8.0, 0.1])
def test_dispatch_and_combine_match_jax(capacity_factor):
    jcfg, cfg = _cfgs(capacity_factor)
    jp, _, m = _params()
    x = _x((48, cfg.d_model), seed=1)
    _, jw, jidx = jmoe._router(jp, jnp.asarray(x), cfg.top_k)
    with torch.no_grad():
        _, w, idx = tmoe._router(m, torch.from_numpy(x), cfg.top_k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    cap = tmoe._capacity(cfg, 48)
    assert cap == max(int(jcfg.top_k * 48 / jcfg.n_experts *
                          jcfg.capacity_factor), 4)
    jbuf, jmeta = jmoe._dispatch_local(jnp.asarray(x), jw, jidx,
                                       cfg.n_experts, cap)
    buf, meta = tmoe._dispatch_local(torch.from_numpy(x), w, idx,
                                     cfg.n_experts, cap)
    for k in ("order", "keep", "slot", "token_id"):
        np.testing.assert_array_equal(meta[k].numpy(), np.asarray(jmeta[k]),
                                      err_msg=k)
    assert buf.shape == (cfg.n_experts * cap, cfg.d_model)
    np.testing.assert_allclose(buf.numpy(), np.asarray(jbuf), **TOL)
    if capacity_factor < 1:
        assert not bool(meta["keep"].all())       # drops happen
    else:
        assert bool(meta["keep"].all())
    out = _x(tuple(buf.shape), seed=2)
    y = tmoe._combine_local(torch.from_numpy(out), meta, 48)
    jy = jmoe._combine_local(jnp.asarray(out), jmeta, 48)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)


def _loss_parts(y, aux, g):
    return (y * g).sum() + aux


@pytest.mark.parametrize("mode", ["ep", "ep2d"])
def test_ep_modes_match_jax_in_value_and_grad(mesh, mode):
    jcfg, cfg = _cfgs()
    jp, tree, m = _params(seed=3)
    x = _x((2, 12, cfg.d_model), seed=4)
    g = _x(x.shape, seed=5)
    jfn = getattr(jmoe, f"moe_{mode}")
    tfn = getattr(tmoe, f"moe_{mode}")

    def jloss(p, xx):
        y, aux = jfn(p, xx, jcfg, _jmesh(), ("data",))
        return _loss_parts(y, aux, jnp.asarray(g)), (y, aux)

    (jl, (jy, jaux)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = tfn(m, xt, cfg, mesh, ("data",))
    loss = _loss_parts(y, aux, torch.from_numpy(g))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(aux.item(), float(jaux), **TOL)
    np.testing.assert_allclose(loss.item(), float(jl), **TOL)
    params = dict(m.named_parameters())
    grads = torch.autograd.grad(loss, [xt, *params.values()])
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jgx), **TOL)
    for (name, _), gr in zip(params.items(), grads[1:]):
        ref = np.asarray(jgp[name])
        assert np.abs(ref).max() > 0
        np.testing.assert_allclose(gr.numpy(), ref, atol=TOL["atol"] *
                                   max(1.0, float(np.abs(ref).max())),
                                   rtol=TOL["rtol"], err_msg=name)
    # the dispatcher's mode picks the same function
    rt = Runtime(mesh=mesh, moe_mode=mode)
    with torch.no_grad():
        y2, aux2 = tmoe.moe_apply(m, torch.from_numpy(x), cfg, rt)
    assert torch.equal(y2, y.detach()) and aux2.item() == aux.item()


def test_capacity_drops_tokens_as_jax(mesh):
    jcfg, cfg = _cfgs(0.1)
    jp, _, m = _params(seed=6)
    x = _x((2, 32, cfg.d_model), seed=6)
    jy, jaux = jax.jit(lambda p, xx: jmoe.moe_ep(p, xx, jcfg, _jmesh(),
                                                 ("data",)))(
        jp, jnp.asarray(x))
    with torch.no_grad():
        y, aux = tmoe.moe_ep(m, torch.from_numpy(x), cfg, mesh)
        full, _ = tmoe.moe_dense(m, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(aux.item(), float(jaux), **TOL)
    assert torch.isfinite(y).all()
    assert y.abs().mean() < full.abs().mean()


def _rank_main(rank, store_path, out_dir, tree, x):
    """One rank of the 2 x 2 mesh: its data shard of x through moe_ep
    and moe_ep2d; writes its rows and aux to out_dir."""
    torch.set_num_threads(1)
    _, cfg = _cfgs(8.0)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, RANKS), rank=rank,
        world_size=RANKS)
    try:
        mesh2 = make_debug_mesh(2, 2, device="cpu")
        m = bridge.load_params(tmoe.MoE(cfg, torch.float32), tree)
        d = mesh2.get_local_rank("data")
        n = x.shape[0] // 2
        xl = torch.from_numpy(x[d * n:(d + 1) * n])
        out = {"data_rank": np.array(d)}
        with torch.no_grad():
            for mode in ("ep", "ep2d"):
                y, aux = getattr(tmoe, f"moe_{mode}")(m, xl, cfg, mesh2)
                out[mode], out[f"{mode}_aux"] = y.numpy(), aux.numpy()
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


def test_four_ranks_match_dense(tmp_path):
    _, cfg = _cfgs(8.0)
    _, tree, m = _params(seed=7)
    x = _x((4, 8, cfg.d_model), seed=7)
    ctx = mp.start_processes(
        _rank_main, args=(str(tmp_path / "store"), str(tmp_path), tree, x),
        nprocs=RANKS, join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_S
    try:
        while not ctx.join(timeout=5):
            assert time.monotonic() < deadline, "ranks did not finish"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    with torch.no_grad():
        y_d, aux_d = tmoe.moe_dense(m, torch.from_numpy(x), cfg)
    y_d = y_d.numpy()
    seen = set()
    for r in range(RANKS):
        got = np.load(tmp_path / f"rank{r}.npz")
        d = int(got["data_rank"])
        seen.add(d)
        for mode in ("ep", "ep2d"):
            np.testing.assert_allclose(got[mode], y_d[2 * d:2 * d + 2],
                                       **TOL, err_msg=f"rank {r} {mode}")
        # ep2d routes the gathered batch: the dense aux loss
        np.testing.assert_allclose(float(got["ep2d_aux"]), aux_d.item(),
                                   **TOL)
    assert seen == {0, 1}


def test_remat_gradients_bitwise():
    _, cfg = _cfgs()
    model = api.init_params(prng.PRNGKey(2), cfg, "cpu")
    rng = np.random.default_rng(8)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 17)))
    batch = {"tokens": tok[:, :16], "labels": tok[:, 1:]}
    l0, g0 = shapes.loss_and_grads(model, batch, cfg)
    l1, g1 = shapes.loss_and_grads(model, batch, cfg, Runtime(remat=True))
    assert l0.item() == l1.item()
    assert set(g0) == set(g1) == set(named(model))
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n


def test_mesh_runtime_and_batch_axes(mesh):
    assert mesh.mesh_dim_names == ("data", "model")
    assert tuple(mesh.shape) == (1, 1)
    assert dist.get_backend() == "gloo"
    jm = _jmesh()
    assert specs.mesh_batch_axes(mesh) == jspecs.mesh_batch_axes(jm)
    assert specs.batch_axis_size(mesh) == jspecs.batch_axis_size(jm) == 1
    _, cfg = _cfgs()
    jcfg = jax_reduced(jax_get_arch(ARCH))
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        rt, jrt = shapes.runtime_for(cfg, shape, mesh), \
            jshapes.runtime_for(jcfg, shape, jm)
        assert (rt.moe_mode, rt.batch_axes, rt.model_axis) == \
            (jrt.moe_mode, jrt.batch_axes, jrt.model_axis)
        assert rt.mesh is mesh
    dense = dataclasses.replace(cfg, n_experts=0)
    assert shapes.runtime_for(dense, "decode_32k", mesh).moe_mode == "ep"
    assert shapes.make_runtime(mesh).moe_mode == "ep"
    assert CPU == Runtime() and CPU.mesh is None and CPU.moe_mode == "dense"
    with pytest.raises(ValueError, match="ranks"):
        make_debug_mesh(2, 1, device="cpu")     # the group has one rank


def test_make_debug_mesh_wants_a_group_for_more_ranks():
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="process group"):
        make_debug_mesh(2, 2, device="cpu")
    assert not dist.is_initialized()
