"""Decode under the inference layout with ``DTensor`` (sharding/specs.py
``shard_params(inference=True)`` and ``shard_decode_state``;
models/attention.py ``decode_attention`` on placed caches, models/ssm.py
``mamba_decode`` on placed states) on the CPU, at reduced float32
configs: dense (granite-8b; chatglm3-6b with one K/V head, whose cache
"model" cuts by its slots), vlm (internvl2-76b), ssm (mamba2-2.7b),
hybrid (zamba2-1.2b) and audio (whisper-base).

(a) On a fake 2 × 2 mesh in process: for all ten architectures at their
    published sizes on the meta device, every parameter laid out by
    ``shard_params`` (the training and the inference layout) and every
    leaf of a decode state laid out by ``shard_decode_state`` carries the
    placements of its sanitized spec, and the local bytes sum to
    ``dryrun.device_bytes`` of the abstract operands; on real tensors, a
    placed cache holds this rank's slice, by heads or by slots.
(b) On one ``gloo`` rank: prefill, then 8 greedy decode steps, every
    step's logits and the final state bitwise the unpartitioned path's.
(c) On spawned 1 × 2 and 2 × 2 ranks (a ``FileStore`` each, a join
    limit): the same within TOL; chatglm3-6b's cache cut by its slots
    (the max and sum all-reduces of ``attend_partial``), granite-8b's by
    its heads.
(d) One decode step of the 2 × 2 ranks from JAX's weights and state
    against JAX's jitted ``decode_fn`` on a (2, 2) Auto mesh of four
    forced host devices (a process of its own), parameters laid out by
    ``param_specs(inference=True)`` and the state by the reference's
    ``kv_cache_spec``: the logits and the new state within TOL, for the
    slot-cut chatglm3-6b and the head-cut granite-8b.
"""
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
from torch.distributed.tensor import DTensor, Shard

from repro_torch import bridge
from repro_torch.configs.base import (ARCH_IDS, ShapeConfig, get_arch,
                                      reduced)
from repro_torch.core import prng
from repro_torch.launch import dryrun, shapes
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import api
from repro_torch.sharding import specs as S

torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=2e-3)
JOIN_S = 240
ARCHS = {"granite-8b": {}, "chatglm3-6b": {"n_kv_heads": 1},
         "internvl2-76b": {}, "mamba2-2.7b": {}, "zamba2-1.2b": {},
         "whisper-base": {}}
B, SEQ, FRAMES, STEPS = 4, 12, 24, 8


def _cfg(arch):
    return reduced(get_arch(arch), **ARCHS[arch])


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, SEQ)))}
    normal = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32))
    if cfg.family == "vlm":
        batch["vision_embeds"] = normal(B, cfg.n_vision_tokens, cfg.d_model)
    if cfg.family == "audio":
        batch["frames"] = normal(B, FRAMES, cfg.d_model)
    return batch


def _whole(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def _decode_run(cfg, model, batch, mesh=None):
    """Prefill (cache of the prompt + STEPS slots), then STEPS greedy
    steps: (every step's logits, the final state).  With ``mesh`` the
    model is placed and the batch, tokens and state follow it."""
    rt_p = rt_d = shapes.CPU
    if mesh is not None:
        rt_p = shapes.runtime_for(cfg, "prefill_32k", mesh)
        rt_d = shapes.runtime_for(cfg, "decode_32k", mesh)
        batch = S.shard_batch(mesh, batch)
    prompt = SEQ + (cfg.n_vision_tokens if cfg.family == "vlm" else 0)
    place = (lambda t: t) if mesh is None else \
        (lambda t: S.place(mesh, t, S.batch_spec_for(mesh, B, 1)))
    logits = []
    with torch.no_grad():
        out, state = api.prefill_fn(model, batch, cfg, rt_p,
                                    cache_len=prompt + STEPS)
        logits.append(_whole(out))
        pos = SEQ if cfg.family == "audio" else prompt
        for i in range(STEPS):
            token = place(logits[-1].argmax(-1))
            out, state = api.decode_fn(model, token, state, pos + i, cfg,
                                       rt_d)
            logits.append(_whole(out))
    return logits, state


def _both(cfg, mesh):
    """(the unpartitioned run, the partitioned one) from the same weights
    and batch."""
    batch = _batch(cfg)
    plain = _decode_run(cfg, api.init_params(prng.PRNGKey(0), cfg, "cpu"),
                        batch)
    placed = S.shard_params(api.init_params(prng.PRNGKey(0), cfg, "cpu"),
                            mesh, inference=True)
    return plain, _decode_run(cfg, placed, batch, mesh)


# ---- (a) the layouts on a fake 2 x 2 mesh --------------------------------

@pytest.fixture
def fake_mesh():
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=3, world_size=4)
    yield init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    dist.destroy_process_group()


def _placed_as(tree, spec_tree, mesh):
    """Every leaf of a placed tree against its sanitized spec."""
    leaves, specs = bridge.leaves(tree), _leaves_of_specs(spec_tree)
    assert len(leaves) == len(specs) > 0
    for t, spec in zip(leaves, specs):
        want = S.placements(S.sanitize_spec(spec, tuple(t.shape), mesh), mesh)
        assert isinstance(t, DTensor) and tuple(t.placements) == \
            tuple(want), (spec, t.placements)


def _leaves_of_specs(tree):
    if isinstance(tree, dict):
        return [s for v in tree.values() for s in _leaves_of_specs(v)]
    if isinstance(tree, list):
        return [s for v in tree for s in _leaves_of_specs(v)]
    return [tree]


@pytest.mark.parametrize("inference", [False, True],
                         ids=["train", "inference"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_layouts_of_every_arch_on_a_fake_mesh(fake_mesh, arch, inference):
    mesh, cfg = fake_mesh, get_arch(arch)
    model = api.empty_params(cfg, "meta")
    specs = S.param_specs(model, inference)
    S.shard_params(model, mesh, inference=inference)
    for n, p in model.named_parameters():
        want = S.placements(S.sanitize_spec(specs[n], p.shape, mesh), mesh)
        assert tuple(p.placements) == tuple(want), n
    abstract = shapes.abstract_params(cfg, mesh, inference)
    assert dryrun.local_bytes(model) == dryrun.device_bytes(abstract, mesh)
    shape = ShapeConfig("t", 64, 4, "decode")
    state = api.init_decode_state(cfg, 4, 64, device="meta")
    placed = S.shard_decode_state(mesh, cfg, 4, state)
    _placed_as(placed, S.decode_state_specs(mesh, cfg, 4, state), mesh)
    assert dryrun.local_bytes(placed) == dryrun.device_bytes(
        shapes.abstract_decode_state(cfg, shape, mesh), mesh)


@pytest.mark.parametrize("arch,cut", [("chatglm3-6b", 2),
                                      ("granite-8b", 1)])
def test_placed_cache_holds_this_ranks_slice(fake_mesh, arch, cut):
    mesh, cfg = fake_mesh, _cfg(arch)
    state = api.init_decode_state(cfg, B, 16, device="cpu")
    for layer in state:
        for k in layer:
            layer[k] = torch.randn(layer[k].shape)
    placed = S.shard_decode_state(mesh, cfg, B, state)
    for got, want in zip(bridge.leaves(placed), bridge.leaves(state)):
        assert tuple(got.placements) == (Shard(0), Shard(cut))
        # this process is rank 3: data 1, model 1
        assert torch.equal(got.to_local(),
                           want.chunk(2, 0)[1].chunk(2, cut)[1])
    assert S.shard_decode_state(mesh, cfg, B, placed)[0]["k"].placements \
        == placed[0]["k"].placements


# ---- (b) one gloo rank, bitwise ------------------------------------------

@pytest.fixture
def mesh1():
    yield make_debug_mesh(device="cpu")
    dist.destroy_process_group()


@pytest.mark.parametrize("arch", list(ARCHS))
def test_one_rank_decode_bitwise(mesh1, arch):
    cfg = _cfg(arch)
    (l0, s0), (l1, s1) = _both(cfg, mesh1)
    for i, (a, b) in enumerate(zip(l0, l1, strict=True)):
        assert torch.equal(a, b), (arch, i)
    a, b = bridge.leaves(s0), bridge.leaves(s1)
    assert len(a) == len(b) and all(isinstance(t, DTensor) for t in b)
    for x, y in zip(a, b):
        assert torch.equal(x, _whole(y)), arch


def test_init_decode_state_on_a_mesh(mesh1):
    cfg = _cfg("zamba2-1.2b")
    rt = shapes.make_runtime(mesh1)
    state = api.init_decode_state(cfg, B, 16, device="cpu", runtime=rt)
    plain = api.init_decode_state(cfg, B, 16, device="cpu")
    _placed_as(state, S.decode_state_specs(mesh1, cfg, B, plain), mesh1)
    assert all(torch.equal(_whole(x), y)
               for x, y in zip(bridge.leaves(state), bridge.leaves(plain)))


# ---- (c) spawned 1 x 2 and 2 x 2 ranks, within TOL -----------------------

def _rank_main(rank, shape, store_path, jax_dir=None):
    torch.set_num_threads(1)
    world = int(np.prod(shape))
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, world), rank=rank,
        world_size=world)
    try:
        mesh = make_debug_mesh(*shape, device="cpu")
        for arch in ARCHS:
            cfg = _cfg(arch)
            (l0, s0), (l1, s1) = _both(cfg, mesh)
            for i, (a, b) in enumerate(zip(l0, l1, strict=True)):
                np.testing.assert_allclose(b.numpy(), a.numpy(), **TOL,
                                           err_msg=f"{arch} step {i}")
            for x, y in zip(bridge.leaves(s0), bridge.leaves(s1), strict=True):
                np.testing.assert_allclose(_whole(y).numpy(), x.numpy(),
                                           **TOL, err_msg=arch)
            cache = s1[0]["k"] if isinstance(s1, list) else None
            if arch in CUTS:
                assert cache.placements[1] == Shard(CUTS[arch]), arch
        if jax_dir is not None:
            _jax_case(mesh, rank, Path(jax_dir))
    finally:
        dist.destroy_process_group()


# the model axis (2 ranks) cuts the one K/V head's cache by its slots, and
# granite's two K/V heads by heads
CUTS = {"chatglm3-6b": 2, "granite-8b": 1}
JAX_SEED, JAX_C = 5, 20
# JAX's prefill and one decode step on a (2, 2) mesh of four host
# devices: parameters by param_specs(inference=True), the state by the
# reference's kv_cache_spec, the token by batch_spec_for
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
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    put = lambda t, spec: jax.device_put(t, NamedSharding(
        mesh, S.sanitize_spec(spec, t.shape, mesh)))
    res = {}
    for arch, kv in (("chatglm3-6b", 1), ("granite-8b", None)):
        cfg = reduced(get_arch(arch), **({} if kv is None else
                                         {"n_kv_heads": kv}))
        params = api.init_params(jax.random.PRNGKey(int(sys.argv[2])), cfg)
        tokens = np.load(os.path.join(out, "tokens.npy"))
        B, P = tokens.shape
        logits, state = api.prefill_fn(params, {"tokens": jnp.asarray(
            tokens.astype(np.int32))}, cfg, cache_len=int(sys.argv[3]))
        token = jnp.argmax(logits, -1).astype(jnp.int32)
        kv_spec = S.kv_cache_spec(mesh, cfg, B)
        pstate = {k: put(v, kv_spec) for k, v in state.items()}
        pparams = jax.tree.map(put, params,
                               S.param_specs(params, inference=True))
        rt = shapes.make_runtime(mesh, moe_mode="ep2d")
        step = jax.jit(lambda p, t, s: api.decode_fn(p, t, s, P, cfg, rt))
        new_logits, new_state = step(
            pparams, put(token, S.batch_spec_for(mesh, B, 1)), pstate)
        res[arch] = {"params": jax.tree.map(np.asarray, params),
                     "state": jax.tree.map(np.asarray, state),
                     "token": np.asarray(token),
                     "logits": np.asarray(new_logits),
                     "new_state": jax.tree.map(np.asarray, new_state)}
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
    """JAX's weights (inference layout) and prefill state placed on the
    2 × 2 mesh, one decode step; rank 0 writes the logits and the new
    state, gathered whole, as JAX's stacked tree."""
    _wait_for(jax_dir / "jax.pkl", jax_dir / "jax.failed", "JAX's (2, 2) run")
    with open(jax_dir / "jax.pkl", "rb") as f:
        ref = pickle.load(f)
    out = {}
    for arch, r in ref.items():
        cfg = _cfg(arch)
        model = S.shard_params(bridge.load_dit(api.empty_params(cfg, "cpu"),
                                               r["params"]), mesh,
                               inference=True)
        state = [{k: torch.from_numpy(r["state"][k][i]) for k in ("k", "v")}
                 for i in range(cfg.n_layers)]
        Bt, P = np.load(jax_dir / "tokens.npy").shape
        state = S.shard_decode_state(mesh, cfg, Bt, state)
        token = S.place(mesh, torch.from_numpy(r["token"]).long(),
                        S.batch_spec_for(mesh, Bt, 1))
        with torch.no_grad():
            logits, new = api.decode_fn(model, token, state, P, cfg,
                                        shapes.runtime_for(cfg, "decode_32k",
                                                           mesh))
        out[arch] = {"logits": _whole(logits).numpy(),
                     "placements": tuple(new[0]["k"].placements),
                     "new_state": {k: np.stack([_whole(c[k]).numpy()
                                                for c in new])
                                   for k in ("k", "v")}}
    if rank == 0:
        torch.save(out, jax_dir / "port.tmp")
        os.replace(jax_dir / "port.tmp", jax_dir / "port.pt")


SHAPES = [(1, 2), (2, 2)]


@pytest.fixture(scope="module")
def rank_groups(tmp_path_factory):
    """Both meshes' ranks spawned together (6 processes), each group
    under its own ``FileStore``, beside JAX's (2, 2) run (``JAX_2X2``, a
    process of its own) whose weights the 2 × 2 ranks take last; all
    killed at the end."""
    jax_dir = tmp_path_factory.mktemp("jax2x2")
    rng = np.random.default_rng(JAX_SEED)
    np.save(jax_dir / "tokens.npy", rng.integers(0, 512, (B, SEQ)))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(Path(__file__).resolve().parents[1] / "src"))
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", JAX_2X2, str(jax_dir), str(JAX_SEED),
         str(JAX_C)], env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
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
def test_spawned_ranks_decode_within_tol(rank_groups, shape):
    groups, deadline, _ = rank_groups
    while not groups[shape].join(timeout=5):
        assert time.monotonic() < deadline, "ranks did not finish"


# ---- (d) against JAX's partitioned decode step ---------------------------

@pytest.mark.parametrize("arch", list(CUTS))
def test_decode_step_matches_jax_on_a_2x2_mesh(rank_groups, arch):
    groups, deadline, jax_dir = rank_groups
    _wait_for(jax_dir / "jax.pkl", jax_dir / "jax.failed", "JAX's (2, 2) run")
    while not groups[(2, 2)].join(timeout=5):
        assert time.monotonic() < deadline, "ranks did not finish"
    with open(jax_dir / "jax.pkl", "rb") as f:
        ref = pickle.load(f)[arch]
    got = torch.load(jax_dir / "port.pt", weights_only=False)[arch]
    assert got["placements"][1] == Shard(CUTS[arch])
    np.testing.assert_allclose(got["logits"], ref["logits"], **TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(got["new_state"][k], ref["new_state"][k],
                                   **TOL, err_msg=k)
