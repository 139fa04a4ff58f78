"""The federated round, the train runtime and the sample engine laid over a
1-D ``("clients",)`` mesh (sharding/specs.py ``shard_*``,
core/collab.py, train/runtime.py, core/sampler.py) on the CPU.

(a) The five placements (``shard_round_batches``, ``shard_cohort_round``,
    ``shard_vectorized_state``, ``shard_sample_plan``, ``shard_inject``)
    on meshes of 1, 2 and 4 ranks (a ``fake`` process group in process,
    this process the last rank): each placed operand's placement is its
    spec sanitized against its shape, and its local part this rank's
    slice; a slot or group count the mesh does not divide stays
    replicated; ``shard_vectorized_state`` records the owning ranks.
(b) One ``gloo`` rank in process, the toy denoiser and the SMALL U-Net:
    a masked, identity-keyed round on placed operands is bitwise the
    unplaced round; the unplaced round is JAX's unsharded
    ``make_vectorized_round`` within TOL (the reference's own mesh path
    fails, tests/test_collab_engine.py); the sample engine on placed
    tables and inject is bitwise the unplaced engine.
(c) 2 and 4 ``gloo`` ranks spawned together (a ``FileStore`` each, a join
    limit): a 3-round ``TrainRuntime`` (four clients, full participation
    with mid-round drops, FedAvg every 2, EMA, async stragglers) whose
    clients' params, moments and steps equal the unsharded run's
    bitwise, whose server and EMA lie within TOL of it and are bitwise
    alike on every rank, registries and queues alike; a tier-1 round
    (replicated on the mesh) bitwise the unsharded one; the sample engine
    bitwise at group and request counts that the world size divides and
    that it does not.
"""
import functools
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import DeviceMesh

from repro.core import collab as jcollab
from repro.optim import adamw as jadamw
from repro_torch import bridge
from repro_torch.core import collab, prng, trees
from repro_torch.core import sample_plan as tsp
from repro_torch.core.sampler import make_sample_engine
from repro_torch.launch.collab_train import toy_apply, toy_init
from repro_torch.optim.adamw import AdamWConfig, init_opt_state
from repro_torch.sharding import specs as S
from repro_torch.train import ParticipationConfig, TrainConfig, TrainRuntime

torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=2e-3)
JOIN_S = 240
WORLDS = (2, 4)
OPT = AdamWConfig(lr=1e-3)
# the SMALL U-Net at 8 x 8 (collab.build_denoiser's default), as
# tests/test_torch_collab_vectorized_unet.py
UKW = dict(n_clients=2, T=12, t_cut=6, image_size=8, channels=3,
           n_classes=4, batch_size=2)


# ---- (a) the placements --------------------------------------------------

@pytest.fixture
def fake_mesh():
    def make(world):
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=world - 1,
                                world_size=world)
        return DeviceMesh("cpu", torch.arange(world),
                          mesh_dim_names=(S.CLIENT_AXIS,))
    yield make
    if dist.is_initialized():
        dist.destroy_process_group()


def _check(placed, value, spec, mesh):
    """``placed`` lays ``value`` out by ``spec`` sanitized against its
    shape, this rank holding its slice."""
    value = torch.as_tensor(value)
    world, rank = mesh.size(), mesh.get_local_rank()
    want = S.sanitize_spec(spec, tuple(value.shape), mesh)
    local, m, dim = S.local_part(placed)
    assert m is mesh and tuple(placed.shape) == tuple(value.shape)
    cut = [i for i, e in enumerate(want) if e is not None]
    if not cut:
        assert dim is None and torch.equal(local, value)
        return
    assert dim == cut[0] and want[dim] == S.CLIENT_AXIS
    assert local.shape[dim] == value.shape[dim] // world
    assert torch.equal(local, value.chunk(world, dim)[rank])


def _round_operands(k, nb=2, B=3):
    rng = np.random.default_rng(k)
    xs = torch.from_numpy(rng.normal(size=(nb, k, B, 4, 4, 3))
                          .astype(np.float32))
    ys = torch.from_numpy(np.eye(4, dtype=np.float32)[
        rng.integers(0, 4, (nb, k, B))])
    return xs, ys, (rng.uniform(size=(nb, k, B)) > 0.3).astype(np.float32)


def _plan_tables(G, R, nc=4):
    rng = np.random.default_rng(G * 10 + R)
    f32 = lambda *s: torch.from_numpy(rng.uniform(size=s).astype(np.float32))
    i32 = lambda *s: torch.from_numpy(rng.integers(0, 9, s).astype(np.int32))
    return tsp.PlanTables(
        group_y=f32(G, 2, nc), group_t=f32(G, 5), group_t_prev=f32(G, 5),
        group_active=f32(G, 5), group_seed=i32(G), request_group=i32(R),
        request_client=i32(R), request_seed=i32(R), client_t=f32(R, 3),
        client_t_prev=f32(R, 3), client_active=f32(R, 3))


def _place_round(mesh, k):
    xs, ys, mask = _round_operands(k)
    got = S.shard_round_batches(mesh, xs, ys, mask)
    for placed, value in zip(got, (xs, ys, mask)):
        _check(placed, value, S.client_batch_spec(value.ndim), mesh)
    assert S.shard_round_batches(mesh, xs, ys)[2] is None


def _place_cohort(mesh, k):
    xs, ys, mask = _round_operands(k)
    uids = np.arange(k, dtype=np.int32) * 3
    got = S.shard_cohort_round(mesh, xs, ys, mask, uids)
    for placed, value in zip(got[:3], (xs, ys, mask)):
        _check(placed, value, S.client_batch_spec(value.ndim), mesh)
    _check(got[3], uids, S.cohort_uid_spec(), mesh)


def _place_state(mesh, k):
    models = [toy_init(prng.fold_in(prng.PRNGKey(0), c)) for c in range(k)]
    state = collab.VectorizedCollabState(
        server_params=models[0], server_opt=init_opt_state(models[0]),
        client_params=models, client_opt=[init_opt_state(m) for m in models])
    assert S.shard_vectorized_state(state, mesh) is state
    world = mesh.size()
    assert state.mesh is mesh
    assert state.owners == (None if k % world else
                            [c // (k // world) for c in range(k)])


def _place_plan(mesh, k):
    tables = _plan_tables(k, 2 * k - 1)
    placed = S.shard_sample_plan(mesh, tables)
    assert type(placed) is tsp.PlanTables
    for p, v, s in zip(placed, tables, S.sample_plan_specs(tables)):
        _check(p, v, s, mesh)


def _place_inject(mesh, k):
    rng = np.random.default_rng(k)
    inj = tsp.InjectTables(
        x=torch.from_numpy(rng.normal(size=(k, 2, 4, 4, 3))
                           .astype(np.float32)),
        y=np.eye(4, dtype=np.float32)[rng.integers(0, 4, (k, 2))])
    placed = S.shard_inject(mesh, inj)
    assert type(placed) is tsp.InjectTables
    for p, v, s in zip(placed, inj, S.inject_specs(inj)):
        _check(p, v, s, mesh)


PLACERS = {"shard_round_batches": _place_round,
           "shard_cohort_round": _place_cohort,
           "shard_vectorized_state": _place_state,
           "shard_sample_plan": _place_plan, "shard_inject": _place_inject}


@pytest.mark.parametrize("k", [4, 6, 3])
@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("fn", sorted(PLACERS))
def test_placement_specs_and_local_shapes(fake_mesh, fn, world, k):
    PLACERS[fn](fake_mesh(world), k)


# ---- shared by (b) and (c) -----------------------------------------------

def _toy_round_state(k, seed=1):
    cp = [toy_init(prng.fold_in(prng.PRNGKey(seed), c)) for c in range(k)]
    sp = toy_init(prng.PRNGKey(seed + 100))
    return cp, [init_opt_state(p) for p in cp], sp, init_opt_state(sp)


def _y(label, B=2, nc=4):
    return np.broadcast_to(np.eye(nc, dtype=np.float32)[label],
                           (B, nc)).copy()


def _sample_case(case, T, hit=None):
    """The plan of a wave: ``case`` (G, R) unique (cut, label) groups and
    requests over three clients; ``hit`` (B, ...) makes label 0's group a
    cache hit (injected) when given."""
    G, R = case
    cuts = [2, 5, T, 0, 7][:G] if G <= 5 else None
    reqs = [tsp.SampleRequest(r % 3, cuts[r % G], _y(r % G % 4))
            for r in range(R)]
    look = None if hit is None else \
        (lambda gk: hit if gk == tsp.group_key(cuts[0], _y(0)) else None)
    plan = tsp.plan_requests(reqs, T, n_clients=3, lookup_fn=look,
                             image_shape=tuple(hit.shape[1:])
                             if hit is not None else None,
                             request_seeds=[3 * r + 1 for r in range(R)])
    return plan, tsp.tables_to_device(plan.tables, "cpu"), \
        tsp.inject_to_device(plan.inject, "cpu")


def _engine_pass(apply_fn, sp, cps, case, T, mesh=None, hit=None):
    """(samples, handoffs) of one engine pass; tables and inject placed on
    ``mesh`` when given."""
    sched = collab.CollabConfig(T=T).sched("cpu")
    _, tables, inject = _sample_case(case, T, hit)
    if mesh is not None:
        tables = S.shard_sample_plan(mesh, tables)
        inject = None if inject is None else S.shard_inject(mesh, inject)
    engine = make_sample_engine(sched, apply_fn, (4, 4, 3))
    return engine(sp, cps, prng.PRNGKey(4), tables, inject)


# ---- (b) one rank in process ---------------------------------------------

@pytest.fixture
def mesh1():
    assert not dist.is_initialized()
    mesh = S.make_client_mesh(4, device="cpu")
    yield mesh
    dist.destroy_process_group()


@functools.lru_cache(maxsize=None)
def _unet_weights(n):
    """``n`` SMALL U-Nets in JAX's layout: numpy normals, std 0.05."""
    init_one, _ = jcollab.build_denoiser(
        None, jcollab.CollabConfig(**UKW))
    like = jax.eval_shape(init_one, jax.random.PRNGKey(0))
    rng = np.random.default_rng(11)
    return [jax.tree.map(lambda s: (0.05 * rng.standard_normal(s.shape))
                         .astype(np.float32), like) for _ in range(n)]


def _unet_models(n):
    init_one, apply_fn = collab.build_denoiser(
        None, collab.CollabConfig(**UKW), "cpu")
    return [bridge.load_unet(init_one(prng.PRNGKey(0)), p)
            for p in _unet_weights(n)], apply_fn


def _round_case(denoiser, t_cut=None):
    """(apply_fn, state maker, xs, ys, mask, uids, config): three slots
    (the last a pad slot), a ragged mask, at the mid cut unless
    ``t_cut`` is given."""
    if denoiser == "toy":
        k, T, img = 3, 20, (4, 4, 3)
        t_cut = 5 if t_cut is None else t_cut
        make = lambda: _toy_round_state(k)
        apply_fn = toy_apply
    else:
        k, T, img = 3, UKW["T"], (8, 8, 3)
        t_cut = UKW["t_cut"] if t_cut is None else t_cut

        def make():
            models, _ = _unet_models(k + 1)
            return (models[1:], [init_opt_state(m) for m in models[1:]],
                    models[0], init_opt_state(models[0]))
        apply_fn = _unet_models(1)[1]
    rng = np.random.default_rng(2)
    xs = torch.from_numpy(rng.uniform(-1, 1, (2, k, 2) + img)
                          .astype(np.float32))
    ys = torch.from_numpy(np.eye(4, dtype=np.float32)[
        rng.integers(0, 4, (2, k, 2))])
    mask = np.ones((2, k, 2), np.float32)
    mask[:, k - 1] = 0.0                     # a pad slot
    mask[1, 0, 1:] = 0.0                     # a short last batch
    uids = np.array([5, 1, 5][:k], np.int32)
    cfg = collab.CollabConfig(T=T, t_cut=t_cut)
    return apply_fn, make, xs, ys, mask, uids, cfg


@pytest.mark.parametrize("denoiser", ["toy", "unet"])
def test_placed_round_is_bitwise_the_unplaced(mesh1, denoiser):
    apply_fn, make, xs, ys, mask, uids, cfg = _round_case(denoiser)
    fn = collab.make_vectorized_round(cfg.sched("cpu"), cfg.cut(), apply_fn,
                                      OPT, identity_keyed=True)
    plain, placed = make(), make()
    m0 = fn(*plain, xs, ys, mask, uids, prng.PRNGKey(3))[4]
    S.COMM_BYTES.clear()
    m1 = fn(*placed, *S.shard_cohort_round(mesh1, xs, ys, mask, uids),
            prng.PRNGKey(3))[4]
    assert S.COMM_BYTES["all_reduce"] > 0 and S.COMM_BYTES["all_gather"] > 0
    for a, b in zip(plain, placed):
        assert trees.equal(a, b)
    assert set(m0) == set(m1)
    for n in m0:
        assert torch.equal(m0[n], m1[n]), n


def test_placed_dense_round_divides_by_the_row_count(mesh1):
    """An unmasked round on placed operands: the server loss is the
    batch's sum over its row count (a rank's part of it, summed), within
    TOL of the unplaced mean."""
    apply_fn, make, xs, ys, _, _, cfg = _round_case("toy")
    fn = collab.make_vectorized_round(cfg.sched("cpu"), cfg.cut(), apply_fn,
                                      OPT, masked=False)
    plain, placed = make(), make()
    m0 = fn(*plain, xs, ys, prng.PRNGKey(3))[4]
    m1 = fn(*placed, *S.shard_round_batches(mesh1, xs, ys)[:2],
            prng.PRNGKey(3))[4]
    for a, b in zip(plain, placed):
        for x, y in zip(trees.leaves(a), trees.leaves(b), strict=True):
            torch.testing.assert_close(y, x, **TOL)
    for n in m0:
        torch.testing.assert_close(m1[n], m0[n], **TOL)


def test_placed_state_trains_as_the_unplaced(mesh1):
    """``shard_vectorized_state`` + ``train_round_vectorized``: the
    round's operands placed on the state's mesh, its slots sent from
    their owner after it; bitwise the unplaced state's round."""
    _, _, xs, ys, mask, _, cfg = _round_case("toy")
    fn = collab.make_vectorized_round(cfg.sched("cpu"), cfg.cut(),
                                      toy_apply, OPT)
    states = []
    for placed in (False, True):
        cp, co, sp, so = _toy_round_state(3)
        st = collab.VectorizedCollabState(sp, so, cp, co)
        if placed:
            S.shard_vectorized_state(st, mesh1)
            assert st.owners == [0, 0, 0]
        S.COMM_BYTES.clear()
        out = collab.train_round_vectorized(st, fn, xs, ys, prng.PRNGKey(2),
                                            mask)
        assert ("broadcast" in S.COMM_BYTES) == placed
        states.append((st, out))
    (a, ra), (b, rb) = states
    assert ra == rb and a.step == b.step
    for x, y in ((a.server_params, b.server_params),
                 (a.server_opt, b.server_opt),
                 (a.client_params, b.client_params),
                 (a.client_opt, b.client_opt)):
        assert trees.equal(x, y)


@pytest.mark.parametrize("denoiser,t_cut", [("toy", 5), ("unet", 0)])
def test_unplaced_round_matches_jax(denoiser, t_cut):
    """The U-Net at the GM cut (the server alone trains: the part of the
    round the mesh cuts; the mid cut's JAX compile takes twice as long,
    and tests/test_torch_collab_vectorized_unet.py holds it)."""
    apply_fn, make, xs, ys, mask, uids, cfg = _round_case(denoiser, t_cut)
    cp, co, sp, so = make()
    metrics = collab.make_vectorized_round(
        cfg.sched("cpu"), cfg.cut(), apply_fn, OPT, identity_keyed=True)(
        cp, co, sp, so, xs, ys, mask, uids, prng.PRNGKey(3))[4]
    jcfg = jcollab.CollabConfig(**dict(UKW, T=cfg.T, t_cut=cfg.t_cut))
    if denoiser == "toy":
        jparams = lambda m: {n: jnp.asarray(v.detach().numpy())
                             for n, v in m.items()}
        jsp, *jcp = [jparams(m) for m in [_toy_round_state(3)[2]] +
                     _toy_round_state(3)[0]]
        japply = toy_apply
    else:
        jsp, *jcp = _unet_weights(4)
        japply = jcollab.build_denoiser(None, jcfg)[1]
    jround = jax.jit(jcollab.make_vectorized_round(
        jcfg.sched(), jcfg.cut(), japply, jadamw.AdamWConfig(lr=OPT.lr),
        identity_keyed=True))
    jout = jround(jcollab.stack_clients(jcp), jcollab.stack_clients(
        [jadamw.init_opt_state(p) for p in jcp]), jsp,
        jadamw.init_opt_state(jsp), jnp.asarray(xs.numpy()),
        jnp.asarray(ys.numpy()), jnp.asarray(mask), jnp.asarray(uids),
        jax.random.PRNGKey(3))
    jcps = bridge.unstack(jax.tree.map(np.asarray, jout[0]))
    port = lambda m: {n: t.detach().numpy() for n, t in m.items()} \
        if denoiser == "toy" else bridge.dump_params(m, jsp)
    for got, want in zip([port(m) for m in cp] + [port(sp)],
                         jcps + [jax.tree.map(np.asarray, jout[2])]):
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want),
                        strict=True):
            np.testing.assert_allclose(a, np.asarray(b), **TOL)
    for n in ("client_loss", "server_loss"):
        np.testing.assert_allclose(metrics[n].numpy(), np.asarray(jout[4][n]),
                                   err_msg=n, **TOL)


@pytest.mark.parametrize("denoiser", ["toy", "unet"])
def test_placed_sample_engine_is_bitwise(mesh1, denoiser):
    if denoiser == "toy":
        cp, _, sp, _ = _toy_round_state(3)
        apply_fn, img, T = toy_apply, (4, 4, 3), 8
    else:
        models, apply_fn = _unet_models(4)
        sp, cp, img, T = models[0], models[1:], (8, 8, 3), 6
    hit = torch.from_numpy(np.random.default_rng(5).normal(
        size=(2,) + img).astype(np.float32))
    engine = make_sample_engine(collab.CollabConfig(T=T).sched("cpu"),
                                apply_fn, img)
    _, tables, inject = _sample_case((4, 7), T, hit)
    assert inject is not None and inject.x.shape[0] == 1
    plain = engine(sp, cp, prng.PRNGKey(4), tables, inject)
    placed = engine(sp, cp, prng.PRNGKey(4),
                    S.shard_sample_plan(mesh1, tables),
                    S.shard_inject(mesh1, inject))
    for a, b in zip(plain, placed):
        assert not isinstance(b, torch.distributed.tensor.DTensor)
        assert torch.equal(a, b)


# ---- (c) 2 and 4 ranks ---------------------------------------------------

RT_CLIENTS, RT_ROUNDS = 4, 3


def _rt_config(**kw):
    base = dict(T=20, t_cut=5, image_shape=(4, 4, 3), n_classes=4,
                batch_size=4, batches_per_round=2, fedavg_every=2,
                ema_decay=0.9, async_mode=True,
                participation=ParticipationConfig(
                    policy="full", drop_p=0.3, lag_p=0.5, lag_max=2))
    base.update(kw)
    return TrainConfig(**base)


def _rt_data(uid):
    rng = np.random.default_rng(40 + uid)
    n = (12, 8, 10, 6)[uid]
    x = torch.from_numpy(rng.uniform(-1, 1, (n, 4, 4, 3))
                         .astype(np.float32))
    return x, torch.from_numpy(np.eye(4, dtype=np.float32)[
        rng.integers(0, 4, n)])


def _runtime(mesh, config, rounds, n_clients=RT_CLIENTS):
    rt = TrainRuntime(config, toy_init, toy_apply, prng.PRNGKey(6),
                      mesh=mesh, device="cpu")
    for u in range(n_clients):
        rt.register_client(*_rt_data(u))
    reps = rt.run(rounds)
    return rt, reps


def _runtime_arrays(rt, tag):
    """Every tensor and counter of a runtime, by name, as numpy."""
    out = {}

    def put(name, model, opt=None):
        for n, t in trees.as_tree(model).items():
            out[f"{tag}/{name}.p.{n}"] = t.detach().numpy()
        if opt is not None:
            for kind in ("m", "v"):
                for n, t in opt[kind].items():
                    out[f"{tag}/{name}.{kind}.{n}"] = t.numpy()
            out[f"{tag}/{name}.step"] = opt["step"].numpy()
    put("server", rt.server_params, rt.server_opt)
    put("ema", rt.ema_server)
    for u in rt.registry.uids():
        r = rt.registry.get(u)
        put(f"client{u}", r.params, r.opt)
        out[f"{tag}/client{u}.counters"] = np.array(
            [r.seen, r.window_seen, r.window_member, r.active])
    for i, p in enumerate(sorted(rt._pending, key=rt._delivery_order)):
        put(f"pending{i}", p["params"], p["opt"])
        out[f"{tag}/pending{i}.meta"] = np.array(
            [p["uid"], p["compute_round"], p["due_round"], p["n_real"]])
    out[f"{tag}/cursor"] = np.array([rt.round, rt.total_steps])
    return out


ENGINE_CASES = {"divides": ((5, 8), True), "does_not": ((3, 5), False)}


def _everything(mesh):
    """The runtime's run, the tier-1 round and the engine passes; on
    ``mesh`` when given."""
    rt, reps = _runtime(mesh, _rt_config(), RT_ROUNDS)
    out = _runtime_arrays(rt, "rt")
    out["rt/tiers"] = np.array([r["tier"] for r in reps])
    out["rt/stragglers"] = np.array([r["stragglers"] for r in reps])
    one, _ = _runtime(mesh, _rt_config(participation=ParticipationConfig(
        policy="fixed", cohort_k=1)), 1)
    out.update(_runtime_arrays(one, "tier1"))
    cp, _, sp, _ = _toy_round_state(3)
    hit = torch.full((2, 4, 4, 3), 0.25)
    for name, (case, with_hit) in ENGINE_CASES.items():
        samples, hand = _engine_pass(toy_apply, sp, cp, case, 8, mesh,
                                     hit if with_hit else None)
        out[f"engine/{name}/samples"] = samples.numpy()
        out[f"engine/{name}/handoffs"] = hand.numpy()
    return out


def _rank_main(rank, world, store_path, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        mesh = S.make_client_mesh(RT_CLIENTS, device="cpu")
        assert mesh.size() == world
        np.savez(f"{out_dir}/w{world}r{rank}.npz", **_everything(mesh))
    finally:
        dist.destroy_process_group()


def test_runtime_and_engine_across_ranks(tmp_path):
    ctxs = [mp.start_processes(
        _rank_main, args=(w, str(tmp_path / f"store{w}"), str(tmp_path)),
        nprocs=w, join=False, start_method="spawn") for w in WORLDS]
    try:
        want = _everything(None)        # the unsharded run, meanwhile
        deadline = time.monotonic() + JOIN_S
        for ctx in ctxs:
            while not ctx.join(timeout=2):
                assert time.monotonic() < deadline, "ranks did not finish"
    finally:
        for ctx in ctxs:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
    # a tier-4 cohort and async stragglers occurred
    assert (want["rt/tiers"] == 4).any() and want["rt/stragglers"].sum() > 0
    inexact = ("rt/server.", "rt/ema.")
    for w in WORLDS:
        got = [dict(np.load(tmp_path / f"w{w}r{r}.npz")) for r in range(w)]
        for r, g in enumerate(got):
            assert set(g) == set(want), (w, r)
            for name, a in want.items():
                if name.startswith(inexact):
                    np.testing.assert_allclose(g[name], a, **TOL,
                                               err_msg=f"{w}/{r} {name}")
                    assert np.array_equal(g[name], got[0][name]), \
                        f"{w} ranks: {name} differs from rank 0's on {r}"
                else:
                    assert np.array_equal(g[name], a), f"{w}/{r} {name}"
