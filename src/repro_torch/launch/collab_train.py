"""Thin CLI over the federated training runtime (train/runtime.py); the
port of the JAX package's ``launch/collab_train.py``, with its flags and
its smoke, plus ``--device`` (CUDA unless ``--device cpu`` is given).

    PYTHONPATH=src python -m repro_torch.launch.collab_train --smoke
    PYTHONPATH=src python -m repro_torch.launch.collab_train --smoke \
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.collab_train \
        --clients 5 --T 1000 --t-cut 200 --rounds 10 --policy bernoulli \
        --p 0.8 --drop-p 0.1 --fedavg-every 4 --ema 0.99 \
        --checkpoint runs/collafuse.msgpack --checkpoint-every 2 [--resume]

The runtime runs on a 1-D ``("clients",)`` mesh (``make_mesh``), as the
reference's does: over the caller's process group, or torchrun's when
``WORLD_SIZE`` is set, one rank's otherwise; a group the CLI made itself
is torn down before ``main`` returns, and only rank 0 prints.

All the training machinery lives in ``repro_torch.train`` (client registry
→ participation sampler → shape-stable cohort round plan → identity-
keyed masked engine → FedAvg/EMA aggregation → checkpoint loop) — this
CLI only builds models, synthesizes per-client datasets, replays
join/leave events, and prints the round reports:

  register clients → TrainRuntime.run_round per round → cohort / tier /
  padded-waste / recompile / loss report, periodic durable checkpoints.

Each client holds its OWN synthetic attribute-structured dataset
(non-IID by default, mirroring the paper's CelebA split; ``--client-
sizes`` makes them unbalanced) and participates only when the sampler
picks it (``--policy`` full | bernoulli | fixed, ``--drop-p`` mid-round
dropout).  ``--join-at``/``--leave-at`` replay a roster change mid-run
(one extra client joins / client 0 leaves at that round).  ``--resume``
restores the checkpoint and continues toward ``--rounds`` total rounds —
bitwise-equal to never having stopped, since all randomness is
addressed by (base key, stream tag, round, uid).  ``--toy`` (default
for --smoke) uses the protocol-scale linear denoiser; ``--denoiser
unet`` (the default otherwise) trains the reduced paper U-Net.

``--lag-p``/``--lag-max`` inject stragglers (addressed TAG_LAG draws),
``--lag-s`` charges them simulated wall-clock, and ``--async`` switches
the aggregator to staleness-tolerant merging (``fedavg.average_stale``)
so late uploads fold in with decayed weight instead of blocking the
round barrier — see train/runtime.py for the sync-bitwise vs
async-tolerance reproducibility contract.

``--smoke``: a 5-client ragged
roster under bernoulli participation with mid-round dropout, ASSERTING
the train-runtime contract — (a) at least one round trained a STRICT
SUBSET cohort, (b) every participation tier compiled exactly ONE engine
signature for the whole run (the RecompileGuard: signatures seen ==
distinct tiers), (c) a run interrupted at the midpoint and resumed
from its checkpoint finishes BITWISE equal to the uninterrupted run
(server+client params, optimizer moments and step counters, EMA track,
RNG key, cohort cursor, and in-flight async payloads all compared), and
(d) straggler-injected overlap invariants: the sync barrier is pure
wall-clock (lagged run BITWISE equal to the lag-free run with
barrier_stall_s > 0), async merging stays within the documented atol
5e-2 tolerance with zero barrier stall and zero recompile regression,
and (e) the privacy pass — the ``--dp-clip/--dp-sigma/--dp-delta/
--secagg`` flags' neutral values (clip=inf, σ=0, secagg off) are
BITWISE equal to the baseline run (the identity ladder), a DP run with
secagg ON is bitwise equal to the same DP run with secagg OFF (pairwise
masks cancel exactly in the fixed-point cohort sum), and the reported
cumulative ε is finite, strictly positive after the first release, and
monotone non-decreasing across round reports, and (f) the observability
pass — an obs-enabled replica (``--obs-jsonl``/``--trace-out``) finishes
BITWISE equal to the plain run with the same signature count (spans and the
JSONL sink are pure observers), its JSONL stream round-trips with one
metrics frame per round, and the Perfetto trace decomposes every round
into cohort_sample / plan / round_dispatch / fedavg child spans.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import tempfile

import numpy as np
import torch

from repro_torch.core import prng, trees
from repro_torch.core.collab import CollabConfig, build_denoiser
from repro_torch.data.synthetic import SyntheticConfig, make_client_datasets
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import ensure_group
from repro_torch.obs import ObsConfig
from repro_torch.sharding.specs import make_client_mesh
from repro_torch.train import (ParticipationConfig, PrivacyConfig,
                               TrainConfig, TrainRuntime)
from repro_torch.train.rounds import participation_tier


def obs_from_args(args):
    """ObsConfig from the CLI sink flags, or None when all are off (the
    structurally-inert default)."""
    cfg = ObsConfig(jsonl_path=getattr(args, "obs_jsonl", None),
                    trace_path=getattr(args, "trace_out", None),
                    profile_waves=getattr(args, "profile_rounds", 0) or 0,
                    profile_dir=getattr(args, "profile_dir", None))
    return cfg if cfg.active else None


def toy_init(k):
    """The protocol-scale linear denoiser's parameters, on the key's
    device: ε̂ = a·x + b."""
    return {"a": prng.uniform(k, (), 0.1, 0.6).requires_grad_(),
            "b": torch.zeros((), device=k.device, requires_grad=True)}


def toy_apply(p, x, t, y):
    return x * p["a"] + p["b"]


def build_model(args, key, device):
    """Returns (init_one, apply_fn); ``init_one`` builds on ``device``."""
    if args.denoiser == "toy":
        return toy_init, toy_apply
    ccfg = CollabConfig(n_clients=args.clients, T=args.T, t_cut=args.t_cut,
                        denoiser=args.denoiser, image_size=args.image_size,
                        batch_size=args.batch, n_classes=args.n_classes)
    return build_denoiser(key, ccfg, device)


def make_train_config(args) -> TrainConfig:
    return TrainConfig(
        T=args.T, t_cut=args.t_cut,
        image_shape=(args.image_size, args.image_size, 3),
        n_classes=args.n_classes,
        batch_size=args.batch, batches_per_round=args.batches_per_round,
        lr=args.lr,
        participation=ParticipationConfig(
            policy=args.policy, p=args.p, cohort_k=args.cohort_k,
            drop_p=args.drop_p, lag_p=args.lag_p, lag_max=args.lag_max),
        privacy=PrivacyConfig(
            clip=args.dp_clip, noise_multiplier=args.dp_sigma,
            delta=args.dp_delta, secagg=args.secagg),
        fedavg_every=args.fedavg_every, ema_decay=args.ema,
        async_mode=args.async_mode, stale_alpha=args.stale_alpha,
        stale_decay=args.stale_decay, lag_s=args.lag_s)


def make_data(args, key, device):
    dcfg = SyntheticConfig(image_size=args.image_size,
                           n_attrs=args.n_classes)
    sizes = (None if args.client_sizes is None else
             [int(s) for s in args.client_sizes.split(",")])
    return make_client_datasets(key, dcfg, args.clients, args.n_per_client,
                                non_iid=not args.iid, sizes=sizes,
                                device=device)


def make_mesh(args):
    """A 1-D ``("clients",)`` mesh sized to the pow2 tier menu
    (sharding/specs.py ``make_client_mesh``), so a sharded cohort axis
    divides every tier, laid over the process group: one rank where no
    group exists (``main`` then sets one up for the run and tears it
    down)."""
    return make_client_mesh(participation_tier(args.clients),
                            device=args.device)


def join_group(device) -> bool:
    """Set up the process group the mesh lays over where none exists:
    torchrun's (``env://``) when ``WORLD_SIZE`` is set, else one rank's
    (launch/mesh.py ``ensure_group``).  True when this call made it."""
    import torch.distributed as dist
    if dist.is_initialized():
        return False
    dev = resolve_device(device)
    if "WORLD_SIZE" in os.environ:
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    else:
        ensure_group(dev)
    return True


def say(*a) -> None:
    """``print`` on rank 0 of the process group (or without one)."""
    import torch.distributed as dist
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(*a)


def fresh_runtime(args, key, init_one, apply_fn, data,
                  obs=None) -> TrainRuntime:
    rt = TrainRuntime(make_train_config(args), init_one, apply_fn, key,
                      mesh=make_mesh(args), obs=obs, device=args.device)
    for (x, y) in data:
        rt.register_client(x, y)
    return rt


def print_report(tag: str, rep: dict):
    say(f"{tag}: cohort={rep['cohort']} tier={rep['tier']} "
          f"drops={rep['mid_round_drops']} "
          f"lag={rep['stragglers']}/{rep['stale_merges']}"
          f"/{rep['pending_payloads']} "
          f"waste={rep['pad_waste_frac']:.2f} "
          f"traces={rep['engine_traces']} "
          f"client_loss={rep['client_loss']:.4f} "
          f"server_loss={rep['server_loss']:.4f} "
          f"fedavg={rep['fedavg_applied']}"
          + (f" eps={rep['dp_epsilon']:.3f}@ep{rep['dp_epoch']}"
             if rep.get("dp_epoch") else "")
          + f" ({rep['wall_s']:.2f}s)")


def assert_runtimes_bitwise(a: TrainRuntime, b: TrainRuntime) -> None:
    """Full-state bitwise comparison: params, opt states (moments AND
    step counters), EMA, registry counters, cohort cursor, RNG key."""
    assert a.round == b.round and a.total_steps == b.total_steps
    assert torch.equal(a._key, b._key)
    assert trees.equal(a.server_params, b.server_params)
    assert trees.equal(a.server_opt, b.server_opt)
    assert trees.equal(a.ema_server, b.ema_server)
    assert a.registry.uids() == b.registry.uids()
    for u in a.registry.uids():
        ra, rb = a.registry.get(u), b.registry.get(u)
        assert trees.equal(ra.params, rb.params), f"client {u} params"
        assert trees.equal(ra.opt, rb.opt), f"client {u} opt"
        assert (ra.seen, ra.window_seen, ra.active) == \
            (rb.seen, rb.window_seen, rb.active), f"client {u} counters"
    # privacy state (neutral configs: None/0 on both sides)
    assert a.dp_epoch == b.dp_epoch
    assert trees.equal(a._dp_ref, b._dp_ref)
    if a._accountant is not None or b._accountant is not None:
        sa, sb = a._accountant.state_dict(), b._accountant.state_dict()
        assert np.array_equal(sa["rdp"], sb["rdp"]) and \
            sa["steps"] == sb["steps"]
    # in-flight async payloads (empty in sync mode) are state too
    assert len(a._pending) == len(b._pending)
    order = lambda p: (p["due_round"], p["compute_round"], p["uid"])
    for pa, pb in zip(sorted(a._pending, key=order),
                      sorted(b._pending, key=order)):
        assert order(pa) == order(pb) and pa["n_real"] == pb["n_real"]
        assert trees.equal(pa["params"], pb["params"])
        assert trees.equal(pa["opt"], pb["opt"])


def smoke(args) -> dict:
    """CI assertions — see module docstring.  Raises on violation."""
    device = resolve_device(args.device)
    key = prng.PRNGKey(args.seed)
    init_one, apply_fn = build_model(args, key, device)
    data = make_data(args, key, device)
    mk = lambda: fresh_runtime(args, key, init_one, apply_fn, data)

    # (a)+(b): partial-participation churn converges onto the tier menu
    rt = mk()
    reps = rt.run(args.rounds)
    for r in reps:
        print_report(f"train/round{r['round']}", r)
    subset_rounds = sum(1 for r in reps
                        if r["strict_subset"] and r["cohort_size"] > 0)
    assert subset_rounds >= 1, "no strict-subset cohort round"
    last = reps[-1]
    assert last["max_signatures_per_tier"] == 1, last
    assert rt.traces == len(last["signatures_per_tier"]), \
        (rt.traces, last["signatures_per_tier"])
    # steady state: more churn, zero NEW compiles beyond new tiers
    more = rt.run(4)[-1]
    assert more["max_signatures_per_tier"] == 1, more
    assert rt.traces == len(more["signatures_per_tier"]), \
        (rt.traces, more["signatures_per_tier"])

    # (c): interrupt at the midpoint, resume from checkpoint, finish —
    # bitwise equal to the uninterrupted run
    full = mk()
    full.run(args.rounds)
    half = mk()
    mid = args.rounds // 2
    half.run(mid)
    path = os.path.join(tempfile.mkdtemp(), "train_smoke.msgpack")
    half.save(path)
    resumed = TrainRuntime.restore(make_train_config(args), init_one,
                                   apply_fn, path, mesh=make_mesh(args),
                                   device=args.device)
    for uid, (x, y) in enumerate(data):
        resumed.attach_data(uid, x, y)
    resumed.run(args.rounds - mid)
    assert_runtimes_bitwise(full, resumed)

    # (d): straggler-injected overlap invariants.  Sync mode's
    # straggler barrier is pure wall-clock — the run is BITWISE equal
    # to the lag-free run while barrier_stall_s > 0 records the blocked
    # time.  Async mode folds the same late uploads in through
    # fedavg.average_stale and must stay within the tolerance
    # of the reference (atol 5e-2 on this workload) with no new engine
    # signature (still one per tier).
    lag_args = argparse.Namespace(**vars(args))
    lag_args.lag_p, lag_args.lag_max, lag_args.lag_s = 0.5, 2, 0.002
    sync_lag = fresh_runtime(lag_args, key, init_one, apply_fn, data)
    sl_reps = sync_lag.run(args.rounds)
    n_straggled = sum(r["stragglers"] for r in sl_reps)
    sync_stall = sum(r["barrier_stall_s"] for r in sl_reps)
    assert n_straggled > 0, "straggler injection never fired"
    assert sync_stall > 0.0, sl_reps
    assert all(r["pending_payloads"] == 0 for r in sl_reps)
    assert_runtimes_bitwise(sync_lag, full)  # barrier = wall-clock only

    async_args = argparse.Namespace(**vars(lag_args))
    async_args.async_mode = True
    arun = fresh_runtime(async_args, key, init_one, apply_fn, data)
    a_reps = arun.run(args.rounds)
    drained = arun.drain()
    merged = sum(r["stale_merges"] for r in a_reps) + drained
    assert 0 < merged <= n_straggled, (merged, n_straggled)
    async_stall = sum(r["barrier_stall_s"] for r in a_reps)
    assert async_stall == 0.0, "async mode must not block on stragglers"
    assert a_reps[-1]["max_signatures_per_tier"] == 1, a_reps[-1]
    assert arun.traces == len(a_reps[-1]["signatures_per_tier"]), \
        (arun.traces, a_reps[-1]["signatures_per_tier"])
    atol = 5e-2  # the reference's (tests/test_train_runtime.py)
    close = lambda pa, pb: all(
        torch.allclose(x.detach(), y.detach(), rtol=1e-5, atol=atol)
        for x, y in zip(trees.leaves(pa), trees.leaves(pb), strict=True))
    for pa, pb in ((arun.server_params, sync_lag.server_params),
                   (arun.ema_server, sync_lag.ema_server)):
        assert close(pa, pb), "async drifted past tolerance"
    for u in arun.registry.uids():
        assert close(arun.registry.get(u).params,
                     sync_lag.registry.get(u).params), f"client {u} drifted"

    # (e): the privacy pass.  (e1) identity ladder — the neutral
    # flag values (clip=inf, sigma=0, secagg off) route through the
    # legacy aggregation path and must be BITWISE equal to the baseline
    # run; (e2) secagg on/off — with DP actually on (finite clip,
    # sigma>0), flipping pairwise masking must not move a single bit of
    # the aggregate (fixed-point masks cancel exactly); (e3) the
    # reported cumulative epsilon is finite, positive once a release
    # landed, and monotone non-decreasing.
    ident_args = argparse.Namespace(**vars(args))
    ident_args.dp_clip, ident_args.dp_sigma = math.inf, 0.0
    ident_args.dp_delta, ident_args.secagg = 1e-5, False
    ident = fresh_runtime(ident_args, key, init_one, apply_fn, data)
    id_reps = ident.run(args.rounds)
    assert_runtimes_bitwise(ident, full)
    assert all(r["dp_epsilon"] == 0.0 and r["dp_epoch"] == 0
               for r in id_reps), "disabled privacy must spend nothing"

    dp_args = argparse.Namespace(**vars(args))
    dp_args.dp_clip, dp_args.dp_sigma, dp_args.dp_delta = 1.0, 0.8, 1e-5
    dp_args.secagg = False
    dp_off = fresh_runtime(dp_args, key, init_one, apply_fn, data)
    off_reps = dp_off.run(args.rounds)
    sa_args = argparse.Namespace(**vars(dp_args))
    sa_args.secagg = True
    dp_on = fresh_runtime(sa_args, key, init_one, apply_fn, data)
    dp_on.run(args.rounds)
    assert_runtimes_bitwise(dp_off, dp_on)

    eps = [r["dp_epsilon"] for r in off_reps]
    assert all(np.isfinite(e) for e in eps), eps
    assert all(b >= a for a, b in zip(eps, eps[1:])), eps
    assert dp_off.dp_epoch > 0 and eps[-1] > 0.0, (dp_off.dp_epoch, eps)

    # (f): the obs pass.  Full tracing + sinks must be a PURE OBSERVER:
    # an obs-enabled replica of the baseline run ends in
    # BITWISE-identical full state (params, opt, registry, RNG, cursor)
    # with zero extra engine signatures, while streaming a
    # round-trippable JSONL frame per round and a Perfetto trace whose
    # round spans decompose into cohort_sample/plan/round_dispatch/
    # fedavg children.
    with tempfile.TemporaryDirectory() as td:
        jsonl = os.path.join(td, "train.jsonl")
        trace = os.path.join(td, "trace.json")
        obs_rt = fresh_runtime(args, key, init_one, apply_fn, data,
                               obs=ObsConfig(jsonl_path=jsonl,
                                             trace_path=trace))
        obs_rt.run(args.rounds)
        obs_rt.obs.close()
        assert_runtimes_bitwise(obs_rt, full)
        assert obs_rt.traces == full.traces, (obs_rt.traces, full.traces)
        records = [json.loads(l) for l in open(jsonl)]
        assert records and all(r["schema"] == 1 for r in records)
        assert all(json.loads(json.dumps(r)) == r for r in records)
        n_frames = sum(1 for r in records if r["kind"] == "metrics")
        assert n_frames == args.rounds, (n_frames, args.rounds)
        events = json.load(open(trace))["traceEvents"]
        round_evs = [e for e in events if e["name"] == "round"]
        assert len(round_evs) == args.rounds, round_evs
        by_parent = {}
        for e in events:
            by_parent.setdefault(e["args"].get("parent"), set()) \
                .add(e["name"])
        want = {"cohort_sample", "plan", "round_dispatch", "fedavg"}
        assert any(want <= by_parent.get(e["args"]["sid"], set())
                   for e in round_evs), by_parent
    say(f"smoke/obs: tracing is a pure observer (bitwise full state, "
          f"{obs_rt.traces} traces both modes, {n_frames} JSONL frames, "
          "Perfetto round decomposition verified)")

    say(f"smoke: OK ({subset_rounds} strict-subset rounds, "
          f"1 signature per tier over {rt.traces} tiers, "
          f"bitwise resume-at-round-{mid} == uninterrupted; "
          f"stragglers={n_straggled} sync_stall={sync_stall:.3f}s "
          f"async_stall={async_stall:.3f}s stale_merges={merged} "
          f"within atol={atol}; privacy: identity ladder bitwise, "
          f"secagg on==off bitwise, eps={eps[-1]:.3f} over "
          f"{dp_off.dp_epoch} releases monotone)")
    return last


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--clients", type=int, default=5)
    ap.add_argument("--T", type=int, default=1000)
    ap.add_argument("--t-cut", type=int, default=200)
    ap.add_argument("--rounds", type=int, default=3,
                    help="TOTAL rounds; with --resume the run continues "
                         "from the checkpoint's cursor toward this")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--batches-per-round", type=int, default=4,
                    help="fixed per-client batch slots per round (the "
                         "shape-stability knob: nb never drifts)")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--image-size", type=int, default=16)
    ap.add_argument("--n-classes", type=int, default=4,
                    help="attribute/label count shared by the synthetic "
                         "data and the denoiser's conditioning")
    ap.add_argument("--n-per-client", type=int, default=512)
    ap.add_argument("--client-sizes", default=None,
                    help="comma-separated per-client dataset sizes "
                         "(unbalanced clients; overrides --n-per-client)")
    ap.add_argument("--denoiser", default="unet",
                    help="unet | toy | assigned arch id")
    ap.add_argument("--iid", action="store_true")
    ap.add_argument("--policy", choices=("full", "bernoulli", "fixed"),
                    default="bernoulli")
    ap.add_argument("--p", type=float, default=0.8,
                    help="bernoulli participation probability")
    ap.add_argument("--cohort-k", type=int, default=0,
                    help="cohort size for --policy fixed")
    ap.add_argument("--drop-p", type=float, default=0.0,
                    help="mid-round dropout probability per cohort member")
    ap.add_argument("--lag-p", type=float, default=0.0,
                    help="straggler probability per cohort member "
                         "(TAG_LAG-addressed injection)")
    ap.add_argument("--lag-max", type=int, default=1,
                    help="max straggler delay in rounds (lag uniform "
                         "on {1..lag_max})")
    ap.add_argument("--lag-s", type=float, default=0.0,
                    help="simulated wall-clock stall per lag round; the "
                         "sync barrier sleeps lag_s * max(lag) per round")
    ap.add_argument("--async", dest="async_mode", action="store_true",
                    help="staleness-tolerant aggregation: straggler "
                         "uploads land late with decayed weight "
                         "(fedavg.average_stale) instead of blocking "
                         "the round barrier")
    ap.add_argument("--stale-alpha", type=float, default=0.6,
                    help="base merge weight for stale payloads")
    ap.add_argument("--stale-decay", type=float, default=0.5,
                    help="staleness decay exponent: w = alpha*(1+s)^-decay")
    ap.add_argument("--dp-clip", type=float, default=math.inf,
                    help="DP-FedAvg per-member update L2 clip C "
                         "(inf = no clipping; the identity ladder)")
    ap.add_argument("--dp-sigma", type=float, default=0.0,
                    help="DP noise multiplier (noise std = sigma * C at "
                         "the cohort aggregation; needs a finite "
                         "--dp-clip)")
    ap.add_argument("--dp-delta", type=float, default=1e-5,
                    help="target delta for the RDP epsilon accountant")
    ap.add_argument("--secagg", action="store_true",
                    help="pairwise-masked secure-aggregation uploads "
                         "(bitwise-identical aggregate; the server sees "
                         "only the sum)")
    ap.add_argument("--fedavg-every", type=int, default=0,
                    help="cross-cohort FedAvg of client nets every N "
                         "rounds (0 = off)")
    ap.add_argument("--ema", type=float, default=0.0,
                    help="server-param EMA decay (0 = off); sampling "
                         "should load the EMA track")
    ap.add_argument("--join-at", type=int, default=None,
                    help="register one extra client at this round")
    ap.add_argument("--leave-at", type=int, default=None,
                    help="client 0 leaves at this round")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=1)
    ap.add_argument("--resume", action="store_true",
                    help="restore --checkpoint (if present) and continue")
    ap.add_argument("--obs-jsonl", default=None, metavar="PATH",
                    help="stream schema-versioned metrics+span records "
                         "to this JSONL file (safe to tail -f)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Perfetto/Chrome trace of the round "
                         "spans here at exit (load in ui.perfetto.dev)")
    ap.add_argument("--profile-rounds", type=int, default=0, metavar="N",
                    help="run torch.profiler around the first N rounds")
    ap.add_argument("--profile-dir", default=None,
                    help="torch.profiler output directory "
                         "(with --profile-rounds)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda unless cpu is asked for)")
    ap.add_argument("--smoke", action="store_true",
                    help="CI preset: assert the train-runtime contract "
                         "(see module docstring)")
    args = ap.parse_args(argv)
    own_group = join_group(args.device)
    try:
        return run(args)
    finally:
        if own_group:
            import torch.distributed as dist
            dist.destroy_process_group()


def run(args):
    """The CLI's body over a process group that ``main`` set up."""
    if args.smoke:
        # 5 ragged clients, bernoulli cohorts with mid-round dropout,
        # FedAvg + EMA on, toy denoiser — wide enough to hit >=2 tiers
        # and a strict subset, small enough for the CPU tests
        args.clients, args.T, args.t_cut = 5, 20, 5
        args.rounds, args.batch, args.batches_per_round = 6, 4, 3
        args.image_size, args.denoiser = 8, "toy"
        args.policy, args.p, args.drop_p = "bernoulli", 0.6, 0.3
        args.fedavg_every, args.ema = 2, 0.9
        args.client_sizes, args.seed = "24,16,8,24,12", 0
        # straggler knobs stay off in the base runs; section (d) turns
        # them on through Namespace copies so (a)-(c) stay lag-free,
        # and section (e) turns the DP knobs on the same way
        args.lag_p, args.lag_max, args.lag_s = 0.0, 1, 0.0
        args.async_mode = False
        args.dp_clip, args.dp_sigma, args.dp_delta = math.inf, 0.0, 1e-5
        args.secagg = False
        return smoke(args)

    device = resolve_device(args.device)
    key = prng.PRNGKey(args.seed)
    init_one, apply_fn = build_model(args, key, device)
    data = make_data(args, key, device)
    cfg = make_train_config(args)
    if args.resume and args.checkpoint and os.path.exists(args.checkpoint):
        rt = TrainRuntime.restore(cfg, init_one, apply_fn, args.checkpoint,
                                  mesh=make_mesh(args),
                                  obs=obs_from_args(args),
                                  device=args.device)
        for uid, (x, y) in enumerate(data):
            if uid in rt.registry:
                rt.attach_data(uid, x, y)
        # a --join-at client restored from the checkpoint regenerates its
        # data from the same addressed key the join used — without this
        # it would resume data-less and silently sit out every round
        if args.join_at is not None and args.clients in rt.registry:
            xj, yj = make_data(args, prng.fold_in(key, 777), device)[0]
            rt.attach_data(args.clients, xj, yj)
        say(f"resumed {args.checkpoint} at round {rt.round}")
    else:
        rt = fresh_runtime(args, key, init_one, apply_fn, data,
                           obs=obs_from_args(args))
    say(f"CollaFuse train runtime: k={args.clients} T={args.T} "
          f"t_cut={args.t_cut} denoiser={args.denoiser} "
          f"policy={args.policy}(p={args.p}, drop_p={args.drop_p}) "
          f"fedavg_every={args.fedavg_every} ema={args.ema} "
          f"rounds={rt.round}->{args.rounds}")
    while rt.round < args.rounds:
        if args.join_at is not None and rt.round == args.join_at and \
                args.clients not in rt.registry:
            x, y = make_data(args, prng.fold_in(key, 777), device)[0]
            uid = rt.register_client(x, y)
            say(f"round {rt.round}: client {uid} joined")
        if args.leave_at is not None and rt.round == args.leave_at:
            rt.leave(0)
            say(f"round {rt.round}: client 0 left")
        rep = rt.run_round()
        print_report(f"round {rep['round']}", rep)
        if args.checkpoint and args.checkpoint_every > 0 and \
                rt.round % args.checkpoint_every == 0:
            rt.save(args.checkpoint)
    if args.checkpoint:
        rt.save(args.checkpoint)
        say("checkpoint ->", args.checkpoint)
    rt.obs.close()
    return rt


if __name__ == "__main__":
    main()
