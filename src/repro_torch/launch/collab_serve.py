"""Thin CLI over the collaborative serve runtime (serve/runtime.py).

    PYTHONPATH=src python -m repro_torch.launch.collab_serve --smoke
    PYTHONPATH=src python -m repro_torch.launch.collab_serve --smoke \
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.collab_serve \
        --clients 5 --requests 24 --T 60 --t-cuts 5,10,20,10,40 --compare

It builds models, synthesizes a queue, serves it through
``ServeRuntime.process`` and prints the serve report (latency /
throughput / cache hit rate / physical-vs-logical model calls / new
signatures).  Runs on CUDA unless ``--device cpu`` is given.

Each synthetic request is (client, label, t_ζ) where t_ζ is the CLIENT's
own cut point (--t-cuts).  ``--zipf`` skews the label distribution;
``--passes`` replays the queue, so steady-state behavior (warm cache,
zero new signatures) is visible from the per-pass reports.  ``--compare``
also runs the same traffic through a fifo, cache-less runtime.  The
default denoiser is a linear toy model; ``--unet`` swaps in the reduced
paper U-Net (``--full-unet`` the paper's full-width ``CONFIG``).

``--smoke`` asserts the serve contract on a mixed-cut queue with repeated
(y, t_ζ) traffic served for three passes (cold fill / first warm /
steady): ≥1 cache hit; bitwise warm == cold == fifo; zero new engine
signatures in the steady pass and one signature per bucket; ≥30% fewer
physical server model calls than the fifo/no-cache baseline; pipelined ==
sequential bitwise under a per-wave host stall (outputs AND cache
traffic); continuous == depth bitwise with no new buckets and every SLO
tracked; and a fully-traced replica (JSONL + Perfetto sinks) bitwise
equal to the untraced run with zero extra signatures, a round-tripping
JSONL stream and wave spans decomposed into plan / cache_probe /
server_scan / client_scan / straggle_stall children.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
from typing import List

import numpy as np
import torch

from repro_torch.configs.ddpm_unet import CONFIG, SMALL
from repro_torch.core import prng
from repro_torch.core.sample_plan import SampleRequest
from repro_torch.core.schedules import DiffusionSchedule
from repro_torch.core.unet import init_unet, unet_apply
from repro_torch.device import resolve_device
from repro_torch.obs import ObsConfig
from repro_torch.serve import ServeConfig, ServeRuntime


def build_models(args, key, device):
    """Returns (server_params, per-client params list, apply_fn) on
    ``device``."""
    if args.unet or args.full_unet:
        base = CONFIG if args.full_unet else SMALL
        ucfg = dataclasses.replace(
            base, image_size=args.image_size, channels=3,
            n_classes=args.n_classes)
        ks, *kc = prng.split(key, args.clients + 1)
        sp = init_unet(ks, ucfg, device)
        cp = [init_unet(k, ucfg, device) for k in kc]
        return sp, cp, unet_apply
    sp = {"a": torch.tensor(0.2, device=device),
          "b": torch.tensor(0.0, device=device)}
    a = torch.linspace(0.1, 0.5, args.clients)
    cp = [{"a": a[i].to(device), "b": torch.tensor(0.0, device=device)}
          for i in range(args.clients)]
    return sp, cp, lambda p, x, t, y: x * p["a"] + p["b"]


def zipf_probs(n_classes: int, a: float) -> np.ndarray:
    """p(rank) ∝ 1/(rank+1)^a — a=0 is uniform; a≈1 is the classic
    web-traffic skew that makes repeated-label serving the common case."""
    p = 1.0 / np.arange(1, n_classes + 1, dtype=np.float64) ** a
    return p / p.sum()


def synth_queue(rng: np.random.Generator, *, clients: int, cuts: List[int],
                requests: int, batch: int, n_classes: int,
                zipf: float = 0.0) -> List[SampleRequest]:
    """Synthetic traffic: each request is a uniform client at its own cut
    with a (possibly Zipf-skewed) label — shared by this CLI and
    benchmarks/collab_serve_runtime.py so both measure the same workload."""
    reqs = []
    eye = np.eye(n_classes, dtype=np.float32)
    probs = zipf_probs(n_classes, zipf)
    for _ in range(requests):
        c = int(rng.integers(clients))
        label = int(rng.choice(n_classes, p=probs))
        y = np.broadcast_to(eye[label], (batch, n_classes)).copy()
        reqs.append(SampleRequest(client=c, t_cut=cuts[c], y=y))
    return reqs


def obs_from_args(args):
    """ObsConfig from the CLI sink flags, or None when all are off (the
    structurally-inert default)."""
    cfg = ObsConfig(jsonl_path=getattr(args, "obs_jsonl", None),
                    trace_path=getattr(args, "trace_out", None),
                    profile_waves=getattr(args, "profile_waves", 0) or 0,
                    profile_dir=getattr(args, "profile_dir", None))
    return cfg if cfg.active else None


def make_runtime(args, sp, cp, apply_fn, sched, key, *, policy=None,
                 cache=None, pipeline=None, straggle_s=None,
                 obs=None) -> ServeRuntime:
    cfg = ServeConfig(
        T=args.T, image_shape=(args.image_size, args.image_size, 3),
        max_wave=args.max_wave,
        policy=args.policy if policy is None else policy,
        server_stride=args.stride,
        cache=(not args.no_cache) if cache is None else cache,
        cache_max_bytes=args.cache_bytes,
        pipeline=(not args.sequential) if pipeline is None else pipeline,
        straggle_s=args.straggle_s if straggle_s is None else straggle_s)
    return ServeRuntime(cfg, sp, cp, apply_fn, sched, key, obs=obs,
                        device=args.device)


def print_report(tag: str, report: dict):
    for k_, v in report.items():
        if k_ == "per_request":      # raw ticket rows — summarize, don't dump
            print(f"{tag}/per_request: {len(v)} rows")
        elif isinstance(v, float):
            print(f"{tag}/{k_}: {v:.4g}")
        else:
            print(f"{tag}/{k_}: {v}")


def run_passes(rt: ServeRuntime, queue, n_passes: int, slo_s=None):
    """Replay ``queue`` n_passes times; returns (per-pass outputs,
    per-pass reports).  Arrival ids keep advancing, so every pass draws
    FRESH samples — only the server prefixes repeat (and hit the cache)."""
    outs, reports = [], []
    for _ in range(n_passes):
        o, r = rt.process(queue, slo_s=slo_s)
        outs.append(o)
        reports.append(r)
    return outs, reports


def assert_same(a: torch.Tensor, b: torch.Tensor) -> None:
    """Bitwise equality of two outputs (any device)."""
    if not torch.equal(a, b):
        diff = (a.float() - b.float()).abs().max().item()
        raise AssertionError(f"outputs differ (max abs {diff})")


def smoke(args, queue, sp, cp, apply_fn, sched, key) -> dict:
    """CI assertions — see module docstring.  Raises on violation."""
    n_passes = 3          # cold fill / first warm (compiles) / steady
    rt = make_runtime(args, sp, cp, apply_fn, sched, key,
                      policy="depth", cache=True)
    cold = make_runtime(args, sp, cp, apply_fn, sched, key,
                        policy="depth", cache=False)
    fifo = make_runtime(args, sp, cp, apply_fn, sched, key,
                        policy="fifo", cache=False)
    outs, reps = run_passes(rt, queue, n_passes)
    cold_outs, _ = run_passes(cold, queue, n_passes)
    fifo_outs, fifo_reps = run_passes(fifo, queue, n_passes)
    steady = reps[-1]
    print_report("serve/pass1", reps[0])
    print_report("serve/steady", steady)
    print_report("fifo_nocache/steady", fifo_reps[-1])

    # ≥1 cache hit on repeated (y, t_ζ) traffic
    assert steady["cache_hits"] >= 1, steady
    assert steady["requests_from_cache"] >= 1, steady
    # warm-vs-cold bitwise: cache hits change NOTHING but the work done
    for p in range(n_passes):
        for a, b in zip(outs[p], cold_outs[p]):
            assert_same(a, b)
    # scheduler/cache choices are pure perf knobs: fifo output identical
    for p in range(n_passes):
        for a, b in zip(outs[p], fifo_outs[p]):
            assert_same(a, b)
    # steady state: one signature per bucket, zero new signatures (the
    # RecompileGuard counts a stage's first sight of a signature)
    assert steady["engine_traces"] == 0, steady
    assert steady["max_signatures_per_bucket"] == 1, steady
    # physical server-call reduction vs the fifo/no-cache runtime (all
    # passes: cold fill + warm serve), at the equal output proven above
    mine = sum(r["server_calls_physical"] for r in reps)
    base = sum(r["server_calls_physical"] for r in fifo_reps)
    reduction = 1.0 - mine / base
    print(f"smoke/server_calls_physical: {mine} vs fifo {base} "
          f"({100 * reduction:.1f}% reduction)")
    assert reduction >= 0.30, (mine, base)
    # the report carries both accounting views (logical vs physical)
    assert "padded_model_calls" in steady
    assert "server_calls_saved_by_dedup" in steady

    # straggler-injected overlap pass: pipelined vs sequential under a
    # host-side stall per wave must be BITWISE equal — outputs and cache
    # traffic — with zero new signatures in both modes' steady passes
    stall = 0.002
    pipe = make_runtime(args, sp, cp, apply_fn, sched, key,
                        policy="depth", cache=True, pipeline=True,
                        straggle_s=stall)
    seq = make_runtime(args, sp, cp, apply_fn, sched, key,
                       policy="depth", cache=True, pipeline=False,
                       straggle_s=stall)
    pipe_outs, pipe_reps = run_passes(pipe, queue, n_passes)
    seq_outs, seq_reps = run_passes(seq, queue, n_passes)
    for p in range(n_passes):
        for a, b in zip(pipe_outs[p], seq_outs[p]):
            assert_same(a, b)
    for p in range(n_passes):
        for k_ in ("cache_hits", "cache_misses", "requests_from_cache",
                   "server_calls_physical", "client_calls_physical"):
            assert pipe_reps[p][k_] == seq_reps[p][k_], (p, k_)
    assert pipe_reps[-1]["engine_traces"] == 0, pipe_reps[-1]
    assert seq_reps[-1]["engine_traces"] == 0, seq_reps[-1]
    assert pipe_reps[-1]["max_signatures_per_bucket"] == 1
    print(f"smoke/straggle: pipelined wall "
          f"{sum(r['wall_s'] for r in pipe_reps):.3f}s vs sequential "
          f"{sum(r['wall_s'] for r in seq_reps):.3f}s at "
          f"{stall * 1e3:.0f}ms/wave stall (bitwise equal outputs)")

    # continuous-admission pass: admission timing is the third
    # pure perf knob — continuous output must be BITWISE equal to the
    # depth-bucketed runtime for the same arrival order, and steady
    # traffic must add ZERO new compiled signatures (a partially-refilled
    # wave can only present shapes on depth's fixed tier menu)
    cont = make_runtime(args, sp, cp, apply_fn, sched, key,
                        policy="continuous", cache=True)
    cont_outs, cont_reps = run_passes(cont, queue, n_passes, slo_s=60.0)
    for p in range(n_passes):
        for a, b in zip(cont_outs[p], outs[p]):
            assert_same(a, b)
    c_steady = cont_reps[-1]
    print_report("continuous/steady", c_steady)
    assert c_steady["engine_traces"] == 0, c_steady
    assert c_steady["max_signatures_per_bucket"] == 1, c_steady
    # zero NEW signatures: every bucket the continuous runtime compiled
    # is a bucket the depth runtime compiled too (same (t_ζ, B) menu)
    depth_buckets = set(reps[0]["signatures_per_bucket"])
    cont_buckets = set(cont_reps[0]["signatures_per_bucket"])
    assert cont_buckets <= depth_buckets, (cont_buckets, depth_buckets)
    # SLO accounting: every request carried the 60 s default deadline —
    # all tracked, none missed at this scale, percentiles populated
    assert c_steady["slo_tracked"] == c_steady["requests"], c_steady
    assert c_steady["slo_misses"] == 0, c_steady
    assert c_steady["latency_p99_s"] > 0.0, c_steady
    assert len(c_steady["per_request"]) == c_steady["requests"]

    # observability pass: full tracing + sinks must be a
    # PURE OBSERVER — an obs-enabled replica of the pipelined straggle
    # runtime produces bitwise-identical samples, identical cache/call
    # accounting, and ZERO extra signatures, while emitting a
    # round-trippable JSONL stream and a Perfetto trace whose wave spans
    # decompose into plan/cache_probe/server_scan/client_scan/
    # straggle_stall children
    with tempfile.TemporaryDirectory() as td:
        jsonl = os.path.join(td, "serve.jsonl")
        trace = os.path.join(td, "trace.json")
        obs_rt = make_runtime(
            args, sp, cp, apply_fn, sched, key,
            policy="depth", cache=True, pipeline=True, straggle_s=stall,
            obs=ObsConfig(jsonl_path=jsonl, trace_path=trace))
        obs_outs, obs_reps = run_passes(obs_rt, queue, n_passes)
        obs_rt.obs.close()
        for p in range(n_passes):
            for a, b in zip(obs_outs[p], pipe_outs[p]):
                assert_same(a, b)
            for k_ in ("cache_hits", "cache_misses", "requests_from_cache",
                       "server_calls_physical", "client_calls_physical",
                       "engine_traces", "signatures_per_bucket"):
                assert obs_reps[p][k_] == pipe_reps[p][k_], (p, k_)
        assert obs_rt.traces == pipe.traces, \
            (obs_rt.traces, pipe.traces)      # zero new signatures
        # JSONL: schema-versioned, one object per line, round-trips
        records = [json.loads(l) for l in open(jsonl)]
        assert records and all(r["schema"] == 1 for r in records)
        kinds = {r["kind"] for r in records}
        assert {"meta", "metrics", "span"} <= kinds, kinds
        assert all(json.loads(json.dumps(r)) == r for r in records)
        n_frames = sum(1 for r in records if r["kind"] == "metrics")
        assert n_frames == n_passes, (n_frames, n_passes)
        # Perfetto/Chrome trace: wave spans with the pinned decomposition
        events = json.load(open(trace))["traceEvents"]
        waves = [e for e in events if e["name"] == "wave"]
        assert waves, events
        by_parent = {}
        for e in events:
            by_parent.setdefault(e["args"].get("parent"), set()) \
                .add(e["name"])
        kids = by_parent.get(waves[0]["args"]["sid"], set())
        assert {"plan", "server_scan", "client_scan",
                "straggle_stall"} <= kids, kids
        assert any(e["name"] == "cache_probe" for e in events)
        # every ticket links to its wave's span id
        wave_sids = {w["args"]["sid"] for w in waves}
        rows = [row for r in obs_reps for row in r["per_request"]]
        assert rows and all(row["span_id"] in wave_sids for row in rows)
    print("smoke/obs: tracing is a pure observer (bitwise outputs, equal "
          f"accounting, {obs_rt.traces} traces both modes, {n_frames} "
          "JSONL frames, Perfetto wave decomposition verified)")

    print("smoke: OK (cache hits, bitwise warm==cold==fifo, 1 signature "
          "per bucket in steady state, >=30% fewer physical server calls, "
          "pipelined==sequential bitwise under straggle, "
          "continuous==depth bitwise with zero new signatures, "
          "obs on==off bitwise)")
    return steady


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--clients", type=int, default=3)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--T", type=int, default=40)
    ap.add_argument("--t-cuts", default="",
                    help="comma list, one per client (default 1:2:4 ramp "
                         "incl. a t_cut=0 GM client when clients >= 4)")
    ap.add_argument("--batch", type=int, default=4,
                    help="samples per request")
    ap.add_argument("--max-wave", type=int, default=8,
                    help="request-axis tier: requests batched per engine "
                         "call (waves are padded to exactly this)")
    ap.add_argument("--policy", choices=("depth", "fifo", "continuous"),
                    default="depth",
                    help="wave scheduler: depth buckets (shape-stable), "
                         "fifo arrival order (the baseline), or "
                         "continuous (admission at wave boundaries)")
    ap.add_argument("--continuous", action="store_true",
                    help="shorthand for --policy continuous")
    ap.add_argument("--slo-s", type=float, default=None,
                    help="default per-request latency deadline in seconds "
                         "(reports slo_tracked/slo_misses; accounting "
                         "only — never steers scheduling)")
    ap.add_argument("--no-cache", action="store_true",
                    help="disable the cross-wave server-prefix cache")
    ap.add_argument("--cache-bytes", type=int, default=64 << 20)
    ap.add_argument("--stride", type=int, default=1,
                    help=">1 runs the strided DDIM server phase "
                         "(ceil((T-t_cut)/stride) server calls per prefix)")
    ap.add_argument("--zipf", type=float, default=1.1,
                    help="label skew exponent (0 = uniform)")
    ap.add_argument("--passes", type=int, default=2,
                    help="replay the queue this many times (pass 2+ shows "
                         "the steady state: warm cache, no recompiles)")
    ap.add_argument("--image-size", type=int, default=8)
    ap.add_argument("--n-classes", type=int, default=4)
    ap.add_argument("--unet", action="store_true",
                    help="reduced paper U-Net instead of the toy denoiser")
    ap.add_argument("--full-unet", action="store_true",
                    help="the paper's full-width U-Net (configs CONFIG)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda unless cpu is asked for)")
    ap.add_argument("--compare", action="store_true",
                    help="also run the fifo/no-cache baseline "
                         "runtime on the same traffic")
    ap.add_argument("--sequential", action="store_true",
                    help="disable wave pipelining (per-wave barrier — "
                         "the barrier baseline loop)")
    ap.add_argument("--straggle-s", type=float, default=0.0,
                    help="host-side stall in seconds before each wave "
                         "(straggler injection; pipelining hides it)")
    ap.add_argument("--obs-jsonl", default=None, metavar="PATH",
                    help="stream schema-versioned metrics+span records "
                         "to this JSONL file (safe to tail -f)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Perfetto/Chrome trace of the wave "
                         "spans here at exit (load in ui.perfetto.dev)")
    ap.add_argument("--profile-waves", type=int, default=0, metavar="N",
                    help="run torch.profiler around the first N waves")
    ap.add_argument("--profile-dir", default=None,
                    help="torch.profiler output directory "
                         "(with --profile-waves)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="CI preset: assert the serve-subsystem contract "
                         "(see module docstring)")
    args = ap.parse_args(argv)
    if args.continuous:
        args.policy = "continuous"
    if args.requests < 1 or args.max_wave < 1 or args.clients < 1 \
            or args.passes < 1:
        raise SystemExit("--requests, --max-wave, --clients, and --passes "
                         "must be >= 1")
    if args.smoke:
        # mixed-cut queue with repeated (y, t_ζ) traffic: 3 cut-depth
        # buckets x 2 hot labels, 12 requests/pass — wide enough that
        # every bucket sees repeats, small enough for CI.  The toy model
        # unless --full-unet asks for the paper's full-width U-Net (then
        # with its own label vocabulary, for the on-card contracts).
        args.requests, args.T, args.max_wave = 12, 20, 4
        args.clients, args.zipf = 3, 0.0
        if args.full_unet:
            args.n_classes = CONFIG.n_classes
            args.image_size = CONFIG.image_size
        else:
            args.unet, args.n_classes = False, 2
        args.no_cache, args.stride = False, 1
        args.sequential, args.straggle_s = False, 0.0

    if args.t_cuts:
        cuts = [int(c) for c in args.t_cuts.split(",")]
        if len(cuts) != args.clients:
            raise SystemExit(f"--t-cuts needs {args.clients} entries")
    else:
        base = max(args.T // 8, 1)
        ramp = [base, 2 * base, 4 * base]
        cuts = [0 if (args.clients >= 4 and c == 3) else ramp[c % 3]
                for c in range(args.clients)]
    for tc in cuts:
        assert 0 <= tc <= args.T, (tc, args.T)

    device = resolve_device(args.device)
    key = prng.PRNGKey(args.seed, device=device)
    sp, cp, apply_fn = build_models(args, key, device)
    sched = DiffusionSchedule.linear(args.T, device=device)
    rng = np.random.default_rng(args.seed)
    queue = synth_queue(rng, clients=args.clients, cuts=cuts,
                        requests=args.requests, batch=args.batch,
                        n_classes=args.n_classes, zipf=args.zipf)

    print(f"serving {args.requests} requests x {args.batch} samples x "
          f"{args.passes} passes, k={args.clients} clients, cuts={cuts}, "
          f"T={args.T}, stride={args.stride}, max_wave={args.max_wave}, "
          f"policy={args.policy}, cache={not args.no_cache}")
    if args.smoke:
        return smoke(args, queue, sp, cp, apply_fn, sched, key)

    rt = make_runtime(args, sp, cp, apply_fn, sched, key,
                      obs=obs_from_args(args))
    _, reports = run_passes(rt, queue, args.passes, slo_s=args.slo_s)
    rt.obs.close()
    for i, rep in enumerate(reports):
        print_report(f"serve/pass{i + 1}", rep)
    if args.compare:
        base_rt = make_runtime(args, sp, cp, apply_fn, sched, key,
                               policy="fifo", cache=False)
        _, base_reports = run_passes(base_rt, queue, args.passes)
        for i, rep in enumerate(base_reports):
            print_report(f"fifo_nocache/pass{i + 1}", rep)
        wall = sum(r["wall_s"] for r in reports)
        bwall = sum(r["wall_s"] for r in base_reports)
        phys = sum(r["server_calls_physical"] for r in reports)
        bphys = sum(r["server_calls_physical"] for r in base_reports)
        print(f"speedup: {bwall / wall:.2f}x wall, "
              f"{100 * (1 - phys / max(bphys, 1)):.1f}% fewer physical "
              f"server calls (serve runtime vs fifo/no-cache runtime)")
    return reports[-1]


if __name__ == "__main__":
    main()
