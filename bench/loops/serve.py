"""The serving loop: CollaFuse Alg. 2 through the program's
``ServeRuntime`` (submit / poll) under a closed loop, then the check of
what it served against the plain reference.

Set-up: the models from the seed, the runtime, the mix's warm-up requests
served and drained (this fills the prefix cache where the mix repeats
prefixes, builds the DDPM-step kernel and warms every shape the window
uses), and the model's FLOPs a call counted at the request's batch.

Window: each client keeps ``outstanding`` requests in the system; a
request that retires is replaced by the client's next.  The denoiser the
runtime is given is the model's, wrapped by ``CallClock``: after each
model call it records a CUDA event, so the device's clock says when each
call finished.  A wave's last call is the last one launched before the
wave's dispatch stamp, and its event times the end of the wave's requests
(the DDPM step that follows it takes microseconds).  ``samples_per_s``
counts the images of the requests that finished after the window's first
finished wave, up to the last wave that closes a whole number of the
mix's cycles inside the window, over the time between those two ends.

A mix's keys (``bench/traffic/*.json``): ``cut_fractions`` (a client
each), ``images`` a request, ``labels`` (see ``traffic.py``),
``outstanding`` requests a client, the runtime's ``max_wave``, ``cache``
and ``cache_mib``, ``warmup``, ``cycle_requests``, and the traced slice
(``trace_after_calls``, ``trace_calls``).

Check: one retired request per client and ``check_rows`` (the
configuration's) of its images, all drawn from the seed, held against
``reference/sample.py`` run on the same weights and keys once the program
is freed: the largest absolute gap of a pixel over the largest absolute
reference pixel.
"""
from __future__ import annotations

import bisect
import gc
import sys
import time
from types import SimpleNamespace
from typing import Dict, List

import numpy as np
import torch

from bench import devtrace, nvml, rates, traffic
from bench.reference import sample as ref_sample
from bench.reference import threefry as tf


class CallClock:
    """The denoiser with a clock: the host time each call was launched
    and, on CUDA, an event after it; on the CPU (tests) a call has
    finished when it returns, so its host time stands in."""

    def __init__(self, apply, device, trace=None, trace_at: int = 0,
                 trace_calls: int = 0):
        self.apply, self.cuda = apply, device.type == "cuda"
        self.on = False
        self.host: List[float] = []
        self.events: List = []
        # the traced slice: calls trace_at .. trace_at + trace_calls − 1
        self.trace, self.summary = trace, None
        self.trace_at, self.trace_end = trace_at, trace_at + trace_calls
        self.slice_rows: List[int] = []   # batch rows of the traced calls

    def start(self) -> None:
        self.on = True
        if self.cuda:
            self.e0 = torch.cuda.Event(enable_timing=True)
            self.e0.record()
        self.t0 = time.perf_counter()

    def __call__(self, params, x, t, y):
        if self.trace is not None and self.on and \
                len(self.host) == self.trace_at:
            self.trace.start()
        out = self.apply(params, x, t, y)
        if self.on:
            if self.trace_at <= len(self.host) < self.trace_end:
                self.slice_rows.append(int(x.shape[0]))
            self.host.append(time.perf_counter())
            if self.cuda:
                e = torch.cuda.Event(enable_timing=True)
                e.record()
                self.events.append(e)
            if self.trace is not None and len(self.host) == self.trace_end:
                self.summary = self.trace.stop()
        return out

    def ends(self) -> List[float]:
        """Seconds from ``start`` to the end of each call, for the calls
        that have finished."""
        if not self.cuda:
            return [h - self.t0 for h in self.host]
        out = []
        for e in self.events:
            if not e.query():
                break
            out.append(self.e0.elapsed_time(e) / 1e3)
        return out

    def last_call_before(self, host_t: float) -> int:
        return bisect.bisect_left(self.host, host_t) - 1


def _to_request(r: traffic.Request):
    from repro_torch.core.sample_plan import SampleRequest
    return SampleRequest(client=r.client, t_cut=r.t_cut, y=r.y)


def _flops_per_call(model, apply, cfg: Dict, images: int, device) -> float:
    from torch.utils.flop_counter import FlopCounterMode
    hw = (cfg["image_size"], cfg["image_size"], cfg["channels"])
    x = torch.zeros((images,) + hw, device=device)
    t = torch.full((images,), 1.0, device=device)
    y = torch.zeros((images, cfg["n_classes"]), device=device)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        apply(model, x, t, y)
    return float(fc.get_total_flops())


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_proc0: float) -> Dict:
    from repro_torch.core.schedules import DiffusionSchedule
    from repro_torch.obs import ObsConfig
    from repro_torch.serve import ServeConfig, ServeRuntime

    cfg, mix, fam = cell.config, cell.mix, cell.family()
    T = cfg["T"]
    hw = (cfg["image_size"], cfg["image_size"], cfg["channels"])
    n_clients = len(mix["cut_fractions"])
    models = [fam.build_program(cfg, fam.make_weights(cfg, seed, i, device),
                                device) for i in range(1 + n_clients)]
    clock = CallClock(fam.apply_fn(), device,
                      devtrace.DeviceTrace() if trace else None,
                      mix["trace_after_calls"], mix["trace_calls"])
    rt = ServeRuntime(
        ServeConfig(T=T, image_shape=hw, max_wave=mix["max_wave"],
                    policy="continuous", cache=mix["cache"],
                    cache_max_bytes=mix["cache_mib"] << 20),
        models[0], models[1:], clock, DiffusionSchedule.linear(T),
        tf.key_from_seed(seed),
        obs=ObsConfig(enabled=True) if trace else None, device=device)
    stream = traffic.Stream(mix, cfg["n_classes"], T, seed)
    log = []                          # (arrival id, request, ticket)
    card = nvml.Card()

    def submit(reqs):
        tks = rt.submit([_to_request(r) for r in reqs])
        for r, tk in zip(reqs, tks):
            log.append((len(log), r, tk))

    submit(stream.warmup())
    rt.drain()
    flops = _flops_per_call(models[0], fam.apply_fn(), cfg, mix["images"],
                            device)
    n_warm = len(log)
    if device.type == "cuda":
        torch.cuda.synchronize(device)

    # -- the window ---------------------------------------------------
    t_w0 = time.perf_counter()
    setup_s = t_w0 - t_proc0
    clock.start()
    card_log = [(0.0, card.read())]
    snap = rt.registry.snapshot().counters
    submit([stream.next(c) for c in range(n_clients)
            for _ in range(mix["outstanding"])])
    while time.perf_counter() - t_w0 < seconds:
        with torch.profiler.record_function("bench.poll"):
            done = rt.poll(block=True)
        with torch.profiler.record_function("bench.submit"):
            submit([stream.next(tk.request.client) for tk in done])
        card_log.append((time.perf_counter() - t_w0, card.read()))
    summary = clock.summary
    counters = rt.registry.snapshot().counters
    ends = clock.ends()

    # each dispatched wave: (stamp, its last call, its requests)
    waves: Dict[float, List] = {}
    for _, _, tk in log[n_warm:]:
        if tk.t_dispatch >= 0:
            waves.setdefault(tk.t_dispatch, []).append(tk)
    marks, done_n, stamps = [], 0, []
    for stamp in sorted(waves):
        i = clock.last_call_before(stamp)
        if i < 0 or i >= len(ends):
            break
        done_n += len(waves[stamp])
        marks.append((ends[i], done_n))
        stamps.append((stamp, i))
    # a traced run reads its counters over the whole waves after its
    # slice (or, where none is left, over every whole wave)
    first, cycle = 0, mix["cycle_requests"]
    if trace:
        cycle = 1
        first = next((k for k, (_, i) in enumerate(stamps)
                      if i >= clock.trace_end - 1), len(marks))
        if rates.whole_cycles(marks, cycle, seconds, first) is None:
            first = 0
    span = rates.whole_cycles(marks, cycle, seconds, first)
    if span is None:
        raise RuntimeError(f"no whole cycle of {cycle} requests between "
                           f"wave ends in {seconds} s")
    a, b = span
    samples_per_s = rates.rate(marks, a, b) * mix["images"]
    (s_a, i_a), (s_b, i_b) = stamps[a], stamps[b]
    print(f"bench: {len(marks)} waves ended, measured {a}..{b}: "
          f"{marks[a][0]:.3f}..{marks[b][0]:.3f} s, {i_b - i_a} calls",
          file=sys.stderr)
    # each wave's end, calls and device ms a call, to tell a drift across
    # the window from a run that is slower throughout
    per_wave, t_prev, i_prev = [], 0.0, -1
    for (t_k, _), (_, i_k) in zip(marks, stamps):
        per_wave.append(f"{t_k:.3f}/{i_k - i_prev}/"
                        f"{1e3 * (t_k - t_prev) / max(1, i_k - i_prev):.3f}")
        t_prev, i_prev = t_k, i_k
    print("bench: waves (end s/calls/ms a call): " + " ".join(per_wave),
          file=sys.stderr)
    read = [(t, r) for t, r in card_log if r is not None]
    if read:
        print("bench: card at polls (s/SM MHz/C/W/clock-event reasons): "
              + " ".join(f"{t:.1f}/{r[0]}/{r[1]}/{r[2]:.0f}/{r[3]:#x}"
                         for t, r in read), file=sys.stderr)
    spans = [] if not trace else [
        (s.name, s.t0, s.t1) for s in rt.obs.tracer.drain()
        if s_a <= s.t0 < s_b]
    retired = [(rid, r, tk) for rid, r, tk in log[n_warm:]
               if tk.output is not None]
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0

    # -- the check ----------------------------------------------------
    rng = np.random.default_rng([int(seed), 2])
    checked, served = [], []
    for c in range(n_clients):
        mine = [x for x in retired if x[1].client == c]
        if not mine:
            continue
        rid, r, tk = mine[int(rng.integers(len(mine)))]
        rows = np.sort(rng.choice(mix["images"], cfg["check_rows"],
                                  replace=False))
        checked.append(ref_sample.Checked(c, r.t_cut, r.y, rid, rows))
        served.append(tk.output[torch.as_tensor(rows, device=device)]
                      .float().clone())
    n_retired = len(retired)
    slice_rows = clock.slice_rows
    del rt, models, log, retired, waves, done, clock
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    compared = check(cell, seed, checked, served, device)
    readings = SimpleNamespace(
        kind="serve", trace=summary, spans=spans, mix=mix,
        counters={k: v - snap.get(k, 0) for k, v in counters.items()},
        calls=i_b - i_a, interval_s=marks[b][0] - marks[a][0],
        flops_per_call=flops, images=mix["images"], pixels=int(np.prod(hw)),
        dtype=cfg["dtype"], config=cfg, slice_rows=slice_rows)
    return {"attempted": n_retired, "failed": 0, "setup_s": setup_s,
            "e2e": {"samples_per_s": samples_per_s},
            "compared": compared, "peak": peak, "readings": readings,
            "trace": summary}


def reference_outputs(cell, seed: int, checked, device,
                      precision: str = "fp32"):
    cfg, fam = cell.config, cell.family()
    n = 1 + len(cell.mix["cut_fractions"])
    weights = [fam.make_weights(cfg, seed, i, device) for i in range(n)]
    eps = lambda w, x, t, y: fam.reference_eps(w, cfg, x, t, y, precision)
    hw = (cfg["image_size"], cfg["image_size"], cfg["channels"])
    return ref_sample.sample(eps, weights[0], weights[1:],
                             tf.key_from_seed(seed), cfg["T"], hw, checked,
                             device)


def check(cell, seed: int, checked, served, device) -> Dict[str, float]:
    """{"sample_gap": largest |served − reference| over the largest
    |reference| of the checked pixels}; infinite where a checked request
    is missing or a value is not finite."""
    if len(checked) < len(cell.mix["cut_fractions"]):
        return {"sample_gap": float("inf")}
    want = reference_outputs(cell, seed, checked, device, "fp32")
    gap = max((s.double() - w.double()).abs().max().item()
              for s, w in zip(served, want))
    scale = max(w.double().abs().max().item() for w in want)
    rel = gap / scale if scale > 0 else float("inf")
    return {"sample_gap": rel if np.isfinite(rel) else float("inf")}


def control(cell, seed: int, device, precision: str) -> Dict[str, float]:
    """The reference at ``precision`` in the program's place, on the
    requests a run checks (each client's first request of the window)."""
    cfg, mix = cell.config, cell.mix
    stream = traffic.Stream(mix, cfg["n_classes"], cfg["T"], seed)
    n_warm = len(stream.warmup())
    rng = np.random.default_rng([int(seed), 2])
    checked = []
    for c in range(len(mix["cut_fractions"])):
        r = stream.next(c)
        rows = np.sort(rng.choice(mix["images"], cfg["check_rows"],
                                  replace=False))
        rid = n_warm + c * mix["outstanding"]
        checked.append(ref_sample.Checked(c, r.t_cut, r.y, rid, rows))
    served = reference_outputs(cell, seed, checked, device, precision)
    return check(cell, seed, checked, served, device)
