"""A traced window: ``torch.profiler`` over CPU and CUDA activity, reduced
to what the per-layer readers and the ``breakdown`` need.

* ``kernels``: every device activity (kernels, copies, sets) as
  (name, start_ns, end_ns) on the profiler's clock.
* ``busy_s``: the union of those intervals; ``window_s``: the host time
  from the profiler's start to its stop; ``span_s``: the device's own
  time from the first activity's start to the last one's end.
* ``top_ops``: device seconds by name; ``idle_gaps``: the longest
  intervals with nothing on the device, each named by the innermost host
  operation running when it began (and the benchmark's own range around
  it, ``bench.*``).
"""
from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch


class TraceSummary:
    def __init__(self, kernels, cpu, window_s: float):
        self.kernels: List[Tuple[str, int, int]] = sorted(
            kernels, key=lambda k: k[1])
        self.window_s = window_s
        busy, gaps, cur_s, cur_e = 0, [], None, None
        for _, s, e in self.kernels:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                    gaps.append((cur_e, s))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        self.busy_s = busy / 1e9
        self.span_s = (cur_e - self.kernels[0][1]) / 1e9 \
            if self.kernels else 0.0
        by_name: Dict[str, float] = defaultdict(float)
        for n, s, e in self.kernels:
            by_name[n] += (e - s) / 1e9
        self.by_name = dict(by_name)
        self._gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
        self._cpu = cpu

    def device_s(self, pattern: str = "") -> float:
        """Device seconds of the activities whose name holds ``pattern``."""
        return sum(v for n, v in self.by_name.items() if pattern in n)

    def count(self, pattern: str) -> int:
        return sum(1 for n, _, _ in self.kernels if pattern in n)

    def top_ops(self, n: int = 10) -> List[List]:
        return [[k[:120], v] for k, v in sorted(
            self.by_name.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self) -> List[List]:
        out = []
        for s, e in self._gaps:
            inner, outer = None, None
            for name, cs, ce in self._cpu:
                if cs <= s < ce:
                    if name.startswith("bench."):
                        outer = name
                    elif inner is None or ce - cs < inner[2] - inner[1]:
                        inner = (name, cs, ce)
            label = " > ".join(x for x in (
                outer, inner[0] if inner else None) if x) or "host idle"
            out.append([label[:120], (e - s) / 1e9])
        return out


class DeviceTrace:
    """Start with ``start()``, end with ``stop()`` → TraceSummary."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._t0 = 0.0

    def start(self) -> None:
        self._prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self) -> TraceSummary:
        """Device work still running at the stop lies outside the
        window and is not waited for."""
        window = time.perf_counter() - self._t0
        self._prof.__exit__(None, None, None)
        from torch.autograd import DeviceType
        kernels, cpu = [], []
        for ev in self._prof.profiler.kineto_results.events():
            if ev.device_type() == DeviceType.CUDA:
                kernels.append((ev.name(), ev.start_ns(), ev.end_ns()))
            else:
                cpu.append((ev.name(), ev.start_ns(), ev.end_ns()))
        return TraceSummary(kernels, cpu, window)
