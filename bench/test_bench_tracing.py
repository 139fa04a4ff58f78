"""The readers of the program's engine spans and starvation probe: the
traced slice's device idle split by the host range each gap began in,
the starved share of the window's steps, and (on a card) the probe
itself on a host-bound and a device-bound step loop."""
import time
from types import SimpleNamespace

import pytest
import torch

from bench import idle_split, spec
from bench.devtrace import TraceSummary

SPLIT = ("model_call_idle_ms.serve", "between_calls_idle_ms.serve")


def _read(name, run):
    return spec.reader(name)(run)


def _run(kernels, cpu, calls=3):
    return SimpleNamespace(kind="serve", slice_rows=[64] * calls,
                           trace=TraceSummary(kernels, cpu, 1e-4),
                           counters={})


# device: busy 0–10, 12–20, 25–30, 30–31 (touching), 40–50 µs: gaps
# 10–12, 20–25, 31–40; an overlapping activity inside the first
KERNELS = [("a", 0, 10_000), ("b", 2_000, 8_000), ("c", 12_000, 20_000),
           ("d", 25_000, 30_000), ("e", 30_000, 31_000),
           ("f", 40_000, 50_000)]
CPU = [("bench.poll", 0, 60_000), ("aten::mm", 9_000, 11_000),
       ("repro.model_call", 9_500, 10_000),       # gap starts at its end
       ("repro.model_call", 18_000, 24_000),      # holds 20–25's start
       ("repro.model_call", 19_000, 21_000),      # nested: one range
       ("repro.client_step", 17_000, 33_000)]


def test_idle_splits_by_where_each_gap_starts():
    run = _run(KERNELS, CPU)
    inside, outside = (_read(n, run) for n in SPLIT)
    assert inside == pytest.approx(5e-3 / 3)       # 20–25 µs
    assert outside == pytest.approx((2e-3 + 9e-3) / 3)
    idle_s = run.trace.span_s * _read("device_idle.serve", run) / 100
    assert (inside + outside) * 3 / 1e3 == pytest.approx(idle_s, abs=1e-9)


def test_gaps_are_the_summary_s():
    gaps = idle_split.device_gaps(KERNELS)
    assert gaps == [(10_000, 12_000), (20_000, 25_000), (31_000, 40_000)]
    t = TraceSummary(KERNELS, [], 1e-4)
    assert sum(e - s for s, e in gaps) / 1e9 == pytest.approx(
        t.span_s - t.busy_s)


def test_idle_split_is_silent_without_model_call_ranges():
    """A program without the engine's spans (the parent of this reader)
    reads nothing, as does a run with no trace, no device activity or no
    traced calls."""
    no_ranges = [c for c in CPU if c[0] != "repro.model_call"]
    for run in (_run(KERNELS, no_ranges), _run(KERNELS, CPU, calls=0),
                _run([], CPU),
                SimpleNamespace(kind="serve", trace=None, slice_rows=[64]),
                SimpleNamespace(kind="train", trace=None, slice_rows=[64])):
        assert [_read(n, run) for n in SPLIT] == [None, None]


def test_starved_share_of_the_probed_steps():
    run = SimpleNamespace(kind="serve", counters={})
    assert _read("starved_steps.serve", run) is None
    run.counters = {"probed_steps": 0, "starved_steps": 0}
    assert _read("starved_steps.serve", run) is None
    run.counters = {"probed_steps": 400, "starved_steps": 300}
    assert _read("starved_steps.serve", run) == pytest.approx(75.0)
    assert _read("starved_steps.serve",
                 SimpleNamespace(kind="train", counters={})) is None


def _starved_share(step, steps=200):
    from repro_torch.obs import StarvationProbe
    from repro_torch.obs.metrics import MetricsRegistry
    reg = MetricsRegistry()
    probe = StarvationProbe(reg, torch.cuda.Event)
    for _ in range(3):                         # warm the kernels
        step()
    torch.cuda.synchronize()
    for _ in range(steps):
        probe.open()
        step()
        probe.close()
    torch.cuda.synchronize()
    return 100.0 * reg.counter("starved_steps").value / \
        reg.counter("probed_steps").value


@pytest.mark.cuda
def test_probe_tells_host_bound_from_device_bound():
    """A tiny kernel and a 1-ms host sleep a step: the device waits at
    nearly every step.  A large matmul a step and no host work: the host
    runs ahead and the device never waits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with -m cuda)")
    x = torch.ones(1024, device="cuda")
    w = torch.randn(8192, 8192, device="cuda")

    def host_bound():
        x.mul_(1.0)
        time.sleep(1e-3)

    def device_bound():
        w @ w
    assert _starved_share(host_bound) >= 90.0
    assert _starved_share(device_bound, steps=100) <= 10.0


@pytest.mark.cuda
def test_program_ranges_are_not_device_activity():
    """The tracer's ranges reach the profiler as CPU ops only: no device
    activity carries a ``repro.`` name, so the device's idle gaps stay
    visible to the trace's reduction."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with -m cuda)")
    from bench.devtrace import DeviceTrace
    from repro_torch.obs import Tracer
    tr, w = Tracer(), torch.randn(1024, 1024, device="cuda")
    trace = DeviceTrace()
    trace.start()
    for _ in range(5):
        with tr.span("model_call"):
            w @ w
        time.sleep(1e-3)
    torch.cuda.synchronize()
    got = trace.stop()
    assert any(n == "repro.model_call" for n, _, _ in got._cpu)
    assert not [n for n, _, _ in got.kernels if n.startswith("repro.")]
    assert got.busy_s < 0.5 * got.span_s       # the sleeps show as idle
