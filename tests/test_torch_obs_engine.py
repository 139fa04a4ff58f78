"""The serve engine's step spans, model-call spans and starvation probe
(repro_torch.obs), on the CPU with a toy denoiser.

* With tracing on, each wave's scans hold one ``server_step`` /
  ``client_step`` span a loop iteration and each step one ``model_call``
  span a denoiser call, nested wave → scan → step → model_call, and every
  synchronous span is a ``repro.<name>`` range in a ``torch.profiler``
  session.
* The probe counts every step (``probed_steps`` == ``scan_steps``) and
  the starved ones from its events' answers, here scripted.
* With tracing off, samples are bitwise the traced run's, the engine sees
  the same signatures, and no span, profiler range or event is made.
"""
import itertools
import json
import os
import tempfile

import numpy as np
import pytest
import torch

from repro_torch.core import prng
from repro_torch.core.sample_plan import SampleRequest
from repro_torch.core.schedules import DiffusionSchedule
from repro_torch.obs import JsonlSink, ObsConfig, StarvationProbe, \
    Telemetry, Tracer
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serve import ServeConfig, ServeRuntime
from repro_torch.serve import runtime as serve_runtime

torch.set_num_threads(1)

T = 16
IMG = (4, 4, 3)
B, NC, K = 2, 3, 3
SP = {"a": torch.tensor(0.2), "b": torch.tensor(0.0)}
CP = {"a": torch.tensor([0.1, 0.3, 0.5]), "b": torch.zeros(K)}


class Denoiser:
    """The toy denoiser, counting its calls."""

    def __init__(self):
        self.calls = 0

    def __call__(self, p, x, t, y):
        self.calls += 1
        return x * p["a"] + p["b"]


def _queue():
    """Two cut-depth buckets × two labels with repeats (cache hits on the
    second pass) and a GM request."""
    eye = np.eye(NC, dtype=np.float32)
    spec = [(0, 4, 0), (1, 8, 0), (2, 4, 0), (0, 4, 1), (1, 8, 0),
            (2, 8, 1), (0, 4, 0), (1, 4, 1), (2, 0, 1)]
    return [SampleRequest(c, tc, np.broadcast_to(eye[l], (B, NC)).copy())
            for c, tc, l in spec]


def _runtime(obs=None, apply=None, **over):
    over.setdefault("max_wave", 4)
    return ServeRuntime(ServeConfig(T=T, image_shape=IMG, **over), SP, CP,
                        apply or Denoiser(),
                        DiffusionSchedule.linear(T, device="cpu"),
                        prng.PRNGKey(0), obs=obs, device="cpu")


class ScriptedEvent:
    """A CUDA event's interface; ``query`` answers from a shared script."""

    def __init__(self, script):
        self.script, self.records = script, 0

    def record(self):
        self.records += 1

    def query(self):
        return next(self.script)


def _traced(event=None):
    return Telemetry(ObsConfig(enabled=True), event=event)


def test_step_and_model_call_spans_per_wave(monkeypatch):
    """Per wave: one step span a loop iteration of each scan, one
    model_call span a denoiser call, nested wave → scan → step →
    model_call; the totals are the runtime's scan steps and physical
    calls."""
    tables = []
    real = serve_runtime.tables_to_device
    monkeypatch.setattr(serve_runtime, "tables_to_device",
                        lambda t, d: tables.append(t) or real(t, d))
    den = Denoiser()
    rt = _runtime(obs=ObsConfig(enabled=True), apply=den)
    reps = [rt.process(_queue())[1] for _ in range(2)]
    spans = rt.obs.spans()
    by_sid = {s.sid: s for s in spans}
    kids = {}
    for s in spans:
        kids.setdefault(s.parent, []).append(s)
    waves = sorted((s for s in spans if s.name == "wave"),
                   key=lambda s: s.attrs["wave"])
    assert len(waves) == len(tables) == sum(r["waves"] for r in reps)
    for w, tb in zip(waves, tables):
        scans = {s.name: s for s in kids[w.sid]
                 if s.name.endswith("_scan")}
        S, C = tb.group_t.shape[1], tb.client_t.shape[1]
        G, R = tb.group_t.shape[0], tb.client_t.shape[0]
        for scan, name, n, width in (("server_scan", "server_step", S, G),
                                     ("client_scan", "client_step", C, R)):
            steps = kids.get(scans[scan].sid, [])
            assert [s.name for s in steps] == [name] * n
            assert [s.attrs["step"] for s in steps] == list(range(n))
            for st in steps:
                assert st.attrs["rows"] == width * B
                calls = kids.get(st.sid, [])
                assert [c.name for c in calls] == ["model_call"] * width
                assert all(c.t0 >= st.t0 and c.t1 <= st.t1 for c in calls)
    calls = [s for s in spans if s.name == "model_call"]
    assert len(calls) == den.calls == sum(
        r["server_calls_physical"] + r["client_calls_physical"]
        for r in reps)
    for c in calls:             # model_call → step → scan → wave
        step = by_sid[c.parent]
        scan = by_sid[step.parent]
        assert by_sid[scan.parent].name == "wave"
    assert sum(1 for s in spans if s.name.endswith("_step")) == \
        rt.registry.counter("scan_steps").value


def test_probe_counts_every_step_and_the_scripted_starved_ones():
    answers = [True, False, False, True, False]
    asked = []

    def script():
        for a in itertools.cycle(answers):
            asked.append(a)
            yield a
    events = []
    it = script()
    make = lambda: events.append(ScriptedEvent(it)) or events[-1]
    rt = _runtime(obs=_traced(make))
    reps = [rt.process(_queue())[1] for _ in range(2)]
    probed = sum(r["probed_steps"] for r in reps)
    assert probed == rt.registry.counter("scan_steps").value > 0
    # the first step has no earlier one (starved); each later step asks
    # the previous step's event once
    assert len(asked) == probed - 1
    assert sum(r["starved_steps"] for r in reps) == 1 + sum(asked)
    assert len(events) == 2                          # reused in turn
    assert [e.records for e in events] == [(probed + 1) // 2, probed // 2]


def test_probe_asks_the_last_closed_step():
    reg = MetricsRegistry()
    script = iter([False, True])
    probe = StarvationProbe(reg, lambda: ScriptedEvent(script))
    probe.open()                      # nothing recorded yet: starved
    probe.close()
    probe.open()                      # the device still runs step 0
    probe.close()
    probe.open()                      # step 1 had finished: starved
    assert reg.counter("probed_steps").value == 3
    assert reg.counter("starved_steps").value == 2


def test_spans_are_profiler_ranges():
    rt = _runtime(obs=ObsConfig(enabled=True))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        rt.process(_queue())
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert {"repro.server_step", "repro.client_step", "repro.model_call",
            "repro.server_scan", "repro.client_scan", "repro.plan"} <= names
    assert "repro.wave" not in names        # asynchronous: not bridged
    # CPU ops, not user annotations (which CUDA traces mirror on the
    # device's timeline as activity over the kernels they hold)
    cats = {e["name"]: e.get("cat") for e in _chrome_events(prof)
            if e.get("name", "").startswith("repro.")}
    assert set(cats.values()) == {"cpu_op"}, cats


def test_a_profiler_may_start_and_stop_inside_spans():
    """The benchmark starts its profiler inside a model call and stops it
    inside a later one: spans opened before the start have no range,
    those opened during it have theirs, and nothing raises."""
    tr = Tracer()
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    with tr.span("client_scan"):
        with tr.span("model_call", n=0):
            prof.__enter__()
        for n in (1, 2):
            with tr.span("model_call", n=n):
                torch.ones(3).add_(1)
        with tr.span("model_call", n=3):
            prof.__exit__(None, None, None)
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.name().startswith("repro.")]
    assert names.count("repro.model_call") >= 2
    assert "repro.client_scan" not in names
    assert [s.attrs["n"] for s in tr.drain() if s.name == "model_call"] == \
        [0, 1, 2, 3]


def _chrome_events(prof):
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def test_tracing_off_is_inert_and_on_changes_no_sample(monkeypatch):
    on = _runtime(obs=_traced(lambda: ScriptedEvent(itertools.repeat(True))))
    on_out = [on.process(_queue()) for _ in range(2)]

    def refuse(*a, **kw):
        raise AssertionError("made on the disabled path")
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    off = _runtime(obs=Telemetry(ObsConfig(), event=refuse))
    for outs, rep in on_out:
        off_outs, off_rep = off.process(_queue())
        assert all(torch.equal(a, b) for a, b in zip(outs, off_outs))
        assert off_rep["engine_traces"] == rep["engine_traces"]
        assert off_rep["probed_steps"] == off_rep["starved_steps"] == 0
        assert rep["probed_steps"] > 0
    assert off.traces == on.traces
    assert off.obs.spans() == []


def test_report_keys_are_the_schema():
    assert set(_runtime()._empty_report()) == \
        set(serve_runtime._SERVE_REPORT_SCHEMA)


def test_jsonl_spans_one_flush_a_batch(tmp_path):
    tr = Tracer(clock=iter(range(100)).__next__)
    for i in range(5):
        with tr.span("client_step", step=i, rows=2):
            pass
    sink = JsonlSink(str(tmp_path / "s.jsonl"), clock=lambda: 7.0)
    flushes = []
    fh = sink._fh
    sink._fh = type("Fh", (), {
        "write": lambda self, s: fh.write(s),
        "flush": lambda self: flushes.append(1) or fh.flush(),
        "close": lambda self: fh.close(), "closed": False})()
    sink.spans(tr.drain())
    sink.spans([])
    assert len(flushes) == 1
    sink.close()
    fh.close()
    lines = (tmp_path / "s.jsonl").read_text().splitlines()
    recs = [json.loads(l) for l in lines]
    assert [r["attrs"]["step"] for r in recs] == list(range(5))
    assert all(r["kind"] == "span" and r["t"] == 7.0 for r in recs)


@pytest.mark.parametrize("server_stride", [1, 4])
def test_ddim_server_steps_are_spanned(server_stride):
    """The strided DDIM server phase steps and probes as the DDPM one."""
    rt = _runtime(obs=_traced(lambda: ScriptedEvent(itertools.repeat(False))),
                  server_stride=server_stride, cache=False)
    _, rep = rt.process([SampleRequest(0, 4, np.eye(NC, dtype=np.float32)
                                       [[0, 1]])])
    steps = [s for s in rt.obs.spans() if s.name == "server_step"]
    assert len(steps) == -(-(T - 4) // server_stride)
    assert rep["probed_steps"] == rt.registry.counter("scan_steps").value
