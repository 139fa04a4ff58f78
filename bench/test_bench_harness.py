"""CPU tests of the benchmark's harness: its traffic, its rate and
roofline arithmetic, the rules on BENCHMARK.json, the discovery of a new
cell from files alone, and the isolation of the harness and its
reference from JAX, the JAX package and (the reference) the program."""
import ast
import json
import shutil
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from bench import cost, rates, spec, traffic
from bench.run import loaded_forbidden

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def _mix(name):
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", ["shared-prefix-closed",
                                  "unique-prefix-closed"])
def test_traffic_is_the_seed_s(name):
    """The same seed gives the same requests, client by client, whatever
    order the clients ask in; another seed gives the same sizes."""
    mix = _mix(name)
    a = traffic.Stream(mix, 8, 1000, 2 ** 31 + 77)
    b = traffic.Stream(mix, 8, 1000, 2 ** 31 + 77)
    ra = [a.next(c) for c in (0, 1, 2, 0, 1, 2)]
    rb = [b.next(c) for c in (2, 1, 0)] + [b.next(c) for c in (2, 1, 0)]
    by_client = lambda rs: {c: [r.y for r in rs if r.client == c]
                            for c in range(3)}
    for c in range(3):
        for ya, yb in zip(by_client(ra)[c], by_client(rb)[c]):
            assert np.array_equal(ya, yb)
    other = traffic.Stream(mix, 8, 1000, 5)
    ro = [other.next(c) for c in (0, 1, 2)]
    assert [r.t_cut for r in ro] == [125, 250, 500] == \
        [r.t_cut for r in ra[:3]]
    assert all(r.y.shape == (64, 8) for r in ra + ro)


def test_shared_and_unique_prefixes():
    shared = traffic.Stream(_mix("shared-prefix-closed"), 8, 1000, 3)
    reqs = [shared.next(0) for _ in range(3)]
    assert all(np.array_equal(r.y, reqs[0].y) for r in reqs)
    assert len({shared.next(c).y.argmax(1)[0] for c in range(3)}) == 3
    warm = shared.warmup()
    assert [r.client for r in warm] == [0, 1, 2]
    assert np.array_equal(warm[1].y, shared.next(1).y)
    unique = traffic.Stream(_mix("unique-prefix-closed"), 8, 1000, 3)
    ys = [unique.next(c).y for c in (0, 1, 2, 0)]
    assert len({y.tobytes() for y in ys}) == 4
    assert 0.4 < float(np.mean(ys)) < 0.6


def test_zipf_probs_rank_order():
    p = traffic.zipf_probs(8, 1.1)
    assert p.sum() == pytest.approx(1.0)
    assert np.all(np.diff(p) < 0)
    assert np.allclose(traffic.zipf_probs(4, 0.0), 0.25)


def test_whole_cycles_on_a_fake_clock():
    """Marks every 2 s, one request each; a cycle of 3 requests: the
    interval runs from the first mark to the last one a whole number of
    cycles on that lies inside the window."""
    marks = [(2.0 * (i + 1), i + 1) for i in range(20)]
    a, b = rates.whole_cycles(marks, 3, window_s=21.0)
    assert (a, b) == (0, 9)
    assert rates.rate(marks, a, b) == pytest.approx(9 / 18.0)
    assert rates.whole_cycles(marks, 3, window_s=21.0, first=2) == (2, 8)
    assert rates.whole_cycles(marks, 3, window_s=7.0) is None
    # two requests finishing at one mark count once, at that mark
    lumpy = [(1.0, 1), (5.0, 3), (6.0, 4), (9.0, 7)]
    assert rates.whole_cycles(lumpy, 3, 10.0) == (0, 3)
    assert rates.rate(lumpy, 0, 3) == pytest.approx(6 / 8.0)


def test_rowwise_bound_by_hand():
    """One slab of 64 rows × 3,072 elements: 196,608 elements at 82
    integer ops each plus 65 Threefry blocks of 77, against 35 float ops
    an element in the integer slots at half weight; bytes 12 an element
    and 32 of keys, coefficients and mask."""
    e = 64 * 3072
    ints = e * 82 + 65 * 77
    slots = max(ints, (ints + e * 35) * 0.5)
    want = max((12 * e + 32) / 3.35e12, slots / (67e12 / 4))
    assert cost.rowwise_launch_bound_s(1, e, 64) == pytest.approx(want)
    assert cost.share_pct(6.7e12, 1.0, 67e12) == pytest.approx(10.0)


def _reader(name):
    return spec.reader(name)


def test_per_layer_readers_by_hand():
    """mfu: calls × (FLOPs a call + 35 × elements) over the interval and
    the fp32 peak; the roofline: the bound of the rows the traced calls
    before the last stepped over the kernels' time; hit rate as a share,
    idle as a share of the device's span."""
    serve = SimpleNamespace(
        kind="serve", counters={"cache_hits": 3, "cache_misses": 1},
        calls=40, interval_s=2.0, flops_per_call=1e12, images=64, pixels=3072,
        dtype="float32", mix={"max_wave": 1}, slice_rows=[64, 64, 64],
        spans=[
            ("server_scan", 0.0, 0.1), ("client_scan", 0.1, 0.5),
            ("plan", 0.5, 0.6)],
        trace=None)
    want = (40 * 1e12 + 40 * 64 * 3072 * 35) / 2.0 / 67e12 * 100
    assert _reader("mfu.serve")(serve) == pytest.approx(want)
    assert _reader("cache_hit_rate.serve")(serve) == pytest.approx(75.0)
    assert _reader("host_ms_per_call.serve")(serve) == pytest.approx(
        500.0 / 40)
    assert _reader("device_idle.serve")(serve) is None
    from bench.devtrace import TraceSummary
    k = [("void ddpm_step_rowwise<float>(x)", 0, 2000),
         ("conv", 2000, 10_000), ("void ddpm_step_rowwise<float>(x)",
                                  12_000, 14_000)]
    serve.trace = TraceSummary(k, [("bench.poll", 0, 20_000),
                                   ("aten::conv2d", 9_000, 13_000)], 20e-6)
    per = cost.rowwise_launch_bound_s(1, 64 * 3072, 64)
    assert _reader("ddpm_step_roofline.serve")(serve) == pytest.approx(
        100 * 2 * per / 4e-6)
    # a wave of two requests: one call of 128 rows and one of 64 traced
    # before the last
    serve.slice_rows = [128, 64, 64]
    per128 = cost.rowwise_launch_bound_s(1, 128 * 3072, 128)
    assert _reader("ddpm_step_roofline.serve")(serve) == pytest.approx(
        100 * (per128 + per) / 4e-6)
    # busy 12 µs of the device's 14-µs span; the host's window is 20 µs
    assert serve.trace.span_s == pytest.approx(14e-6)
    assert _reader("device_idle.serve")(serve) == pytest.approx(
        100 * 2 / 14)
    assert serve.trace.idle_gaps()[0][0] == "bench.poll > aten::conv2d"
    serve.slice_rows = []
    assert _reader("ddpm_step_roofline.serve")(serve) is None
    other = SimpleNamespace(kind="train", trace=serve.trace)
    assert _reader("device_idle.serve")(other) is None


def test_dit_kernel_readers_by_hand():
    """Flash and SSD: launches × the bound at the traced calls' mean rows
    over the kernel's time; silent where the configuration has no heads
    or no traced calls."""
    from bench.devtrace import TraceSummary
    cfg = json.loads((BENCH / "configs" / "zamba2-hybrid-dit.json")
                     .read_text())
    k = [("flash_fwd_wgmma", 0, 5_000), ("ssd_scan_fwd", 5_000, 25_000),
         ("flash_fwd_wgmma", 30_000, 35_000)]
    run = SimpleNamespace(kind="serve", config=cfg, slice_rows=[96, 32],
                          trace=TraceSummary(k, [], 40e-6))
    nbytes, flops = cost.flash_cost((64, 32, 64, 64), 32, 2)
    want = 100 * 2 * cost.bound_s(nbytes, flops, 989e12) / 10e-6
    assert _reader("flash_roofline.serve")(run) == pytest.approx(want)
    nbytes, flops = cost.ssd_cost((64, 64, 64, 64), 64, 64, 2)
    want = 100 * cost.bound_s(nbytes, flops, 989e12) / 20e-6
    assert _reader("ssd_scan_roofline.serve")(run) == pytest.approx(want)
    run.slice_rows = []
    assert _reader("flash_roofline.serve")(run) is None
    assert _reader("ssd_scan_roofline.serve")(run) is None
    run.slice_rows, run.config = [64], {"dtype": "float32"}
    assert _reader("flash_roofline.serve")(run) is None


def test_benchmark_json_keeps_the_rules():
    bench = spec.load_benchmark(ROOT)
    assert spec.problems(bench, ROOT) == []
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for w in bench["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        cell = spec.Cell.load(bench, w["name"], ROOT)
        assert cell.end_to_end and cell.per_layer
        assert any(m["name"] != "setup_s" for m in cell.end_to_end)
    assert len(json.dumps(bench)) < 64 * 1024


def test_a_new_cell_is_found_from_files_alone(tmp_path):
    """A new mix, limits file, configuration and per-layer reader, plus a
    workloads entry, make a cell the harness runs: no file it had
    changes."""
    shutil.copytree(BENCH / "configs", tmp_path / "bench" / "configs")
    for d in ("traffic", "limits", "metrics"):
        shutil.copytree(BENCH / d, tmp_path / "bench" / d)
    bench = spec.load_benchmark(ROOT)
    cfg = json.loads((BENCH / "configs" / "ddpm-unet.json").read_text())
    cfg["image_size"] = 64
    (tmp_path / "bench" / "configs" / "ddpm-unet-64.json").write_text(
        json.dumps(cfg))
    mix = _mix("shared-prefix-closed")
    mix.update(labels="zipf", zipf_a=1.1)
    (tmp_path / "bench" / "traffic" / "zipf-closed.json").write_text(
        json.dumps(mix))
    (tmp_path / "bench" / "limits" / "unet64-zipf.json").write_text(
        json.dumps({"sample_gap": 1.0}))
    (tmp_path / "bench" / "metrics" / "requests.serve.py").write_text(
        "def read(run):\n    return float(run.requests)\n")
    bench["configs"].append({"name": "ddpm-unet-64", "source": "x",
                             "file": "bench/configs/ddpm-unet-64.json",
                             "reduced": [], "why": "y"})
    bench["workloads"].append({"name": "unet64-zipf",
                               "config": "ddpm-unet-64",
                               "traffic": "zipf-closed", "chips": 1,
                               "why": "z"})
    bench["per_layer"].append({"name": "requests.serve", "unit": "1",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "serve runtime",
                               "moves": "samples_per_s",
                               "workloads": ["unet64-zipf"]})
    for m in bench["end_to_end"]:
        if m["name"] == "samples_per_s":
            m["workloads"].append("unet64-zipf")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    assert spec.problems(bench, tmp_path) == []
    cell = spec.Cell.load(bench, "unet64-zipf", tmp_path)
    assert cell.config["image_size"] == 64
    assert cell.mix["labels"] == "zipf"
    assert cell.loop().__name__ == "bench.loops.serve"
    assert cell.family().__name__ == "bench.models.unet"
    assert [m["name"] for m in cell.end_to_end] == ["samples_per_s",
                                                    "setup_s"]
    got = spec.read_per_layer(cell, SimpleNamespace(
        kind="other", requests=7), tmp_path)
    assert got == {"requests.serve": {"value": 7.0, "unit": "1"}}
    stream = traffic.Stream(cell.mix, 8, 1000, 1)
    assert stream.next(0).y.sum() == 64


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    p.relative_to(BENCH).as_posix() for p in BENCH.rglob("*.py")))
def test_no_jax_and_a_reference_of_its_own(path):
    """No module of the benchmark imports JAX or the JAX package, by
    whole top-level name; the reference imports nothing of the program;
    the tests alone may (to hold the reference against it)."""
    tops = {m.split(".")[0] for m in _imports(BENCH / path)}
    assert not tops & {"jax", "jaxlib", "flax", "repro"}
    if path.startswith("reference/"):
        assert "repro_torch" not in tops


def test_forbidden_names_compare_whole():
    assert loaded_forbidden(["repro_torch", "repro_torch.core", "jaxtyping",
                             "torch", "bench.run"]) == []
    assert loaded_forbidden(["repro.core", "jax.numpy", "flax",
                             "jaxlib"]) == ["flax", "jax", "jaxlib", "repro"]
