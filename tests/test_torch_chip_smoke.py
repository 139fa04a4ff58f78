"""``chip_smoke.py``'s accounting, checked on the CPU: the device time of
a profile, the grouped matmul's bound, and the ``kernels`` line.

A kineto ``key_averages()`` holds a row per CPU op and a row per device
kernel; the CPU op's self device time repeats the time of the kernels it
launched.  Device time is the sum over the device rows alone (the rule of
torch's own profiler table); summing every row counted those kernels
twice.  The grouped matmul's bound counts its bytes (tokens read once,
one set when broadcast to every expert) and its flops; the ``kernels``
line lists all five kernels with every key the contract names, and the
three kernels with variants their launches per variant.
"""
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _row(device_type, us, count=1, **kw):
    return SimpleNamespace(device_type=device_type, self_device_time_total=us,
                           count=count, key="k", **kw)


def test_device_rows_count_each_kernel_once():
    cs = _chip_smoke()
    rows = [_row(DeviceType.CPU, 30.0),        # aten::mm: its kernel's time
            _row(DeviceType.CUDA, 30.0),       # the GEMM kernel itself
            _row(DeviceType.CUDA, 5.0, 2),     # a ctypes kernel, no CPU op
            _row(DeviceType.CUDA, 7.0, is_user_annotation=True)]
    picked = cs.device_rows(rows)
    assert sum(e.self_device_time_total for e in picked) == 35.0
    assert sum(e.count for e in picked) == 3


def test_device_rows_of_a_cpu_profile_are_empty():
    with profile(activities=[ProfilerActivity.CPU]) as p:
        torch.ones(4).add_(1)
    assert _chip_smoke().device_rows(p.key_averages()) == []


def test_gmm_bound_counts_bytes_and_flops_of_the_moe_path():
    """(16, 256, 6144) @ (16, 6144, 10752) in bf16 with tokens broadcast:
    the weights, one token set and the output in bytes, 2·E·C·D·F flops;
    bytes bind on the H100."""
    cs = _chip_smoke()
    E, C, D, F = 16, 256, 6144, 10752
    nbytes, flops = cs.gmm_work(E, C, D, F, 2, True)
    assert nbytes == 2 * (C * D + E * D * F + E * C * F)
    assert flops == 2 * E * C * D * F == 541_165_879_296
    ms, by = cs.gmm_bound(E, C, D, F, 2, True)
    assert by == "bytes"
    assert ms == nbytes / cs.HBM_BYTES_PER_S * 1e3
    assert 0.65 < ms < 0.67
    # without the broadcast every expert's tokens are read
    unshared, _ = cs.gmm_work(E, C, D, F, 2, False)
    assert unshared - nbytes == 2 * (E - 1) * C * D
    # float32 at the CUDA-core rate: operations bind
    ms32, by32 = cs.gmm_bound(E, C, D, F, 4, True)
    assert by32 == "operations"
    assert ms32 == flops / cs.FP32_FLOPS_PER_S * 1e3


def test_kernels_line_lists_every_kernel_with_every_key():
    """Every kernel carries the contract's keys; the three kernels with
    variants also carry their launches per variant and their card time,
    flash its numbers at head dim 128, the SSD scan its simt variant's
    time and the grouped matmul its three shapes."""
    cs = _chip_smoke()
    names = ["ddpm_step_batched", "ddpm_step", "flash_attention",
             "ssd_scan", "grouped_matmul"]
    records = {n: dict(max_abs_err=0.0, ms=1.0, plain_ms=2.0, bound_ms=0.5,
                       bound_by="bytes") for n in names}
    records["grouped_matmul"].update(library_ms=0.8, card_ms=0.79,
                                     shapes=[dict(name="gate", ms=0.8)])
    records["flash_attention"].update(
        library_ms=0.03, card_ms=0.004,
        head_dim_128=dict(ms=0.028, library_ms=0.035, bound_ms=0.0022))
    records["ssd_scan"].update(library_ms=None, card_ms=0.0054,
                               simt_ms=0.082)
    launches = {n: i + 1 for i, n in enumerate(names)}
    launches.update({"flash_attention/wgmma": 3, "flash_attention/simt": 0,
                     "grouped_matmul/wgmma": 5, "grouped_matmul/wmma": 0,
                     "grouped_matmul/simt": 0, "ssd_scan/wgmma": 4,
                     "ssd_scan/simt": 0})
    line = cs.kernels_line(records, launches)
    assert [k["name"] for k in line["kernels"]] == names
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    extra = {"flash_attention": {"launches_by_variant", "card_ms",
                                 "head_dim_128"},
             "ssd_scan": {"launches_by_variant", "card_ms", "simt_ms"},
             "grouped_matmul": {"launches_by_variant", "card_ms", "shapes"}}
    for k in line["kernels"]:
        assert set(k) == keys | extra.get(k["name"], set())
        assert k["route"] == "cuda"
        assert (ROOT / k["source"]).is_file()
        path, line_no = k["replaces"].split(":")
        src = (ROOT / path).read_text().splitlines()
        assert src[int(line_no) - 1].startswith("def ")
        assert k["launches"] == launches[k["name"]]
    flash, ssd, gmm = line["kernels"][2], line["kernels"][3], \
        line["kernels"][-1]
    assert ssd["launches_by_variant"] == {"wgmma": 4, "simt": 0}
    assert ssd["card_ms"] == 0.0054 and ssd["simt_ms"] == 0.082
    assert ssd["library_ms"] is None
    assert ssd["replaces"] == "src/repro/kernels/ssd_scan/kernel.py:69"
    assert flash["launches_by_variant"] == {"wgmma": 3, "simt": 0}
    assert flash["head_dim_128"] == records["flash_attention"]["head_dim_128"]
    assert flash["card_ms"] == 0.004 and flash["library_ms"] == 0.03
    assert gmm["launches_by_variant"] == {"wgmma": 5, "wmma": 0, "simt": 0}
    assert gmm["source"] == "src/repro_torch/csrc/grouped_matmul.cu"
    assert gmm["replaces"] == "src/repro/kernels/grouped_matmul/kernel.py:39"
    assert gmm["library_ms"] == 0.8 and gmm["card_ms"] == 0.79
    assert line["kernels"][0]["library_ms"] is None
