"""``chip_smoke.py``'s device-time accounting, checked on the CPU.

A kineto ``key_averages()`` holds a row per CPU op and a row per device
kernel; the CPU op's self device time repeats the time of the kernels it
launched.  Device time is the sum over the device rows alone (the rule of
torch's own profiler table); summing every row counted those kernels
twice.
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
