"""The dry run of the paper's own programs (launch/collab_dryrun.py) on
the fake production mesh, on the CPU, in a subprocess (its fake process
group must not meet other test files' groups): at ``--image-size 16
--batch 16 --T 100 --t-cut 20`` it writes all six programs with the dry
run's fields; the ``--clients`` divisibility check of the reference
holds; one Alg.-1 step of its U-Net (``collab_step_program``) counts the
same FLOPs and saved bytes on meta, under ``dryrun.measure``'s counters
(group norm answered from its shapes, output shapes cached), as on the
CPU under ``FlopCounterMode``."""
import json
import subprocess
import sys
from pathlib import Path

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import kernels
from repro_torch.launch import collab_dryrun, dryrun

ROOT = Path(__file__).resolve().parents[1]
PROGRAMS = {"collab_train_step", "server_denoise", "vectorized_round",
            "ragged_round", "train_runtime", "vectorized_sample"}
FIELDS = {"trace_s", "flops", "aten_flops", "kernel_flops",
          "bytes_per_device", "saved_activation_bytes", "saved_param_bytes",
          "collectives", "collective_bytes", "collective_bound_s",
          "partitioner"}


def _run(tmp_path, *argv):
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "OMP_NUM_THREADS": "1"}
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.collab_dryrun",
         "--out", str(tmp_path), *argv], capture_output=True, text=True,
        timeout=600, cwd=str(tmp_path), env=env)


def test_collab_dryrun_writes_the_six_programs(tmp_path):
    proc = _run(tmp_path, "--image-size", "16", "--batch", "16", "--T",
                "100", "--t-cut", "20")
    assert proc.returncode == 0, proc.stderr[-4000:]
    rec = json.loads((tmp_path / "collafuse_unet__pod16x16.json")
                     .read_text())
    assert rec["n_devices"] == 256 and rec["T"] == 100
    progs = rec["results"]
    assert set(progs) == PROGRAMS
    for name, r in progs.items():
        assert set(r) == FIELDS, name
        assert r["flops"] > 0 and r["partitioner"] is None
        assert r["collectives"] == {} and r["collective_bound_s"] == 0
        assert r["bytes_per_device"]["total"] == sum(
            v for k, v in r["bytes_per_device"].items() if k != "total")
    # the sampling programs save nothing for a backward; the training
    # ones do, and their kernels are the keyed DDPM steps' alone
    assert progs["server_denoise"]["saved_activation_bytes"] == 0
    assert progs["vectorized_sample"]["saved_activation_bytes"] == 0
    assert progs["collab_train_step"]["saved_activation_bytes"] > 0
    assert set(progs["server_denoise"]["kernel_flops"]) == {"ddpm_step"}
    assert set(progs["vectorized_sample"]["kernel_flops"]) == {
        "ddpm_step_batched"}
    # the three rounds run the same steps; only their inputs differ
    assert progs["vectorized_round"]["flops"] == \
        progs["ragged_round"]["flops"] == progs["train_runtime"]["flops"]


def test_collab_dryrun_refuses_a_client_count_that_does_not_tile(tmp_path):
    proc = _run(tmp_path, "--clients", "3")
    assert proc.returncode != 0
    assert "--clients 3: must divide" in proc.stderr


def test_a_unet_step_counts_on_meta_as_on_the_cpu():
    """Image 16, batch 2, T 10, cut 2: client and server both train."""
    fn, args = collab_dryrun.collab_step_program(16, 2, 10, 2, "meta")
    meta = dryrun.measure(fn, args)
    fn, args = collab_dryrun.collab_step_program(16, 2, 10, 2, "cpu")
    kernels.reset_flops()
    with FlopCounterMode(display=False) as fc, dryrun.SavedBytes() as saved, \
            torch.no_grad():
        fn(*args)
    assert meta["flops"] == fc.get_total_flops() + kernels.total_flops()
    assert meta["aten_flops"] == fc.get_total_flops() > 0
    assert meta["saved_activation_bytes"] == saved.activation_bytes > 0
    assert meta["saved_param_bytes"] == saved.param_bytes > 0
