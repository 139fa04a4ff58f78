#!/usr/bin/env python3
"""What launch/dryrun.py's ``StepCounters`` saves: the walls of the two
dry runs as chip_smoke.py's ``phase_dryrun`` runs them (``dryrun --all``
on the single-pod fake mesh, then ``collab_dryrun`` at
chip_smoke.COLLAB_DRYRUN_ARGS), each once with the dry run's own counters
and once with plain counters (``FlopCounterMode`` and a dispatch mode
that counts the c10d ops: no output shapes cached, group norm through
torch's meta decomposition), and whether the two give the same records.

    PYTHONPATH=src python3 scripts/torch_dryrun_walls.py [--out DIR]

Prints, for each dry run and each counter, its wall in seconds, then the
fields (FLOPs, saved bytes, census, bytes per device) on which the two
counters' records differ: none, or it exits nonzero.  Runs on the CPU
alone (no card is needed or touched); the records go under ``--out``
(default experiments/dryrun_walls).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

# the plain counters, put in place of ``dryrun.measure`` in the process
# that runs a dry run
PLAIN = r'''
import sys, time
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode
from repro_torch import kernels
from repro_torch.launch import collab_dryrun, dryrun


class Census(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace == "c10d" and args:
            name = func._overloadpacket.__name__
            c = self.ops.setdefault(dryrun.COLLECTIVE_NAMES.get(name, name),
                                    {"count": 0, "bytes": 0})
            c["count"] += 1
            c["bytes"] += sum(t.numel() * t.element_size()
                              for t in dryrun.tensor_leaves(args[0]))
        return out


def measure(fn, args):
    kernels.reset_flops()
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as fc, Census() as census, \
            dryrun.SavedBytes() as saved, torch.no_grad():
        fn(*args)
    kflops = dict(kernels.FLOPS)
    coll = sum(c["bytes"] for c in census.ops.values())
    return {"trace_s": round(time.perf_counter() - t0, 3),
            "flops": fc.get_total_flops() + sum(kflops.values()),
            "aten_flops": fc.get_total_flops(), "kernel_flops": kflops,
            "saved_activation_bytes": saved.activation_bytes,
            "saved_param_bytes": saved.param_bytes,
            "collectives": census.ops, "collective_bytes": coll,
            "collective_bound_s": coll / dryrun.NVLINK_BW}


dryrun.measure = collab_dryrun.measure = measure
module = dryrun if sys.argv[1] == "dryrun" else collab_dryrun
module.main(sys.argv[2:])
'''

# what the records are compared on (every field but the walls)
WALLS = ("trace_s",)


def strip(rec):
    if isinstance(rec, dict):
        return {k: strip(v) for k, v in rec.items() if k not in WALLS}
    return rec


def run(name: str, argv, counters: str, out: Path) -> float:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    cmd = [sys.executable] + (
        ["-m", f"repro_torch.launch.{name}"] if counters == "own" else
        ["-c", PLAIN, name]) + list(argv) + ["--out", str(out)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=str(ROOT), env=env, capture_output=True,
                          text=True, timeout=1800)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        print(proc.stdout[-2000:], proc.stderr[-4000:], file=sys.stderr)
        raise SystemExit(f"{name} ({counters}): exit {proc.returncode}")
    return wall


def main(argv=None) -> int:
    import chip_smoke
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=str(ROOT / "experiments" /
                                         "dryrun_walls"))
    args = ap.parse_args(argv)
    runs = (("dryrun", ["--all"]),
            ("collab_dryrun", chip_smoke.COLLAB_DRYRUN_ARGS))
    walls, differ = {}, []
    for counters in ("own", "plain"):
        for name, a in runs:
            out = Path(args.out) / counters
            walls[name, counters] = run(name, a, counters, out)
            print(f"{name} ({counters} counters): wall "
                  f"{walls[name, counters]:.1f} s", flush=True)
    own, plain = Path(args.out) / "own", Path(args.out) / "plain"
    names = sorted(p.name for p in own.glob("*.json"))
    if names != sorted(p.name for p in plain.glob("*.json")):
        differ.append("the set of records")
    for n in names:
        a = strip(json.loads((own / n).read_text()))
        b = strip(json.loads((plain / n).read_text()))
        if a != b:
            differ.append(n)
    print(f"records compared: {len(names)}; differ: {differ or 'none'}")
    for name, _ in runs:
        print(f"{name}: own {walls[name, 'own']:.1f} s, plain "
              f"{walls[name, 'plain']:.1f} s "
              f"({walls[name, 'plain'] / walls[name, 'own']:.2f}x)")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
