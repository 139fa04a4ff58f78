"""Per-device figures of the partitioned steps on the fake production
mesh: ``train_4k`` with and without ``Runtime.remat``, and every decode
pair.

    PYTHONPATH=src python3 scripts/torch_partition_fit.py [--out DIR]

Runs ``launch/dryrun.reckon`` on the single-pod ``("data", "model")``
(16, 16) fake mesh (launch/mesh.py ``make_production_mesh``): the
``train_4k`` step of granite-8b, zamba2-1.2b and dbrx-132b (the dense,
the hybrid and the MoE family) once with the runtime of ``runtime_for``
and once with ``remat=True`` beside it, and the ``decode_32k`` and
``long_500k`` steps of the ten architectures (those the JAX package
runs) in the inference layout.  Prints per pair and mode: FLOPs, bytes
per device (parameters, AdamW state, batch, decode state), saved
activation bytes per device, collective bytes and their count by op,
and whether the placed operands plus the saved activations (a lower
bound of the step's peak: gradients and transients come on top) fit one
80 GB card.  Writes ``DIR/partition_fit.json``.  Runs on the CPU, meta
device only; no card is used.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

CARD_BYTES = 80e9
TRAIN_ARCHS = ("granite-8b", "zamba2-1.2b", "dbrx-132b")
DECODE_SHAPES = ("decode_32k", "long_500k")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)
    from repro_torch.configs.base import ARCH_IDS, get_arch, get_shape
    from repro_torch.launch import dryrun
    from repro_torch.launch import shapes as SH
    from repro_torch.launch.mesh import make_production_mesh
    mesh = make_production_mesh()
    runs = []
    for arch in TRAIN_ARCHS:
        base = SH.runtime_for(get_arch(arch), "train_4k", mesh)
        runs += [(arch, "train_4k", "plain", base),
                 (arch, "train_4k", "remat",
                  dataclasses.replace(base, remat=True))]
    for arch in ARCH_IDS:
        cfg = get_arch(arch)
        runs += [(cfg.name, shape, "plain",
                  SH.runtime_for(cfg, shape, mesh))
                 for shape in DECODE_SHAPES
                 if SH.skip_reason(cfg, get_shape(shape)) is None]
    out = {}
    for arch, shape, mode, rt in runs:
        rec = dryrun.reckon(get_arch(arch), shape, mesh, rt)
        held = rec["bytes_per_device"]["total"]
        saved = rec["saved_activation_bytes"]["per_device"]
        row = {"flops": rec["flops"], "bytes_per_device": held,
               "saved_activation_bytes": saved,
               "saved_param_bytes": rec["saved_param_bytes"],
               "collective_bytes": rec["collective_bytes"],
               "collectives": {k: v["count"] for k, v in
                               rec["collectives"].items()},
               "partitioner": rec["partitioner"],
               "fits_80GB_lower_bound": held + saved <= CARD_BYTES,
               "trace_s": rec["trace_s"]}
        out[f"{arch}/{shape}/{mode}"] = row
        print(f"{arch} {shape} {mode}: flops {row['flops']:.6g} "
              f"bytes/device {held} saved/device {saved} collective "
              f"bytes {row['collective_bytes']} {row['collectives']} "
              f"held+saved {(held + saved) / 1e9:.2f} GB "
              f"fits {row['fits_80GB_lower_bound']}", flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "partition_fit.json"), "w") as f:
        json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
