"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Finds the cell in ``BENCHMARK.json`` and everything it names under
``bench/`` (``spec.py``), runs the program (``src/repro_torch``) on one
CUDA device through the mix's loop, checks what the timed path produced
against the plain reference, and prints one JSON object as the last line
of standard output: ``correct``, ``attempted``, ``failed``, ``metrics``
(the end-to-end metrics, or with ``--trace 1`` the per-layer ones),
``device``, with ``--trace 1`` the ``breakdown``, and last ``compared``:
each number held against its limit.  The same numbers close standard
error.  With no CUDA device, or fewer than the cell asks for, it prints
no result and exits 2.  It exits 3 if JAX or the JAX package was loaded.

``--control <precision>`` runs the cell's control instead (the reference
at a lower precision, or a planted fault, in the program's place) and
prints its compared numbers; the benchmark's own runs never take it.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _paths() -> None:
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def loaded_forbidden(modules=None):
    """Top-level names of loaded modules (``sys.modules`` by default)
    that are JAX or the JAX package, compared whole (``repro_torch`` is
    not ``repro``)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", default=None)
    args = ap.parse_args(argv)
    _paths()
    from bench import spec
    cell = spec.Cell.load(spec.load_benchmark(ROOT), args.workload, ROOT)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"bench: needs {cell.chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    loop = cell.loop()
    card = _power_limit()
    if args.control is not None:
        compared = loop.control(cell, args.seed, device, args.control)
        print(json.dumps({"control": args.control, "seed": args.seed,
                          "card": card, "compared": compared}))
        return 0
    out = loop.run(cell, args.seed, args.seconds, bool(args.trace),
                     device, T_START)
    found = loaded_forbidden()
    if found:
        print(f"bench: loaded {found}", file=sys.stderr)
        return 3
    kind = torch.cuda.get_device_name(device)
    dev = {"platform": "gpu", "kind": kind, "count": 1,
           "memory_peak_bytes": int(out["peak"])}
    # a gap that is not a number reads as the largest float JSON holds
    compared = {n: {"value": v if v == v and abs(v) < 1e308 else 1e308,
                    "limit": cell.limits[n]}
                for n, v in out["compared"].items()}
    correct = all(c["value"] <= c["limit"] for c in compared.values())
    line = {"correct": correct, "attempted": out["attempted"],
            "failed": out["failed"]}
    if args.trace:
        tr = out["trace"]
        line["metrics"] = spec.read_per_layer(cell, out["readings"])
        if tr is not None:
            dev["busy_s"] = tr.busy_s
            dev["window_s"] = tr.window_s
            line["breakdown"] = {"device_ops": tr.top_ops(),
                                 "idle_gaps": tr.idle_gaps()}
    else:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        values = dict(out["e2e"], setup_s=out["setup_s"])
        line["metrics"] = {n: {"value": v, "unit": units[n]}
                           for n, v in values.items() if n in units}
    line["device"] = dev
    line["card"] = card
    line["compared"] = compared
    for n, c in compared.items():
        print(f"{n} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
