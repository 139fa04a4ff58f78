#!/usr/bin/env python3
"""Whether the LM training path keeps its bits across processes on one
card, and where it first differs: ``launch/train.py``'s ``main`` on
Zamba2-1.2B at the published widths (threefry seed 0, batch 4 x 1,024
tokens, bf16), ``--steps`` steps (default 2), in fresh child processes.

    python3 scripts/torch_lm_step_bits.py [--steps N]

The children, in order:

* ``plain`` twice: as ``chip_smoke.py``'s LM training phase runs it
  (``device.deterministic_cuda()``, grad off outside the step);
* ``warm``: the same after work that leaves the process in another state,
  as earlier phases of ``chip_smoke.py`` do: an odd-sized allocation held
  and bf16 GEMMs of other shapes, with and without a bias;
* ``workspace``: the same with ``CUBLAS_WORKSPACE_CONFIG=:4096:8``;
* ``det``: that and ``torch.use_deterministic_algorithms(True,
  warn_only=True)``; the ops it warns about (no deterministic CUDA
  version) are listed.

Each child records checksums of the step's inputs (the Zipf table's
cumsum, summed on the host as the draws sum it; step 0's tokens, the initial parameters) and of every module's
output in the first forward, in call order (a global forward hook; the
bit patterns summed as int64, all and every seventh), each step's loss
and gradient norm (their float32 bits) and a checksum of the parameters
after each step.  Prints, for each child against the first, the first
module call whose output differs and whether each step's numbers agree
bitwise, then one JSON line with every child's numbers, the card's
name, power limit and driver, and torch's and CUDA's versions.  Needs
one CUDA device; exits nonzero without one.
"""
from __future__ import annotations

import argparse
import json
import os
import struct
import subprocess
import sys
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARGV = ["--arch", "zamba2-1.2b", "--batch", "4", "--seq", "1024",
        "--log-every", "1"]
MODES = ("plain", "plain", "warm", "workspace", "det")


def bits(x: float) -> str:
    return struct.pack(">f", x).hex()


def checksum(t) -> list:
    import torch
    v = t.detach().contiguous()
    if v.is_floating_point():
        v = v.view({2: torch.int16, 4: torch.int32}[v.element_size()])
    v = v.reshape(-1).to(torch.int64)
    return [int(v.sum()), int(v[::7].sum())]


def child(mode: str, steps: int) -> dict:
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.device import deterministic_cuda
    from repro_torch.launch import train
    from repro_torch.optim.adamw import named

    torch.set_grad_enabled(False)
    deterministic_cuda()
    held = None
    if mode == "warm":
        held = torch.empty(12_345_679, dtype=torch.uint8, device="cuda")
        g = torch.Generator(device="cuda").manual_seed(1)
        for m, k, n in ((1000, 3000, 777), (4096, 2048, 8192), (333, 64, 65)):
            a = torch.randn(m, k, generator=g, device="cuda").bfloat16()
            b = torch.randn(k, n, generator=g, device="cuda").bfloat16()
            bias = torch.randn(n, generator=g, device="cuda").bfloat16()
            torch.addmm(bias, a, b)
            a @ b
        torch.cuda.synchronize()
    if mode == "det":
        torch.use_deterministic_algorithms(True, warn_only=True)
    # the step's inputs: the Zipf table's cumsum, step 0's tokens, the
    # initial parameters
    from repro_torch.configs.base import get_arch
    from repro_torch.core import prng
    from repro_torch.data.tokens import zipf_probs
    from repro_torch.models import api
    cfg = get_arch("zamba2-1.2b")
    key = prng.PRNGKey(0, device="cuda")
    inputs = dict(
        zipf_cumsum=checksum(torch.cumsum(zipf_probs(cfg.vocab_size), 0)),
        tokens=checksum(train.build_batch(prng.fold_in(key, 0), cfg, 4,
                                          1024)["tokens"]),
        init_params=[sum(checksum(t)[j] for t in named(
            api.init_params(key, cfg, "cuda")).values()) for j in (0, 1)])

    calls = []
    recording = [True]

    def hook(module, inputs, output):
        if recording[0]:
            out = output[0] if isinstance(output, (tuple, list)) else output
            if isinstance(out, torch.Tensor) and out.is_floating_point():
                calls.append([type(module).__name__] + checksum(out))

    records = []

    def on_step(i, params, opt, metrics):
        recording[0] = False
        p = named(params)
        records.append(dict(
            loss=bits(float(metrics["loss"])),
            grad_norm=bits(float(metrics["grad_norm"])),
            params=[sum(checksum(t)[j] for t in p.values()) for j in (0, 1)]))

    handle = torch.nn.modules.module.register_module_forward_hook(hook)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        losses = train.main(ARGV + ["--steps", str(steps)], on_step=on_step)
    handle.remove()
    nondet = sorted({str(w.message).split(" does not have a deterministic")[0]
                     for w in caught
                     if "deterministic" in str(w.message)})
    del held
    return dict(mode=mode, inputs=inputs, losses=losses, steps=records,
                calls=calls,
                nondeterministic=nondet,
                cublas_workspace=os.environ.get("CUBLAS_WORKSPACE_CONFIG"))


def compare(a: dict, b: dict) -> str:
    first = next((i for i, (x, y) in enumerate(zip(a["calls"], b["calls"]))
                  if x != y), None)
    where = ("every module output bitwise" if first is None and
             len(a["calls"]) == len(b["calls"]) else
             f"first differing module output: call {first} "
             f"({b['calls'][first][0]}) of {len(b['calls'])}")
    same = [x == y for x, y in zip(a["steps"], b["steps"])]
    inputs = {k: a["inputs"][k] == v for k, v in b["inputs"].items()}
    return (f"inputs bitwise: {inputs}; {where}; steps bitwise (loss, grad "
            f"norm, parameters): {same}; "
            f"losses {[s['loss'] for s in b['steps']]} "
            f"({', '.join(f'{x:.6f}' for x in b['losses'])})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--child", choices=sorted(set(MODES)))
    ap.add_argument("--steps", type=int, default=2)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    if args.child:
        print("CHILD " + json.dumps(child(args.child, args.steps)))
        return 0
    runs = []
    for mode in MODES:
        env = dict(os.environ)
        if mode in ("workspace", "det"):
            env["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        done = subprocess.run([sys.executable, __file__, "--child", mode,
                               "--steps", str(args.steps)],
                              env=env, capture_output=True, text=True)
        if done.returncode != 0:
            print(done.stdout[-4000:], done.stderr[-4000:], file=sys.stderr)
            return done.returncode
        out = done.stdout
        runs.append(json.loads(next(line[6:] for line in out.splitlines()
                                    if line.startswith("CHILD "))))
    for i, r in enumerate(runs[1:], 1):
        print(f"child {i} ({r['mode']}) against child 0 (plain): "
              f"{compare(runs[0], r)}")
    print(f"child 4 (det) warns of: {runs[4]['nondeterministic']}")
    smi = lambda q: subprocess.run(
        ["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(json.dumps({
        "card": smi("name,power.limit"), "driver": smi("driver_version"),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "runs": [{k: v for k, v in r.items() if k != "calls"} |
                 {"module_calls": len(r["calls"])} for r in runs]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
