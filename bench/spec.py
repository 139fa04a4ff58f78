"""What a run is, found by name: the cell in ``BENCHMARK.json``, its
configuration file, its traffic mix, its limits and the readers of its
per-layer metrics.  Nothing here names a cell: a new cell is a
``workloads`` entry plus files under ``bench/``.

* ``bench/configs/<config>.json``: the sizes; ``"model_code"`` picks the
  model code ``bench/models/<model_code>.py``.
* ``bench/traffic/<traffic>.json``: the mix; ``"kind"`` picks the loop
  ``bench/loops/<kind>.py``.
* ``bench/limits/<workload>.json``: each compared number's limit.
* ``bench/metrics/<metric>.py``: a ``read(run)`` that returns the
  metric's value, or None where the run has nothing to read.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_benchmark(root: Path = ROOT) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    def __init__(self, name: str, config: Dict, mix: Dict, limits: Dict,
                 end_to_end: List[Dict], per_layer: List[Dict],
                 chips: int = 1):
        self.name, self.config, self.mix, self.limits = \
            name, config, mix, limits
        self.chips = chips
        self.end_to_end = [m for m in end_to_end if self._mine(m)]
        self.per_layer = [m for m in per_layer if self._mine(m)]

    @classmethod
    def load(cls, bench: Dict, workload: str, root: Path = ROOT) -> "Cell":
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        w = cells[workload]
        entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
        read = lambda p: json.loads(p.read_text())
        here = root / "bench"
        return cls(workload, read(root / entry["file"]),
                   read(here / "traffic" / f"{w['traffic']}.json"),
                   read(here / "limits" / f"{workload}.json"),
                   bench["end_to_end"], bench["per_layer"], w["chips"])

    def _mine(self, metric: Dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    def family(self):
        return importlib.import_module(
            f"bench.models.{self.config['model_code']}")

    def loop(self):
        return importlib.import_module(f"bench.loops.{self.mix['kind']}")


def reader(metric: str, root: Path = ROOT):
    """The ``read`` function of ``bench/metrics/<metric>.py``."""
    path = root / "bench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{metric.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_per_layer(cell: Cell, run, root: Path = ROOT) -> Dict[str, Dict]:
    """{name: {"value", "unit"}} of the cell's per-layer metrics that
    found something to read."""
    out = {}
    for m in cell.per_layer:
        value = reader(m["name"], root)(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def problems(bench: Dict, root: Path = ROOT) -> List[str]:
    """What in ``bench`` breaks the naming rules or names a file, reader,
    loop or limit that is not there."""
    out: List[str] = []
    here = root / "bench"
    metrics = bench["end_to_end"] + bench["per_layer"]
    for group in (bench["configs"], bench["workloads"], metrics):
        names = [x["name"] for x in group]
        if len(set(names)) != len(names):
            out.append(f"repeated names in {names}")
        out += [f"bad name {n!r}" for n in names if not NAME.match(n)]
    out += [f"bad unit {m['unit']!r}" for m in metrics
            if not UNIT.match(m["unit"])]
    for c in bench["configs"]:
        out += [f"bad key {k!r}" for k in c["reduced"] if not NAME.match(k)]
        if not (root / c["file"]).is_file():
            out.append(f"missing {c['file']}")
    for w in bench["workloads"]:
        for k in ("config", "traffic"):
            if not NAME.match(w[k]):
                out.append(f"bad {k} {w[k]!r}")
        for rel in (f"traffic/{w['traffic']}.json",
                    f"limits/{w['name']}.json"):
            if not (here / rel).is_file():
                out.append(f"missing bench/{rel}")
    out += [f"missing bench/metrics/{m['name']}.py"
            for m in bench["per_layer"]
            if not (here / "metrics" / f"{m['name']}.py").is_file()]
    return out


