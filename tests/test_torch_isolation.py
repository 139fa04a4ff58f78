"""The port stands alone: no module of ``repro_torch``, not
``chip_smoke.py`` and not the port's examples (``examples/torch_*.py``)
imports JAX, the JAX package, ``msgpack`` or ``ml_dtypes`` (the card's
machine has neither), and its entry points run on CUDA unless the caller
asks for the CPU — without a card they raise instead of falling back."""
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
IMPORT_RE = re.compile(
    r"^\s*(import\s+(jax|repro|msgpack|ml_dtypes)\b|"
    r"from\s+(jax|repro|msgpack|ml_dtypes)(\.|\s))")

_BLOCKED_IMPORT = r'''
import importlib, pkgutil, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro", "msgpack",
                                  "ml_dtypes"):
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Block())
for blocked in ("jax", "msgpack", "ml_dtypes"):
    sys.modules[blocked] = None
sys.path[:0] = [{src!r}, {root!r}]
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
import importlib.util, pathlib
for path in sorted(pathlib.Path({root!r}, "examples").glob("torch_*.py")):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
assert not any(m.split(".")[0] in ("jax", "repro", "msgpack", "ml_dtypes")
               for m in sys.modules
               if sys.modules[m] is not None), "jax/repro/msgpack imported"
print(len(names))
'''


def _sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"] + \
        sorted((ROOT / "examples").glob("torch_*.py"))


def test_every_module_imports_with_jax_blocked():
    code = _BLOCKED_IMPORT.format(src=str(ROOT / "src"), root=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr
    n = int(proc.stdout.strip().splitlines()[-1])
    assert n == len(list(pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")))


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_line_imports_jax_or_repro(path):
    bad = [line for line in path.read_text().splitlines()
           if IMPORT_RE.match(line)]
    assert not bad, bad


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")


def test_serve_runtime_without_device_raises():
    _no_cuda()
    from repro_torch.core import prng
    from repro_torch.core.schedules import DiffusionSchedule
    from repro_torch.serve import ServeConfig, ServeRuntime
    cfg = ServeConfig(T=4, image_shape=(2, 2, 3))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeRuntime(cfg, {"a": torch.tensor(0.1)}, [{"a": torch.tensor(0.1)}],
                     lambda p, x, t, y: x * p["a"],
                     DiffusionSchedule.linear(4), prng.PRNGKey(0))


def test_init_unet_and_cli_without_device_raise():
    _no_cuda()
    from repro_torch.configs.ddpm_unet import SMALL
    from repro_torch.core import prng
    from repro_torch.core.unet import init_unet
    from repro_torch.launch import collab_serve
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_unet(prng.PRNGKey(0), SMALL)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        collab_serve.main(["--requests", "1"])
