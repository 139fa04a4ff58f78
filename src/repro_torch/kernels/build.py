"""Build a CUDA source of this package into a shared library and load it.

Route: ``nvcc`` compiles one ``.cu`` file with a plain C interface into a
``.so`` for ``sm_90a`` (Hopper), loaded with ``ctypes``; nothing includes
PyTorch's headers, so a build takes seconds.  The library lands in
``build/repro_torch/`` at the root of the checkout (listed in
``.gitignore``) under a name carrying the hash of the source and flags, so
an edited source is rebuilt on its first use and an unchanged one is
reused.  A failed compile raises with nvcc's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Tuple

REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "repro_torch"
CSRC = Path(__file__).resolve().parents[1] / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# path -> (library, seconds the build took here (0.0 if reused), nvcc log)
_LOADED: Dict[str, Tuple[ctypes.CDLL, float, str]] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are "
                       "built on first use and need the CUDA toolkit")


def library_path(source: str) -> Path:
    src = CSRC / source
    digest = hashlib.sha256(src.read_bytes() +
                            " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}_{digest}.so"


def load(source: str) -> Tuple[ctypes.CDLL, float, str]:
    """(library, build seconds, nvcc output) for ``csrc/<source>``,
    compiling it first if no library for this source hash exists."""
    out = library_path(source)
    hit = _LOADED.get(str(out))
    if hit is not None:
        return hit
    seconds, log = 0.0, ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / source)],
            capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed on {source}:\n{log}")
        os.replace(tmp, out)
    entry = (ctypes.CDLL(str(out)), seconds, log)
    _LOADED[str(out)] = entry
    return entry
