"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled with nvcc for
sm_90a into its own shared library, named by a hash of its source, under
``build/irgs_tpu_torch/`` at the repository root, at first use, and loaded
with ctypes. A library already built for the same source is reused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "irgs_tpu_torch"

_LOADED: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's kernels are built from "
                           f"{CSRC} on a machine with the CUDA toolkit")
    return path


def build(name: str, verbose: bool = False) -> tuple[Path, float, str]:
    """Compile csrc/<name>.cu for sm_90a, unless the library for this source
    exists. Returns (library path, seconds, compiler log); with `verbose`
    the log holds ptxas' register and spill lines."""
    src_path = CSRC / f"{name}.cu"
    tag = hashlib.sha256(src_path.read_bytes()).hexdigest()[:12]
    lib = BUILD_DIR / f"lib{name}_{tag}.so"
    if lib.exists():
        return lib, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp),
           str(src_path)]
    if verbose:
        cmd[1:1] = ["-Xptxas", "-v"]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src_path.name} "
                           f"({res.returncode}):\n{res.stderr}")
    os.replace(tmp, lib)
    return lib, secs, res.stderr


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed. The
    caller declares argtypes and restype."""
    if name not in _LOADED:
        path, _, _ = build(name)
        _LOADED[name] = ctypes.CDLL(str(path))
    return _LOADED[name]
