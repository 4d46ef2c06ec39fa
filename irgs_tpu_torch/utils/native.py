"""ctypes binding of the repository's native host helpers
(native/irgs_native.cpp, unchanged; ≙ irgs_tpu/utils/native.py).

The port uses one of them: the Morton-window k-nearest-neighbour search
(≙ simple-knn's distCUDA2), which `create_from_pcd` takes above 50k points.
The shared object is built with g++ at first use into
``build/irgs_tpu_torch/`` at the repository root, named by a hash of the
source, beside the CUDA libraries; `build_library` builds the port's own
host sources (``irgs_tpu_torch/csrc/*.cpp``) the same way. A failed build raises where the search
is needed: the JAX loader falls back to the brute force, which gives other
scales above 50k points, and the port does not.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SRC = ROOT / "native" / "irgs_native.cpp"
BUILD_DIR = ROOT / "build" / "irgs_tpu_torch"

_LIB = None


def build_library(src: Path, stem: str, flags: tuple = ()) -> Path:
    """Compile the C++ source `src` (with g++'s extra `flags`, if any) into
    ``build/irgs_tpu_torch/lib<stem>_<hash>.so`` unless the library for
    this source and these flags exists; returns its path. A failed build
    raises."""
    key = src.read_bytes() + (" ".join(flags).encode() if flags else b"")
    tag = hashlib.sha256(key).hexdigest()[:12]
    lib = BUILD_DIR / f"lib{stem}_{tag}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run(["g++", "-O3", "-std=c++17", *flags, "-shared",
                          "-fPIC", "-o", str(tmp), str(src), "-lpthread"],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed on {src.name} ({res.returncode}):\n"
                           f"{res.stderr}")
    os.replace(tmp, lib)
    return lib


def build() -> Path:
    """Compile native/irgs_native.cpp unless the library for this source
    exists; returns its path."""
    return build_library(SRC, "irgs_native")


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.mean_knn_dist2.argtypes = [f32p, ctypes.c_int64, ctypes.c_int,
                                       ctypes.c_int, f32p]
        lib.mean_knn_dist2.restype = None
        _LIB = lib
    return _LIB


def mean_knn_dist2_native(points: np.ndarray, k: int = 3,
                          window: int = 48) -> np.ndarray:
    """Morton-window approximate k-NN mean squared distance of [N, 3]
    points -> [N] float32 (≙ irgs_tpu mean_knn_dist2_native)."""
    pts = np.ascontiguousarray(points, np.float32)
    out = np.zeros(len(pts), np.float32)
    f32p = ctypes.POINTER(ctypes.c_float)
    _lib().mean_knn_dist2(pts.ctypes.data_as(f32p), len(pts), k, window,
                          out.ctypes.data_as(f32p))
    return out
