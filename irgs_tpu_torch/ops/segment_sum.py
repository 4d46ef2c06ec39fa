"""Deterministic scatter-add of rows: the gradient of a row gather.

``scatter_add_rows(grad, idx, n)`` returns ``out [n, W]`` with
``out[i] = Σ_{j: idx[j] = i} grad[j]``. On the card, ``index_add_`` adds
with atomics, so its result changes in the last bits from run to run; the
JAX package's scatter-add (XLA's, the VJP of its gathers) does not. Here the
indices are sorted (a stable sort), each run of one index is cut into
pieces of at most ``PIECE`` rows, and the CUDA kernel of
``csrc/segment_sum.cu`` sums each piece in sorted order; the pieces of a run
are summed again by the same kernel, level after level, until each index
has one. Every addition then has a fixed place, whatever the card
schedules. A long run (the raster slab pads its unused slots with copies of
one index) spreads over many threads instead of one.

The CPU path is ``index_add_``, which adds in index order there. For a CUDA
tensor the wrapper launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda_build

PIECE = 32  # rows a thread sums at one level

# launches of the kernel since the last reset_launches()
LAUNCHES = {"segment_sum": 0}

_LIB = None


def reset_launches() -> None:
    LAUNCHES["segment_sum"] = 0


def _lib():
    global _LIB
    if _LIB is None:
        lib = _cuda_build.load("segment_sum")
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.irgs_segment_sum.argtypes = [vp, vp, vp, cll, ci, vp, vp]
        lib.irgs_segment_sum.restype = ci
        _LIB = lib
    return _LIB


def segment_sum_plain(src, perm, bounds):
    """out[q] = Σ_{r in [bounds[q], bounds[q+1])} src[perm[r]] (perm None:
    the identity), each piece summed in the order of r: the kernel's plain
    version."""
    rows = src if perm is None else src[perm]
    n = bounds.shape[0] - 1
    out = torch.zeros((n, src.shape[1]), dtype=src.dtype, device=src.device)
    length = bounds[1:] - bounds[:-1]
    piece = torch.repeat_interleave(torch.arange(n, device=src.device), length)
    pos = torch.arange(rows.shape[0], device=src.device) - bounds[:-1][piece]
    for r in range(int(length.max()) if n else 0):
        take = pos == r
        out[piece[take]] += rows[take]
    return out


def segment_sum_cuda(src, perm, bounds):
    """Launch the kernel: src [R, W] float32, perm [M] int64 or None, bounds
    [Q + 1] int64 -> [Q, W]."""
    for name, x, dtype in (("src", src, torch.float32),
                           ("bounds", bounds, torch.int64),
                           ("perm", perm, torch.int64)):
        if x is None:
            continue
        if x.device.type != "cuda" or x.device != src.device:
            raise ValueError(f"segment_sum_cuda: {name} must be on the CUDA "
                             f"device of src, got {x.device}")
        if x.dtype != dtype or not x.is_contiguous():
            raise ValueError(f"segment_sum_cuda: {name} must be contiguous "
                             f"{dtype}, got {x.dtype}")
    if src.dim() != 2:
        raise ValueError(f"src must be 2-D, got {tuple(src.shape)}")
    q, w = bounds.shape[0] - 1, src.shape[1]
    out = torch.empty((q, w), dtype=torch.float32, device=src.device)
    if q == 0 or w == 0:
        return out
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().irgs_segment_sum(
            src.data_ptr(), 0 if perm is None else perm.data_ptr(),
            bounds.data_ptr(), q, w, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"segment_sum launch failed: cuda error {err}")
    LAUNCHES["segment_sum"] += 1
    return out


def _pieces(keys):
    """Sorted keys [M] -> (bounds [Q + 1] of pieces of at most PIECE rows
    inside each run of equal keys, the key of each piece, the number of
    runs)."""
    m = keys.shape[0]
    pos = torch.arange(m, device=keys.device)
    new_run = torch.ones(m, dtype=torch.bool, device=keys.device)
    new_run[1:] = keys[1:] != keys[:-1]
    run_starts = torch.nonzero(new_run).reshape(-1)
    run_start = run_starts[torch.cumsum(new_run.long(), 0) - 1]
    first = new_run | ((pos - run_start) % PIECE == 0)
    starts = torch.nonzero(first).reshape(-1)
    bounds = torch.cat([starts, torch.full((1,), m, device=keys.device,
                                           dtype=starts.dtype)])
    return bounds, keys[starts], run_starts.shape[0]


@torch.no_grad()
def scatter_sorted(grad, idx, n_rows: int, segment_sum=segment_sum_cuda):
    """Σ of the rows of `grad` [M, W] by index `idx` [M] -> [n_rows, W]: a
    stable sort of the indices, then `segment_sum` (the kernel, or its plain
    version) level after level over pieces of at most PIECE rows."""
    out = torch.zeros((n_rows, grad.shape[1]), dtype=grad.dtype,
                      device=grad.device)
    if idx.numel() == 0:
        return out
    keys, perm = torch.sort(idx, stable=True)
    src = grad.contiguous()
    while True:
        bounds, keys, n_runs = _pieces(keys)
        src = segment_sum(src, perm, bounds)
        perm = None
        if keys.shape[0] == n_runs:
            break
    return out.index_copy_(0, keys, src)


@torch.no_grad()
def scatter_add_rows(grad, idx, n_rows: int):
    """grad [M, W] float32, idx [M] int64 in [0, n_rows) -> [n_rows, W],
    out[i] = Σ_{j: idx[j] = i} grad[j]. CPU tensors take index_add_; CUDA
    tensors the sorted piecewise sums of the kernel, the same bits on every
    run."""
    if grad.device.type == "cpu":
        out = torch.zeros((n_rows, grad.shape[1]), dtype=grad.dtype)
        return out.index_add_(0, idx, grad)
    if grad.device.type != "cuda":
        raise ValueError(f"scatter_add_rows: unsupported device {grad.device}")
    return scatter_sorted(grad, idx, n_rows)
