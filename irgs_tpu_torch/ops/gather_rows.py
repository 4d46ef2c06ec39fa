"""Row gather ``table[idx]``: a CUDA kernel and its plain PyTorch version
(≙ irgs_tpu/ops/gather_pallas.py).

Replaces the Pallas TPU kernel ``_gather_kernel`` (``gather_rows``), a row
gather with a rolling window of in-flight row DMAs, which the grid tracer's
tiled select uses to fetch rows of the pair-ordered candidate table (in the
JAX package when ``TracerConfig.pallas_gather`` > 0; in the port for every
table on the card). The kernel (``csrc/gather_rows.cu``) copies rows of
32-bit words, so it serves f32 and int32 tables alike. It is bound by
bytes; the card hides the row reads' latency with resident warps, so it has
no counterpart to the TPU kernel's DMA window (see the source).

``gather_rows`` takes the plain version for tensors on the CPU only; for a
CUDA tensor it launches the kernel or raises. It is not differentiable (the
tracer gathers detached candidate rows).
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda_build

# launches of the kernel since the last reset_launches()
LAUNCHES = {"gather_rows": 0}

_LIB = None
_WORD_DTYPES = (torch.float32, torch.int32)


def reset_launches() -> None:
    LAUNCHES["gather_rows"] = 0


def _lib():
    global _LIB
    if _LIB is None:
        lib = _cuda_build.load("gather_rows")
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.irgs_gather_rows.argtypes = [vp, vp, vp, cll, cll, ci, vp]
        lib.irgs_gather_rows.restype = ci
        _LIB = lib
    return _LIB


def gather_rows_plain(table, idx):
    """table[idx]: the kernel's plain version (the CPU path and its
    oracle)."""
    return table[idx]


@torch.no_grad()
def gather_rows_cuda(table, idx):
    """Launch the kernel: table [T, W] float32 or int32, idx [M] int64 on one
    CUDA device, both contiguous -> [M, W]."""
    if table.device.type != "cuda" or idx.device != table.device:
        raise ValueError("gather_rows_cuda: table and idx must be on one CUDA "
                         f"device, got {table.device} and {idx.device}")
    if table.dim() != 2 or table.dtype not in _WORD_DTYPES:
        raise ValueError("table must be a 2-D float32 or int32 tensor, got "
                         f"{table.dtype} {tuple(table.shape)}")
    if idx.dim() != 1 or idx.dtype != torch.int64:
        raise ValueError(f"idx must be a 1-D int64 tensor, got {idx.dtype} "
                         f"{tuple(idx.shape)}")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("table and idx must be contiguous")
    T, W = table.shape
    M = idx.shape[0]
    if T == 0 and M > 0:
        raise ValueError("gather_rows_cuda: gather from an empty table")
    out = torch.empty((M, W), dtype=table.dtype, device=table.device)
    if M == 0 or W == 0:
        return out
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().irgs_gather_rows(table.data_ptr(), idx.data_ptr(),
                                      out.data_ptr(), M, T, W, stream)
    if err != 0:
        raise RuntimeError(f"gather_rows launch failed: cuda error {err}")
    LAUNCHES["gather_rows"] += 1
    return out


@torch.no_grad()
def gather_rows(table, idx):
    """table [T, W], idx [M] int64 (caller-clamped to [0, T)) -> [M, W],
    equal to ``table[idx]`` bit for bit. CPU tensors take the plain version,
    CUDA tensors the kernel."""
    if table.device.type == "cpu":
        return gather_rows_plain(table, idx)
    if table.device.type == "cuda":
        return gather_rows_cuda(table, idx)
    raise ValueError(f"gather_rows: unsupported device {table.device}")
