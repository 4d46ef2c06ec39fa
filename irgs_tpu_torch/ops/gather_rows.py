"""Row gather ``table[idx]``: a CUDA kernel and its plain PyTorch version
(≙ irgs_tpu/ops/gather_pallas.py).

Replaces the Pallas TPU kernel ``_gather_kernel`` (``gather_rows``), a row
gather with a rolling window of in-flight row DMAs, which the grid tracer's
tiled select uses to fetch rows of its pair-ordered candidate table (in the
JAX package when ``TracerConfig.pallas_gather`` > 0; in the port for every
table on the card). The kernel (``csrc/gather_rows.cu``) copies rows of
32-bit words, so it serves f32 and int32 tables alike. It is bound by the
bytes it writes; a persistent grid of warps reads each chunk's indices ahead
of its rows, keeps rows in flight in registers (8 units of 16 or 4 bytes a
lane) and stores the output evict-first, past the table rows in L2; see
the source.

``gather_rows`` takes the plain version for tensors on the CPU only; for a
CUDA tensor it launches the kernel or raises. It is not differentiable (the
tracer gathers detached candidate rows). Its host path is short, since the
tracer launches it thousands of times a frame: no autograd mode switch (the
output is a fresh tensor), the raw stream handle, the C entry bound once and
given its arguments in one array, and a device switch (in the C entry) only
when the table's device is not the current one.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import _cuda_build

# launches of the kernel since the last reset_launches()
LAUNCHES = {"gather_rows": 0}

_FN = None
_WORD_DTYPES = (torch.float32, torch.int32)
# each thread's argument array for the C entry (its address last)
_ARGS = threading.local()


def reset_launches() -> None:
    LAUNCHES["gather_rows"] = 0


def _fn():
    """The kernel's C entry, built and bound at first use."""
    global _FN
    if _FN is None:
        fn = _cuda_build.load("gather_rows").irgs_gather_rows
        fn.argtypes = [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def gather_rows_plain(table, idx):
    """table[idx]: the kernel's plain version (the CPU path and its
    oracle)."""
    return table[idx]


def gather_rows_cuda(table, idx):
    """Launch the kernel: table [T, W] float32 or int32, idx [M] int64 on one
    CUDA device, both contiguous -> [M, W]."""
    dev = table.get_device()
    if not table.is_cuda or idx.get_device() != dev:
        raise ValueError("gather_rows_cuda: table and idx must be on one CUDA "
                         f"device, got {table.device} and {idx.device}")
    if table.dtype not in _WORD_DTYPES or table.dim() != 2:
        raise ValueError("table must be a 2-D float32 or int32 tensor, got "
                         f"{table.dtype} {tuple(table.shape)}")
    if idx.dtype != torch.int64 or idx.dim() != 1:
        raise ValueError(f"idx must be a 1-D int64 tensor, got {idx.dtype} "
                         f"{tuple(idx.shape)}")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("table and idx must be contiguous")
    T, W = table.shape
    M = idx.shape[0]
    if T == 0 and M > 0:
        raise ValueError("gather_rows_cuda: gather from an empty table")
    out = table.new_empty((M, W))
    if M == 0 or W == 0:
        return out
    args = getattr(_ARGS, "array", None)
    if args is None:
        args = _ARGS.array = (ctypes.c_longlong * 9)()
        args[8] = ctypes.addressof(args)
    args[:8] = (table.data_ptr(), idx.data_ptr(), out.data_ptr(), M, T, W,
                torch._C._cuda_getCurrentRawStream(dev), dev)
    err = _fn()(args[8])
    if err != 0:
        raise RuntimeError(f"gather_rows launch failed: cuda error {err}")
    LAUNCHES["gather_rows"] += 1
    return out


def gather_rows(table, idx):
    """table [T, W], idx [M] int64 (caller-clamped to [0, T)) -> [M, W],
    equal to ``table[idx]`` bit for bit. CPU tensors take the plain version,
    CUDA tensors the kernel."""
    if table.is_cuda:
        return gather_rows_cuda(table, idx)
    if table.device.type == "cpu":
        return gather_rows_plain(table.detach(), idx)
    raise ValueError(f"gather_rows: unsupported device {table.device}")
