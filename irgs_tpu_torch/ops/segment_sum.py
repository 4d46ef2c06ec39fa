"""Deterministic scatter-add of rows: the gradient of a row gather.

``scatter_add_rows(grad, idx, n)`` returns ``out [n, W]`` with
``out[i] = Σ_{j: idx[j] = i} grad[j]``. On the card, ``index_add_`` adds
with atomics, so its result changes in the last bits from run to run; the
JAX package's scatter-add (XLA's, the VJP of its gathers) does not. Here the
indices are sorted once (a stable sort of int32 keys), and the CUDA kernel
of ``csrc/segment_sum.cu`` reduces the sorted rows by key over fixed tiles of
``TILE`` positions: a run inside a tile goes straight to its output row, a
run cut by a tile's edge leaves partials in two carry slots per tile, and the
next level reduces the slots with the same kernel. The number of levels
(``n_levels``) and every grid size follow from the number of rows alone, so
the host reads no device value (no sync), and every addition has a fixed
place whatever the card schedules. A long run (the raster slab pads its
unused slots with copies of one index) spreads over many tiles.

The CPU path is ``index_add_``, which adds in index order there. For a CUDA
tensor the wrapper launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda_build

TILE = 64  # sorted positions a tile reduces (C); measured, PERF.md
MAX_BLOCKS = 8  # column blocks a level reads in place (csrc MAX_BLOCKS)

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
        lib.irgs_segment_sum.argtypes = [vp, vp, ci, vp, vp, cll, ci, ci, vp,
                                         cll, vp, vp, vp]
        lib.irgs_segment_sum.restype = ci
        _LIB = lib
    return _LIB


def n_tiles(m: int, tile: int = TILE) -> int:
    return -(-m // tile)


def n_levels(m: int, tile: int = TILE) -> int:
    """Launches of the kernel for m sorted rows: one level per pass until a
    level has a single tile (which cuts no run)."""
    levels = 0
    while m > 0:
        levels += 1
        t = n_tiles(m, tile)
        m = 2 * t if t > 1 else 0
    return levels


def segment_sum_plain(src, perm, keys, tile, out, carry_keys, carry_vals):
    """One level of the kernel in plain PyTorch, the same additions in the
    same order: for each tile of `tile` sorted positions, the running sum of
    src[perm[p]] (perm None: src[p]; src a list: its blocks side by side)
    over each run of equal `keys`; a run inside the tile to out[key], a run
    cut by the tile's edge to carry slot 2t (it began before the tile) or
    2t + 1 (it goes on past it), the other slots a zero row, their keys -1
    where unused. Vectorised over tiles; it loops over the positions of a
    tile."""
    m, dev = keys.shape[0], keys.device
    src = _side_by_side(src)
    rows = src if perm is None else src[perm]
    keys = keys.long()
    t = n_tiles(m, tile)
    lo = torch.arange(t, device=dev) * tile
    hi = torch.clamp(lo + tile, max=m)
    head_cut = (lo > 0) & (keys[(lo - 1).clamp_min(0)] == keys[lo])
    tail_cut = (hi < m) & (keys[hi.clamp(max=m - 1)] == keys[hi - 1])
    if carry_vals is not None:
        carry_vals.zero_()
        carry_keys[0::2] = torch.where(head_cut, keys[lo], -1).to(
            carry_keys.dtype)
        carry_keys[1::2] = torch.where(tail_cut, keys[hi - 1], -1).to(
            carry_keys.dtype)
    acc = torch.zeros((t, src.shape[1]), dtype=src.dtype, device=dev)
    cur, first = keys[lo], torch.ones(t, dtype=torch.bool, device=dev)
    tiles = torch.arange(t, device=dev)

    def flush(ends, last):
        head = ends & first & head_cut
        tail = ends & ~head & last & tail_cut
        done = ends & ~head & ~tail & (cur >= 0) & (cur < out.shape[0])
        if carry_vals is not None:
            carry_vals[2 * tiles[head]] = acc[head]
            carry_vals[2 * tiles[tail] + 1] = acc[tail]
        out[cur[done]] = acc[done]

    for r in range(min(tile, m)):
        pos = lo + r
        live = pos < hi
        pos = pos.clamp(max=m - 1)
        k = keys[pos]
        if r > 0:
            edge = live & (k != cur)
            flush(edge, False)
            first = first & ~edge
            cur = torch.where(edge, k, cur)
            acc = torch.where(edge[:, None], torch.zeros_like(acc), acc)
        acc = torch.where(live[:, None], acc + rows[pos], acc)
    flush(torch.ones(t, dtype=torch.bool, device=dev), True)


def _blocks(src):
    """The column blocks of `src`: a tensor, or a list of [R, w] tensors
    side by side."""
    return [src] if torch.is_tensor(src) else list(src)


def _side_by_side(src):
    blocks = _blocks(src)
    return blocks[0] if len(blocks) == 1 else torch.cat(blocks, 1)


def _vec(blocks):
    """Columns a lane loads at once: 4 (16 bytes) when every block's width
    and pointer allow it, else 2 or 1."""
    for v in (4, 2):
        if all(b.shape[1] % v == 0 and b.data_ptr() % (4 * v) == 0
               for b in blocks):
            return v
    return 1


def segment_sum_cuda(src, perm, keys, tile, out, carry_keys, carry_vals):
    """Launch one level of the kernel: src [R, W] float32, or a list of at
    most MAX_BLOCKS blocks [R, w] side by side (read in place), perm [M]
    int64 or None, keys [M] int32 sorted, out [n, W] float32, carry_keys
    [2T] int32 and carry_vals [2T, W] float32 (T = ceil(M / tile); both None
    when T is 1). Writes out's complete runs and the carry slots in place."""
    blocks = [b for b in _blocks(src) if b.shape[-1] > 0]
    dev = out.device
    for name, x, dtype in ([(f"src[{i}]", b, torch.float32)
                            for i, b in enumerate(blocks)]
                           + [("perm", perm, torch.int64),
                              ("keys", keys, torch.int32),
                              ("out", out, torch.float32),
                              ("carry_keys", carry_keys, torch.int32),
                              ("carry_vals", carry_vals, torch.float32)]):
        if x is None:
            continue
        if x.device.type != "cuda" or x.device != dev:
            raise ValueError(f"segment_sum_cuda: {name} must be on the CUDA "
                             f"device of out, got {x.device}")
        if x.dtype != dtype or not x.is_contiguous():
            raise ValueError(f"segment_sum_cuda: {name} must be contiguous "
                             f"{dtype}, got {x.dtype}")
    m, w = keys.shape[0], sum(b.shape[1] for b in blocks)
    if (any(b.dim() != 2 or b.shape[0] != blocks[0].shape[0] for b in blocks)
            or out.dim() != 2 or out.shape[1] != w
            or not 0 < len(blocks) <= MAX_BLOCKS):
        raise ValueError(f"segment_sum_cuda: src blocks "
                         f"{[tuple(b.shape) for b in blocks]} must be 1 to "
                         f"{MAX_BLOCKS} of [R, *] and out {tuple(out.shape)} "
                         f"[*, {w}]")
    if (carry_vals is None) != (n_tiles(m, tile) <= 1) or (
            carry_vals is not None
            and (tuple(carry_vals.shape) != (2 * n_tiles(m, tile), w)
                 or carry_keys.shape[0] != carry_vals.shape[0])):
        raise ValueError("segment_sum_cuda: carry slots must be [2 * "
                         "ceil(M / tile)] (None for one tile)")
    if m == 0 or w == 0:
        return
    ptr = lambda x: 0 if x is None else x.data_ptr()
    ptrs = (ctypes.c_longlong * len(blocks))(*[b.data_ptr() for b in blocks])
    widths = (ctypes.c_int * len(blocks))(*[b.shape[1] for b in blocks])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().irgs_segment_sum(
            ptrs, widths, len(blocks), ptr(perm), keys.data_ptr(), m, tile,
            _vec(blocks), out.data_ptr(), out.shape[0], ptr(carry_keys),
            ptr(carry_vals), stream)
    if err != 0:
        raise RuntimeError(f"segment_sum launch failed: cuda error {err}")
    LAUNCHES["segment_sum"] += 1


@torch.no_grad()
def scatter_sorted(grad, idx, n_rows: int, segment_sum=segment_sum_cuda,
                   tile: int = TILE):
    """Σ of the rows of `grad` [M, W] (or a list of blocks [M, w] side by
    side) by index `idx` [M] -> [n_rows, W]: one stable sort of the indices
    as int32 keys, then `segment_sum` (the kernel, or its plain version)
    once per level, n_levels(M, tile) times."""
    blocks = [b.contiguous() for b in _blocks(grad)]
    if len(blocks) > MAX_BLOCKS:
        blocks = [torch.cat(blocks, 1)]
    w = sum(b.shape[1] for b in blocks)
    dtype, dev = blocks[0].dtype, blocks[0].device
    out = torch.zeros((n_rows, w), dtype=dtype, device=dev)
    m = idx.numel()
    if m == 0 or w == 0:
        return out
    if n_rows >= 2 ** 31:
        raise ValueError(f"scatter_sorted: {n_rows} rows do not fit int32 keys")
    keys, perm = torch.sort(idx.reshape(-1).to(torch.int32), stable=True)
    src = blocks
    while True:
        t = n_tiles(m, tile)
        ck = cv = None
        if t > 1:
            ck = torch.empty(2 * t, dtype=torch.int32, device=dev)
            cv = torch.empty((2 * t, w), dtype=dtype, device=dev)
        segment_sum(src, perm, keys, tile, out, ck, cv)
        if ck is None:
            return out
        src, perm, keys, m = cv, None, ck, 2 * t


@torch.no_grad()
def scatter_add_rows(grad, idx, n_rows: int):
    """grad [M, W] float32, or a list of blocks [M, w] side by side (the
    gradients of several tables gathered by `idx`), idx [M] int64 in [0,
    n_rows) -> [n_rows, W], out[i] = Σ_{j: idx[j] = i} grad[j]. CPU tensors
    take index_add_ (of the blocks side by side); CUDA tensors the kernel's
    reduce-by-key levels, which read the blocks in place: the same bits on
    every run, with no host sync and n_levels(M) launches."""
    dev = _blocks(grad)[0].device
    if dev.type == "cpu":
        rows = _side_by_side(grad)
        out = torch.zeros((n_rows, rows.shape[1]), dtype=rows.dtype)
        return out.index_add_(0, idx, rows)
    if dev.type != "cuda":
        raise ValueError(f"scatter_add_rows: unsupported device {dev}")
    return scatter_sorted(grad, idx, n_rows)
