"""Per-tile surfel blend: CUDA kernels (forward + backward) and their plain
PyTorch version.

Replaces the Pallas TPU kernels of irgs_tpu/ops/raster_pallas.py:
``_make_fwd_kernel`` (forward) and ``_make_bwd_kernel`` (its custom VJP),
joined by ``blend_tiles``. The kernels live in ``csrc/raster_blend.cu``; they
are compiled with nvcc for sm_90a into a shared library with a plain C
interface at first use (``ops/_cuda_build.py``), and called through ctypes on
PyTorch's current stream.

What bounds them on the card. Counted over every pixel x splat pair, the
work (~100 fp32 operations a pair forward, ~300 backward, against 4·F bytes
of slab per splat shared by 256 pixels) is far above the H100's fp32 ridge,
so the yardstick is fp32 operations. The work is uneven and sparse, though:
a tile's K = 128 chunks run in order in one block, and the heaviest tile of
the bench slab blends about as many chunks as the average SM's share of all
tiles, so the kernels are held to that tile's chain of steps; and ~11 % of
the pairs have alpha > 0 (~66 % of the (warp, splat) steps have none).

The design: an exact cull (alpha is certainly below 1/255 when rho2d and
rho3d both exceed 2 ln(255·o), tested without a division) lets a warp with
no live pair skip the step, and a lane with alpha = 0 the rest of it. The
forward splits each chunk into 4 sub-ranges of splats, one group of 256
threads (a thread per pixel) each, so a tile has 4 times the warps: a first
step sums each sub-range's log-transmittance, then each blends with its
incoming T and the sub-ranges are combined in order. Tiles start heaviest
first (`tile_order`). Chunks are double-buffered in shared memory with
cp.async. The backward needs no replay for Σ w·dL/dw per pixel: it has a closed form
in the forward's totals (`s_tot_closed`); its 12 + NA per-splat sums over a
warp's pixels are one reduce-scatter, summed over the 8 warps in a fixed
order in shared memory, with no atomics. The chain to the 12 geometric slab
columns is derived by hand.

Slab layout (`slab_width(S)` f32 rows, padded to a multiple of 8):
  0:3 Tu | 3:6 Tv | 6:9 Tw | 9:11 center | 11 opacity | 12:12+NA attrs,
  attrs = rgb(3) ‖ feature(S) ‖ normal(3), NA = 6 + S.
Per-tile outputs [n_tiles, 256, C_OUT], C_OUT = NA + 9:
  attrs | D | D2 | A | M1 | M2 | dist | med_depth | med_ord | T.

``blend_tiles`` takes the plain version for tensors on the CPU only; for a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda_build

TILE = 16
TILE_PIX = TILE * TILE
NEAR_N = 0.2
FAR_N = 100.0
FILTER_INV_SQUARE = 2.0
ALPHA_EPS = 1.0 / 255.0
T_DONE = 1e-4
K = 128  # splats per chunk; tile segments are K-aligned
MAX_S = 8  # feature widths the kernels are instantiated for

# launches of each kernel since the last reset_launches()
LAUNCHES = {"blend_fwd": 0, "blend_bwd": 0}

_LIB = None


def n_attr(S: int) -> int:
    return 6 + S


def c_out(S: int) -> int:
    return n_attr(S) + 9


def slab_width(S: int) -> int:
    return ((12 + n_attr(S) + 7) // 8) * 8


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# bind
# ---------------------------------------------------------------------------

def _lib():
    global _LIB
    if _LIB is None:
        lib = _cuda_build.load("raster_blend")
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.irgs_blend_fwd.argtypes = [vp, vp, vp, vp, vp, ci, ci, cll, ci,
                                       vp]
        lib.irgs_blend_fwd.restype = ci
        lib.irgs_blend_bwd.argtypes = [vp, vp, vp, vp, vp, vp, vp, ci, ci,
                                       cll, ci, vp]
        lib.irgs_blend_bwd.restype = ci
        _LIB = lib
    return _LIB


def _check(name, x, dtype, shape=None):
    if x.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
    if shape is not None and tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_inputs(splat, starts, counts, n_tiles, S):
    if not 0 <= S <= MAX_S:
        raise ValueError(f"feature width S={S} not in [0, {MAX_S}]")
    _check("splat", splat, torch.float32, (slab_width(S), splat.shape[1]))
    _check("starts", starts, torch.int32, (n_tiles,))
    _check("counts", counts, torch.int32, (n_tiles,))
    if not (splat.device == starts.device == counts.device):
        raise ValueError("splat, starts and counts must share one device")


def tile_order(counts):
    """The order in which the kernels' blocks take the tiles: by slab count,
    heaviest first (ties in tile order). A tile's chain of chunks is the
    longest single task of a launch, so it should not start last."""
    return torch.argsort(counts, descending=True, stable=True)


def blend_fwd_cuda(splat, starts, counts, grid_x: int, n_tiles: int, S: int):
    """Launch the forward kernel -> [n_tiles, 256, C_OUT]."""
    _check_inputs(splat, starts, counts, n_tiles, S)
    out = torch.empty((n_tiles, TILE_PIX, c_out(S)), dtype=torch.float32,
                      device=splat.device)
    order = tile_order(counts)
    with torch.cuda.device(splat.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().irgs_blend_fwd(
            splat.data_ptr(), starts.data_ptr(), counts.data_ptr(),
            order.data_ptr(), out.data_ptr(), n_tiles, grid_x, splat.shape[1],
            S, stream)
    if err != 0:
        raise RuntimeError(f"blend_fwd launch failed: cuda error {err}")
    LAUNCHES["blend_fwd"] += 1
    return out


def blend_bwd_cuda(splat, starts, counts, fwd_out, cot, grid_x: int,
                   n_tiles: int, S: int):
    """Launch the backward kernel -> dslab [F, b_pad]. Columns outside every
    tile's range are never written and stay zero."""
    _check_inputs(splat, starts, counts, n_tiles, S)
    shape = (n_tiles, TILE_PIX, c_out(S))
    _check("fwd_out", fwd_out, torch.float32, shape)
    _check("cot", cot, torch.float32, shape)
    dslab = torch.zeros_like(splat)
    order = tile_order(counts)
    with torch.cuda.device(splat.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().irgs_blend_bwd(
            splat.data_ptr(), starts.data_ptr(), counts.data_ptr(),
            order.data_ptr(), fwd_out.data_ptr(), cot.data_ptr(),
            dslab.data_ptr(), n_tiles, grid_x, splat.shape[1], S, stream)
    if err != 0:
        raise RuntimeError(f"blend_bwd launch failed: cuda error {err}")
    LAUNCHES["blend_bwd"] += 1
    return dslab


class BlendTiles(torch.autograd.Function):
    """The kernel pair as one differentiable op (≙ the blend_tiles
    custom_vjp of raster_pallas.py)."""

    @staticmethod
    def forward(ctx, splat, starts, counts, grid_x, n_tiles, S):
        out = blend_fwd_cuda(splat, starts, counts, grid_x, n_tiles, S)
        ctx.save_for_backward(splat, starts, counts, out)
        ctx.meta = (grid_x, n_tiles, S)
        return out

    @staticmethod
    def backward(ctx, cot):
        splat, starts, counts, out = ctx.saved_tensors
        grid_x, n_tiles, S = ctx.meta
        dslab = blend_bwd_cuda(splat, starts, counts, out, cot.contiguous(),
                               grid_x, n_tiles, S)
        return dslab, None, None, None, None, None


def blend_tiles(splat, starts, counts, grid_x: int, n_tiles: int, S: int):
    """splat [F, B_pad] (K-aligned tile segments along the columns, zero
    padding columns), starts/counts [n_tiles] int32 (counts multiples of K)
    -> [n_tiles, 256, C_OUT]. CPU tensors take the plain version; CUDA
    tensors the kernels."""
    if splat.device.type == "cpu":
        return blend_tiles_plain(splat, starts, counts, grid_x, n_tiles, S)
    if splat.device.type == "cuda":
        return BlendTiles.apply(splat, starts, counts, grid_x, n_tiles, S)
    raise ValueError(f"blend_tiles: unsupported device {splat.device}")


# ---------------------------------------------------------------------------
# plain PyTorch version (the CPU path and the kernels' oracle)
# ---------------------------------------------------------------------------

def s_tot_closed(fwd_out, cot, S: int):
    """Σ_k w_k·dL/dw_k per pixel ([n_tiles, 256]) from the forward's totals
    and the cotangent, as the backward kernel forms it. dL/dw_k is linear in
    what the forward summed (attrs, depth, depth², 1, m, m² and the
    distortion's m_k²·A + M2 − 2·m_k·M1), so the sum over k is
    Σ_a g_a·acc_a + g_D·D + g_D2·D2 + g_A·A + g_M1·M1 + g_M2·M2
    + 2·g_dist·(A·M2 − M1²)."""
    NA = n_attr(S)
    acc, D, D2, A, M1, M2 = (fwd_out[..., :NA], *fwd_out[..., NA:NA + 5]
                             .unbind(-1))
    g_acc, gD, gD2, gA, gM1, gM2, g_dist = (cot[..., :NA],
                                            *cot[..., NA:NA + 6].unbind(-1))
    return ((g_acc * acc).sum(-1) + gD * D + gD2 * D2 + gA * A + gM1 * M1
            + gM2 * M2 + 2.0 * g_dist * (A * M2 - M1 * M1))


def _excl_cumsum(x):
    return torch.cumsum(x, dim=-1) - x


def alpha_depth(slab, px, py):
    """slab [a, F, K] × pixels [a, 256, 1] -> alpha, depth, m [a, 256, K]
    (≙ raster_pallas._alpha_depth). Zero padding columns give alpha 0."""
    col = lambda j: slab[:, j, None, :]
    kx = px * col(6) - col(0)
    ky = px * col(7) - col(1)
    kz = px * col(8) - col(2)
    lx = py * col(6) - col(3)
    ly = py * col(7) - col(4)
    lz = py * col(8) - col(5)
    p_x = ky * lz - kz * ly
    p_y = kz * lx - kx * lz
    p_z = kx * ly - ky * lx
    pz_safe = torch.where(p_z == 0.0, torch.ones_like(p_z), p_z)
    sx = p_x / pz_safe
    sy = p_y / pz_safe
    rho3d = sx * sx + sy * sy
    dx = col(9) - px
    dy = col(10) - py
    rho2d = FILTER_INV_SQUARE * (dx * dx + dy * dy)
    rho = torch.minimum(rho3d, rho2d)
    depth = torch.where(rho3d <= rho2d, sx * col(6) + sy * col(7) + col(8),
                        col(8).expand(rho.shape))
    a0 = col(11) * torch.exp(-0.5 * rho)
    alpha = torch.minimum(a0, torch.full_like(a0, 0.99))
    bad = (p_z == 0.0) | (depth < NEAR_N) | (alpha < ALPHA_EPS)
    alpha = torch.where(bad, torch.zeros_like(alpha), alpha)
    dmax = torch.maximum(depth, torch.full_like(depth, 1e-6))
    m = FAR_N / (FAR_N - NEAR_N) * (1.0 - NEAR_N / dmax)
    return alpha, depth, m


def blend_tiles_plain(splat, starts, counts, grid_x: int, n_tiles: int,
                      S: int, return_chunks: bool = False):
    """Same function and output layout as the kernels, in plain PyTorch,
    including the tile-level early stop. Differentiable w.r.t. `splat` by
    autograd, with the kernel's gradient semantics: the final-T path reaches
    only splats whose weight is live (as the backward kernel's dalpha).
    With `return_chunks`, also returns the number of K-chunks each tile
    blended before it stopped ([n_tiles] int64: the work these inputs
    need)."""
    NA = n_attr(S)
    dev = splat.device
    f32 = torch.float32
    starts_l = starts.long()
    n_chunks = (counts // K).long()
    i = torch.arange(TILE_PIX, device=dev)
    tile = torch.arange(n_tiles, device=dev)
    px_all = ((tile % grid_x) * TILE)[:, None].to(f32) + (i % TILE).to(f32)
    py_all = ((tile // grid_x) * TILE)[:, None].to(f32) + (i // TILE).to(f32)
    lane = torch.arange(K, device=dev)

    zeros = lambda *s: torch.zeros((n_tiles, TILE_PIX) + s, dtype=f32, device=dev)
    acc = zeros(NA)
    D, D2, A, M1, M2, dist, med_d = (zeros() for _ in range(7))
    med_o = torch.full((n_tiles, TILE_PIX), -1.0, dtype=f32, device=dev)
    T = torch.ones((n_tiles, TILE_PIX), dtype=f32, device=dev)
    running = torch.ones(n_tiles, dtype=torch.bool, device=dev)
    chunks_run = torch.zeros(n_tiles, dtype=torch.long, device=dev)

    n_max = int(n_chunks.max()) if n_tiles else 0
    for c in range(n_max):
        act = torch.nonzero(running & (c < n_chunks)).reshape(-1)
        if act.numel() == 0:
            break
        chunks_run[act] += 1
        cols = starts_l[act, None] + c * K + lane                  # [a, K]
        slab = splat[:, cols].permute(1, 0, 2)                     # [a, F, K]
        px, py = px_all[act, :, None], py_all[act, :, None]
        alpha, depth, m = alpha_depth(slab, px, py)

        T_tile = T[act]
        lg = torch.log1p(-alpha)
        T_in = T_tile[..., None] * torch.exp(_excl_cumsum(lg))
        live = T_in * (1.0 - alpha) >= T_DONE
        w = torch.where(live, alpha * T_in, torch.zeros_like(alpha))

        # median depth: last contributing splat with incoming T > 0.5
        mmask = (w > 0.0) & (T_in > 0.5)
        ordf = (c * K + lane).to(f32)
        cand = torch.where(mmask, ordf, torch.full_like(w, -1.0)).amax(-1)
        sel = mmask & (ordf == cand[..., None])
        cand_d = torch.where(sel, depth, torch.zeros_like(depth)).sum(-1)
        has = cand >= 0.0

        attrs = slab[:, 12:12 + NA, :].transpose(1, 2)              # [a, K, NA]
        sw = w.sum(-1)
        mw = m * w
        m2w = m * mw
        dist_intra = torch.sum(m * m * w * _excl_cumsum(w) + w * _excl_cumsum(m2w)
                               - 2.0 * m * w * _excl_cumsum(mw), dim=-1)
        A_prev, M1_prev, M2_prev = A[act], M1[act], M2[act]
        dist_cross = (m2w.sum(-1) * A_prev + sw * M2_prev
                      - 2.0 * mw.sum(-1) * M1_prev)
        # the final T multiplies every splat's (1 - alpha); its gradient
        # reaches live splats only (as in the backward kernel)
        lg_t = torch.where(live, lg, lg.detach())

        put = lambda x, v: x.index_copy(0, act, v)
        acc = put(acc, acc[act] + torch.bmm(w, attrs))
        D = put(D, D[act] + (w * depth).sum(-1))
        D2 = put(D2, D2[act] + (w * depth * depth).sum(-1))
        A = put(A, A_prev + sw)
        M1 = put(M1, M1_prev + mw.sum(-1))
        M2 = put(M2, M2_prev + m2w.sum(-1))
        dist = put(dist, dist[act] + dist_intra + dist_cross)
        med_d = put(med_d, torch.where(has, cand_d, med_d[act]))
        med_o = put(med_o, torch.where(has, cand, med_o[act]))
        T_new = T_tile * torch.exp(lg_t.sum(-1))
        T = put(T, T_new)
        running = running.index_copy(0, act, T_new.detach().amax(-1) > T_DONE)

    out = torch.cat([acc, D[..., None], D2[..., None], A[..., None],
                     M1[..., None], M2[..., None], dist[..., None],
                     med_d[..., None], med_o[..., None], T[..., None]], dim=-1)
    return (out, chunks_run) if return_chunks else out
